"""The port's model-split layout (K5b) against the JAX reference's.

At an even device count the reference's ``fleet_mesh`` has model = 2: its
``shard_params`` splits the hidden dimension over ``model`` (w_enc
``P(None, "model")``, b_enc ``P("model")``, w_dec ``P("model", None)``,
b_dec replicated) and ``shard_batch``/``shard_noise`` split the rows over
``data`` only.  The port's ``virtual_mesh(n, "cpu")`` takes the same
layout, and its fit is K5b's plain version
(``kernels.reference.fit_model_shard``).  The reference runs on its 8, 6
and 2 forced virtual CPU devices (tests/conftest.py), called directly as
tests/test_torch_shard.py calls it.

The shards' arrays are compared bitwise; the steps and fits at the
tolerances of tests/test_torch_shard.py (PARAM_ATOL / LOSS_RTOL for one
step, FIT_RTOL / FIT_ATOL / FIT_LOSS_RTOL for a 40-step fit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clawker_tpu.analytics import anomaly as ref
from clawker_tpu.analytics import features as ref_F
from clawker_tpu.analytics import runtime as ref_art
from clawker_tpu_torch import graft_entry
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import features as F
from clawker_tpu_torch.analytics import mesh as M
from clawker_tpu_torch.analytics import runtime as art
from clawker_tpu_torch.kernels import anomaly as K
from clawker_tpu_torch.kernels import reference as R

from test_torch_runtime import (FIT_ATOL, FIT_LOSS_RTOL, FIT_RTOL, _noise,
                                _param_arrays, _records)
from test_torch_shard import LOSS_RTOL, LR, PARAM_ATOL, ZERO_LAUNCHES

torch.set_num_threads(1)

CPU = "cpu"
# device count -> the reference's mesh shape, data x 2
SPLIT = {8: (4, 2), 6: (3, 2), 2: (1, 2)}


def _jax_params(arrays):
    return ref.AnomalyParams(*(jnp.asarray(a) for a in arrays))


def _by_device(arr) -> list[np.ndarray]:
    """A sharded jax array's shards, in device order (the mesh's shard
    order, data-major)."""
    return [np.asarray(sh.data) for sh in
            sorted(arr.addressable_shards, key=lambda sh: sh.device.id)]


@pytest.fixture
def injected(monkeypatch):
    """Both runtimes draw the same numpy params and noise."""
    made = {}

    def noise_for(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in made:
            made[shape] = _noise(shape)
        return made[shape]

    monkeypatch.setattr(
        ref_art, "anomaly_init", lambda seed, feat=None: _jax_params(
            _param_arrays(feat or 32)))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            noise_for(shape)))
    monkeypatch.setattr(art, "_draw", lambda seed, steps, x: (
        anomaly.params_from_numpy(_param_arrays(x.shape[1]), device=x.device),
        torch.from_numpy(noise_for((steps,) + tuple(x.shape)))))


# ------------------------------------------------------------ the layout


@pytest.mark.parametrize("n", sorted(SPLIT, reverse=True))
def test_mesh_splits_the_hidden_dimension_at_an_even_count(n):
    mesh = M.virtual_mesh(n, CPU)
    assert (mesh.data, mesh.model) == SPLIT[n]
    assert dict(ref.fleet_mesh(n).shape) == mesh.shape


@pytest.mark.parametrize("n", sorted(SPLIT, reverse=True))
def test_params_halves_are_the_references_bit_for_bit(n):
    """Shard (d, m) holds the reference's device d * 2 + m arrays: half m
    of w_enc, b_enc and w_dec, and the whole b_dec."""
    arrays = _param_arrays(40)
    want = ref.shard_params(_jax_params(arrays), ref.fleet_mesh(n))
    got = M.shard_params(anomaly.params_from_numpy(arrays, device=CPU),
                         M.virtual_mesh(n, CPU))
    assert len(got) == n
    for name, arr, mine in zip(anomaly.AnomalyParams._fields, want,
                               zip(*got)):
        shards = _by_device(arr)
        assert len(shards) == n, name
        for s, (a, b) in enumerate(zip(shards, mine)):
            assert a.shape == tuple(b.shape), (name, s)
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f"{name} {s}")


@pytest.mark.parametrize("n", sorted(SPLIT, reverse=True))
def test_row_and_noise_blocks_are_the_references_bit_for_bit(n):
    """Both shards of data block d hold the reference's rows of devices
    d * 2 and d * 2 + 1; the noise's steps axis stays whole."""
    mesh_j, mesh = ref.fleet_mesh(n), M.virtual_mesh(n, CPU)
    rows = 24 * mesh.data
    x = np.random.default_rng(n).standard_normal((rows, 32)).astype(
        np.float32)
    noises = _noise((3, rows, 32))
    for want, got in (
            (ref.shard_batch(jnp.asarray(x), mesh_j),
             M.shard_rows(torch.from_numpy(x), mesh)),
            (ref.shard_noise(jnp.asarray(noises), mesh_j),
             M.shard_noise(torch.from_numpy(noises), mesh))):
        shards = _by_device(want)
        assert len(shards) == len(got) == n
        for a, b in zip(shards, got):
            np.testing.assert_array_equal(b.numpy(), a)


# ------------------------------------------------------------- the steps


@pytest.mark.parametrize("feat", [32, 40])
@pytest.mark.parametrize("n", sorted(SPLIT, reverse=True))
def test_split_train_step_matches_reference(n, feat):
    rng = np.random.default_rng(n + feat)
    x = rng.standard_normal((16 * SPLIT[n][0], feat)).astype(np.float32)
    arrays = _param_arrays(feat)
    mesh_j = ref.fleet_mesh(n)
    pj, lj = jax.jit(ref.train_step)(
        ref.shard_params(_jax_params(arrays), mesh_j),
        ref.shard_batch(jnp.asarray(x), mesh_j), LR)
    params = anomaly.params_from_numpy(arrays, device=CPU)
    pt, lt = M.train_step(params, torch.from_numpy(x),
                          M.virtual_mesh(n, CPU), lr=LR)
    for name, got, want in zip(anomaly.AnomalyParams._fields,
                               anomaly.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    assert all(np.array_equal(p.numpy(), a) for p, a in zip(params, arrays))


@pytest.mark.parametrize("feat", [32, 40])
@pytest.mark.parametrize("n", sorted(SPLIT, reverse=True))
def test_split_denoise_step_matches_reference(n, feat):
    rng = np.random.default_rng(20 + n + feat)
    x = rng.standard_normal((16 * SPLIT[n][0], feat)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    arrays = _param_arrays(feat)
    mesh_j = ref.fleet_mesh(n)
    step = jax.jit(lambda p, x, nz: ref.denoise_step_with_noise(p, x, nz,
                                                                lr=LR))
    pj, lj = step(ref.shard_params(_jax_params(arrays), mesh_j),
                  ref.shard_batch(jnp.asarray(x), mesh_j),
                  ref.shard_batch(jnp.asarray(noise), mesh_j))
    pt, lt = M.denoise_step_with_noise(
        anomaly.params_from_numpy(arrays, device=CPU), torch.from_numpy(x),
        torch.from_numpy(noise), M.virtual_mesh(n, CPU), lr=LR)
    for name, got, want in zip(anomaly.AnomalyParams._fields,
                               anomaly.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)


# -------------------------------------------------------------- the fit


@pytest.mark.parametrize("n", [8, 6])
def test_split_fit_and_score_matches_reference(injected, n):
    """``_fit_and_score`` over the split mesh against the reference's over
    ``fleet_mesh(n)``: 40 steps, the fitted raw scores."""
    keys, X = F.featurize(_records(hot_agent=True))
    _, ref_X = ref_F.featurize(_records(hot_agent=True))
    raw_j, _, xj, tj = ref_art._fit_and_score(
        ref_X, train_steps=40, lr=LR, seed=0, mesh=ref.fleet_mesh(n))
    raw, params, x, t = art._fit_and_score(
        X, train_steps=40, lr=LR, seed=0, mesh=M.virtual_mesh(n, CPU))
    desc = "x".join(map(str, SPLIT[n]))
    assert t["device"] == f"cpu mesh={desc}"
    assert tj["device"].endswith(f"mesh={desc}")
    assert tuple(x.shape) == tuple(xj.shape) and raw.shape == (len(keys),)
    np.testing.assert_allclose(raw, raw_j, rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_array_equal(
        anomaly.score(params, x)[:len(keys)].numpy(), raw)


@pytest.mark.parametrize("n", [8, 6])
def test_split_fit_losses_match_reference_scan(n):
    """The 40-step fit's losses over the split mesh against the reference's
    jitted scan over the same mesh, and the halves' b_dec the same bits."""
    _, X = F.featurize(_records(hot_agent=True))
    mesh_j, mesh = ref.fleet_mesh(n), M.virtual_mesh(n, CPU)
    Xn = art._pad_rows(X, 32, mesh.data)
    arrays = _param_arrays(32)
    noise = _noise((40,) + Xn.shape)
    fit, _ = ref_art._jitted()
    _, losses_j = fit(ref.shard_params(_jax_params(arrays), mesh_j),
                      ref.shard_batch(jnp.asarray(Xn), mesh_j),
                      ref.shard_noise(jnp.asarray(noise), mesh_j), LR)
    replicas = M.shard_params(anomaly.params_from_numpy(arrays, device=CPU),
                              mesh)
    losses = art._fit_shards(replicas, M.shard_rows(torch.from_numpy(Xn),
                                                    mesh),
                             M.shard_noise(torch.from_numpy(noise), mesh),
                             LR, mesh)
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j),
                               rtol=FIT_LOSS_RTOL)
    assert torch.equal(replicas[0].b_dec, replicas[1].b_dec)


# ------------------------------------------------------ the plain version


@pytest.mark.parametrize("rows, feat", [
    ([40, 40], 32), ([22, 22, 21], 40), ([129], 7), ([17] * 4, 61)])
@pytest.mark.parametrize("noisy", [True, False])
def test_model_step_grads_at_one_half_are_shard_step_grads(rows, feat,
                                                           noisy):
    """At model = 1 the split step adds the same terms in the same order
    as K5's plain step: the same bits."""
    g = torch.Generator().manual_seed(sum(rows) + feat)
    params = anomaly.init_params(g, feat=feat)
    xs = [torch.randn((n, feat), generator=g) for n in rows]
    noises = ([torch.randn((n, feat), generator=g) for n in rows] if noisy
              else [None] * len(rows))
    got, loss = R.model_step_grads([tuple(params)], xs, noises, 0.25)
    want, want_loss = R.shard_step_grads(*params, xs, noises, 0.25)
    assert len(got) == 1
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))
    assert torch.equal(loss, want_loss)


def test_model_step_grads_are_the_batch_gradients():
    """The halves' gradients, joined, are the whole batch's (to fp32
    summation order); both halves carry the same db_dec."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((129, 32)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((129, 32)).astype(
        np.float32))
    params = anomaly.params_from_numpy(_param_arrays(32), device=CPU)
    mesh = M.virtual_mesh(6, CPU)
    halves = M.shard_params(params, mesh)[:2]
    got, loss = R.model_step_grads(halves, M.shard_rows(x, mesh)[::2],
                                   M.shard_rows(noise, mesh)[::2], 0.25)
    want, want_loss = R.step_grads(*params, x, noise, 0.25)
    joined = (torch.cat([got[0][0], got[1][0]], dim=1),
              torch.cat([got[0][1], got[1][1]]),
              torch.cat([got[0][2], got[1][2]]), got[0][3])
    assert torch.equal(got[0][3], got[1][3])
    for a, b in zip(joined, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)


def test_split_score_is_the_score():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((130, 32)).astype(np.float32))
    params = anomaly.params_from_numpy(_param_arrays(32), device=CPU)
    for n in SPLIT:
        assert torch.equal(M.score(params, x, M.virtual_mesh(n, CPU)),
                           anomaly.score(params, x))


# ---------------------------------------------------------- the entries


def test_dryrun_multichip_runs_the_split(monkeypatch):
    """``dryrun_multichip(8, "cpu")`` takes K5b's plain step twice (train
    and denoise) over the 4x2 mesh and K5's never; nothing launches."""
    calls = {"model": 0, "shard": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(R, "fit_model_step",
                        counted("model", R.fit_model_step))
    monkeypatch.setattr(R, "fit_shard_step",
                        counted("shard", R.fit_shard_step))
    K.reset_launches()
    graft_entry.dryrun_multichip(8, device=CPU)
    assert calls == {"model": 2, "shard": 0}
    assert K.LAUNCHES == ZERO_LAUNCHES
    graft_entry.dryrun_multichip(3, device=CPU)
    assert calls == {"model": 2, "shard": 2}


def _model_inputs(rows=(40, 40), feat=32, steps=2):
    g = torch.Generator().manual_seed(0)
    params = anomaly.init_params(g, feat=feat)
    mesh = M.Mesh(data=len(rows), model=2,
                  devices=(torch.device(CPU),) * (2 * len(rows)))
    halves = M.shard_params(params, mesh)
    xs = [t for n in rows for t in [torch.randn((n, feat), generator=g)] * 2]
    noises = [t for n in rows
              for t in [torch.randn((steps, n, feat), generator=g)] * 2]
    return halves, xs, noises, torch.empty(steps)


@pytest.mark.parametrize("bad", [
    "odd_shards", "whole_params", "halves_count", "two_sets_one_half",
    "rows_differ", "noise_rows", "losses_size",
])
def test_fit_model_rejects_what_the_kernel_does_not_take(bad):
    halves, xs, noises, losses = _model_inputs()
    if bad == "odd_shards":
        halves, xs, noises = halves[:3], xs[:3], noises[:3]
    elif bad == "whole_params":
        params = anomaly.init_params(torch.Generator().manual_seed(1))
        halves = [params] * 4
    elif bad == "halves_count":
        halves = halves[:2]
    elif bad == "two_sets_one_half":
        halves = list(halves)
        halves[2] = anomaly.AnomalyParams(*(p.clone() for p in halves[0]))
    elif bad == "rows_differ":
        xs[1] = torch.randn(39, 32)
    elif bad == "noise_rows":
        noises[1] = torch.randn(2, 39, 32)
    elif bad == "losses_size":
        losses = torch.empty(3)
    with pytest.raises(ValueError):
        K.fit_model_(halves, xs, noises, lr=LR, sigma=0.25, losses_out=losses)


def test_cpu_model_calls_launch_nothing_and_match_the_plain_fit():
    K.reset_launches()
    halves, xs, noises, losses = _model_inputs(rows=(22, 21, 21))
    start = [tuple(p.clone() for p in h) for h in halves[:2]]
    K.fit_model_(halves, xs, noises, lr=LR, sigma=0.25, losses_out=losses)
    want, want_losses = R.fit_model_shard(start, xs[::2], noises[::2], LR,
                                          0.25)
    for got, w in zip(halves[:2], want):
        assert all(torch.equal(p, q) for p, q in zip(got, w))
    assert torch.equal(losses, want_losses)
    assert torch.equal(halves[0].b_dec, halves[1].b_dec)
    K.fit_model_step_(halves, xs, None, lr=LR, sigma=0.0,
                      loss_out=torch.empty(1))
    assert K.LAUNCHES == ZERO_LAUNCHES


def test_a_model_axis_other_than_one_or_two_raises():
    """K5b splits the hidden dimension in two; nothing lays out or fits
    another split."""
    mesh = M.Mesh(data=1, model=4, devices=(torch.device(CPU),) * 4)
    params = anomaly.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError):
        M.shard_params(params, mesh)
    with pytest.raises(ValueError):
        M.train_step(params, x, mesh)
