"""The port's fleet mesh and sharded fit (K5, K5b) against the JAX reference.

The reference shards over its 8 virtual CPU devices (tests/conftest.py):
``fleet_mesh``, ``shard_params``/``shard_batch``/``shard_noise`` and
``runtime._fit_and_score(mesh=)``, called directly as
tests/test_analytics.py does (never ``dryrun_multichip``, which pins the
platform for the whole process).  The port runs the same function over
``virtual_mesh(n, "cpu")``: n CPU shards, K5b's plain version where the
mesh splits the hidden dimension (model = 2, at an even n), else K5's.
Params and noise are made with numpy and carried to both sides.

Tolerances are those of the unsharded twins, for the same reasons: the
sides differ in summation order and in tanh (a few ulp), which now and
then tips a bf16 rounding.  Fitted raw scores at FIT_RTOL / FIT_ATOL and
fit losses at FIT_LOSS_RTOL (tests/test_torch_runtime.py); one step's
params at PARAM_ATOL and loss at LOSS_RTOL (tests/test_torch_anomaly.py).
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
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import features as F
from clawker_tpu_torch.analytics import mesh as M
from clawker_tpu_torch.analytics import runtime as art
from clawker_tpu_torch.kernels import anomaly as K
from clawker_tpu_torch.kernels import reference as R
from clawker_tpu_torch.sentinel import ScoringEngine, featurize_fused
from clawker_tpu_torch.sentinel import engine as port_engine

from test_torch_runtime import (FIT_ATOL, FIT_LOSS_RTOL, FIT_RTOL,
                                _noise, _param_arrays, _records)

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-4
LR = 1e-2
CPU = "cpu"
ZERO_LAUNCHES = {K.SCORE: 0, K.FIT_STEP: 0, K.FIT: 0, K.FIT_SHARD: 0,
                 K.FIT_SHARD_PARTIALS: 0, K.FIT_SHARD_REDUCE: 0,
                 K.FIT_MODEL: 0, K.FIT_MODEL_FORWARD: 0,
                 K.FIT_MODEL_PARTIALS: 0, K.FIT_MODEL_REDUCE: 0,
                 K.FIT_MODEL_CARDS: 0}


def _jax_params(arrays):
    return ref.AnomalyParams(*(jnp.asarray(a) for a in arrays))


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


# ----------------------------------------------------------------- the mesh


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_reference(n):
    want = dict(ref.fleet_mesh(n).shape)
    assert M.virtual_mesh(n, CPU).shape == want
    assert M.fleet_mesh(n, device=[CPU] * 8).shape == want
    assert len(M.virtual_mesh(n, CPU).devices) == n


def test_virtual_mesh_names_devices_as_tensors_report_them():
    """"cpu:0" is the CPU that tensors report as "cpu": one device, so one
    params set, and the fit over it runs."""
    mesh = M.virtual_mesh(5, [CPU, "cpu:0"])
    assert mesh.devices == (torch.device(CPU),) * 5
    assert mesh.distinct == [torch.device(CPU)]
    assert mesh.desc == "5x1"
    x = torch.randn(40, 32, generator=torch.Generator().manual_seed(0))
    params = anomaly.init_params(torch.Generator().manual_seed(1))
    new, _ = M.train_step(params, x, mesh)
    assert new.w_enc.device == x.device
    with pytest.raises(ValueError):
        M.virtual_mesh(0, CPU)


@pytest.mark.parametrize("n", range(1, 9))
def test_padded_rows_match_reference(injected, n):
    """128 windows pad to a multiple of the data axis on both sides (129
    at n = 6: a 3x2 mesh)."""
    X = np.random.default_rng(n).standard_normal((128, 32)).astype(
        np.float32)
    _, _, xj, tj = ref_art._fit_and_score(X, train_steps=1, lr=LR, seed=0,
                                          mesh=ref.fleet_mesh(n))
    _, _, xt, tt = art._fit_and_score(X, train_steps=1, lr=LR, seed=0,
                                      mesh=M.virtual_mesh(n, CPU))
    assert tuple(xt.shape) == tuple(xj.shape)
    assert tt["device"] == f"cpu mesh={M.virtual_mesh(n, CPU).desc}"
    assert tj["device"].endswith(tt["device"].split(" ", 1)[1])
    if n == 6:
        assert xt.shape[0] == 129


def _six_shards(model: int) -> M.Mesh:
    """Six CPU shards: 6x1 (the rows over every shard), or 3x2, the
    reference's layout, which ``virtual_mesh(6)`` takes."""
    if model == 1:
        return M.Mesh(data=6, model=1, devices=(torch.device(CPU),) * 6)
    return M.virtual_mesh(6, CPU)


@pytest.mark.parametrize("model, rows, sizes, noise_rows", [
    (1, 129, [22, 22, 22, 21, 21, 21], 21),
    (2, 130, [44, 44, 43, 43, 43, 43], 43),
])
def test_uneven_shards_differ_by_a_row_in_shard_order(model, rows, sizes,
                                                      noise_rows):
    """The data blocks are contiguous and differ by a row, in data order;
    at model = 2 both shards of a block take its rows."""
    mesh = _six_shards(model)
    assert mesh.model == model
    bounds = M.shard_bounds(rows, mesh)
    assert [b - a for a, b in bounds] == sizes
    blocks = bounds[::model]
    assert bounds == [b for b in blocks for _ in range(model)]
    assert blocks[0][0] == 0 and blocks[-1][1] == rows
    assert all(b == c for (_, b), (c, _) in zip(blocks, blocks[1:]))
    x = torch.arange(rows * 2, dtype=torch.float32).view(rows, 2)
    assert torch.equal(torch.cat(M.shard_rows(x, mesh)[::model]), x)
    noises = torch.randn(3, rows, 2)
    shards = M.shard_noise(noises, mesh)
    assert [tuple(s.shape) for s in shards][3] == (3, noise_rows, 2)
    assert torch.equal(torch.cat(shards[::model], dim=1), noises)


@pytest.mark.parametrize("model", [1, 2])
def test_params_are_replicated_once_per_device(model):
    """Model 1: one copy per device, the params themselves there.  Model
    2: one set per shard, the reference's halves, one copy per half shared
    by the shards of the device, every half its own b_dec."""
    params = anomaly.init_params(torch.Generator().manual_seed(0))
    mesh = (M.Mesh(data=8, model=1, devices=(torch.device(CPU),) * 8)
            if model == 1 else M.virtual_mesh(8, CPU))
    assert mesh.model == model
    replicas = M.shard_params(params, mesh)
    if model == 1:
        assert len(replicas) == 1
        assert all(p is q for p, q in zip(replicas[0], params))
        return
    assert len(replicas) == 8 and len({id(r) for r in replicas}) == 2
    half = K.HIDDEN // 2
    for s, r in enumerate(replicas):
        cols = slice(s % 2 * half, (s % 2 + 1) * half)
        assert r is replicas[s % 2]
        for got, want in zip(r, (params.w_enc[:, cols], params.b_enc[cols],
                                 params.w_dec[cols], params.b_dec)):
            assert got.is_contiguous() and torch.equal(got, want)
            assert got.data_ptr() != want.data_ptr()
    assert replicas[0].b_dec.data_ptr() != replicas[1].b_dec.data_ptr()
    whole = M.whole_params(replicas, mesh)
    assert len(whole) == 4 and all(w is whole[0] for w in whole)
    assert all(torch.equal(p, q) for p, q in zip(whole[0], params))


@pytest.mark.parametrize("rows, total", [
    ([22, 22, 22, 21, 21, 21], 6),
    ([528] * 8, 136),            # 8 shards of the hour: more than 132
    ([2048] * 4, 256),           # more than 8 runs of 17 slots hold
    ([4224], 132),
    ([33, 1], 3),
])
def test_slot_regions_lie_back_to_back(rows, total):
    offsets = K.shard_slot_offsets(rows)
    assert offsets[0] == 0 and offsets[-1] == total
    assert [b - a for a, b in zip(offsets, offsets[1:])] == [
        K.fit_slots(n) for n in rows]
    assert K.shard_slot_floats(rows, 32) == total * K.slot_floats(32)


# ------------------------------------------------- the sharded fit and score


@pytest.mark.parametrize("steps", [1, 40])
def test_sharded_fit_matches_reference_sharded_scan(steps):
    """The port's fit over 8 CPU shards (4x2, K5b's plain version: the
    hidden dimension split over model as the reference splits it) against
    the reference's jitted scan over its 4x2 mesh of 8 devices: losses and
    fitted scores."""
    _, X = F.featurize(_records(hot_agent=True))
    Xn = art._pad_rows(X, 32, 4)
    arrays = _param_arrays(32)
    noise = _noise((steps,) + Xn.shape)

    mesh_j = ref.fleet_mesh(8)
    fit, score_fn = ref_art._jitted()
    xj = ref.shard_batch(jnp.asarray(Xn), mesh_j)
    pj, losses_j = fit(ref.shard_params(_jax_params(arrays), mesh_j), xj,
                       ref.shard_noise(jnp.asarray(noise), mesh_j), LR)
    want = np.asarray(score_fn(pj, xj))

    mesh = M.virtual_mesh(8, CPU)
    x = torch.from_numpy(Xn)
    replicas = M.shard_params(anomaly.params_from_numpy(arrays, device=CPU),
                              mesh)
    xs = M.shard_rows(x, mesh)
    losses = art._fit_shards(replicas, xs,
                             M.shard_noise(torch.from_numpy(noise), mesh), LR,
                             mesh)
    got = M.score_shards(replicas, xs, mesh).numpy()

    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j),
                               rtol=FIT_LOSS_RTOL)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)


def test_sharded_fit_and_score_matches_reference(injected):
    keys, X = F.featurize(_records(hot_agent=True))
    ref_keys, ref_X = ref_F.featurize(_records(hot_agent=True))
    raw_j, _, xj, tj = ref_art._fit_and_score(
        ref_X, train_steps=40, lr=LR, seed=0, mesh=ref.fleet_mesh(8))
    raw, params, x, t = art._fit_and_score(
        X, train_steps=40, lr=LR, seed=0, mesh=M.virtual_mesh(8, CPU))
    assert raw.shape == raw_j.shape == (len(keys),)
    assert tuple(x.shape) == tuple(xj.shape)
    assert t["device"] == "cpu mesh=4x2" and tj["device"].endswith("mesh=4x2")
    np.testing.assert_allclose(raw, raw_j, rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_array_equal(
        anomaly.score(params, x)[:len(keys)].numpy(), raw)


@pytest.mark.parametrize("shards", [2, 3, 6, 8])
def test_port_sharded_matches_port_unsharded(injected, shards):
    """Against the unsharded fit of the same padded batch: 3 and 6 shards
    (data axis 3) pad the 24 windows to 129 rows, not 128."""
    _, X = F.featurize(_records(hot_agent=True))
    mesh = M.virtual_mesh(shards, CPU)
    got, _, x, _ = art._fit_and_score(X, train_steps=40, lr=LR, seed=0,
                                      mesh=mesh)
    assert x.shape[0] == -(-128 // mesh.data) * mesh.data
    params, noises = art._draw(0, 40, x)
    art._fit(params, x, noises, LR)
    want = anomaly.score(params, x)[:len(X)].numpy()
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)


def test_one_shard_is_the_unsharded_fit_bit_for_bit():
    """K5's plain version over one shard adds the same terms as the plain
    fit, so its params and losses are the same bits (on the card the
    kernels hold the same, chip_smoke.py)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((200, 40)).astype(np.float32))
    noises = torch.from_numpy(
        rng.standard_normal((5, 200, 40)).astype(np.float32))
    params = anomaly.params_from_numpy(_param_arrays(40), device=CPU)
    want, want_losses = R.fit(*params, x, noises, LR, 0.25)
    got, got_losses = R.fit_shard(*params, [x], [noises], LR, 0.25)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    assert torch.equal(got_losses, want_losses)


def test_sharded_gradients_are_the_batch_gradients():
    """Each shard's step_grads with the batch's count, summed in shard
    order, is the whole batch's gradient (to fp32 summation order)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((129, 32)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((129, 32)).astype(
        np.float32))
    params = anomaly.params_from_numpy(_param_arrays(32), device=CPU)
    mesh = M.virtual_mesh(6, CPU)
    got, loss = R.shard_step_grads(*params, M.shard_rows(x, mesh),
                                   M.shard_rows(noise, mesh), 0.25)
    want, want_loss = R.step_grads(*params, x, noise, 0.25)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)


@pytest.mark.parametrize("feat", [32, 40])
def test_sharded_train_step_matches_reference(feat):
    rng = np.random.default_rng(feat)
    x = rng.standard_normal((32, feat)).astype(np.float32)
    arrays = _param_arrays(feat)
    mesh_j = ref.fleet_mesh(8)
    pj, lj = jax.jit(ref.train_step)(
        ref.shard_params(_jax_params(arrays), mesh_j),
        ref.shard_batch(jnp.asarray(x), mesh_j), LR)
    params = anomaly.params_from_numpy(arrays, device=CPU)
    pt, lt = M.train_step(params, torch.from_numpy(x),
                          M.virtual_mesh(8, CPU), lr=LR)
    for name, got, want in zip(anomaly.AnomalyParams._fields,
                               anomaly.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    # the inputs are left as they were
    assert all(np.array_equal(p.numpy(), a) for p, a in zip(params, arrays))


@pytest.mark.parametrize("feat", [32, 40])
def test_sharded_denoise_step_matches_reference(feat):
    rng = np.random.default_rng(10 + feat)
    x = rng.standard_normal((48, feat)).astype(np.float32)
    noise = rng.standard_normal((48, feat)).astype(np.float32)
    arrays = _param_arrays(feat)
    mesh_j = ref.fleet_mesh(6)
    step = jax.jit(lambda p, x, nz: ref.denoise_step_with_noise(p, x, nz,
                                                                lr=LR))
    pj, lj = step(ref.shard_params(_jax_params(arrays), mesh_j),
                  ref.shard_batch(jnp.asarray(x), mesh_j),
                  ref.shard_batch(jnp.asarray(noise), mesh_j))
    pt, lt = M.denoise_step_with_noise(
        anomaly.params_from_numpy(arrays, device=CPU), torch.from_numpy(x),
        torch.from_numpy(noise), M.virtual_mesh(6, CPU), lr=LR)
    for name, got, want in zip(anomaly.AnomalyParams._fields,
                               anomaly.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)


def test_sharded_score_is_the_score():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((130, 32)).astype(np.float32))
    params = anomaly.params_from_numpy(_param_arrays(32), device=CPU)
    assert torch.equal(M.score(params, x, M.virtual_mesh(4, CPU)),
                       anomaly.score(params, x))


# ----------------------------------------------------------- the wrappers


def _shard_inputs(rows=(40, 40), feat=32, steps=2):
    g = torch.Generator().manual_seed(0)
    params = anomaly.init_params(g, feat=feat)
    xs = [torch.randn((n, feat), generator=g) for n in rows]
    noises = [torch.randn((steps, n, feat), generator=g) for n in rows]
    return [params], xs, noises, torch.empty(steps)


@pytest.mark.parametrize("bad", [
    "no_shards", "feature_mismatch", "noise_rows", "noise_count",
    "two_params_one_device", "params_elsewhere", "losses_size",
    "noise_step_not_contiguous",
])
def test_fit_shard_rejects_what_the_kernel_does_not_take(bad):
    replicas, xs, noises, losses = _shard_inputs()
    if bad == "no_shards":
        xs, noises = [], []
    elif bad == "feature_mismatch":
        xs[1] = torch.randn(40, 16)
    elif bad == "noise_rows":
        noises[1] = torch.randn(2, 39, 32)
    elif bad == "noise_count":
        noises = noises[:1]
    elif bad == "two_params_one_device":
        replicas = replicas * 2
    elif bad == "params_elsewhere":
        replicas = []
    elif bad == "losses_size":
        losses = torch.empty(3)
    elif bad == "noise_step_not_contiguous":
        noises[0] = torch.randn(2, 32, 40).transpose(1, 2)
    with pytest.raises(ValueError):
        K.fit_shard_(replicas, xs, noises, lr=LR, sigma=0.25,
                     losses_out=losses)


def test_fit_shard_step_checks_its_loss_out():
    replicas, xs, noises, _ = _shard_inputs()
    with pytest.raises(ValueError):
        K.fit_shard_step_(replicas, xs, [n[0] for n in noises], lr=LR,
                          sigma=0.25, loss_out=torch.empty(1), step=1)


def test_cpu_shard_calls_launch_nothing():
    K.reset_launches()
    replicas, xs, noises, losses = _shard_inputs(rows=(22, 21, 21))
    K.fit_shard_(replicas, xs, noises, lr=LR, sigma=0.25, losses_out=losses)
    K.fit_shard_step_(replicas, xs, None, lr=LR, sigma=0.0,
                      loss_out=torch.empty(1))
    M.score(replicas[0], torch.cat(xs), M.virtual_mesh(3, CPU))
    assert K.LAUNCHES == ZERO_LAUNCHES


# ------------------------------------------------------------- the sentinel


def test_sentinel_engine_is_unsharded_on_one_card_or_the_cpu(monkeypatch):
    assert ScoringEngine(device=CPU)._mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ScoringEngine(device="cuda")._mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert ScoringEngine(device=CPU)._mesh() is None


def test_sentinel_engine_shards_over_several_cards(monkeypatch):
    """With more than one card visible the engine scores over the fleet
    mesh (here a stand-in of CPU shards), as the reference's does."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(port_engine, "fleet_mesh",
                        lambda: M.virtual_mesh(4, CPU))
    recs = _records(hot_agent=True)
    for i, r in enumerate(recs):
        r["worker"] = f"fake-{i % 2}"
    keys, X, worker_of = featurize_fused(recs, None)
    rep = ScoringEngine(train_steps=5, device="cuda").score_tick(
        keys, X, worker_of)
    assert rep.device == "cpu mesh=2x2"
    assert rep.raw.shape == (len(keys),)
    assert np.isfinite(rep.z).all()
