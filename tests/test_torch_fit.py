"""The port's whole fit (K3's wrapper, ``kernels.anomaly.fit_``) against
a loop of fit steps and against the JAX reference's jitted ``lax.scan``.

Inputs, params and noise are made from a seed with numpy and handed to
both sides.  On the CPU ``fit_`` runs the plain fit
(``kernels/reference.py``); the CUDA kernel is held against it, and
against a loop of K2 launches bit for bit, by ``chip_smoke.py`` on the
card.  Tolerances are test_torch_runtime.py's: params rtol FIT_RTOL,
atol FIT_ATOL; per-step losses rtol FIT_LOSS_RTOL.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clawker_tpu.analytics import anomaly as ref
from clawker_tpu.analytics import runtime as ref_art
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import runtime as art
from clawker_tpu_torch.kernels import anomaly as K
from clawker_tpu_torch.kernels import reference as R
from test_torch_runtime import FIT_ATOL, FIT_LOSS_RTOL, FIT_RTOL

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

LR = 1e-2
SIGMA = 0.25        # the runtime's and the reference scan's noise scale


def _arrays(n: int, feat: int, steps: int):
    rng = np.random.default_rng(n * 1000 + feat + steps)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    noises = rng.standard_normal((steps, n, feat)).astype(np.float32)
    params = (
        (rng.standard_normal((feat, 128)) * (2.0 / feat) ** 0.5).astype(np.float32),
        (0.01 * rng.standard_normal(128)).astype(np.float32),
        (rng.standard_normal((128, feat)) * (2.0 / 128) ** 0.5).astype(np.float32),
        (0.01 * rng.standard_normal(feat)).astype(np.float32),
    )
    return x, noises, params


def _fit(arrays, x, noises):
    params = anomaly.params_from_numpy(arrays, device="cpu")
    losses = torch.empty(len(noises))
    K.fit_(params, torch.from_numpy(x), torch.from_numpy(noises), lr=LR,
           sigma=SIGMA, losses_out=losses)
    return params, losses


@pytest.mark.parametrize("n, feat", [(200, 32), (384, 40)])
@pytest.mark.parametrize("steps", [1, 7])
def test_fit_is_a_loop_of_fit_steps(n, feat, steps):
    x, noises, arrays = _arrays(n, feat, steps)
    params, losses = _fit(arrays, x, noises)

    loop = anomaly.params_from_numpy(arrays, device="cpu")
    loop_losses = torch.empty(steps)
    scratch = torch.empty(K.scratch_floats(n, feat))
    for s in range(steps):
        K.fit_step_(loop, torch.from_numpy(x), torch.from_numpy(noises[s]),
                    lr=LR, sigma=SIGMA, loss_out=loop_losses, step=s,
                    scratch=scratch)
    assert all(torch.equal(p, q) for p, q in zip(params, loop))
    assert torch.equal(losses, loop_losses)


@pytest.mark.parametrize("n, feat", [(200, 32), (384, 40)])
@pytest.mark.parametrize("steps", [1, 40, 120])
def test_fit_matches_reference_scan(n, feat, steps):
    x, noises, arrays = _arrays(n, feat, steps)
    fit, score_fn = ref_art._jitted()
    pj, losses_j = fit(ref.AnomalyParams(*(jnp.asarray(a) for a in arrays)),
                       jnp.asarray(x), jnp.asarray(noises), LR)

    params, losses = _fit(arrays, x, noises)

    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j),
                               rtol=FIT_LOSS_RTOL)
    for name, got, want in zip(anomaly.AnomalyParams._fields,
                               anomaly.params_to_numpy(params), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=name)
    np.testing.assert_allclose(
        anomaly.score(params, torch.from_numpy(x)).numpy(),
        np.asarray(score_fn(pj, jnp.asarray(x))), rtol=FIT_RTOL,
        atol=FIT_ATOL)


@pytest.mark.parametrize("bad", ["noise_2d", "noise_rows", "noise_features",
                                 "short_losses", "long_losses",
                                 "short_scratch", "slots_only_scratch",
                                 "misaligned_scratch", "cpu_stamps",
                                 "four_point_stamps"])
def test_fit_rejects_what_the_kernel_does_not_take(bad):
    n, feat, steps = 200, 32, 3
    x, noises, arrays = _arrays(n, feat, steps)
    xt, nt = torch.from_numpy(x), torch.from_numpy(noises)
    losses = torch.empty(steps)
    scratch = stamps = None
    if bad == "noise_2d":
        nt = nt[0]
    elif bad == "noise_rows":
        nt = nt[:, :-1]
    elif bad == "noise_features":
        nt = torch.zeros((steps, n, feat + 1))
    elif bad == "short_losses":
        losses = torch.empty(steps - 1)
    elif bad == "long_losses":
        losses = torch.empty(steps + 1)
    elif bad == "short_scratch":
        scratch = torch.empty(K.scratch_floats(n, feat) - 1)
    elif bad == "slots_only_scratch":   # no room for the staged weights
        scratch = torch.empty(K.fit_slots(n) * K.slot_floats(feat))
    elif bad == "misaligned_scratch":   # the staged weights copy in 16 B
        scratch = torch.empty(K.scratch_floats(n, feat) + 1)[1:]
    elif bad == "cpu_stamps":   # the phase trace is the kernel's alone
        stamps = torch.zeros((steps, K.FIT_STAMPS, 132), dtype=torch.int64)
    else:                       # the trace before phase A's sub-stages
        stamps = torch.zeros((steps, 4, 132), dtype=torch.int64)
    match = {"four_point_stamps": "trace's points",
             "misaligned_scratch": "16-byte"}.get(bad)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    with pytest.raises(ValueError, match=match):
        K.fit_(params, xt, nt.contiguous(), lr=LR, sigma=SIGMA,
               losses_out=losses, scratch=scratch, stamps=stamps)
    for p, a in zip(params, arrays):          # nothing was applied
        assert np.array_equal(p.numpy(), a)


def test_fit_of_no_steps_leaves_params():
    x, _, arrays = _arrays(200, 32, 1)
    params, losses = _fit(arrays, x, np.zeros((0, 200, 32), np.float32))
    assert losses.numel() == 0
    for p, a in zip(params, arrays):
        assert np.array_equal(p.numpy(), a)


def test_cpu_fit_leaves_launch_counters_at_zero():
    K.reset_launches()
    x, noises, arrays = _arrays(200, 40, 3)
    _fit(arrays, x, noises)
    art._fit(anomaly.params_from_numpy(arrays, device="cpu"),
             torch.from_numpy(x), torch.from_numpy(noises), LR)
    assert K.LAUNCHES == {K.SCORE: 0, K.FIT_STEP: 0, K.FIT: 0,
                          K.FIT_SHARD: 0, K.FIT_SHARD_PARTIALS: 0,
                          K.FIT_SHARD_REDUCE: 0}


def test_runtime_fit_is_one_fit_call(monkeypatch):
    """The runtime's fit goes through ``fit_`` once, never step by step."""
    calls = []
    real = K.fit_
    monkeypatch.setattr(K, "fit_", lambda *a, **kw: calls.append(
        a[2].shape) or real(*a, **kw))
    monkeypatch.setattr(K, "fit_step_", lambda *a, **kw: pytest.fail(
        "the fit ran step by step"))
    x, noises, arrays = _arrays(200, 32, 4)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    losses = art._fit(params, torch.from_numpy(x), torch.from_numpy(noises),
                      LR)
    assert calls == [(4, 200, 32)]
    want, want_losses = _fit(arrays, x, noises)
    assert torch.equal(losses, want_losses)
    assert all(torch.equal(p, q) for p, q in zip(params, want))


@pytest.mark.parametrize("feat", [7, 32, 40, 61])
def test_staged_weights_are_bf16_of_the_transposed_params(feat):
    """reference.staged, the layout K3 keeps in its scratch and copies to
    shared memory: bf16 W_enc^T [H][FP+8], bf16 W_dec^T [FP][H+8], fp32
    b_enc [H], fp32 b_dec [FP], zeros past F."""
    _, _, arrays = _arrays(64, feat, 1)
    params = [torch.from_numpy(a) for a in arrays]
    buf = R.staged(*params)
    assert buf.dtype == torch.float32 and buf.dim() == 1
    assert buf.numel() == K.staged_floats(feat)
    assert buf.numel() * 4 % 16 == 0          # cp.async's unit
    fp = -(-feat // 16) * 16
    raw = buf.view(torch.bfloat16)
    we_t = raw[:128 * (fp + 8)].view(128, fp + 8)
    wd_t = raw[128 * (fp + 8):128 * (fp + 8) + fp * 136].view(fp, 136)
    be = buf[(128 * (fp + 8) + fp * 136) // 2:][:128]
    bd = buf[(128 * (fp + 8) + fp * 136) // 2 + 128:]
    w_enc, b_enc, w_dec, b_dec = params
    assert torch.equal(we_t[:, :feat], w_enc.T.to(torch.bfloat16))
    assert not we_t[:, feat:].float().any()
    assert torch.equal(wd_t[:feat, :128], w_dec.T.to(torch.bfloat16))
    assert not wd_t[feat:].float().any() and not wd_t[:, 128:].float().any()
    assert torch.equal(be, b_enc)
    assert bd.numel() == fp
    assert torch.equal(bd[:feat], b_dec) and not bd[feat:].any()


@pytest.mark.parametrize("n, feat", [(100, 32), (130, 7), (384, 40),
                                     (260, 61)])
def test_step_grads_are_the_reference_gradients_unrounded(n, feat):
    """reference.step_grads, the plain version of a K2 step's slot sums:
    its weight sums are the JAX reference's gradients before their bf16
    rounding (and not yet rounded), its bias gradients and loss the
    reference's.  Normwise relative limits: bf16's unit roundoff 2^-8 for
    the weights (measured 1.6e-3); 1e-4 for the biases (measured <= 7.7e-6:
    a tanh one ulp apart tips a bf16 dh now and then, which moves single
    entries by 2^-8 of one row's term)."""
    x, noises, arrays = _arrays(n, feat, 1)
    noisy = jnp.asarray(x) + SIGMA * jnp.asarray(noises[0])

    def loss_fn(p):
        return jnp.mean(jnp.square(ref._reconstruct(p, noisy) - x))

    lj, gj = jax.value_and_grad(loss_fn)(
        ref.AnomalyParams(*(jnp.asarray(a) for a in arrays)))
    grads, loss = R.step_grads(*(torch.from_numpy(a) for a in arrays),
                               torch.from_numpy(x),
                               torch.from_numpy(noises[0]), SIGMA)
    for name, g, want in zip(("w_enc", "b_enc", "w_dec", "b_dec"), grads,
                             gj):
        want = np.asarray(want)
        off = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
        if name.startswith("w"):
            assert not torch.equal(R.bf(g), g), name
            assert off <= 2.0 ** -8, (name, off)
        else:
            assert off <= 1e-4, (name, off)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)
