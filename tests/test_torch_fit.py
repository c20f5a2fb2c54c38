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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clawker_tpu.analytics import anomaly as ref
from clawker_tpu.analytics import runtime as ref_art
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import runtime as art
from clawker_tpu_torch.kernels import anomaly as K
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
                                 "short_scratch", "cpu_stamps"])
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
    else:                       # the phase trace is the kernel's alone
        stamps = torch.zeros(4 * steps * 132, dtype=torch.int64)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    with pytest.raises(ValueError):
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
    assert K.LAUNCHES == {K.SCORE: 0, K.FIT_STEP: 0, K.FIT: 0}


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
