"""K1's score (``csrc/anomaly_score.cu``) against the JAX reference.

The kernel runs only on a GPU.  What can be held here is its order of
summing: each row's squared errors, padded with zeros to F rounded up
to 16, are summed by 8 threads, thread q taking columns q, q + 8, ...
in turn, and the 8 partial sums are combined as ((s0 + s4) + (s2 + s6))
+ ((s1 + s5) + (s3 + s7)), then divided by F.  ``_k1_order_score``
repeats that order in fp32 on the plain reconstruction, and the JAX
score must agree with it at ``test_torch_anomaly``'s score tolerance
(rtol 1e-4, atol 1e-6: the sides differ in summation order and in
tanh, a few ulp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clawker_tpu.analytics import anomaly as ref
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.kernels import anomaly as K
from clawker_tpu_torch.kernels import reference as R

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

SCORE_RTOL = 1e-4
SCORE_ATOL = 1e-6
LOSS_RTOL = 1e-5          # chip_smoke's STEP1_LOSS_RTOL
ROW_THREADS = 8           # csrc/anomaly_score.cu, kRowThreads


def _arrays(n: int, feat: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    params = (
        (rng.standard_normal((feat, 128)) * (2.0 / feat) ** 0.5).astype(np.float32),
        (0.01 * rng.standard_normal(128)).astype(np.float32),
        (rng.standard_normal((128, feat)) * (2.0 / 128) ** 0.5).astype(np.float32),
        (0.01 * rng.standard_normal(feat)).astype(np.float32),
    )
    return x, params


def _k1_row_sums(e2: torch.Tensor) -> torch.Tensor:
    """Each row of ``e2`` [n, F] summed in K1's order, in fp32."""
    n, f = e2.shape
    fp = -(-f // 16) * 16
    e2 = torch.cat([e2, torch.zeros((n, fp - f))], dim=1)
    cols = e2.view(n, fp // ROW_THREADS, ROW_THREADS)
    s = torch.zeros((n, ROW_THREADS))
    for k in range(fp // ROW_THREADS):        # thread q: q, q + 8, ...
        s = s + cols[:, k]
    half = ROW_THREADS // 2
    while half:                               # lanes q ^ 4, q ^ 2, q ^ 1
        s = s[:, :half] + s[:, half:2 * half]
        half //= 2
    return s[:, 0]


def _k1_order_score(params, x: torch.Tensor) -> torch.Tensor:
    """The plain reconstruction's squared errors, summed per row in K1's
    order, divided by F."""
    _, _, r = R._forward(*params, x)
    return _k1_row_sums(torch.square(r - x)) / x.shape[1]


def _lanes(row: np.ndarray) -> list[np.float32]:
    """One row's sum as K1's 8 lanes of the row compute it: each its
    columns in turn, then three shuffle-and-add rounds; every lane ends
    with the sum.  The kernel's zeros past F add nothing."""
    s = [np.float32(0.0)] * ROW_THREADS
    for q in range(ROW_THREADS):
        for j in range(q, len(row), ROW_THREADS):
            s[q] = np.float32(s[q] + row[j])
    off = ROW_THREADS // 2
    while off:
        s = [np.float32(s[q] + s[q ^ off]) for q in range(ROW_THREADS)]
        off //= 2
    return s


@pytest.mark.parametrize("feat", [7, 32, 40, 61])
def test_row_sums_are_the_kernel_lanes(feat):
    # magnitudes spread over 2^-20..2^20, so that a change of order
    # changes the rounded sum
    rng = np.random.default_rng(feat)
    e2 = (rng.random((16, feat)) * 2.0 ** rng.integers(-20, 21, (16, feat))
          ).astype(np.float32)
    got = _k1_row_sums(torch.from_numpy(e2)).numpy()
    for i, row in enumerate(e2):
        lanes = _lanes(row)
        assert all(v == lanes[0] for v in lanes)
        assert got[i] == lanes[0]


@pytest.mark.parametrize("feat", [7, 32, 40, 61])
@pytest.mark.parametrize("n", [100, 130, 384])
def test_k1_summing_order_matches_jax(n, feat):
    x, arrays = _arrays(n, feat, seed=n * 100 + feat)
    want = np.asarray(jax.jit(ref.score)(
        ref.AnomalyParams(*(jnp.asarray(a) for a in arrays)),
        jnp.asarray(x)))
    params = anomaly.params_from_numpy(arrays, device="cpu")
    got = _k1_order_score(params, torch.from_numpy(x)).numpy()
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("feat", [7, 32, 40, 61])
def test_cpu_score_is_the_plain_version_and_launches_nothing(feat):
    K.reset_launches()
    x, arrays = _arrays(130, feat, seed=feat)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    xt = torch.from_numpy(x)
    assert torch.equal(K.score(params, xt), R.score(*params, xt))
    assert torch.equal(anomaly.score(params, xt), R.score(*params, xt))
    assert K.LAUNCHES == {K.SCORE: 0, K.FIT_STEP: 0, K.FIT: 0,
                          K.FIT_SHARD: 0, K.FIT_SHARD_PARTIALS: 0,
                          K.FIT_SHARD_REDUCE: 0,
                          K.FIT_MODEL: 0, K.FIT_MODEL_FORWARD: 0,
                          K.FIT_MODEL_PARTIALS: 0, K.FIT_MODEL_REDUCE: 0,
                          K.FIT_MODEL_CARDS: 0}


# chip_smoke holds K1's mean score against K2's noise-free step-0 loss on
# the card; the plain versions of both agree the same way here
@pytest.mark.parametrize("feat", [7, 32, 40, 61])
def test_mean_score_is_the_noise_free_step_loss(feat):
    x, arrays = _arrays(384, feat, seed=7 * feat)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    xt = torch.from_numpy(x)
    _, loss = R.fit_step(*params, xt, None, 1e-2, 0.0)
    mean = float(R.score(*params, xt).double().mean())
    np.testing.assert_allclose(mean, float(loss), rtol=LOSS_RTOL)
    mean = float(_k1_order_score(params, xt).double().mean())
    np.testing.assert_allclose(mean, float(loss), rtol=LOSS_RTOL)
