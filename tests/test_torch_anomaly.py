"""The port's autoencoder (score, fit steps) against the JAX reference.

Inputs, params and noise are made from a seed with numpy and handed to
both sides; the JAX side runs jitted on the CPU, the port's on the CPU
through the plain PyTorch versions the CUDA kernels are held against.

Tolerances (both sides round to bf16 at the same points and differ only
in fp32 summation order and in tanh, a few ulp):
* params: atol 1e-5 after 1, 40 and 120 steps (measured <= 5e-6 at 120);
* per-step loss: rtol 1e-4 (measured <= 1.7e-5 over 120 steps);
* score on the same params: rtol 1e-4, atol 1e-6 (measured ~1e-5).
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

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

N = 256
STEPS = 120
CHECK_STEPS = (1, 40, 120)
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-4
SCORE_RTOL = 1e-4
SCORE_ATOL = 1e-6
LR = 1e-2


def _arrays(feat: int, seed: int = 0):
    rng = np.random.default_rng(seed + feat)
    x = rng.standard_normal((N, feat)).astype(np.float32)
    noise = rng.standard_normal((STEPS, N, feat)).astype(np.float32)
    params = (
        (rng.standard_normal((feat, 128)) * (2.0 / feat) ** 0.5).astype(np.float32),
        (0.01 * rng.standard_normal(128)).astype(np.float32),
        (rng.standard_normal((128, feat)) * (2.0 / 128) ** 0.5).astype(np.float32),
        (0.01 * rng.standard_normal(feat)).astype(np.float32),
    )
    return x, noise, params


def _jax_params(arrays):
    return ref.AnomalyParams(*(jnp.asarray(a) for a in arrays))


@pytest.fixture(scope="module", params=[32, 40], ids=["F32", "F40"])
def trajectories(request):
    """Params and losses of both sides after each denoising step."""
    feat = request.param
    x, noise, arrays = _arrays(feat)
    step = jax.jit(lambda p, x, nz: ref.denoise_step_with_noise(p, x, nz,
                                                                lr=LR))
    pj = _jax_params(arrays)
    pt = anomaly.params_from_numpy(arrays, device="cpu")
    xt = torch.from_numpy(x)
    out = {"feat": feat, "x": x, "arrays": arrays, "jax": {}, "torch": {},
           "jax_loss": [], "torch_loss": []}
    for s in range(STEPS):
        pj, lj = step(pj, jnp.asarray(x), jnp.asarray(noise[s]))
        pt, lt = anomaly.denoise_step_with_noise(
            pt, xt, torch.from_numpy(noise[s]), lr=LR)
        out["jax_loss"].append(float(lj))
        out["torch_loss"].append(float(lt))
        if s + 1 in CHECK_STEPS:
            out["jax"][s + 1] = [np.asarray(p) for p in pj]
            out["torch"][s + 1] = anomaly.params_to_numpy(pt)
    return out


@pytest.mark.parametrize("steps", CHECK_STEPS)
def test_denoise_step_params_match_jax(trajectories, steps):
    for name, got, want in zip(anomaly.AnomalyParams._fields,
                               trajectories["torch"][steps],
                               trajectories["jax"][steps]):
        np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{name} after {steps} steps")


@pytest.mark.parametrize("steps", CHECK_STEPS)
def test_denoise_step_losses_match_jax(trajectories, steps):
    np.testing.assert_allclose(trajectories["torch_loss"][:steps],
                               trajectories["jax_loss"][:steps],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("steps", [0, *CHECK_STEPS])
def test_score_matches_jax_on_carried_params(trajectories, steps):
    arrays = (trajectories["arrays"] if steps == 0
              else trajectories["torch"][steps])
    x = trajectories["x"]
    want = np.asarray(jax.jit(ref.score)(_jax_params(arrays), jnp.asarray(x)))
    got = anomaly.score(anomaly.params_from_numpy(arrays, device="cpu"),
                        torch.from_numpy(x)).numpy()
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("feat", [32, 40])
@pytest.mark.parametrize("steps", [1, 5])
def test_train_step_matches_jax(feat, steps):
    x, _, arrays = _arrays(feat, seed=7)
    step = jax.jit(lambda p, x: ref.train_step(p, x, lr=LR))
    pj = _jax_params(arrays)
    pt = anomaly.params_from_numpy(arrays, device="cpu")
    for _ in range(steps):
        pj, lj = step(pj, jnp.asarray(x))
        pt, lt = anomaly.train_step(pt, torch.from_numpy(x), lr=LR)
        np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    for got, want in zip(anomaly.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("feat", [32, 40])
def test_reconstruct_matches_jax(feat):
    x, _, arrays = _arrays(feat, seed=3)
    want = np.asarray(jax.jit(ref._reconstruct)(_jax_params(arrays),
                                                jnp.asarray(x)))
    got = anomaly.reconstruct(anomaly.params_from_numpy(arrays, device="cpu"),
                              torch.from_numpy(x)).numpy()
    # JAX's CPU tanh and torch's differ by an ulp now and then, which can
    # tip bf16(g) of an element by one bf16 ulp (2^-8 |g|): r moves by
    # that times |w_dec| ~ 0.1 (measured <= 2.4e-3); the score, a mean
    # of 32-40 squares, averages it away (see SCORE_RTOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert np.mean(np.abs(got - want) > 1e-5) < 0.05


def test_denoise_step_leaves_inputs_and_uses_generator():
    x, _, arrays = _arrays(32, seed=5)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    xt = torch.from_numpy(x)
    new, loss = anomaly.denoise_step(params, xt,
                                     torch.Generator().manual_seed(11))
    noise = torch.randn(xt.shape, generator=torch.Generator().manual_seed(11))
    want, want_loss = anomaly.denoise_step_with_noise(params, xt, noise)
    for p, a in zip(params, arrays):
        assert np.array_equal(p.numpy(), a)       # inputs untouched
    for got, w in zip(new, want):
        assert torch.equal(got, w)
    assert float(loss) == float(want_loss)


def test_params_numpy_round_trip():
    _, _, arrays = _arrays(40, seed=9)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    assert [tuple(p.shape) for p in params] == [(40, 128), (128,), (128, 40),
                                                (40,)]
    assert all(p.dtype == torch.float32 for p in params)
    back = anomaly.params_to_numpy(params)
    assert type(back) is anomaly.AnomalyParams
    for got, want in zip(back, arrays):
        assert np.array_equal(got, want)
    # JAX params carried across and back unchanged
    pj = _jax_params(arrays)
    for got, want in zip(anomaly.params_to_numpy(
            anomaly.params_from_numpy(pj, device="cpu")), pj):
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("feat", [32, 40])
def test_init_params_shapes_scales_and_seed(feat):
    params = anomaly.init_params(torch.Generator().manual_seed(0), feat=feat)
    again = anomaly.init_params(torch.Generator().manual_seed(0), feat=feat)
    ref_params = ref.init_params(jax.random.key(0), feat=feat)
    for p, a, r in zip(params, again, ref_params):
        assert tuple(p.shape) == r.shape and p.dtype == torch.float32
        assert torch.equal(p, a)
    assert not params.b_enc.any() and not params.b_dec.any()
    assert abs(float(params.w_enc.std()) - (2.0 / feat) ** 0.5) < 0.1 * (
        2.0 / feat) ** 0.5
    assert abs(float(params.w_dec.std()) - (2.0 / 128) ** 0.5) < 0.1 * (
        2.0 / 128) ** 0.5


def test_cpu_calls_leave_launch_counters_at_zero():
    K.reset_launches()
    x, noise, arrays = _arrays(32, seed=1)
    params = anomaly.params_from_numpy(arrays, device="cpu")
    anomaly.score(params, torch.from_numpy(x))
    anomaly.denoise_step_with_noise(params, torch.from_numpy(x),
                                    torch.from_numpy(noise[0]))
    anomaly.train_step(params, torch.from_numpy(x))
    assert K.LAUNCHES == {K.SCORE: 0, K.FIT_STEP: 0, K.FIT: 0,
                          K.FIT_SHARD: 0, K.FIT_SHARD_PARTIALS: 0,
                          K.FIT_SHARD_REDUCE: 0,
                          K.FIT_MODEL: 0, K.FIT_MODEL_FORWARD: 0,
                          K.FIT_MODEL_PARTIALS: 0, K.FIT_MODEL_REDUCE: 0,
                          K.FIT_MODEL_CARDS: 0}


@pytest.mark.parametrize("bad", ["f64", "wide", "hidden", "noncontig",
                                 "rank"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, _, arrays = _arrays(32, seed=2)
    params = list(anomaly.params_from_numpy(arrays, device="cpu"))
    xt = torch.from_numpy(x)
    if bad == "f64":
        xt = xt.double()
    elif bad == "wide":
        xt = torch.zeros((N, 65))
    elif bad == "hidden":
        params[0] = torch.zeros((32, 64))
    elif bad == "noncontig":
        xt = torch.zeros((32, N)).T
    else:
        xt = xt[None]
    with pytest.raises((TypeError, ValueError)):
        anomaly.score(anomaly.AnomalyParams(*params), xt)


# K2's and K3's scratch: K3's staged weights, then one slot of
# 2 F H + H + F + 1 floats per block of phase A, min(ceil(n / 32), 132)
# blocks, at every width chip_smoke's KERNEL_SHAPES hold the kernels at
@pytest.mark.parametrize("feat", [7, 32, 40, 61])
@pytest.mark.parametrize("n, slots", [(1, 1), (200, 7), (4224, 132),
                                      (8192, 132)])
def test_scratch_floats_is_one_slot_per_block(n, slots, feat):
    assert K.fit_slots(n) == slots
    assert K.slot_floats(feat) == 2 * feat * 128 + 128 + feat + 1
    assert K.scratch_floats(n, feat) == (K.staged_floats(feat)
                                         + slots * K.slot_floats(feat))


@pytest.mark.parametrize("bad", ["ok", "short", "f64", "device",
                                 "noncontig"])
def test_fit_step_checks_its_scratch(bad):
    x, noise, arrays = _arrays(32, seed=4)
    xt, nt = torch.from_numpy(x), torch.from_numpy(noise[0])
    size = K.scratch_floats(N, 32)
    scratch = {
        "ok": lambda: torch.empty(size),
        "short": lambda: torch.empty(size - 1),
        "f64": lambda: torch.empty(size, dtype=torch.float64),
        "device": lambda: torch.empty(size, device="meta"),
        "noncontig": lambda: torch.empty(2 * size)[::2],
    }[bad]()
    params = anomaly.params_from_numpy(arrays, device="cpu")
    loss = torch.empty(1)
    if bad == "ok":
        K.fit_step_(params, xt, nt, lr=LR, sigma=0.25, loss_out=loss,
                    scratch=scratch)
        want, want_loss = anomaly.denoise_step_with_noise(
            anomaly.params_from_numpy(arrays, device="cpu"), xt, nt, lr=LR)
        assert all(torch.equal(p, w) for p, w in zip(params, want))
        assert float(loss[0]) == float(want_loss)
        return
    with pytest.raises((TypeError, ValueError)):
        K.fit_step_(params, xt, nt, lr=LR, sigma=0.25, loss_out=loss,
                    scratch=scratch)
    for p, a in zip(params, arrays):          # nothing was applied
        assert np.array_equal(p.numpy(), a)


def _grouped_sum_step(arrays, x, noise, *, lr, sigma=0.25):
    """One denoising step with the gradient sums grouped as K2 groups them:
    block b's slot adds up the fp32 sums of its row tiles b, b + G, ...
    (FIT_ROWS rows each, one matmul per tile); the REDUCE_GROUPS
    contiguous runs of slots are summed in order and combined in K2's
    tree; the full weight sums are rounded to bf16 once, then applied.
    This is K2's tiling, not its exact order of additions (launch A keeps
    one FMA chain per element over all of a block's rows, and its forward
    runs on the tensor cores): it shows that partial sums per tile and
    slot, rounded only at the end, keep parity with JAX."""
    from clawker_tpu_torch.kernels import reference as R

    w_enc, b_enc, w_dec, b_dec = (torch.from_numpy(a) for a in arrays)
    xt = torch.from_numpy(x)
    noisy = xt + sigma * torch.from_numpy(noise)
    a, gb, r = R._forward(w_enc, b_enc, w_dec, b_dec, noisy)
    e = r - xt
    count = e.numel()
    dr = (2.0 * e) * (1.0 / count)
    da = R.bf(dr @ R.bf(w_dec).T) * R.gelu_tanh_grad(a)
    xb = R.bf(noisy)

    n, f = x.shape
    tiles = -(-n // K.FIT_ROWS)
    g_slots = K.fit_slots(n)
    slots = []
    for b in range(g_slots):
        acc = torch.zeros(K.slot_floats(f))
        for t in range(b, tiles, g_slots):
            rows = slice(t * K.FIT_ROWS, min((t + 1) * K.FIT_ROWS, n))
            acc = acc + torch.cat([
                (xb[rows].T @ da[rows]).flatten(), da[rows].sum(0),
                (dr[rows].T @ gb[rows]).flatten(), dr[rows].sum(0),
                torch.square(e[rows]).sum()[None]])
        slots.append(acc)
    per = -(-g_slots // K.REDUCE_GROUPS)
    runs = []
    for grp in range(K.REDUCE_GROUPS):
        s = torch.zeros_like(slots[0])
        for k in range(min(grp * per, g_slots), min(grp * per + per, g_slots)):
            s = s + slots[k]
        runs.append(s)
    half = K.REDUCE_GROUPS // 2
    while half:
        runs[:half] = [runs[g] + runs[g + half] for g in range(half)]
        half //= 2
    total = runs[0]
    fh = f * 128
    grads = (R.bf(total[:fh].view(f, 128)), total[fh:fh + 128],
             R.bf(total[fh + 128:2 * fh + 128].view(f, 128).T),
             total[2 * fh + 128:2 * fh + 128 + f])
    new = [p - lr * g for p, g in zip((w_enc, b_enc, w_dec, b_dec), grads)]
    return [t.numpy() for t in new], float(total[-1] / count)


# fewer rows than one tile; one tile per block; more tiles than blocks
# (the grid-stride loop runs, and the reduce's runs are 17 slots long)
@pytest.mark.parametrize("n, feat", [(100, 32), (384, 40), (8192, 32)])
def test_kernel_reduction_order_keeps_parity_with_jax(n, feat):
    rng = np.random.default_rng(n + feat)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    noise = rng.standard_normal((n, feat)).astype(np.float32)
    _, _, arrays = _arrays(feat, seed=n)
    pj, lj = jax.jit(lambda p, x, nz: ref.denoise_step_with_noise(
        p, x, nz, lr=LR))(_jax_params(arrays), jnp.asarray(x),
                          jnp.asarray(noise))
    got, loss = _grouped_sum_step(arrays, x, noise, lr=LR)
    for name, g, want in zip(anomaly.AnomalyParams._fields, got, pj):
        np.testing.assert_allclose(g, np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_allclose(loss, float(lj), rtol=LOSS_RTOL)
