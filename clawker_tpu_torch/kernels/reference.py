"""Plain PyTorch versions of the anomaly kernels: the score, the fit step,
the fit (a loop of fit steps), and the fit step and fit over rows split
into shards.

Written out as explicit forward and backward formulas, no autograd, at
the rounding points of the JAX reference (``clawker_tpu/analytics/
anomaly.py``) as its jaxpr shows them:

* the forward dots take bf16 operands and give fp32 results;
* the backward dots multiply the fp32 cotangent by a bf16 operand and
  round the RESULT (the full sum) to bf16: dW_enc, dW_dec, and the
  gradient flowing into the GELU;
* the bias gradients stay fp32, and the error term uses the unrounded
  fp32 ``x``;
* GELU is the tanh form.

A bf16 ``torch.matmul`` (bf16 result) or ``F.gelu`` at its default (erf)
would not match.  Matrix products here are fp32; on a CUDA tensor they
must run with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` is
False by default, and ``chip_smoke.py`` pins it).

The CPU path of the wrappers in ``kernels/anomaly.py`` runs these, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import math

import torch

# float32(sqrt(2/pi)), as jax.nn.gelu(approximate=True) rounds it
GELU_C = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32))
GELU_K = 0.044715


def bf(t: torch.Tensor) -> torch.Tensor:
    """Round an fp32 tensor to bf16 (nearest-even) and back."""
    return t.to(torch.bfloat16).float()


def gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    return a * (0.5 * (1.0 + torch.tanh(GELU_C * (a + GELU_K * a ** 3))))


def gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(GELU_C * (a + GELU_K * a ** 3))
    return (0.5 * (1.0 + t)
            + a * 0.5 * (1.0 - t * t) * GELU_C * (1.0 + 3.0 * GELU_K * a * a))


def _forward(w_enc, b_enc, w_dec, b_dec, x):
    """-> (pre-activation a, bf16-rounded activation gb, reconstruction r)."""
    a = bf(x) @ bf(w_enc) + b_enc
    gb = bf(gelu_tanh(a))
    r = gb @ bf(w_dec) + b_dec
    return a, gb, r


def score(w_enc, b_enc, w_dec, b_dec, x: torch.Tensor) -> torch.Tensor:
    """Per-row mean squared reconstruction error: [n, F] -> [n]."""
    _, _, r = _forward(w_enc, b_enc, w_dec, b_dec, x)
    return torch.square(r - x).mean(dim=-1)


def step_grads(w_enc, b_enc, w_dec, b_dec, x: torch.Tensor,
               noise: torch.Tensor | None, sigma: float,
               count: int | None = None):
    """The gradients of one (denoising) step with the two weight sums NOT
    rounded to bf16: fp32 sums over all rows of the fp32 cotangent times
    the bf16 operand.  ``noise`` None is the plain autoencoder step.
    ``count`` is the mean's element count, by default x's: a shard of a
    batch gives its terms of the whole batch's mean with the batch's.

    -> ((dW_enc [F, H], db_enc [H], dW_dec [H, F], db_dec [F]), loss)."""
    noisy = x if noise is None else x + sigma * noise
    a, gb, r = _forward(w_enc, b_enc, w_dec, b_dec, noisy)
    e = r - x
    count = e.numel() if count is None else count
    loss = torch.square(e).sum() / count
    dr = (2.0 * e) * (1.0 / count)
    db_dec = dr.sum(dim=0)
    dw_dec = gb.T @ dr
    dh = bf(dr @ bf(w_dec).T)
    da = dh * gelu_tanh_grad(a)
    db_enc = da.sum(dim=0)
    dw_enc = bf(noisy).T @ da
    return (dw_enc, db_enc, dw_dec, db_dec), loss


def fit_step(w_enc, b_enc, w_dec, b_dec, x: torch.Tensor,
             noise: torch.Tensor | None, lr: float, sigma: float):
    """One (denoising) SGD step on the mean squared error of the whole
    batch.  ``noise`` None is the plain autoencoder step (sigma = 0).

    -> ((w_enc, b_enc, w_dec, b_dec) updated, loss before the step)."""
    grads, loss = step_grads(w_enc, b_enc, w_dec, b_dec, x, noise, sigma)
    return sgd_update((w_enc, b_enc, w_dec, b_dec), grads, lr), loss


def sgd_update(params, grads, lr: float):
    """SGD on the unrounded gradient sums: the weight sums rounded to bf16
    (the reference's rounding of the backward dots' results)."""
    dw_enc, db_enc, dw_dec, db_dec = grads
    rounded = (bf(dw_enc), db_enc, bf(dw_dec), db_dec)
    return tuple(p - lr * g for p, g in zip(params, rounded))


def shard_step_grads(w_enc, b_enc, w_dec, b_dec, xs, noises, sigma: float):
    """``step_grads`` of each shard of the rows (``xs``, and ``noises``
    of the same rows or None), each with the whole batch's count, summed in
    shard order: the sharded step's unrounded gradient sums and its loss."""
    count = sum(x.shape[0] for x in xs) * xs[0].shape[1]
    total, loss = None, 0.0
    for x, noise in zip(xs, noises):
        grads, part = step_grads(w_enc, b_enc, w_dec, b_dec, x, noise, sigma,
                                 count=count)
        total = grads if total is None else tuple(
            a + b for a, b in zip(total, grads))
        loss = loss + part
    return total, loss


def fit_shard_step(w_enc, b_enc, w_dec, b_dec, xs, noises, lr: float,
                   sigma: float):
    """One (denoising) SGD step on the mean squared error of the batch
    whose rows are split into ``xs`` (``noises`` their noise rows, or
    Nones): the sum of the shards' gradients, updated as ``fit_step``.

    -> ((w_enc, b_enc, w_dec, b_dec) updated, loss before the step)."""
    grads, loss = shard_step_grads(w_enc, b_enc, w_dec, b_dec, xs, noises,
                                   sigma)
    return sgd_update((w_enc, b_enc, w_dec, b_dec), grads, lr), loss


def model_step_grads(halves, xs, noises, sigma: float):
    """The step over rows split into data blocks ``xs`` (``noises`` their
    noise rows, or Nones) with the hidden dimension split into ``halves``
    (one params set per model shard m: w_enc[:, H_m], b_enc[H_m],
    w_dec[H_m, :] and the whole b_dec), as K5b runs it
    (``csrc/anomaly_fit_model.cu``).  For each block: each half's forward
    ``a_m = bf(noisy) @ bf(w_enc_m) + b_enc_m`` and partial decoder output
    ``y_m = bf(gelu(a_m)) @ bf(w_dec_m)``; ``r = (y_0 + y_1 + ...) + b_dec``
    summed in model order; dr with the whole batch's count; then each
    half's backward on its own columns.  The blocks' terms are summed in
    data order.  At one half it adds what ``shard_step_grads`` adds.

    -> ([(dW_enc_m, db_enc_m, dW_dec_m, db_dec)] per half, the weight sums
    not rounded to bf16, loss)."""
    count = sum(x.shape[0] for x in xs) * xs[0].shape[1]
    total, loss = None, 0.0
    for x, noise in zip(xs, noises):
        noisy = x if noise is None else x + sigma * noise
        fwd = []
        for w_enc, b_enc, w_dec, _ in halves:
            a = bf(noisy) @ bf(w_enc) + b_enc
            gb = bf(gelu_tanh(a))
            fwd.append((a, gb, gb @ bf(w_dec)))
        y = fwd[0][2]
        for _, _, y_m in fwd[1:]:
            y = y + y_m
        e = (y + halves[0][3]) - x
        part = torch.square(e).sum() / count
        dr = (2.0 * e) * (1.0 / count)
        db_dec = dr.sum(dim=0)
        grads = []
        for (w_enc, b_enc, w_dec, _), (a, gb, _) in zip(halves, fwd):
            dh = bf(dr @ bf(w_dec).T)
            da = dh * gelu_tanh_grad(a)
            grads.append((bf(noisy).T @ da, da.sum(dim=0), gb.T @ dr,
                          db_dec))
        total = grads if total is None else [
            tuple(p + q for p, q in zip(t, g)) for t, g in zip(total, grads)]
        loss = loss + part
    return total, loss


def fit_model_step(halves, xs, noises, lr: float, sigma: float):
    """One (denoising) SGD step of ``model_step_grads``: each half updated
    as ``fit_step`` updates the params (its b_dec by the same db_dec, so
    every half's b_dec is the same bits).

    -> ([each half's (w_enc, b_enc, w_dec, b_dec) updated], loss before
    the step)."""
    grads, loss = model_step_grads(halves, xs, noises, sigma)
    return [sgd_update(p, g, lr) for p, g in zip(halves, grads)], loss


def fit_model_shard(halves, xs, noises, lr: float, sigma: float):
    """``fit`` with the rows split into data blocks and the hidden
    dimension into ``halves``: one ``fit_model_step`` for each step of the
    blocks' noises (``noises[d]`` is block d's [steps, n_d, F]).

    -> ([each half after the last step], losses [steps])."""
    halves = [tuple(p) for p in halves]
    steps = len(noises[0])
    losses = torch.empty(steps, dtype=torch.float32, device=xs[0].device)
    for step in range(steps):
        halves, losses[step] = fit_model_step(
            halves, xs, [nz[step] for nz in noises], lr, sigma)
    return halves, losses


def staged(w_enc, b_enc, w_dec, b_dec) -> torch.Tensor:
    """K3's staged weights (``csrc/anomaly_fit_phases.cuh``, ``Staged``)
    as the flat float32 buffer at the start of its scratch: bf16 W_enc^T
    [H][FP+8], bf16 W_dec^T [FP][H+8], fp32 b_enc [H], fp32 b_dec [FP],
    zeros past F, with FP = F rounded up to 16 (two bf16 to a float)."""
    f, hidden = w_enc.shape
    fp = -(-f // 16) * 16
    opts = {"dtype": torch.bfloat16, "device": w_enc.device}
    we_t = torch.zeros((hidden, fp + 8), **opts)
    we_t[:, :f] = w_enc.T.to(torch.bfloat16)
    wd_t = torch.zeros((fp, hidden + 8), **opts)
    wd_t[:f, :hidden] = w_dec.T.to(torch.bfloat16)
    bd = torch.zeros(fp, dtype=torch.float32, device=w_enc.device)
    bd[:f] = b_dec
    return torch.cat([we_t.reshape(-1).view(torch.float32),
                      wd_t.reshape(-1).view(torch.float32), b_enc, bd])


def fit(w_enc, b_enc, w_dec, b_dec, x: torch.Tensor, noises: torch.Tensor,
        lr: float, sigma: float):
    """``len(noises)`` denoising steps, one for each [n, F] noise of
    ``noises`` [steps, n, F], as the reference's ``lax.scan`` of the step.

    -> ((w_enc, b_enc, w_dec, b_dec) after the last step, losses [steps],
    each the loss before its step)."""
    params = (w_enc, b_enc, w_dec, b_dec)
    losses = torch.empty(len(noises), dtype=torch.float32, device=x.device)
    for step, noise in enumerate(noises):
        params, losses[step] = fit_step(*params, x, noise, lr, sigma)
    return params, losses


def fit_shard(w_enc, b_enc, w_dec, b_dec, xs, noises, lr: float,
              sigma: float):
    """``fit`` over rows split into shards: one ``fit_shard_step`` for each
    step of the shards' noises (``noises[s]`` is shard s's [steps, n_s,
    F]).  -> (params after the last step, losses [steps])."""
    params = (w_enc, b_enc, w_dec, b_dec)
    steps = len(noises[0])
    losses = torch.empty(steps, dtype=torch.float32, device=xs[0].device)
    for step in range(steps):
        params, losses[step] = fit_shard_step(
            *params, xs, [nz[step] for nz in noises], lr, sigma)
    return params, losses
