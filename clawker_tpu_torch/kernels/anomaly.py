"""Wrappers of the anomaly kernels: K1 (score), K2 (fit step) and K3 (fit).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, and launches on the current
CUDA stream.  A tensor on the CPU goes to the plain version in
``reference.py``; a CUDA tensor launches the kernel or raises -- there is
no fallback.  ``LAUNCHES`` counts kernel launches (never CPU calls), so a
run can show that its main path went through the kernels.

Layouts are the JAX reference's: ``w_enc`` [F, H], ``b_enc`` [H],
``w_dec`` [H, F], ``b_dec`` [F], all fp32; any F <= 64 with H = 128.
"""

from __future__ import annotations

import torch

from . import reference
from .build import kernel

HIDDEN = 128
MAX_FEATURES = 64
# The fit step's tiling, named once more in csrc/anomaly_fit_phases.cuh
# (kFitRows, kFitMaxBlocks, kReduceGroups): rows per tile, the cap on
# phase A's blocks (one partial slot each), and phase B's groups of slots
FIT_ROWS = 32
FIT_MAX_BLOCKS = 132
REDUCE_GROUPS = 8

SCORE = "anomaly_score"
FIT_STEP = "anomaly_fit_step"
FIT = "anomaly_fit"
# K3's trace: points per step (csrc/anomaly_fit.cu, kStamps)
FIT_STAMPS = 9
LAUNCHES = {SCORE: 0, FIT_STEP: 0, FIT: 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(params, x: torch.Tensor, *others: torch.Tensor | None) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"x must be [n, F], got shape {tuple(x.shape)}")
    n, f = x.shape
    if n < 1 or not 1 <= f <= MAX_FEATURES:
        raise ValueError(f"need n >= 1 and 1 <= F <= {MAX_FEATURES}, "
                         f"got [{n}, {f}]")
    w_enc, b_enc, w_dec, b_dec = params
    want = {"w_enc": (f, HIDDEN), "b_enc": (HIDDEN,), "w_dec": (HIDDEN, f),
            "b_dec": (f,)}
    for (name, shape), t in zip(want.items(), params):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in (*params, x, *(o for o in others if o is not None)):
        if t.dtype != torch.float32:
            raise TypeError(f"anomaly kernels take float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("anomaly kernels take contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return n, f


def _launched(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err} "
                           f"({torch.cuda.get_device_name()})")
    LAUNCHES[name] += 1


def score(params, x: torch.Tensor) -> torch.Tensor:
    """K1: per-row mean squared reconstruction error, [n, F] -> [n]."""
    n, f = _check(params, x)
    if x.device.type == "cpu":
        return reference.score(*params, x)
    fn = kernel(SCORE)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), *(p.data_ptr() for p in params),
                 out.data_ptr(), n, f, stream)
    _launched(SCORE, err)
    return out


def fit_slots(n: int) -> int:
    """Blocks of phase A (K2's launch A), each one slot of partial sums."""
    return min(-(-n // FIT_ROWS), FIT_MAX_BLOCKS)


def staged_floats(f: int) -> int:
    """Floats of K3's staged weights for F = f (``reference.staged``):
    bf16 W_enc^T [H][FP+8] and W_dec^T [FP][H+8], fp32 b_enc [H] and
    b_dec [FP], FP = f rounded up to 16."""
    fp = -(-f // 16) * 16
    return (HIDDEN * (fp + 8) + fp * (HIDDEN + 8)) // 2 + HIDDEN + fp


def slot_floats(f: int) -> int:
    """Floats of one slot of partial sums: dW_enc [F, H], db_enc [H],
    dW_dec^T [F, H], db_dec [F] and the squared error."""
    return 2 * f * HIDDEN + HIDDEN + f + 1


def scratch_floats(n: int, f: int) -> int:
    """Floats of the scratch of K2 and K3 for x of shape [n, f]: K3's
    staged weights, then one slot per block of phase A (K2 uses the
    slots' room from the start)."""
    return staged_floats(f) + fit_slots(n) * slot_floats(f)


def _check_scratch(scratch: torch.Tensor, x: torch.Tensor, n: int,
                   f: int) -> None:
    if scratch.dtype != torch.float32:
        raise TypeError(f"scratch must be float32, got {scratch.dtype}")
    if scratch.device != x.device:
        raise ValueError(f"scratch on {scratch.device}, x on {x.device}")
    if not scratch.is_contiguous():
        raise ValueError("scratch must be contiguous")
    if scratch.data_ptr() % 16:
        raise ValueError("scratch must start at a 16-byte boundary")
    if scratch.numel() < scratch_floats(n, f):
        raise ValueError(f"scratch holds {scratch.numel()} floats, needs "
                         f"{scratch_floats(n, f)} for [{n}, {f}]")


def fit_step_(params, x: torch.Tensor, noise: torch.Tensor | None, *,
              lr: float, sigma: float, loss_out: torch.Tensor,
              step: int = 0, scratch: torch.Tensor | None = None) -> None:
    """K2, in place: one (denoising) SGD step on ``params``; writes the
    step's loss (before the update) to ``loss_out[step]``.  ``noise``
    None is the plain autoencoder step.  ``scratch`` (float32, at least
    ``scratch_floats(n, F)``, on x's device) is the kernel's partial-sum
    buffer; a loop of steps allocates it once, else each call does."""
    n, f = _check(params, x, noise, loss_out)
    if noise is not None and noise.shape != x.shape:
        raise ValueError(f"noise {tuple(noise.shape)} != x {tuple(x.shape)}")
    if loss_out.dim() != 1 or not 0 <= step < loss_out.numel():
        raise ValueError("loss_out must be 1-d with an entry for `step`")
    if scratch is not None:
        _check_scratch(scratch, x, n, f)
    if x.device.type == "cpu":
        new, loss = reference.fit_step(*params, x, noise, lr, sigma)
        for p, q in zip(params, new):
            p.copy_(q)
        loss_out[step] = loss
        return
    fn = kernel(FIT_STEP)
    if scratch is None:
        scratch = torch.empty(scratch_floats(n, f), dtype=torch.float32,
                              device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), 0 if noise is None else noise.data_ptr(),
                 sigma if noise is not None else 0.0,
                 *(p.data_ptr() for p in params),
                 scratch.data_ptr(), scratch.numel(),
                 loss_out.data_ptr() + step * loss_out.element_size(),
                 lr, n, f, stream)
    _launched(FIT_STEP, err)


def _check_fit(params, x, noises, losses_out, scratch, stamps):
    """fit_'s checks of its arguments -> (n, f, steps)."""
    n, f = _check(params, x, noises, losses_out)
    if noises.dim() != 3 or tuple(noises.shape[1:]) != (n, f):
        raise ValueError(f"noises must be [steps, {n}, {f}], got "
                         f"{tuple(noises.shape)}")
    steps = noises.shape[0]
    if losses_out.dim() != 1 or losses_out.numel() != steps:
        raise ValueError(f"losses_out must hold {steps} losses, got shape "
                         f"{tuple(losses_out.shape)}")
    if scratch is not None:
        _check_scratch(scratch, x, n, f)
    if stamps is not None:
        if stamps.dim() != 3 or tuple(stamps.shape[:2]) != (steps,
                                                            FIT_STAMPS):
            raise ValueError(f"stamps must be [{steps}, {FIT_STAMPS}, "
                             f"blocks] (the trace's points per step), got "
                             f"{tuple(stamps.shape)}")
        if (stamps.dtype != torch.int64 or stamps.device != x.device
                or x.device.type != "cuda" or not stamps.is_contiguous()):
            raise ValueError("stamps must be a contiguous int64 tensor on "
                             "x's CUDA device")
    return n, f, steps


def fit_(params, x: torch.Tensor, noises: torch.Tensor, *, lr: float,
         sigma: float, losses_out: torch.Tensor,
         scratch: torch.Tensor | None = None,
         stamps: torch.Tensor | None = None) -> None:
    """K3, in place: the whole fit, one denoising SGD step on ``params`` for
    each [n, F] noise of ``noises`` [steps, n, F], in one launch; writes
    each step's loss (before its update) to ``losses_out[step]``.
    ``scratch`` is as for ``fit_step_``; None allocates it.  ``stamps``
    (int64 on the card, [steps, FIT_STAMPS, blocks], blocks at least the
    launch's: the larger of the SM count and ``fit_slots(n)``) asks the
    kernel for a trace of its phases: see ``csrc/anomaly_fit.cu``.  The
    CPU path takes none."""
    n, f, steps = _check_fit(params, x, noises, losses_out, scratch, stamps)
    if steps == 0:
        return
    if x.device.type == "cpu":
        new, losses = reference.fit(*params, x, noises, lr, sigma)
        for p, q in zip(params, new):
            p.copy_(q)
        losses_out.copy_(losses)
        return
    fn = kernel(FIT)
    if scratch is None:
        scratch = torch.empty(scratch_floats(n, f), dtype=torch.float32,
                              device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), noises.data_ptr(), sigma,
                 *(p.data_ptr() for p in params),
                 scratch.data_ptr(), scratch.numel(), losses_out.data_ptr(),
                 lr, n, f, steps, 0 if stamps is None else stamps.data_ptr(),
                 0 if stamps is None else stamps.numel(), stream)
    _launched(FIT, err)
