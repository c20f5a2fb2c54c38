"""Wrappers of the anomaly kernels: K1 (score), K2 (fit step), K3 (fit), K5
(the fit over rows split into shards: one launch per fit on one card, or
the per-step route of S + 1 launches a step) and K5b (the fit over rows
split into data blocks and the hidden dimension into two model shards: one
launch per fit on one card, each work item both halves of a slot; one
launch per card per fit across cards with peer access; or the per-step
route of 2 S + 2 launches a step).

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

import ctypes
import os
import threading
from typing import NamedTuple

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
FIT_SHARD = "anomaly_fit_shard_fit"
FIT_SHARD_PARTIALS = "anomaly_fit_shard_partials"
FIT_SHARD_REDUCE = "anomaly_fit_shard_reduce"
# K3's and K5's trace: points per step (csrc/anomaly_fit_persistent.cuh,
# kStamps)
FIT_STAMPS = 9
# K5's one-launch fit: the most shards its table holds (kMaxShards), and a
# block's most shared memory on an H100 (kMaxSmem)
MAX_SHARDS = 64
MAX_SMEM = 232448
FIT_MODEL = "anomaly_fit_model_fit"
FIT_MODEL_FORWARD = "anomaly_fit_model_forward"
FIT_MODEL_PARTIALS = "anomaly_fit_model_partials"
FIT_MODEL_REDUCE = "anomaly_fit_model_reduce"
# K5b: its model shards and each one's hidden units (csrc/anomaly_fit_model.cu,
# kModel and kHalf), and the data blocks its one-launch fit's table holds
# (kMaxData)
MODEL = 2
HALF = HIDDEN // MODEL
MAX_DATA = 32
# K5b across cards: one launch per card (csrc/anomaly_fit_model.cu, the
# cards route), the most cards of one launch set (csrc/anomaly_cards.cuh,
# kMaxCards) and its trace's points per step (kCardStamps)
FIT_MODEL_CARDS = "anomaly_fit_model_cards"
MAX_CARDS = 8
CARDS_STAMPS = 10
# K5b's routes (``model_route``)
ROUTE_FOLD = "fold"
ROUTE_CARDS = "cards"
ROUTE_STEPS = "steps"
LAUNCHES = {SCORE: 0, FIT_STEP: 0, FIT: 0, FIT_SHARD: 0,
            FIT_SHARD_PARTIALS: 0, FIT_SHARD_REDUCE: 0, FIT_MODEL: 0,
            FIT_MODEL_FORWARD: 0, FIT_MODEL_PARTIALS: 0, FIT_MODEL_REDUCE: 0,
            FIT_MODEL_CARDS: 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(params, x: torch.Tensor, *others: torch.Tensor | None,
           hidden: int = HIDDEN) -> tuple[int, int]:
    """The checks every kernel makes of its params (``hidden`` units: K5b's
    model shard holds HALF), x and other tensors -> (n, f)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [n, F], got shape {tuple(x.shape)}")
    n, f = x.shape
    if n < 1 or not 1 <= f <= MAX_FEATURES:
        raise ValueError(f"need n >= 1 and 1 <= F <= {MAX_FEATURES}, "
                         f"got [{n}, {f}]")
    w_enc, b_enc, w_dec, b_dec = params
    want = {"w_enc": (f, hidden), "b_enc": (hidden,), "w_dec": (hidden, f),
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


def staged_floats(f: int, hidden: int = HIDDEN) -> int:
    """Floats of K3's staged weights for F = f (``reference.staged``):
    bf16 W_enc^T [H][FP+8] and W_dec^T [FP][H+8], fp32 b_enc [H] and
    b_dec [FP], FP = f rounded up to 16 (H = ``hidden``: K5b's image of
    a half holds HALF)."""
    fp = -(-f // 16) * 16
    return (hidden * (fp + 8) + fp * (hidden + 8)) // 2 + hidden + fp


def slot_floats(f: int) -> int:
    """Floats of one slot of partial sums: dW_enc [F, H], db_enc [H],
    dW_dec^T [F, H], db_dec [F] and the squared error."""
    return 2 * f * HIDDEN + HIDDEN + f + 1


def scratch_floats(n: int, f: int) -> int:
    """Floats of the scratch of K2 and K3 for x of shape [n, f]: K3's
    staged weights, then one slot per block of phase A (K2 uses the
    slots' room from the start)."""
    return staged_floats(f) + fit_slots(n) * slot_floats(f)


def _padded(f: int) -> int:
    return -(-f // 16) * 16


def work_bytes(f: int) -> int:
    """Bytes of phase A's working set in shared memory at F = f
    (csrc/anomaly_fit_phases.cuh, work_bytes): fp32 gelu'(a) [R][H+8],
    dr [R][FP+1] and 8 warp sums, the staged weights, then bf16 noisy x
    [R][FP+8], gelu [R][H+8], dr's three terms [3][R][FP+8] and da's
    [3][R][H+8]."""
    fp, ldh = _padded(f), HIDDEN + 8
    return (4 * (FIT_ROWS * ldh + FIT_ROWS * (fp + 1) + 8)
            + 4 * staged_floats(f)
            + 2 * (4 * FIT_ROWS * (fp + 8) + 4 * FIT_ROWS * ldh))


def tile_bytes(f: int) -> int:
    """Bytes of one fp32 [R][FP] tile of x or noise in shared memory."""
    return 4 * FIT_ROWS * _padded(f)


def fit_shared_plan(per_block: int, f: int,
                    work: int | None = None) -> tuple[int, int]:
    """The x tiles a block of K3 or of K5's one-launch fit keeps resident
    when the most tiles any block walks in a step is ``per_block``, and
    the launch's shared bytes (csrc/anomaly_fit_persistent.cuh,
    shared_plan): all of them while the working set (``work``, else
    ``work_bytes(f)``), the tiles and two noise tiles fit in
    ``MAX_SMEM``; else 0, one tile reloaded at each tile.  K3 walks
    ceil(ceil(n / 32) / fit_slots(n)) tiles a block."""
    base = (work_bytes(f) if work is None else work) + 2 * tile_bytes(f)
    if base + per_block * tile_bytes(f) <= MAX_SMEM:
        return per_block, base + per_block * tile_bytes(f)
    return 0, base + tile_bytes(f)


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
        _check_stamps(stamps, steps, x.device)
    return n, f, steps


def _check_stamps(stamps: torch.Tensor, steps: int,
                  device: torch.device) -> None:
    if stamps.dim() != 3 or tuple(stamps.shape[:2]) != (steps, FIT_STAMPS):
        raise ValueError(f"stamps must be [{steps}, {FIT_STAMPS}, "
                         f"blocks] (the trace's points per step), got "
                         f"{tuple(stamps.shape)}")
    if (stamps.dtype != torch.int64 or stamps.device != device
            or device.type != "cuda" or not stamps.is_contiguous()):
        raise ValueError("stamps must be a contiguous int64 tensor on "
                         "x's CUDA device")


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


# ------------------------------------------------------------------ K5


def shard_slot_offsets(rows) -> list[int]:
    """Where each shard's slots start in K5's slot buffer, in slots, for
    shards of ``rows`` rows each, and last the total: the shards' regions
    lie back to back in shard order, ``fit_slots(n_s)`` slots each."""
    offsets = [0]
    for n in rows:
        offsets.append(offsets[-1] + fit_slots(n))
    return offsets


def shard_slot_floats(rows, f: int) -> int:
    """Floats of K5's slot buffer for shards of ``rows`` rows at F = f."""
    return shard_slot_offsets(rows)[-1] * slot_floats(f)


def shard_scratch_floats(rows, f: int) -> int:
    """Floats of the scratch of K5's one-launch fit: the staged weights,
    then the slot buffer (``shard_slot_floats``)."""
    return staged_floats(f) + shard_slot_floats(rows, f)


class ShardItem(NamedTuple):
    """One work item of K5's one-launch fit: the per-step route's launch
    A of shard ``shard``, block ``b``, which walks ``tiles`` of that shard
    and writes slot ``slot``."""
    shard: int
    b: int
    slot: int
    tiles: tuple[int, ...]


class ShardFitPlan(NamedTuple):
    """``items[k]``: block k's items, in the order it takes them;
    ``resident_tiles`` and ``smem`` as ``fit_shared_plan`` gives them."""
    items: list[list[ShardItem]]
    resident_tiles: int
    smem: int


def shard_fit_plan(rows, blocks: int, f: int) -> ShardFitPlan:
    """K5's one-launch fit over shards of ``rows`` rows at F = f on
    ``blocks`` blocks (one per SM), as csrc/anomaly_fit_shard.cu plans it
    (item_of, most_block_tiles): slot i is shard s's block
    b = i - shard_slot_offsets(rows)[s], walking tiles b, b + ga_s, ...
    (ga_s = fit_slots(n_s)) of shard s; block k takes slots k, k + blocks,
    ...; its x tiles stay resident while the most any block walks fit."""
    if not 1 <= len(rows) <= MAX_SHARDS:
        raise ValueError(f"K5's one-launch fit takes 1 to {MAX_SHARDS} "
                         f"shards, got {len(rows)}")
    offsets = shard_slot_offsets(rows)
    items = [[] for _ in range(blocks)]
    for s, n in enumerate(rows):
        ga, tiles = fit_slots(n), -(-n // FIT_ROWS)
        for b in range(ga):
            slot = offsets[s] + b
            items[slot % blocks].append(
                ShardItem(s, b, slot, tuple(range(b, tiles, ga))))
    most = max(sum(len(it.tiles) for it in block) for block in items)
    return ShardFitPlan(items, *fit_shared_plan(most, f))


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Each [n, F] matrix of ``t`` (its last two dims) is contiguous."""
    return t.is_contiguous() if t.dim() == 2 else (
        len(t) == 0 or t[0].is_contiguous())


def _check_shards(replicas, xs, noises, steps: int | None):
    """fit_shard_step_'s and fit_shard_'s checks -> (rows, f, params by
    device).  ``noises`` holds one [n_s, F] (steps None) or [steps, n_s, F]
    tensor per shard, or is None."""
    if not xs:
        raise ValueError("need at least one shard")
    by_dev = {}
    for p in replicas:
        dev = p[0].device
        if dev in by_dev:
            raise ValueError(f"two params sets on {dev}: one per device")
        by_dev[dev] = p
    if set(by_dev) != {x.device for x in xs}:
        raise ValueError(f"params on {sorted(map(str, by_dev))}, shards on "
                         f"{sorted({str(x.device) for x in xs})}: one params "
                         f"set per device the shards lie on")
    if len({x.device.type for x in xs}) != 1:
        raise ValueError("shards on the CPU and on CUDA devices at once")
    if noises is not None and len(noises) != len(xs):
        raise ValueError(f"{len(noises)} noise shards for {len(xs)} shards")
    rows = []
    for s, x in enumerate(xs):
        n, f = _check(by_dev[x.device], x)
        if f != xs[0].shape[1]:
            raise ValueError(f"shard {s} has F = {f}, shard 0 "
                             f"{xs[0].shape[1]}")
        rows.append(n)
        if noises is None:
            continue
        nz = noises[s]
        want = (n, f) if steps is None else (steps, n, f)
        if tuple(nz.shape) != want:
            raise ValueError(f"noise of shard {s} must be {want}, got "
                             f"{tuple(nz.shape)}")
        if (nz.dtype != torch.float32 or nz.device != x.device
                or not _rows_contiguous(nz)):
            raise ValueError(f"noise of shard {s} must be float32 on "
                             f"{x.device}, each [n, F] step contiguous")
    return rows, xs[0].shape[1], by_dev


def _check_slots(slots: torch.Tensor, home: torch.device, need: int,
                 name: str = "slots") -> None:
    if (slots.dtype != torch.float32 or slots.device != home
            or not slots.is_contiguous() or slots.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous float32 tensor on "
                         f"{home} at a 16-byte boundary")
    if slots.numel() < need:
        raise ValueError(f"{name} holds {slots.numel()} floats, needs {need}")


def _shard_stepper(by_dev, xs, rows, f, *, lr, sigma, slots):
    """-> step(noise_ptrs, loss_ptr), which enqueues one K5 step on the
    current streams: phase A of each shard into its card's slot buffer
    (``slots`` on the first shard's card), the other cards' regions
    copied to the first's, phase B there, and its params copied back to
    the other cards (``csrc/anomaly_fit_shard.cu``)."""
    home = xs[0].device
    n_total = sum(rows)
    offsets = shard_slot_offsets(rows)
    pf = slot_floats(f)
    need = offsets[-1] * pf
    bufs = {home: slots}
    for dev in by_dev:
        if dev not in bufs:
            bufs[dev] = torch.empty(need, dtype=torch.float32, device=dev)
    shards_on = {dev: [s for s, x in enumerate(xs) if x.device == dev]
                 for dev in by_dev}
    streams = {dev: torch.cuda.current_stream(dev).cuda_stream
               for dev in by_dev}
    partials, reduce = kernel(FIT_SHARD_PARTIALS), kernel(FIT_SHARD_REDUCE)
    # each shard's arguments before and after its noise pointer
    head = [x.data_ptr() for x in xs]
    tail = []
    for s, x in enumerate(xs):
        buf = bufs[x.device]
        tail.append((sigma, *(p.data_ptr() for p in by_dev[x.device]),
                     buf.data_ptr() + 4 * offsets[s] * pf,
                     buf.numel() - offsets[s] * pf, rows[s], n_total, f,
                     streams[x.device]))
    gather = [(bufs[home][offsets[s] * pf:offsets[s + 1] * pf],
               bufs[x.device][offsets[s] * pf:offsets[s + 1] * pf])
              for s, x in enumerate(xs) if x.device != home]
    copies = [(q, p) for dev, params in by_dev.items() if dev != home
              for q, p in zip(params, by_dev[home])]
    reduce_args = (slots.data_ptr(), slots.numel(), offsets[-1],
                   *(p.data_ptr() for p in by_dev[home]))

    def step(noise_ptrs, loss_ptr: int) -> None:
        for dev, shards in shards_on.items():
            with torch.cuda.device(dev):
                for s in shards:
                    _launched(FIT_SHARD_PARTIALS,
                              partials(head[s], noise_ptrs[s], *tail[s]))
        for dst, src in gather:
            dst.copy_(src)
        with torch.cuda.device(home):
            _launched(FIT_SHARD_REDUCE,
                      reduce(*reduce_args, loss_ptr, lr, n_total, f,
                             streams[home]))
        for q, p in copies:
            q.copy_(p)

    return step


def fit_shard_step_(replicas, xs, noises, *, lr: float, sigma: float,
                    loss_out: torch.Tensor, step: int = 0,
                    slots: torch.Tensor | None = None) -> None:
    """K5, in place: one (denoising) SGD step on the batch whose rows are
    split into the shards ``xs`` (each [n_s, F], in shard order), with
    ``noises`` their noise rows ([n_s, F] each) or None for the plain
    autoencoder step.  ``replicas`` holds one params set per device the
    shards lie on; all of them get the same updated params.  Writes the
    step's loss (before the update) to ``loss_out[step]``, on the first
    shard's device.  ``slots`` (float32, at least ``shard_slot_floats``,
    on the first shard's device) receives every shard's slots; None
    allocates it.  It takes the per-step route on every layout: phase A
    of each shard, then phase B (``csrc/anomaly_fit_shard.cu``)."""
    rows, f, by_dev = _check_shards(replicas, xs, noises, None)
    home = xs[0].device
    if (loss_out.dim() != 1 or not 0 <= step < loss_out.numel()
            or loss_out.dtype != torch.float32 or loss_out.device != home):
        raise ValueError(f"loss_out must be 1-d float32 on {home} with an "
                         f"entry for `step`")
    nz = noises if noises is not None else [None] * len(xs)
    if home.type == "cpu":
        params = by_dev[home]
        new, loss = reference.fit_shard_step(*params, xs, nz, lr, sigma)
        for p, q in zip(params, new):
            p.copy_(q)
        loss_out[step] = loss
        return
    need = shard_slot_floats(rows, f)
    if slots is None:
        slots = torch.empty(need, dtype=torch.float32, device=home)
    _check_slots(slots, home, need)
    stepper = _shard_stepper(by_dev, xs, rows, f, lr=lr, sigma=sigma,
                             slots=slots)
    stepper([0 if t is None else t.data_ptr() for t in nz],
            loss_out.data_ptr() + step * loss_out.element_size())


def _fit_shard_steps(by_dev, xs, noises, rows, f, *, lr, sigma, slots,
                     losses_out) -> None:
    """The per-step route of the fit: one ``_shard_stepper`` step for each
    step of the noise shards, S + 1 launches a step from the host."""
    stepper = _shard_stepper(by_dev, xs, rows, f, lr=lr, sigma=sigma,
                             slots=slots)
    bases = [nz.data_ptr() for nz in noises]
    strides = [nz.stride(0) * nz.element_size() for nz in noises]
    loss0 = losses_out.data_ptr()
    for s in range(noises[0].shape[0]):
        stepper([b + s * d for b, d in zip(bases, strides)], loss0 + 4 * s)


def fit_shard_(replicas, xs, noises, *, lr: float, sigma: float,
               losses_out: torch.Tensor,
               scratch: torch.Tensor | None = None,
               stamps: torch.Tensor | None = None) -> None:
    """K5, in place: the whole fit over the shards ``xs`` (each [n_s, F],
    in shard order), one denoising step for each step of the noise shards
    (``noises[s]`` is shard s's [steps, n_s, F], each step's rows
    contiguous).  Writes each step's loss (before its update) to
    ``losses_out[step]`` on the first shard's device.  ``scratch``
    (float32, at least ``shard_scratch_floats(rows, F)``, on the first
    shard's device, 16-byte aligned) holds the staged weights and every
    shard's slots; None allocates it.

    The route follows the layout: all the shards on one CUDA device, one
    ``anomaly_fit_shard_fit`` launch (at most ``MAX_SHARDS`` shards; more
    raise ``ValueError``); shards on several cards, the per-step route
    (S + 1 launches a step, the slots gathered to the first card and the
    params copied back); the CPU, ``reference.fit_shard``.  Both kernel
    routes give the same bits.  ``stamps`` (one card only: int64
    [steps, FIT_STAMPS, the SM count]) asks the one-launch fit for K3's
    trace of its phases."""
    if not noises or noises[0].dim() != 3:
        raise ValueError("noises must hold one [steps, n_s, F] tensor per "
                         "shard")
    steps = noises[0].shape[0]
    rows, f, by_dev = _check_shards(replicas, xs, noises, steps)
    home = xs[0].device
    if (losses_out.dim() != 1 or losses_out.numel() != steps
            or losses_out.dtype != torch.float32
            or losses_out.device != home):
        raise ValueError(f"losses_out must hold {steps} float32 losses on "
                         f"{home}")
    one_device = len(by_dev) == 1
    if one_device and len(xs) > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards on one device, got "
                         f"{len(xs)}")
    if stamps is not None:
        if not one_device:
            raise ValueError("stamps trace the one-launch fit: the shards "
                             "must lie on one card")
        _check_stamps(stamps, steps, home)
    if steps == 0:
        return
    if home.type == "cpu":
        params = by_dev[home]
        new, losses = reference.fit_shard(*params, xs, noises, lr, sigma)
        for p, q in zip(params, new):
            p.copy_(q)
        losses_out.copy_(losses)
        return
    need = shard_scratch_floats(rows, f)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.float32, device=home)
    _check_slots(scratch, home, need, "scratch")
    if not one_device:
        _fit_shard_steps(by_dev, xs, noises, rows, f, lr=lr, sigma=sigma,
                         slots=scratch[staged_floats(f):],
                         losses_out=losses_out)
        return
    fn = kernel(FIT_SHARD)
    table = (ctypes.c_longlong * (4 * len(xs)))(*(
        v for x, nz, n in zip(xs, noises, rows)
        for v in (x.data_ptr(), nz.data_ptr(), nz.stride(0), n)))
    with torch.cuda.device(home):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table, len(xs), sigma, *(p.data_ptr() for p in by_dev[home]),
                 scratch.data_ptr(), scratch.numel(), losses_out.data_ptr(),
                 lr, f, steps, 0 if stamps is None else stamps.data_ptr(),
                 0 if stamps is None else stamps.numel(), stream)
    _launched(FIT_SHARD, err)


# ------------------------------------------------------------------ K5b


def half_slot_floats(f: int) -> int:
    """Floats of one slot of K5b's half: dW_enc_m [F, HALF], db_enc_m
    [HALF], dW_dec_m^T [F, HALF], db_dec [F] and the squared error."""
    return 2 * f * HALF + HALF + f + 1


def model_image_floats(f: int) -> int:
    """Floats of the one-launch fit's staged images of both halves at F =
    f: K3's image at a hidden width of HALF, one a half."""
    return MODEL * staged_floats(f, HALF)


def _route_floats(rows, f: int) -> int:
    """Floats of the slots and y that follow the images in K5b's scratch:
    both halves' slots (``shard_slot_offsets(rows)[-1]`` a half), the
    halves' partial outputs y [MODEL, N, F], and one float for half 1's
    copy of the loss."""
    return (MODEL * shard_slot_offsets(rows)[-1] * half_slot_floats(f)
            + MODEL * sum(rows) * f + 1)


def model_scratch_floats(rows, f: int) -> int:
    """Floats of K5b's scratch for data blocks of ``rows`` rows at F = f
    (``csrc/anomaly_fit_model.cu``): the one-launch fit's staged images
    (``model_image_floats``), then both halves' slots, then the per-step
    route's partial outputs y [MODEL, N, F], then one float for half 1's
    copy of the loss.  The one-launch fit uses the images, the slots and
    a float; the per-step route all but the images."""
    return model_image_floats(f) + _route_floats(rows, f)


def half_slot_at(rows, f: int, d: int, m: int) -> int:
    """Where data block d's first slot of half m lies among K5b's slots (in
    floats from the first, ``model_image_floats(f)`` into the scratch):
    half m's slots from ``m x shard_slot_offsets(rows)[-1]`` slots on, each
    data block's back to back in data order, which is where both routes
    write them and the reduce of half m reads them."""
    offsets = shard_slot_offsets(rows)
    return (m * offsets[-1] + offsets[d]) * half_slot_floats(f)


def fold_work_bytes(f: int) -> int:
    """Bytes of the one-launch fit's working set in shared memory at F = f
    (csrc/anomaly_fit_model.cu, fold_work_bytes): both halves' staged
    weights (bf16 W_enc_m^T [HALF][FP+8], W_dec_m^T [FP][HALF+8], fp32
    b_enc_m [HALF], b_dec [FP]), 8 warp sums, each half's fp32 gelu'(a)
    [R][HALF+8], dr [R][FP+1], then bf16 noisy x [R][FP+8], each half's
    gelu [R][HALF+8], dr's three terms [3][R][FP+8] and each half's da's
    [3][R][HALF+8]."""
    fp, ldq = _padded(f), HALF + 8
    staged = 2 * (HALF * (fp + 8) + fp * ldq) + 4 * (HALF + fp)
    return (MODEL * staged + 4 * (8 + MODEL * FIT_ROWS * ldq
                                  + FIT_ROWS * (fp + 1))
            + 2 * (4 * FIT_ROWS * (fp + 8) + MODEL * 4 * FIT_ROWS * ldq))


class ModelItem(NamedTuple):
    """One work item of K5b's one-launch fit: data block ``d``'s block
    ``b`` of its ``fit_slots(n_d)``, slot ``slot`` of each half, which
    walks ``tiles`` of block d with both halves and writes both halves'
    slot ``slot`` at ``at`` (half 0's, half 1's; floats from the first
    slot, as ``half_slot_at`` counts)."""
    d: int
    b: int
    slot: int
    tiles: tuple[int, ...]
    at: tuple[int, int]


class ModelFitPlan(NamedTuple):
    """``items[k]``: block k's items, in the order it takes them;
    ``resident_tiles`` and ``smem`` by K5's rule over
    ``fold_work_bytes``."""
    items: list[list[ModelItem]]
    resident_tiles: int
    smem: int


def model_fit_plan(rows, blocks: int, f: int) -> ModelFitPlan:
    """K5b's one-launch fit over data blocks of ``rows`` rows at F = f on
    ``blocks`` blocks (one per SM), as csrc/anomaly_fit_model.cu plans it
    (fold_item, fold_block_tiles, shared_plan): slot i of each half is data
    block d's block b = i - shard_slot_offsets(rows)[d], walking tiles
    b, b + ga_d, ... (ga_d = fit_slots(n_d)) with both halves: K5's items
    (``shard_fit_plan``) over the data blocks; block k takes slots k,
    k + blocks, ...; its x tiles stay resident by ``fit_shared_plan`` over
    ``fold_work_bytes``."""
    if not 1 <= len(rows) <= MAX_DATA:
        raise ValueError(f"K5b's one-launch fit takes 1 to {MAX_DATA} "
                         f"data blocks, got {len(rows)}")
    pf = half_slot_floats(f)
    items = [[ModelItem(it.shard, it.b, it.slot, it.tiles, tuple(
        half_slot_at(rows, f, it.shard, m) + it.b * pf for m in range(MODEL)))
        for it in block] for block in shard_fit_plan(rows, blocks, f).items]
    most = max(sum(len(it.tiles) for it in block) for block in items)
    return ModelFitPlan(items, *fit_shared_plan(most, f, fold_work_bytes(f)))


def _check_model(halves, xs, noises, steps: int | None):
    """fit_model_step_'s and fit_model_'s checks -> (rows of each data
    block, f, {(device, m): half m's params there}).  Shard s is data block
    s // MODEL's half s % MODEL; ``halves[s]`` its params, which the shards
    of one device and half share; both halves of a block hold the same
    rows (``noises`` as for ``_check_shards``)."""
    if not xs or len(xs) % MODEL:
        raise ValueError(f"need data x {MODEL} shards, got {len(xs)}")
    if len(halves) != len(xs):
        raise ValueError(f"{len(halves)} params sets for {len(xs)} shards: "
                         f"one per shard")
    if len({x.device.type for x in xs}) != 1:
        raise ValueError("shards on the CPU and on CUDA devices at once")
    if noises is not None and len(noises) != len(xs):
        raise ValueError(f"{len(noises)} noise shards for {len(xs)} shards")
    f = xs[0].shape[1] if xs[0].dim() == 2 else 0
    rows, sets = [], {}
    for s, (x, p) in enumerate(zip(xs, halves)):
        n, fx = _check(p, x, hidden=HALF)
        if fx != f:
            raise ValueError(f"shard {s} has F = {fx}, shard 0 {f}")
        key = (x.device, s % MODEL)
        if key not in sets:
            sets[key] = p
        elif any(a.data_ptr() != b.data_ptr() for a, b in zip(sets[key], p)):
            raise ValueError(f"two params sets of half {key[1]} on "
                             f"{key[0]}: the shards of a device and half "
                             f"share one")
        if s % MODEL == 0:
            rows.append(n)
        elif n != rows[-1]:
            raise ValueError(f"shard {s} holds {n} rows, its data block "
                             f"{rows[-1]}: both halves take the same rows")
        if noises is None:
            continue
        nz = noises[s]
        want = (n, f) if steps is None else (steps, n, f)
        if tuple(nz.shape) != want:
            raise ValueError(f"noise of shard {s} must be {want}, got "
                             f"{tuple(nz.shape)}")
        if (nz.dtype != torch.float32 or nz.device != x.device
                or not _rows_contiguous(nz)):
            raise ValueError(f"noise of shard {s} must be float32 on "
                             f"{x.device}, each [n, F] step contiguous")
    return rows, f, sets


def _model_stepper(sets, xs, rows, f, *, lr, sigma, scratch):
    """-> step(noise_ptrs, loss_ptr), which enqueues one K5b step on the
    current streams: the forward of each shard into its card's y, every
    card's y gathered to the first shard's card and copied back to the
    others, the partials of each shard into its card's slots, the other
    cards' slots copied to the first's, phase B there once per half (on
    that card's params of the half, or a copy there), and those params
    copied to every other set of the half (``csrc/anomaly_fit_model.cu``).
    ``scratch`` (``model_scratch_floats``) lies on the first shard's card;
    the route takes what follows the images."""
    home = xs[0].device
    n_total = sum(rows)
    offsets = shard_slot_offsets(rows)
    pf = half_slot_floats(f)
    y_base = MODEL * offsets[-1] * pf
    row0 = [sum(rows[:d]) for d in range(len(rows))]
    need = _route_floats(rows, f)
    scratch = scratch[model_image_floats(f):]
    devs = list(dict.fromkeys(x.device for x in xs))
    bufs = {dev: scratch if dev == home else torch.empty(
        need, dtype=torch.float32, device=dev) for dev in devs}
    masters = []
    for m in range(MODEL):
        own = sets.get((home, m))
        if own is None:
            src = next(p for (_, h), p in sets.items() if h == m)
            own = tuple(t.to(home, copy=True) for t in src)
        masters.append(own)
    streams = {dev: torch.cuda.current_stream(dev).cuda_stream
               for dev in devs}
    forward = kernel(FIT_MODEL_FORWARD)
    partials = kernel(FIT_MODEL_PARTIALS)
    reduce = kernel(FIT_MODEL_REDUCE)

    def y_at(d, m):
        return y_base + (m * n_total + row0[d]) * f

    def slot_at(d, m):
        return half_slot_at(rows, f, d, m)

    fwd, part = [], []
    for s, x in enumerate(xs):
        d, m = divmod(s, MODEL)
        dev, base = x.device, bufs[x.device].data_ptr()
        params = tuple(p.data_ptr() for p in sets[(dev, m)])
        fwd.append((sigma, *params, base + 4 * y_at(d, m), rows[d], f,
                    streams[dev]))
        part.append((sigma, *params, base + 4 * y_at(d, MODEL - 1 - m),
                     base + 4 * slot_at(d, m), need - slot_at(d, m), rows[d],
                     n_total, f, streams[dev]))
    away = [(s, divmod(s, MODEL)) for s, x in enumerate(xs) if x.device != home]
    y_gather = [(bufs[home][y_at(d, m):y_at(d, m) + rows[d] * f],
                 bufs[xs[s].device][y_at(d, m):y_at(d, m) + rows[d] * f])
                for s, (d, m) in away]
    y_bcast = [(bufs[dev][y_base:need - 1], bufs[home][y_base:need - 1])
               for dev in devs if dev != home]
    slot_gather = [(bufs[home][slot_at(d, m):slot_at(d, m) + fit_slots(
        rows[d]) * pf], bufs[xs[s].device][slot_at(d, m):slot_at(d, m)
                                           + fit_slots(rows[d]) * pf])
                   for s, (d, m) in away]
    discard = scratch.data_ptr() + 4 * (need - 1)
    reduce_args = [(scratch.data_ptr() + 4 * slot_at(0, m), offsets[-1] * pf,
                    offsets[-1], *(p.data_ptr() for p in masters[m]))
                   for m in range(MODEL)]
    copies = [(q, p) for (_, m), params in sets.items()
              if params is not masters[m]
              for q, p in zip(params, masters[m])]

    def step(noise_ptrs, loss_ptr: int) -> None:
        for fn, name, args in ((forward, FIT_MODEL_FORWARD, fwd),
                               (partials, FIT_MODEL_PARTIALS, part)):
            for dev in devs:
                with torch.cuda.device(dev):
                    for s, x in enumerate(xs):
                        if x.device == dev:
                            _launched(name, fn(x.data_ptr(), noise_ptrs[s],
                                               *args[s]))
            if fn is forward:
                for dst, src in y_gather + y_bcast:
                    dst.copy_(src)
        for dst, src in slot_gather:
            dst.copy_(src)
        with torch.cuda.device(home):
            for m in range(MODEL):
                _launched(FIT_MODEL_REDUCE, reduce(
                    *reduce_args[m], loss_ptr if m == 0 else discard, lr,
                    n_total, f, streams[home]))
        for q, p in copies:
            q.copy_(p)

    return step


def _model_scratch(scratch, home, rows, f):
    need = model_scratch_floats(rows, f)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.float32, device=home)
    _check_slots(scratch, home, need, "scratch")
    return scratch


def fit_model_step_(halves, xs, noises, *, lr: float, sigma: float,
                    loss_out: torch.Tensor, step: int = 0,
                    scratch: torch.Tensor | None = None) -> None:
    """K5b, in place: one (denoising) SGD step on the batch whose rows are
    split into data blocks and whose hidden units into MODEL halves: shard
    s (in shard order, data-major) holds data block s // MODEL's rows
    ``xs[s]`` (both halves the same rows) and half s % MODEL's params
    ``halves[s]`` (w_enc [F, HALF], b_enc [HALF], w_dec [HALF, F], the
    whole b_dec), shared by the shards of one device and half; ``noises``
    the shards' noise rows, or None for the plain autoencoder step.  Every
    params set of a half gets the same updated half; every half's b_dec the
    same bits.  Writes the step's loss (before the update) to
    ``loss_out[step]`` on the first shard's device.  ``scratch`` (float32,
    at least ``model_scratch_floats``, there) None allocates it.  It takes
    the per-step route on every layout."""
    rows, f, sets = _check_model(halves, xs, noises, None)
    home = xs[0].device
    if (loss_out.dim() != 1 or not 0 <= step < loss_out.numel()
            or loss_out.dtype != torch.float32 or loss_out.device != home):
        raise ValueError(f"loss_out must be 1-d float32 on {home} with an "
                         f"entry for `step`")
    nz = noises if noises is not None else [None] * len(xs)
    if home.type == "cpu":
        new, loss = reference.fit_model_step(
            [sets[(home, m)] for m in range(MODEL)], xs[::MODEL],
            nz[::MODEL], lr, sigma)
        _copy_halves(sets, new)
        loss_out[step] = loss
        return
    scratch = _model_scratch(scratch, home, rows, f)
    stepper = _model_stepper(sets, xs, rows, f, lr=lr, sigma=sigma,
                             scratch=scratch)
    stepper([0 if t is None else t.data_ptr() for t in nz],
            loss_out.data_ptr() + step * loss_out.element_size())


def _copy_halves(sets, new) -> None:
    for (_, m), params in sets.items():
        for p, q in zip(params, new[m]):
            p.copy_(q)


def _fit_model_steps(sets, xs, noises, rows, f, *, lr, sigma, scratch,
                     losses_out) -> None:
    """The per-step route of K5b's fit: one ``_model_stepper`` step for each
    step of the noise shards, 2 S + 2 launches a step from the host."""
    stepper = _model_stepper(sets, xs, rows, f, lr=lr, sigma=sigma,
                             scratch=scratch)
    bases = [nz.data_ptr() for nz in noises]
    strides = [nz.stride(0) * nz.element_size() for nz in noises]
    loss0 = losses_out.data_ptr()
    for s in range(noises[0].shape[0]):
        stepper([b + s * d for b, d in zip(bases, strides)], loss0 + 4 * s)


def _fold_tables(sets, xs, noises, rows, home):
    """The one-launch fit's two int64 tables: each data block's x and noise
    pointers, noise step stride and rows, and the halves' params on
    ``home``."""
    table = (ctypes.c_longlong * (4 * len(rows)))(*(
        v for x, nz, n in zip(xs[::MODEL], noises[::MODEL], rows)
        for v in (x.data_ptr(), nz.data_ptr(), nz.stride(0), n)))
    hv = (ctypes.c_longlong * (4 * MODEL))(*(
        p.data_ptr() for m in range(MODEL) for p in sets[(home, m)]))
    return table, hv


# ------------------------------------------------ K5b across cards


def cards_copy_floats(f: int) -> int:
    """Floats at the start of a card's scratch of the cards route: its copy
    of the halves it holds no params of (half m's w_enc [F, HALF], b_enc
    [HALF], w_dec [HALF, F], b_dec [F] from m (half_slot_floats(f) - 1)
    on), rounded up to 16 bytes."""
    return -(-MODEL * (half_slot_floats(f) - 1) // 4) * 4


def cards_slots_at(f: int) -> int:
    """Where a card's slots start in its scratch of the cards route, in
    floats: after the copy and both halves' images."""
    return cards_copy_floats(f) + model_image_floats(f)


def cards_slot_floats(rows, f: int) -> int:
    """Floats of a card's slots in the cards route: two parities (step s
    takes s % 2) of both halves' slots, each parity laid out as the fold's
    slots (``half_slot_at``)."""
    return 2 * MODEL * shard_slot_offsets(rows)[-1] * half_slot_floats(f)


def cards_scratch_floats(rows, f: int) -> int:
    """Floats of one card's scratch in the cards route
    (``csrc/anomaly_fit_model.cu``, model_cards): the copy
    (``cards_copy_floats``), both halves' images, the slots
    (``cards_slot_floats``), then one float for the losses of the cards
    that write none."""
    return cards_slots_at(f) + cards_slot_floats(rows, f) + 1


class CardsFitPlan(NamedTuple):
    """The cards route's plan: ``runs[c][d]`` the run [lo, hi) of data
    block d's blocks (its ``fit_slots(n_d)``) that card c takes;
    ``items[c][k]`` card c's block k's items, in the order it takes them;
    ``resident_tiles[c]`` and ``smem[c]`` by the fold's rule over card c's
    items."""
    runs: list[list[tuple[int, int]]]
    items: list[list[list[ModelItem]]]
    resident_tiles: list[int]
    smem: list[int]


def cards_fit_plan(rows, cards_of_shards, blocks: int,
                   f: int) -> CardsFitPlan:
    """The cards route over data blocks of ``rows`` rows at F = f, shard s
    on card ``cards_of_shards[s]`` (0 .. C - 1, every card holding one), on
    ``blocks`` blocks a card, as csrc/anomaly_fit_model.cu plans it
    (card_items, card_slot, card_block_tiles): data block d's
    ``fit_slots(n_d)`` slots are split evenly, a contiguous run each, over
    the distinct cards of its shards (d, 0) and (d, 1), in that order; a
    card's items are its slots data block by data block, the fold's items
    (``model_fit_plan``) of those slots; its block k takes items k,
    k + blocks, ...; its x tiles stay resident by ``fit_shared_plan`` over
    ``fold_work_bytes``."""
    if not 1 <= len(rows) <= MAX_DATA:
        raise ValueError(f"K5b's cards route takes 1 to {MAX_DATA} data "
                         f"blocks, got {len(rows)}")
    if len(cards_of_shards) != MODEL * len(rows):
        raise ValueError(f"{len(cards_of_shards)} shards for {len(rows)} "
                         f"data blocks: {MODEL} a block")
    cards = max(cards_of_shards) + 1
    if sorted(set(cards_of_shards)) != list(range(cards)):
        raise ValueError(f"cards {sorted(set(cards_of_shards))}: every card "
                         f"0 .. C - 1 holds a shard")
    if cards > MAX_CARDS:
        raise ValueError(f"at most {MAX_CARDS} cards, got {cards}")
    offsets = shard_slot_offsets(rows)
    pf = half_slot_floats(f)
    runs = [[(0, 0)] * len(rows) for _ in range(cards)]
    for d, n in enumerate(rows):
        holders = list(dict.fromkeys(cards_of_shards[MODEL * d:
                                                     MODEL * (d + 1)]))
        ga = fit_slots(n)
        for pos, c in enumerate(holders):
            runs[c][d] = (pos * ga // len(holders),
                          (pos + 1) * ga // len(holders))
    items, resident, smem = [], [], []
    for c in range(cards):
        mine = [ModelItem(d, b, offsets[d] + b, tuple(
            range(b, -(-rows[d] // FIT_ROWS), fit_slots(rows[d]))), tuple(
            half_slot_at(rows, f, d, m) + b * pf for m in range(MODEL)))
            for d in range(len(rows)) for b in range(*runs[c][d])]
        per = [mine[k::blocks] for k in range(blocks)]
        most = max(sum(len(it.tiles) for it in block) for block in per)
        r, sm = fit_shared_plan(most, f, fold_work_bytes(f))
        items.append(per)
        resident.append(r)
        smem.append(sm)
    return CardsFitPlan(runs, items, resident, smem)


def cards_allocator_ok() -> bool:
    """Whether PyTorch's CUDA allocator hands out memory that peer access
    covers, as the cards route needs of its scratch and its flags:
    cudaMalloc, the caching allocator's default.  Not under
    ``expandable_segments`` (segments mapped with cuMemMap, which peers
    reach only after cuMemSetAccess) nor the ``cudaMallocAsync`` backend
    (pools, which need cudaMemPoolSetAccess), as
    PYTORCH_CUDA_ALLOC_CONF (or PYTORCH_ALLOC_CONF) sets them."""
    opts = {}
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        for item in os.environ.get(var, "").replace(" ", "").split(","):
            key, _, value = item.partition(":")
            opts[key] = value
    return (opts.get("expandable_segments", "").lower() != "true"
            and opts.get("backend", "native") == "native")


def peered(a: torch.device, b: torch.device) -> bool:
    """Whether card a can reach card b's memory for the cards route: peer
    access between them, and an allocator whose memory it covers."""
    return cards_allocator_ok() and torch.cuda.can_device_access_peer(a, b)


def model_route(devices, peered_fn=peered) -> str:
    """K5b's route for shards on ``devices`` (one per shard), decided before
    any launch: all on one card, the fold (ROUTE_FOLD); on several cards,
    every ordered pair of which ``peered_fn(a, b)`` says can reach the
    other's memory, the cards route (ROUTE_CARDS: at most MAX_CARDS cards,
    more raise ``ValueError``); else the per-step route (ROUTE_STEPS)."""
    cards = list(dict.fromkeys(devices))
    if len(cards) == 1:
        return ROUTE_FOLD
    if not all(peered_fn(a, b) for a in cards for b in cards if a != b):
        return ROUTE_STEPS
    if len(cards) > MAX_CARDS:
        raise ValueError(f"K5b's cards route takes at most {MAX_CARDS} "
                         f"cards, got {len(cards)}")
    return ROUTE_CARDS


class _CardSet:
    """What persists between the launches over one set of cards: each
    card's flags (MAX_CARDS int64, one per sender; csrc/anomaly_cards.cuh)
    zeroed once and never reset, and the barriers they have counted
    (``epoch``)."""

    def __init__(self, cards):
        self.flags = [torch.zeros(MAX_CARDS, dtype=torch.int64, device=dev)
                      for dev in cards]
        for dev in cards:       # zeroed before any peer stores to them
            torch.cuda.synchronize(dev)
        self.epoch = 0


# Every cards-route launch, over whatever set of cards, is checked and
# enqueued under one lock, on a stream of the module's own on each card
# (``_cards_stream``), which nothing else uses.  So the launches on every
# card run in the order of the lock: two sets that share cards never reach
# those cards in opposite orders and spin on each other.  Each of a set's
# launches waits for the work enqueued on EVERY card's current stream
# before the call, and each current stream waits for its card's launch
# after it.  So no work that another thread enqueues between two of the
# set's launches (a copy between cards makes one card's stream wait for
# another's) can hold one card's launch back while a peer's spins.
_cards_lock = threading.Lock()
_CARD_SETS: dict[tuple[torch.device, ...], _CardSet] = {}
_cards_streams: dict[torch.device, torch.cuda.Stream] = {}


def _cards_stream(dev: torch.device) -> torch.cuda.Stream:
    """The cards route's stream on ``dev``; called under ``_cards_lock``."""
    if dev not in _cards_streams:
        _cards_streams[dev] = torch.cuda.Stream(device=dev)
    return _cards_streams[dev]


def _card_set(cards) -> _CardSet:
    """The card set's state; called under ``_cards_lock``."""
    key = tuple(cards)
    if key not in _CARD_SETS:
        _CARD_SETS[key] = _CardSet(cards)
    return _CARD_SETS[key]


def _check_card_stamps(stamps, cards, steps: int) -> None:
    if len(stamps) != len(cards):
        raise ValueError(f"stamps of the cards route: one tensor per card, "
                         f"{len(cards)}, got {len(stamps)}")
    for t, dev in zip(stamps, cards):
        if (t.dim() != 3 or tuple(t.shape[:2]) != (steps, CARDS_STAMPS)
                or t.dtype != torch.int64 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"stamps on {dev} must be a contiguous int64 "
                             f"[{steps}, {CARDS_STAMPS}, blocks] tensor "
                             f"there")


def _fit_model_cards(sets, xs, noises, rows, f, *, lr, sigma, scratch,
                     losses_out, stamps) -> None:
    """The cards route of K5b's fit: one ``anomaly_fit_model_cards`` launch
    on each card, on the route's own stream there, ordered after every
    card's current stream and before its own card's (``_cards_lock``),
    checked on every card (the peer access, the grid) before any of them
    launches.  ``scratch`` (home's, at least
    ``cards_scratch_floats``) None allocates it; the others' are
    allocated here."""
    cards = list(dict.fromkeys(x.device for x in xs))
    index = {dev: c for c, dev in enumerate(cards)}
    need = cards_scratch_floats(rows, f)
    scratches = [torch.empty(need, dtype=torch.float32, device=dev)
                 if c or scratch is None else scratch
                 for c, dev in enumerate(cards)]
    _check_slots(scratches[0], cards[0], need, "scratch")
    at = 4 * cards_slots_at(f)
    shard_cards = (ctypes.c_longlong * len(xs))(*(index[x.device]
                                                  for x in xs))
    source = {}     # half m: a params set of it, the first in shard order
    for s, x in enumerate(xs):
        source.setdefault(s % MODEL, sets[(x.device, s % MODEL)])
    args = []
    for c, dev in enumerate(cards):
        table = []
        for d, n in enumerate(rows):
            mine = [s for s in range(MODEL * d, MODEL * (d + 1))
                    if xs[s].device == dev]
            if mine:
                nz = noises[mine[0]]
                table += [xs[mine[0]].data_ptr(), nz.data_ptr(),
                          nz.stride(0), n]
            else:
                table += [0, 0, 0, n]
        halves, sources = [], []    # a half held here, or where from
        for m in range(MODEL):
            own = sets.get((dev, m))
            halves += [p.data_ptr() for p in own] if own else [0] * 4
            sources += [0] * 4 if own else [p.data_ptr() for p in source[m]]
        args.append((
            (ctypes.c_longlong * len(table))(*table), len(rows), shard_cards,
            (ctypes.c_longlong * len(halves))(*halves),
            (ctypes.c_longlong * len(sources))(*sources)))
    tail = [(scratches[c].data_ptr(), need,
             losses_out.data_ptr() if c == 0 else 0, lr, f,
             noises[0].shape[0], 0 if stamps is None else stamps[c].data_ptr(),
             0 if stamps is None else stamps[c].numel())
            for c in range(len(cards))]
    fn = kernel(FIT_MODEL_CARDS)
    with _cards_lock:
        state = _card_set(cards)
        peers = (ctypes.c_longlong * (3 * len(cards)))(*(
            v for dev, sc, fl in zip(cards, scratches, state.flags)
            for v in (dev.index, sc.data_ptr() + at, fl.data_ptr())))
        for c, dev in enumerate(cards):       # every check, no launch
            with torch.cuda.device(dev):
                err = fn(*args[c], peers, len(cards), c, state.epoch, sigma,
                         *tail[c], 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{FIT_MODEL_CARDS} on {dev}: "
                                   f"cudaError_t {err} "
                                   f"({torch.cuda.get_device_name(dev)})")
        ready = [torch.cuda.Event() for _ in cards]
        for dev, ev in zip(cards, ready):
            ev.record(torch.cuda.current_stream(dev))
        done = [torch.cuda.Event() for _ in cards]
        for c, dev in enumerate(cards):
            stream = _cards_stream(dev)
            for ev in ready:
                stream.wait_event(ev)
            with torch.cuda.device(dev):
                _launched(FIT_MODEL_CARDS, fn(*args[c], peers, len(cards), c,
                                              state.epoch, sigma, *tail[c], 1,
                                              stream.cuda_stream))
            done[c].record(stream)
        for dev, ev in zip(cards, done):
            torch.cuda.current_stream(dev).wait_event(ev)
        state.epoch += noises[0].shape[0] + 2


def fit_model_(halves, xs, noises, *, lr: float, sigma: float,
               losses_out: torch.Tensor,
               scratch: torch.Tensor | None = None,
               stamps=None, route: str | None = None) -> None:
    """K5b, in place: the whole fit over the shards as ``fit_model_step_``
    lays them out, one denoising step for each step of the noise shards
    (``noises[s]`` is shard s's [steps, n_s, F], each step's rows
    contiguous).  Writes each step's loss (before its update) to
    ``losses_out[step]`` on the first shard's device.  ``scratch``
    (float32, 16-byte aligned, on the first shard's device: at least
    ``model_scratch_floats(rows, F)``, on the cards route
    ``cards_scratch_floats``) None allocates it.

    The route (``route``, else ``model_route`` of the shards' devices and
    their peer access) is decided before any launch: all the shards on one
    CUDA device, one ``anomaly_fit_model_fit`` launch (the fold: at most
    ``MAX_DATA`` data blocks; its work items ``model_fit_plan``); shards
    on several cards with peer access between every pair, one
    ``anomaly_fit_model_cards`` launch on each card (at most ``MAX_CARDS``
    cards; items ``cards_fit_plan``), at whose end every card holds both
    halves' updated params (a half it has no set of only in its scratch,
    which for every card but the first is allocated here and freed when
    the call returns); else the per-step route.  The CPU takes
    ``reference.fit_model_shard`` whatever the route.  Every kernel route
    gives the same bits.  ``route`` (ROUTE_CARDS or ROUTE_STEPS) forces a
    route so that one can be held against another on the same shards:
    ROUTE_CARDS also runs the cards route with the shards on one card (one
    participating card), which the fit on one card never takes by itself.
    The port's own callers leave it None.  ``stamps`` asks
    for a trace of the phases: on the fold an int64 [steps, FIT_STAMPS,
    the SM count] tensor (``csrc/anomaly_fit_model.cu``), on the cards
    route one int64 [steps, CARDS_STAMPS, the SM count] tensor per card, in
    the order of the cards' first shards."""
    if not noises or noises[0].dim() != 3:
        raise ValueError("noises must hold one [steps, n_s, F] tensor per "
                         "shard")
    steps = noises[0].shape[0]
    rows, f, sets = _check_model(halves, xs, noises, steps)
    home = xs[0].device
    if (losses_out.dim() != 1 or losses_out.numel() != steps
            or losses_out.dtype != torch.float32
            or losses_out.device != home):
        raise ValueError(f"losses_out must hold {steps} float32 losses on "
                         f"{home}")
    if route not in (None, ROUTE_CARDS, ROUTE_STEPS):
        raise ValueError(f"unknown route {route!r}: None (the layout's), "
                         f"{ROUTE_CARDS!r} or {ROUTE_STEPS!r}")
    devices = [x.device for x in xs]
    cards = list(dict.fromkeys(devices))
    if home.type == "cpu":
        route = ROUTE_FOLD      # checked as the fold; run by the reference
    elif route is None:
        route = model_route(devices)
    elif (route == ROUTE_CARDS and len(cards) > 1
          and model_route(devices) != ROUTE_CARDS):
        raise ValueError("the cards route needs peer access between every "
                         "pair of cards")
    if route != ROUTE_STEPS and len(rows) > MAX_DATA:
        raise ValueError(f"at most {MAX_DATA} data blocks in one launch, "
                         f"got {len(rows)}")
    if route == ROUTE_CARDS and len(cards) > MAX_CARDS:
        raise ValueError(f"K5b's cards route takes at most {MAX_CARDS} "
                         f"cards, got {len(cards)}")
    if stamps is not None:
        if home.type == "cpu":
            raise ValueError("stamps trace a kernel on a card")
        if route == ROUTE_FOLD:
            _check_stamps(stamps, steps, home)
        elif route == ROUTE_CARDS:
            _check_card_stamps(stamps, cards, steps)
        else:
            raise ValueError("stamps trace a one-launch fit: the fold or "
                             "the cards route")
    if steps == 0:
        return
    if home.type == "cpu":
        new, losses = reference.fit_model_shard(
            [sets[(home, m)] for m in range(MODEL)], xs[::MODEL],
            noises[::MODEL], lr, sigma)
        _copy_halves(sets, new)
        losses_out.copy_(losses)
        return
    if route == ROUTE_CARDS:
        _fit_model_cards(sets, xs, noises, rows, f, lr=lr, sigma=sigma,
                         scratch=scratch, losses_out=losses_out,
                         stamps=stamps)
        return
    scratch = _model_scratch(scratch, home, rows, f)
    if route == ROUTE_STEPS:
        _fit_model_steps(sets, xs, noises, rows, f, lr=lr, sigma=sigma,
                         scratch=scratch, losses_out=losses_out)
        return
    fn = kernel(FIT_MODEL)
    table, hv = _fold_tables(sets, xs, noises, rows, home)
    with torch.cuda.device(home):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table, len(rows), hv, sigma, scratch.data_ptr(),
                 scratch.numel(), losses_out.data_ptr(), lr, f, steps,
                 0 if stamps is None else stamps.data_ptr(),
                 0 if stamps is None else stamps.numel(), stream)
    _launched(FIT_MODEL, err)
