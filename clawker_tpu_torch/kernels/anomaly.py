"""Wrappers of the anomaly kernels: K1 (score), K2 (fit step), K3 (fit) and
K5 (the fit over rows split into shards: one launch per fit on one card,
or the per-step route of S + 1 launches a step).

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
LAUNCHES = {SCORE: 0, FIT_STEP: 0, FIT: 0, FIT_SHARD: 0,
            FIT_SHARD_PARTIALS: 0, FIT_SHARD_REDUCE: 0}


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


def fit_shared_plan(per_block: int, f: int) -> tuple[int, int]:
    """The x tiles a block of K3 or of K5's one-launch fit keeps resident
    when the most tiles any block walks in a step is ``per_block``, and
    the launch's shared bytes (csrc/anomaly_fit_persistent.cuh,
    shared_plan): all of them while the working set, the tiles and two
    noise tiles fit in ``MAX_SMEM``; else 0, one tile reloaded at each
    tile.  K3 walks ceil(ceil(n / 32) / fit_slots(n)) tiles a block."""
    base = work_bytes(f) + 2 * tile_bytes(f)
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
