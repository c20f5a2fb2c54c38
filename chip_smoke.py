#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card: every phase below
    python3 chip_smoke.py --cards    # several cards: the multi-card
                                     # paths alone (``cards_phase``)

1. Prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``clawker_tpu_torch/kernels/csrc`` into ``build/kernels/``.
2. Kernel phase: K1 (score), K2 (fit step) and K3 (the whole fit, one
   launch) against their plain PyTorch versions on the card, at the main
   path's shapes, one ragged n, fewer rows than one K2 tile, more K2
   tiles than blocks and one odd F for each width K2 pads F to (16, 64),
   with the tolerances below; each K2 fit also beside the plain fit on
   the CPU, the drift that summation order alone gives; two K2 fits, and
   two K3 fits, from the same inputs must agree bit for bit, and K3 bit
   for bit with the loop of K2 launches; each kernel's median time beside
   its bound, and K1's beside the launch floor (an empty kernel in the
   same harness).  Two K1 scores from the same inputs must agree bit for
   bit, and K1's mean score must agree with K2's noise-free step-0 loss
   within STEP1_LOSS_RTOL.  K2's first step's slots, summed, must agree
   with the plain fp32 sums of the unrounded gradients
   (``reference.step_grads``) within SLOT_SUM_RTOL.  K3's staged weights
   must equal their plain version (``reference.staged``) bit for bit,
   and at RELOAD_SHAPE, too large for its x tiles to stay in shared
   memory, K3 must still be bit-identical to K2's loop.  At OPT_IN_SHAPE
   K1, K2 and K3 run on every visible device, each of which opts in to
   more than 48 KB of shared memory on its own.  The three kernels'
   registers and spills as ptxas reports them (spills must be 0).
3. Main-path phase, at full width (F = 32 / 40, H = 128): ``score_windows``
   on the bench's synthetic fleet ([640, 32] padded) and on an hour of a
   64-agent fleet ([4224, 32]), 120 fit steps each; the sentinel's
   ``ScoringEngine.score_tick`` on the 64-agent fused tick ([384, 40],
   40 steps) three times; a seeded exfil agent must score hottest.  The
   kernels' launch counters are zeroed before and read after each run:
   every fit is one K3 launch and no K2 launch.  Each case prints its
   fit's ``train_ms``, the host's enqueue time per fit (no synchronize
   inside) and its parts, K3's device time per fit beside its bound, its
   phase trace (the step's phases, and phase A's sub-stages), and the
   noise draw's (K4) device time beside its bound.
4. Sentinel phase, the live ``FleetSentinel`` on the card (F = 40),
   its streams under ``build/chip_smoke/sentinel/``: (a) the 64-agent
   fused tick over four worker files ([384, 40], 40 steps): the first
   tick scores every window, an idle tick launches nothing, a seeded
   exfil burst on one worker flags within two ticks with that worker and
   kind ``egress``, through a typed ``anomaly.flag`` bus event and the
   registry, and the state file resumes a fresh sentinel; (b) a full
   collector buffer (98,304 records, [4224, 40]), three scored ticks;
   (c) the flag latency of the reference bench's scenario
   (bench.py:2376-2440), live on the ticking thread, 5 reps, each flag
   within 10 s.  Every tick runs through ``_counted``: one K3 and one
   K1 launch per scored tick, none per idle tick, no ``on_error``
   message.  Prints each stage's host ms of a tick at (a) and (b), and
   the flag latency's p50 and max.
5. K5 (the fit over rows split into shards): the per-step route (a launch
   A per shard and a launch B a step) one step against its plain version
   at every KERNEL_SHAPES entry over 2 and 4 shards; the one-launch fit
   (``anomaly_fit_shard_fit``, the route of every fit whose shards lie on
   one card) bit for bit against the per-step route at every
   KERNEL_SHAPES entry over 1, 2, 4 and 8 shards, on both fleets, and at
   RELOAD_SHAPE over 2 shards (x not resident), bit for bit against K3
   over 1 shard, twice the same bits, and against the plain sharded fit
   at K3's tolerances; its time per 120-step fit on both fleets over 1,
   2, 4 and 8 shards beside the per-step route's and K3's, with its phase
   trace over 4 and 8 shards; the sharded main path (the hour over 4
   shards of the card) is one K5 launch and 4 K1 launches.  The graft
   entry (``entry``, ``dryrun_multichip(8)``: the per-step route, counted)
   and ``bench_lane`` on the card.
6. CLI phase: ``python -m clawker_tpu_torch monitor anomalies`` in a
   subprocess must exit 0 and report a CUDA device;
   ``python -m clawker_tpu_torch fleet anomaly`` on two workers' streams
   that hold a hot agent must exit 2 and flag it with kind ``egress``.

Any failure exits non-zero.  Without a GPU, or without the repository
beside it, the script fails before printing any result.  The last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
the line before it the per-kernel JSON record.  Imports nothing of JAX
or of the reference package.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over HBM_BPS and its products over their type's rate
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
HIDDEN = 128

# Tolerances, kernel against plain version on the same card and inputs.
# Both sides round at the same points; they differ in summation order
# (fp32, ~1e-7 relative) and in tanh (a few ulp), which now and then tips
# a bf16 rounding of an activation or a weight gradient by one bf16 ulp.
SCORE_RTOL = 1e-3       # score: a tipped bf16(g) moves r by ~2^-9 |g w|
SCORE_ATOL = 1e-6
STEP1_PARAM_ATOL = 1e-5   # one step: a tipped bf16 gradient moves a
STEP1_LOSS_RTOL = 1e-5    # param by lr * 2^-8 |g| ~ 1e-6
FIT_PARAM_ATOL = 1e-4   # 120 steps: such tips accumulate, SGD does not
FIT_LOSS_RTOL = 1e-4    # amplify them (measured ~5e-6 CPU vs JAX)
# Every step's loss is also held against the plain loss of the kernel's
# own params, at FIT_LOSS_RTOL: the tensor cores' accumulation behaves
# like rounding toward zero, which now and then tips one bf16(g), and
# one tip moved a loss by 3.1e-5 at [100, 32] on an H100.  That check
# covers the loss output at every F; the one against the plain fit also
# covers the params' drift.  F < 16: the fit drives the loss to ~7% of
# its start (3.08 -> 0.22 at [130, 7]), so the same drift of the params
# (< 1e-5) moves the late losses by more of it: 3.0e-4 at [130, 7] on an
# H100, where two round-to-nearest fits (the plain one on the CPU and on
# the card, printed for each shape) drifted 3.7e-5.
NARROW_FIT_LOSS_RTOL = 1e-3
NARROW_F = 16
# One K2 step's slots, summed, against the plain fp32 sums of the same
# bf16 operands and unrounded fp32 cotangent (``reference.step_grads``):
# the larger normwise relative error of dW_enc and dW_dec.  It holds the
# backward's exact split of the cotangent (Split3), which the limits
# above barely see: a cotangent rounded to bf16 moves a param by about
# lr x 2^-8 |g| a step.  On an H100 the sound kernel read 2.5e-6 to
# 4.2e-5 over KERNEL_SHAPES; with Split3 cut to its hi term, 2.0e-3 at
# [100, 32], where every other check passed (only STEP1_PARAM_ATOL at
# [130, 7] failed, by 2x).
SLOT_SUM_RTOL = 3e-4

# (n, F): the main path pads rows to multiples of 128 -- the sentinel tick
# to [384, 40], the bench fleet to [640, 32], the hour of 64 agents to
# [4224, 32] -- beside round sizes, one ragged n that masks rows, fewer
# rows than one K2 tile (100), more K2 tiles than blocks (8192), and an
# odd F for the widths K2 pads F to that the main path does not take
# (7 -> 16, 61 -> 64; 32 and 40 -> 48 are the main path's)
KERNEL_SHAPES = [(100, 32), (130, 7), (200, 40), (256, 40), (260, 61),
                 (384, 40), (512, 32), (640, 32), (4096, 32), (4224, 32),
                 (8192, 32)]
# K3 keeps a block's x tiles in shared memory while they fit (up to 12
# tiles a block at F padded to 64: n <= 50688); one more row makes every
# block reload its tiles, the path this shape holds against K2
RELOAD_SHAPE = (50689, 61)
RELOAD_STEPS = 4
# F = 61 pads to 64, where K1, K2 and K3 all need more than 48 KB of
# shared memory: every device opts in to it on its own
OPT_IN_SHAPE = (260, 61)
TIMED_SHAPE = (4224, 32)
FIT_STEPS = 120
SPIN_CYCLES = 1_000_000   # ~0.5 ms: covers the host's enqueue in event_ms
# The live sentinel (sentinel_phase): its fit steps per tick, and the
# flag-latency scenario of the reference bench (bench.py:2376-2440)
SENTINEL_STEPS = 40
FLAG_REPS = 5
FLAG_DEADLINE_S = 10.0
# K5, the fit over rows split into shards: the shard counts of the
# per-step route's step held against its plain version at KERNEL_SHAPES,
# of the fit held against K3 on the two fleets, of the one-launch fit held
# against the per-step route (KERNEL_SHAPES, both fleets) and timed, and of
# its phase trace; RELOAD_SHAPE over RELOAD_SHARDS shards is too large for
# x to stay resident; the main path's sharded run uses MAIN_PATH_SHARDS
# shards (2x2)
SHARD_SOURCE = "anomaly_fit_shard"
SHARD_COUNTS = (2, 4)
MESH_SHARDS = (2, 4, 8)
TIMED_SHARDS = (1, 2, 4, 8)
TRACED_SHARDS = (4, 8)
RELOAD_SHARDS = 2
MAIN_PATH_SHARDS = 4
# K5's fit against K3's on the same inputs: the same function, but the
# slots group the rows otherwise where a shard's rows are not whole tiles
# (8 shards of 640 or 4224 rows), and the other order of the fp32 sums
# now and then tips a bf16 rounding of a weight gradient, as JAX's and
# the port's fits differ: the scores at tests/test_torch_runtime.py's
# FIT_RTOL / FIT_ATOL and the losses at its FIT_LOSS_RTOL, the limits that
# hold the port's fit against JAX's; the params at FIT_PARAM_ATOL
MESH_SCORE_RTOL = 5e-3
MESH_SCORE_ATOL = 1e-5
MESH_LOSS_RTOL = 1e-3


def synth_egress_records(agents: int = 8, windows: int = 64,
                         per_window: int = 40) -> list[dict]:
    """Deterministic synthetic netlogger stream: `agents` containers with
    plausible verdict/port mixes across `windows` minutes (a copy of
    bench.py's generator)."""
    verdicts = ["ALLOW", "ALLOW", "ALLOW", "REDIRECT", "DENY"]
    reasons = {"ALLOW": "ROUTE", "REDIRECT": "ROUTE", "DENY": "NO_DNS_ENTRY"}
    base = 1_700_000_000
    out = []
    for a in range(agents):
        for w in range(windows):
            for i in range(per_window):
                ts = base + w * 60 + (i * 7) % 60
                v = verdicts[(a + w + i) % len(verdicts)]
                out.append({
                    "@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                time.gmtime(ts)),
                    "service": "ebpf-egress",
                    "container": f"clawker.loop-{a}",
                    "dst_ip": f"198.51.100.{(a * 13 + i) % 250}",
                    "dst_port": [443, 443, 80, 53, 8443][(w + i) % 5],
                    "proto": 6 if i % 5 else 17,
                    "verdict": v,
                    "reason": reasons[v],
                    "zone": f"z{(a + i) % 6}.example.com",
                })
    return out


def exfil_burst(agent: str, window: int, n: int = 55) -> list[dict]:
    """One agent suddenly sprays denies at many hosts on odd ports."""
    start = 1_700_000_000 + window * 60
    return [{"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime(start + i % 59)),
             "service": "ebpf-egress", "container": agent,
             "dst_ip": f"203.0.113.{i}", "dst_port": 4444 + i, "proto": 6,
             "verdict": "DENY", "reason": "NO_DNS_ENTRY", "zone": ""}
            for i in range(n)]


def benign_window(agent: str, window: int, n: int) -> list[dict]:
    """``n`` ordinary records of one agent in one more minute."""
    start = 1_700_000_000 + window * 60
    return [{"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime(start + i % 59)),
             "service": "ebpf-egress", "container": agent,
             "dst_ip": f"198.51.100.{i % 250}", "dst_port": 443, "proto": 6,
             "verdict": "ALLOW", "reason": "ROUTE", "zone": "z0.example.com"}
            for i in range(n)]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing


def cuda_ms(fn, *, batches: int = 15, per_batch: int = 20) -> float:
    """Median device time per call of ``fn``: ``per_batch`` calls are
    captured in one CUDA graph (after a warm-up), and CUDA events time
    each replay, so the card runs the calls back to back and the host's
    dispatch of them is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    del graph
    return statistics.median(times)


def event_ms(fn, *, reps: int = 15) -> float:
    """Median device time of one call of ``fn`` by CUDA events, for calls
    too long or too many-launched to capture in a graph (K3's fit, the
    plain fit, the noise draw).  A spin kernel keeps the card busy while
    the host enqueues the events and the call, so the host's dispatch of a
    one-launch call is not in its time; a call whose host work outlasts
    the spin (the plain fit's thousands of launches) is timed with it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, *, reps: int = 200) -> float:
    """Median wall time per call of ``fn`` as the host sees it, each call
    synchronized: dispatch, launch and device time together."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def score_bound(n: int, f: int) -> tuple[float, str]:
    """Least time of K1: x in, weights in, one score per row out; the two
    products (bf16 operands) at the bf16 tensor rate."""
    nbytes = 4 * (n * f + 2 * f * HIDDEN + HIDDEN + f + n)
    ops = 4 * n * f * HIDDEN
    return _bound(nbytes / HBM_BPS, ops / BF16_FLOPS)


def step_flops(n: int, f: int) -> int:
    """bf16 tensor-core flops of one fit step: the two forward products
    (4 nFH) and the three backward ones.  Each backward product multiplies
    the fp32 cotangent unrounded, which the tensor cores take as three
    bf16 terms whose sum is exact: 18 nFH (at the fp32 rate, 6 nFH would
    take 4.9x as long)."""
    return (4 + 18) * n * f * HIDDEN


def fit_step_bound(n: int, f: int) -> tuple[float, str]:
    """Least time of K2: x and noise in, params in and out, the loss out;
    ``step_flops`` at the bf16 rate."""
    params = 2 * f * HIDDEN + HIDDEN + f
    nbytes = 4 * (2 * n * f + 2 * params + 1)
    return _bound(nbytes / HBM_BPS, step_flops(n, f) / BF16_FLOPS)


def fit_bound(n: int, f: int, steps: int,
              extra_bytes: int = 0) -> tuple[float, str]:
    """Least time of K3: x in once, each step's noise in once, the params
    in and out once, one loss per step out (and ``extra_bytes``); ``steps``
    x ``step_flops`` at the bf16 rate."""
    params = 2 * f * HIDDEN + HIDDEN + f
    nbytes = 4 * (n * f + steps * n * f + 2 * params + steps) + extra_bytes
    return _bound(nbytes / HBM_BPS, steps * step_flops(n, f) / BF16_FLOPS)


def noise_bound(n: int, f: int, steps: int) -> tuple[float, str]:
    """Least time of the noise draw (K4): steps x n x F floats written."""
    return _bound(4 * steps * n * f / HBM_BPS, 0.0)


def _bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# ------------------------------------------------------------ kernel phase


def _inputs(n: int, f: int, steps: int, device, seed: int):
    import torch

    from clawker_tpu_torch.analytics import anomaly

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((n, f), generator=gen).to(device)
    noises = torch.randn((steps, n, f), generator=gen).to(device)
    params = anomaly.AnomalyParams(*(
        p.to(device) for p in anomaly.init_params(gen, feat=f)))
    return params, x, noises


def _max_abs(a, b) -> float:
    return max(float((p - q).abs().max()) for p, q in zip(a, b))


def _close(got, want, *, rtol: float, atol: float = 0.0) -> tuple[bool, float]:
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def _rel(got, want) -> float:
    return float(((got - want).abs() / want.abs()).max())


def _slot_totals(slots, count: int, f: int):
    """The sum over the first ``count`` slots of a slot buffer, in fp64,
    unpacked: ((dW_enc [F, H], db_enc [H], dW_dec [H, F], db_dec [F]),
    the squared-error sum)."""
    from clawker_tpu_torch.kernels import anomaly as K

    fh = f * HIDDEN
    t = slots[:count * K.slot_floats(f)].view(
        count, K.slot_floats(f)).double().sum(0)
    return ((t[:fh].view(f, HIDDEN), t[fh:fh + HIDDEN],
             t[fh + HIDDEN:2 * fh + HIDDEN].view(f, HIDDEN).T,
             t[2 * fh + HIDDEN:2 * fh + HIDDEN + f]), t[-1])


def _slot_sum_err(params, x, noise, scratch, count: int | None = None
                  ) -> float:
    """A step from ``params`` left its slots at the start of ``scratch``
    (K2's fit_slots(n), or ``count`` of them): their sums of dW_enc and
    dW_dec (unrounded) against ``reference.step_grads``'s over all of x,
    as the larger normwise relative error."""
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = x.shape
    (got_enc, _, got_dec, _), _ = _slot_totals(
        scratch, K.fit_slots(n) if count is None else count, f)
    (dw_enc, _, dw_dec, _), _ = R.step_grads(*params, x, noise, 0.25)
    return max(float((g - w.double()).norm() / w.double().norm())
               for g, w in ((got_enc, dw_enc), (got_dec, dw_dec)))


def score_checks(params, x) -> tuple[float, float]:
    """K1 on ``params``: against the plain score; twice the same bits; its
    mean score against K2's noise-free step-0 loss (the two reconstruct
    alike).  -> (max abs error, the mean's relative error)."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = x.shape
    scores = K.score(params, x)
    ok, err = _close(scores, R.score(*params, x), rtol=SCORE_RTOL,
                     atol=SCORE_ATOL)
    check(ok, f"K1 score [{n},{f}] off by {err:.3g}")
    check(torch.equal(scores, K.score(params, x)),
          f"K1 [{n},{f}]: two scores from the same inputs differ")
    loss0 = torch.empty(1, device=x.device)
    K.fit_step_(tuple(p.clone() for p in params), x, None, lr=1e-2,
                sigma=0.0, loss_out=loss0)
    ok, lerr = _close(scores.double().mean(), loss0.double()[0],
                      rtol=STEP1_LOSS_RTOL)
    check(ok, f"K1 [{n},{f}]: mean score off K2's noise-free loss by "
              f"{lerr:.3g}")
    return err, lerr / float(loss0[0])


def kernel_phase(device) -> dict:
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    errs = {K.SCORE: 0.0, K.FIT_STEP: 0.0, K.FIT: 0.0}
    slot_max = 0.0
    score_loss_max = 0.0
    timings = {}
    for n, f in KERNEL_SHAPES:
        params, x, noises = _inputs(n, f, FIT_STEPS, device, seed=n + f)

        err, rel = score_checks(params, x)
        errs[K.SCORE] = max(errs[K.SCORE], err)
        score_loss_max = max(score_loss_max, rel)

        # K2: one step, then the whole fit, against the plain steps
        scratch = torch.empty(K.scratch_floats(n, f), device=device)
        kp = tuple(p.clone() for p in params)
        rp = tuple(p.clone() for p in params)
        k_loss = torch.empty(FIT_STEPS, device=device)
        r_loss = torch.empty(FIT_STEPS, device=device)
        own_loss = torch.empty(FIT_STEPS, device=device)
        for s in range(FIT_STEPS):
            _, own_loss[s] = R.fit_step(*kp, x, noises[s], 1e-2, 0.25)
            K.fit_step_(kp, x, noises[s], lr=1e-2, sigma=0.25,
                        loss_out=k_loss, step=s, scratch=scratch)
            rp, r_loss[s] = R.fit_step(*rp, x, noises[s], 1e-2, 0.25)
            if s == 0:
                torch.cuda.synchronize()
                slot_err = _slot_sum_err(params, x, noises[0], scratch)
                check(slot_err <= SLOT_SUM_RTOL,
                      f"K2 [{n},{f}] slot sums of step 1 off the plain fp32 "
                      f"sums by {slot_err:.3g} (normwise)")
                slot_max = max(slot_max, slot_err)
                err = _max_abs(kp, rp)
                check(err <= STEP1_PARAM_ATOL,
                      f"K2 [{n},{f}] params after 1 step off by {err:.3g}")
                ok, lerr = _close(k_loss[:1], r_loss[:1],
                                  rtol=STEP1_LOSS_RTOL)
                check(ok, f"K2 [{n},{f}] loss of step 1 off by {lerr:.3g}")
                errs[K.FIT_STEP] = max(errs[K.FIT_STEP], err)
        torch.cuda.synchronize()
        err = _max_abs(kp, rp)
        check(err <= FIT_PARAM_ATOL,
              f"K2 [{n},{f}] params after {FIT_STEPS} steps off by {err:.3g}")
        ok, lerr = _close(k_loss, own_loss, rtol=FIT_LOSS_RTOL)
        check(ok, f"K2 [{n},{f}] a step's loss off the plain loss of the "
                  f"kernel's own params by {lerr:.3g}")
        rtol = FIT_LOSS_RTOL if f >= NARROW_F else NARROW_FIT_LOSS_RTOL
        ok, lerr = _close(k_loss, r_loss, rtol=rtol)
        check(ok, f"K2 [{n},{f}] per-step losses off by {lerr:.3g}")
        errs[K.FIT_STEP] = max(errs[K.FIT_STEP], err)
        # the yardstick: the plain fit on the CPU against the one on the card
        cp = tuple(p.cpu() for p in params)
        c_loss = torch.empty(FIT_STEPS)
        for s in range(FIT_STEPS):
            cp, c_loss[s] = R.fit_step(*cp, x.cpu(), noises[s].cpu(), 1e-2,
                                       0.25)
        print(f"K2 [{n},{f}] after {FIT_STEPS} steps, off the plain fit on "
              f"the card: params {err:.3g}, losses {_rel(k_loss, r_loss):.3g} "
              f"relative (rtol {rtol}); the plain losses of the kernel's "
              f"own params {_rel(k_loss, own_loss):.3g} relative at most, "
              f"at step {int(((k_loss - own_loss).abs() / own_loss).argmax())}"
              f"; the plain fit on the CPU: "
              f"params {_max_abs(cp, [p.cpu() for p in rp]):.3g}, losses "
              f"{_rel(c_loss, r_loss.cpu()):.3g}; loss {float(r_loss[0]):.4g}"
              f" -> {float(r_loss[-1]):.4g}; step 1's slot sums off the "
              f"plain fp32 sums by {slot_err:.3g} (normwise)")

        # K2 is deterministic: the same fit again, bit for bit
        kq = tuple(p.clone() for p in params)
        q_loss = torch.empty(FIT_STEPS, device=device)
        for s in range(FIT_STEPS):
            K.fit_step_(kq, x, noises[s], lr=1e-2, sigma=0.25,
                        loss_out=q_loss, step=s, scratch=scratch)
        torch.cuda.synchronize()
        check(all(torch.equal(p, q) for p, q in zip(kp, kq))
              and torch.equal(k_loss, q_loss),
              f"K2 [{n},{f}]: two fits from the same inputs differ")

        # K3: the whole fit in one launch, bit for bit the loop of K2
        # launches, within K2's tolerances of the plain fit, and twice the
        # same
        fits = []
        for _ in range(2):
            fp = tuple(p.clone() for p in params)
            f_loss = torch.empty(FIT_STEPS, device=device)
            K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=f_loss,
                   scratch=scratch)
            torch.cuda.synchronize()
            fits.append((fp, f_loss))
        fp, f_loss = fits[0]
        off = (f_loss != k_loss).nonzero()
        check(all(torch.equal(p, q) for p, q in zip(fp, kp)) and not len(off),
              f"K3 [{n},{f}]: not bit-identical to {FIT_STEPS} K2 launches:"
              f" params {_max_abs(fp, kp):.3g} apart, first loss apart at "
              f"step {int(off[0]) if len(off) else None}")
        err = _max_abs(fp, rp)
        check(err <= FIT_PARAM_ATOL,
              f"K3 [{n},{f}] params after {FIT_STEPS} steps off by {err:.3g}")
        ok, lerr = _close(f_loss, r_loss, rtol=rtol)
        check(ok, f"K3 [{n},{f}] per-step losses off by {lerr:.3g}")
        errs[K.FIT] = max(errs[K.FIT], err)
        check(all(torch.equal(p, q) for p, q in zip(fp, fits[1][0]))
              and torch.equal(f_loss, fits[1][1]),
              f"K3 [{n},{f}]: two fits from the same inputs differ")
        # K3's staged weights (its prologue's layout, phase B's values) are
        # bit for bit their plain version built from the fitted params
        check(torch.equal(scratch[:K.staged_floats(f)].view(torch.int32),
                          R.staged(*fp).view(torch.int32)),
              f"K3 [{n},{f}]: the staged weights in its scratch are not "
              f"reference.staged of its params")

        # K1 again on the fitted params: the scores the lane reports
        ok, err = _close(K.score(kp, x), R.score(*kp, x),
                         rtol=SCORE_RTOL, atol=SCORE_ATOL)
        check(ok, f"K1 score [{n},{f}] on fitted params off by {err:.3g}")
        errs[K.SCORE] = max(errs[K.SCORE], err)

        # times: kernel and plain version on the same inputs
        tp = tuple(p.clone() for p in params)
        loss1 = torch.empty(1, device=device)
        calls = {
            K.SCORE: (lambda: K.score(params, x),
                      lambda: R.score(*params, x), score_bound(n, f)),
            K.FIT_STEP: (lambda: K.fit_step_(tp, x, noises[0], lr=1e-2,
                                             sigma=0.25, loss_out=loss1,
                                             scratch=scratch),
                         lambda: R.fit_step(*params, x, noises[0], 1e-2,
                                            0.25),
                         fit_step_bound(n, f)),
        }
        row = {}
        for name, (kernel_call, plain_call, (bound, by)) in calls.items():
            ms, plain = cuda_ms(kernel_call), cuda_ms(plain_call)
            row[name] = (ms, plain, bound, by)
            floor = ""
            if name == K.SCORE:   # an empty launch in the same harness
                floor = (f", launch floor "
                         f"{cuda_ms(lambda: torch.cuda._sleep(0)) * 1e3:.2f}"
                         f" us")
            print(f"kernel {name} [{n},{f}]: device {ms * 1e3:.2f} us, "
                  f"host per synchronized call "
                  f"{host_us(kernel_call):.2f} us (plain device "
                  f"{plain * 1e3:.2f} us, bound {bound * 1e3:.3f} us by {by}"
                  f"{floor})")
        # K3: one launch per fit, timed alone by events
        tq = tuple(p.clone() for p in params)
        losses = torch.empty(FIT_STEPS, device=device)

        def fit_call():
            K.fit_(tq, x, noises, lr=1e-2, sigma=0.25, losses_out=losses,
                   scratch=scratch)

        ms = event_ms(fit_call)
        plain = event_ms(lambda: R.fit(*params, x, noises, 1e-2, 0.25),
                         reps=5)
        bound, by = fit_bound(n, f, FIT_STEPS)
        row[K.FIT] = (ms, plain, bound, by)
        k2 = row[K.FIT_STEP][0]
        print(f"kernel {K.FIT} [{n},{f}]: device {ms:.4f} ms per "
              f"{FIT_STEPS}-step fit, {ms / FIT_STEPS * 1e3:.2f} us per step "
              f"({FIT_STEPS} x K2 {FIT_STEPS * k2:.4f} ms), host per "
              f"synchronized call {host_us(fit_call, reps=20):.2f} us (plain "
              f"fit {plain:.3f} ms, bound {bound:.4f} ms by {by})")
        timings[(n, f)] = row
    reload_check(device)
    print(f"kernel tolerances: score rtol {SCORE_RTOL} atol {SCORE_ATOL}; "
          f"fit step 1: params atol {STEP1_PARAM_ATOL}, loss rtol "
          f"{STEP1_LOSS_RTOL}; after {FIT_STEPS} steps: params atol "
          f"{FIT_PARAM_ATOL}, losses rtol {FIT_LOSS_RTOL} (F < {NARROW_F}: "
          f"{NARROW_FIT_LOSS_RTOL}), each step's loss rtol {FIT_LOSS_RTOL}"
          f" against the plain loss of the kernel's own params; step 1's "
          f"slot sums normwise rtol {SLOT_SUM_RTOL} (largest "
          f"{slot_max:.3g}); K1's mean score against K2's noise-free loss "
          f"rtol {STEP1_LOSS_RTOL} (largest {score_loss_max:.3g}); two K1 "
          f"scores and two K2 fits bit-identical at every shape; K3 at K2's "
          f"{FIT_STEPS}-step tolerances, bit-identical to the K2 loop and "
          f"to itself")
    print(f"kernel max abs err: {json.dumps(errs)}")
    return {"errs": errs, "timings": timings}


def reload_check(device) -> None:
    """K3 at RELOAD_SHAPE, where a block's x tiles do not fit in shared
    memory and it reloads them at each tile: bit for bit the loop of K2
    launches and itself, within K2's tolerances of the plain fit."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = RELOAD_SHAPE
    params, x, noises = _inputs(n, f, RELOAD_STEPS, device, seed=n + f)
    scratch = torch.empty(K.scratch_floats(n, f), device=device)
    kp = tuple(p.clone() for p in params)
    k_loss = torch.empty(RELOAD_STEPS, device=device)
    for s in range(RELOAD_STEPS):
        K.fit_step_(kp, x, noises[s], lr=1e-2, sigma=0.25, loss_out=k_loss,
                    step=s, scratch=scratch)
    rp, r_loss = R.fit(*params, x, noises, 1e-2, 0.25)
    fits = []
    for _ in range(2):
        fp = tuple(p.clone() for p in params)
        f_loss = torch.empty(RELOAD_STEPS, device=device)
        K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=f_loss,
               scratch=scratch)
        fits.append((fp, f_loss))
    torch.cuda.synchronize()
    (fp, f_loss), (fq, q_loss) = fits
    check(all(torch.equal(p, q) for p, q in zip(fp, kp))
          and torch.equal(f_loss, k_loss),
          f"K3 [{n},{f}] (x reloaded): not bit-identical to {RELOAD_STEPS} "
          f"K2 launches: params {_max_abs(fp, kp):.3g} apart")
    check(all(torch.equal(p, q) for p, q in zip(fp, fq))
          and torch.equal(f_loss, q_loss),
          f"K3 [{n},{f}] (x reloaded): two fits from the same inputs differ")
    err = _max_abs(fp, rp)
    check(err <= FIT_PARAM_ATOL,
          f"K3 [{n},{f}] (x reloaded) params off by {err:.3g}")
    ok, lerr = _close(f_loss, r_loss, rtol=FIT_LOSS_RTOL)
    check(ok, f"K3 [{n},{f}] (x reloaded) losses off by {lerr:.3g}")
    check(torch.equal(scratch[:K.staged_floats(f)].view(torch.int32),
                      R.staged(*fp).view(torch.int32)),
          f"K3 [{n},{f}] (x reloaded): staged weights off their plain "
          f"version")
    print(f"K3 [{n},{f}], x tiles reloaded, {RELOAD_STEPS} steps: "
          f"bit-identical to the K2 loop and to itself; off the plain fit: "
          f"params {err:.3g}, losses {_rel(f_loss, r_loss):.3g} relative")


def every_device_check() -> None:
    """K1, K2 and K3 at OPT_IN_SHAPE on every visible device, each against
    its plain version (K3 bit for bit against K2's loop): all three need
    more than 48 KB of shared memory there, which each device must be
    opted in to."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = OPT_IN_SHAPE
    for d in range(torch.cuda.device_count()):
        device = torch.device("cuda", d)
        params, x, noises = _inputs(n, f, 2, device, seed=n + f)
        ok, err = _close(K.score(params, x), R.score(*params, x),
                         rtol=SCORE_RTOL, atol=SCORE_ATOL)
        check(ok, f"K1 [{n},{f}] on {device}: off by {err:.3g}")
        kp = tuple(p.clone() for p in params)
        k_loss = torch.empty(2, device=device)
        for s in range(2):
            K.fit_step_(kp, x, noises[s], lr=1e-2, sigma=0.25,
                        loss_out=k_loss, step=s)
        rp, _ = R.fit(*params, x, noises, 1e-2, 0.25)
        fp = tuple(p.clone() for p in params)
        f_loss = torch.empty(2, device=device)
        K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=f_loss)
        torch.cuda.synchronize(device)
        err = _max_abs(kp, rp)
        check(err <= STEP1_PARAM_ATOL,
              f"K2 [{n},{f}] on {device}: params off by {err:.3g}")
        check(all(torch.equal(p, q) for p, q in zip(fp, kp))
              and torch.equal(f_loss, k_loss),
              f"K3 [{n},{f}] on {device}: not bit-identical to K2's loop")
        print(f"device {d} ({torch.cuda.get_device_name(d)}): K1, K2 and "
              f"K3 at [{n},{f}], each opted in above 48 KB, agree with "
              f"their plain versions")
    shard_cards_check()


def shard_cards_check() -> None:
    """K5 over the fleet mesh of every visible card, when there are
    several: every card's params the same bits, and those of the same
    shards on one card."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    cards = torch.cuda.device_count()
    if cards < 2:
        print("K5 over several cards: one card visible, not run")
        return
    n, f = TIMED_SHAPE
    params, x, noises = _inputs(n, f, 8, "cuda:0", seed=n + f)
    mesh = M.fleet_mesh()
    replicas = M.shard_params(tuple(p.clone() for p in params), mesh)
    losses = torch.empty(len(noises), device=x.device)
    K.fit_shard_(replicas, M.shard_rows(x, mesh), M.shard_noise(noises, mesh),
                 lr=1e-2, sigma=0.25, losses_out=losses)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    home = [p.cpu() for p in replicas[0]]
    check(all(torch.equal(p.cpu(), q) for r in replicas[1:]
              for p, q in zip(r, home)),
          f"K5 over {cards} cards: the cards' params differ")
    one_card = _shard_fit(params, x, noises, M.virtual_mesh(cards, "cuda:0"))
    check(all(torch.equal(p.cpu(), q) for p, q in zip(one_card[0], home))
          and torch.equal(one_card[1], losses),
          f"K5 over {cards} cards: not the bits of {cards} shards of one "
          f"card")
    print(f"K5 [{n},{f}] x{len(noises)} over the {mesh.desc} fleet mesh of "
          f"{cards} cards: every card's params the same bits, and those of "
          f"{cards} shards of cuda:0")


def ptxas_report(name: str) -> None:
    """Print ptxas's register and spill lines for ``name``'s kernels; any
    spill fails."""
    from clawker_tpu_torch.kernels import build

    log = build.build_log(name)
    check(bool(log), f"no nvcc log for {name}: it was not built here")
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print(f"ptxas {name}: {line.strip()}")
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", log)]
    check(bool(spills) and not any(spills),
          f"{name}: ptxas reports spills {spills}")


# ---------------------------------------------------------------- K5 phase


def plain_reduce(params, slots, count: int, n_total: int, f: int,
                 lr: float):
    """The plain version of K5's launch B: ``count`` slots summed, the
    update as ``reference.fit_step`` applies it.  -> (params, loss)."""
    from clawker_tpu_torch.kernels import reference as R

    grads, sq = _slot_totals(slots, count, f)
    new = R.sgd_update(params, tuple(g.float() for g in grads), lr)
    return new, sq.float() / (n_total * f)


def shard_bound(rows, f: int) -> tuple[tuple[float, str], tuple[float, str]]:
    """Least times of the per-step route's two launches: launch A of a
    shard of rows[0] rows (x and noise in, the params in, its slots out;
    the step's flops over its rows), and launch B over every shard's
    slots (the slots in, the params in and out, the loss out).  The fit
    itself, whatever implements it, is bound by ``fit_bound`` over all
    the rows."""
    from clawker_tpu_torch.kernels import anomaly as K

    params = 2 * f * HIDDEN + HIDDEN + f
    n = rows[0]
    a_bytes = 4 * (2 * n * f + params + K.fit_slots(n) * K.slot_floats(f))
    b_bytes = 4 * (K.shard_slot_floats(rows, f) + 2 * params + 1)
    return (_bound(a_bytes / HBM_BPS, step_flops(n, f) / BF16_FLOPS),
            _bound(b_bytes / HBM_BPS, 0.0))


def _shard_fit(params, x, noises, mesh, stamps=None):
    """K5's fit over ``mesh`` from a copy of ``params``, as ``fit_shard_``
    routes it (one launch when the shards lie on one card) -> (the first
    device's params, losses)."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    replicas = M.shard_params(tuple(p.clone() for p in params), mesh)
    losses = torch.empty(len(noises), device=x.device)
    K.fit_shard_(replicas, M.shard_rows(x, mesh), M.shard_noise(noises, mesh),
                 lr=1e-2, sigma=0.25, losses_out=losses, stamps=stamps)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    return replicas[0], losses


def _per_step_fit(params, x, noises, mesh):
    """K5's fit over ``mesh`` from a copy of ``params`` by the per-step
    route (a launch A per shard and a launch B each step), on any layout
    -> (the first device's params, losses)."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    replicas = M.shard_params(tuple(p.clone() for p in params), mesh)
    xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
    rows, f, by_dev = K._check_shards(replicas, xs, ns, len(noises))
    losses = torch.empty(len(noises), device=x.device)
    slots = torch.empty(K.shard_slot_floats(rows, f), device=x.device)
    K._fit_shard_steps(by_dev, xs, ns, rows, f, lr=1e-2, sigma=0.25,
                       slots=slots, losses_out=losses)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    return replicas[0], losses


def _k3_fit(params, x, noises):
    import torch

    from clawker_tpu_torch.kernels import anomaly as K

    fp = tuple(p.clone() for p in params)
    losses = torch.empty(len(noises), device=x.device)
    K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=losses)
    torch.cuda.synchronize()
    return fp, losses


def _same_fit(a, b) -> bool:
    import torch

    (pa, la), (pb, lb) = a, b
    return (all(torch.equal(p, q) for p, q in zip(pa, pb))
            and torch.equal(la, lb))


def _routes_agree(tag: str, params, x, noises, mesh) -> None:
    """The one-launch fit over ``mesh`` (one card) bit for bit the
    per-step route's, and twice the same bits."""
    one = _shard_fit(params, x, noises, mesh)
    per = _per_step_fit(params, x, noises, mesh)
    check(_same_fit(one, per),
          f"{tag}: the one-launch fit is not the per-step route's bits: "
          f"params {_max_abs(one[0], per[0]):.3g} apart, losses "
          f"{float((one[1] - per[1]).abs().max()):.3g}")
    check(_same_fit(one, _shard_fit(params, x, noises, mesh)),
          f"{tag}: two one-launch fits from the same inputs differ")


def shard_kernel_phase(device) -> dict:
    """K5 at every KERNEL_SHAPE: over SHARD_COUNTS shards of one card, the
    per-step route's step against its plain version (params and loss at
    the fit-step tolerances; the gathered slots' sums at SLOT_SUM_RTOL;
    launch B against the plain reduce of its own slots); over
    TIMED_SHARDS shards the one-launch fit bit for bit the per-step
    route's (``_routes_agree``), over one shard K3's, and over
    MAIN_PATH_SHARDS within K3's tolerances of the plain sharded fit.
    Then ``shard_reload_check``.  -> max abs errors per launch."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    errs = {K.FIT_SHARD: 0.0, K.FIT_SHARD_PARTIALS: 0.0,
            K.FIT_SHARD_REDUCE: 0.0}
    slot_max = 0.0
    for n, f in KERNEL_SHAPES:
        params, x, noises = _inputs(n, f, FIT_STEPS, device, seed=n + f)
        for shards in SHARD_COUNTS:
            mesh = M.virtual_mesh(shards, device)
            xs, ns = M.shard_rows(x, mesh), M.shard_rows(noises[0], mesh)
            rows = [len(t) for t in xs]
            total = K.shard_slot_offsets(rows)[-1]
            slots = torch.empty(K.shard_slot_floats(rows, f), device=device)
            kp = tuple(p.clone() for p in params)
            loss = torch.empty(1, device=device)
            K.fit_shard_step_([kp], xs, ns, lr=1e-2, sigma=0.25,
                              loss_out=loss, slots=slots)
            torch.cuda.synchronize()
            name = f"K5 [{n},{f}] over {shards} shards"
            rp, r_loss = R.fit_shard_step(*params, xs, ns, 1e-2, 0.25)
            err = _max_abs(kp, rp)
            check(err <= STEP1_PARAM_ATOL,
                  f"{name}: params after 1 step off by {err:.3g}")
            ok, lerr = _close(loss[0], r_loss, rtol=STEP1_LOSS_RTOL)
            check(ok, f"{name}: loss of step 1 off by {lerr:.3g}")
            # the gathered slots against the whole batch's unrounded
            # gradients, and launch B against the plain reduce of them
            slot_err = _slot_sum_err(params, x, noises[0], slots, total)
            check(slot_err <= SLOT_SUM_RTOL,
                  f"{name}: slot sums off the plain fp32 sums by "
                  f"{slot_err:.3g} (normwise)")
            slot_max = max(slot_max, slot_err)
            got, _ = _slot_totals(slots, total, f)
            want, _ = R.shard_step_grads(*params, xs, ns, 0.25)
            a_err = max(float((g - w.double()).abs().max())
                        for g, w in zip(got, want))
            pp, p_loss = plain_reduce(params, slots, total, n, f, 1e-2)
            b_err = _max_abs(kp, pp)
            check(b_err <= STEP1_PARAM_ATOL,
                  f"{name}: launch B off the plain reduce of its slots by "
                  f"{b_err:.3g}")
            ok, lerr = _close(loss[0], p_loss, rtol=STEP1_LOSS_RTOL)
            check(ok, f"{name}: launch B's loss off the plain one by "
                      f"{lerr:.3g}")
            errs[K.FIT_SHARD_PARTIALS] = max(errs[K.FIT_SHARD_PARTIALS],
                                             a_err)
            errs[K.FIT_SHARD_REDUCE] = max(errs[K.FIT_SHARD_REDUCE], err,
                                           b_err)
        for shards in TIMED_SHARDS:
            _routes_agree(f"K5 [{n},{f}] x{FIT_STEPS} over {shards} shards",
                          params, x, noises, M.virtual_mesh(shards, device))
        one = _shard_fit(params, x, noises, M.virtual_mesh(1, device))
        k3 = _k3_fit(params, x, noises)
        check(_same_fit(one, k3),
              f"K5 [{n},{f}] over 1 shard: not bit-identical to K3 after "
              f"{FIT_STEPS} steps: params {_max_abs(one[0], k3[0]):.3g} "
              f"apart")
        mesh = M.virtual_mesh(MAIN_PATH_SHARDS, device)
        sp, s_loss = _shard_fit(params, x, noises, mesh)
        rp, r_loss = R.fit_shard(*params, M.shard_rows(x, mesh),
                                 M.shard_noise(noises, mesh), 1e-2, 0.25)
        err = _max_abs(sp, rp)
        check(err <= FIT_PARAM_ATOL,
              f"K5 [{n},{f}] x{FIT_STEPS} over {MAIN_PATH_SHARDS} shards: "
              f"params off the plain sharded fit by {err:.3g}")
        rtol = FIT_LOSS_RTOL if f >= NARROW_F else NARROW_FIT_LOSS_RTOL
        ok, lerr = _close(s_loss, r_loss, rtol=rtol)
        check(ok, f"K5 [{n},{f}] x{FIT_STEPS} over {MAIN_PATH_SHARDS} "
                  f"shards: losses off the plain sharded fit by {lerr:.3g}")
        errs[K.FIT_SHARD] = max(errs[K.FIT_SHARD], err)
    shard_reload_check(device)
    print(f"K5 at {len(KERNEL_SHAPES)} shapes over {SHARD_COUNTS} shards of "
          f"one card: step 1's params (atol {STEP1_PARAM_ATOL}) and loss "
          f"(rtol {STEP1_LOSS_RTOL}) against the plain sharded step and "
          f"launch B against the plain reduce of its own slots; the "
          f"gathered slots' sums normwise rtol {SLOT_SUM_RTOL} (largest "
          f"{slot_max:.3g}); the one-launch fit over {TIMED_SHARDS} shards "
          f"bit-identical to the per-step route and to itself, over one "
          f"shard to K3, and over {MAIN_PATH_SHARDS} shards at K3's "
          f"{FIT_STEPS}-step tolerances of the plain sharded fit")
    print(f"K5 max abs err: {json.dumps(errs)}")
    return errs


def shard_reload_check(device) -> None:
    """K5's one-launch fit at RELOAD_SHAPE over RELOAD_SHARDS shards,
    where a block's x tiles (two items' worth) do not fit in shared
    memory and it reloads them at each tile: bit for bit the per-step
    route and itself, within K3's tolerances of the plain sharded fit."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = RELOAD_SHAPE
    params, x, noises = _inputs(n, f, RELOAD_STEPS, device, seed=n + f)
    mesh = M.virtual_mesh(RELOAD_SHARDS, device)
    rows = [len(t) for t in M.shard_rows(x, mesh)]
    plan = K.shard_fit_plan(
        rows, torch.cuda.get_device_properties(device).multi_processor_count,
        f)
    check(plan.resident_tiles == 0,
          f"K5 [{n},{f}] over {RELOAD_SHARDS} shards: planned resident")
    tag = f"K5 [{n},{f}] x{RELOAD_STEPS} over {RELOAD_SHARDS} shards"
    _routes_agree(f"{tag} (x reloaded)", params, x, noises, mesh)
    sp, s_loss = _shard_fit(params, x, noises, mesh)
    rp, r_loss = R.fit_shard(*params, M.shard_rows(x, mesh),
                             M.shard_noise(noises, mesh), 1e-2, 0.25)
    err = _max_abs(sp, rp)
    check(err <= FIT_PARAM_ATOL, f"{tag} (x reloaded) params off by "
                                 f"{err:.3g}")
    ok, lerr = _close(s_loss, r_loss, rtol=FIT_LOSS_RTOL)
    check(ok, f"{tag} (x reloaded) losses off by {lerr:.3g}")
    print(f"{tag}, x tiles reloaded ({K.shard_slot_offsets(rows)[-1]} "
          f"slots, {plan.smem} bytes of shared memory): the one-launch fit "
          f"bit-identical to the per-step route and to itself; off the "
          f"plain sharded fit: params {err:.3g}, losses "
          f"{_rel(s_loss, r_loss):.3g} relative")


def mesh_fit_phase(device) -> dict:
    """K5's fit of the two fleets' padded windows, drawn as
    ``_fit_and_score`` draws them (seed 0, FIT_STEPS steps), against K3's:
    over 1 shard bit for bit; over MESH_SHARDS shards twice the same
    bits, params within FIT_PARAM_ATOL, losses within MESH_LOSS_RTOL and
    the sharded score within MESH_SCORE_RTOL / MESH_SCORE_ATOL of K3's; the
    sharded score bit for bit K1's on the same params.  Over 1 and
    MESH_SHARDS shards the one-launch fit bit for bit the per-step
    route's.  Each fleet's ``shard_timings``.  -> the timings at
    TIMED_SHAPE."""
    import torch

    from clawker_tpu_torch.analytics import features as F
    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.analytics import runtime as art
    from clawker_tpu_torch.kernels import anomaly as K

    fleets = {
        "bench fleet": synth_egress_records(),
        "hour of 64 agents": synth_egress_records(agents=64, windows=64,
                                                  per_window=24),
    }
    timings = {}
    for name, records in fleets.items():
        _, X = F.featurize(records)
        data = M.virtual_mesh(max(MESH_SHARDS), device).data
        x = torch.from_numpy(art._pad_rows(X, X.shape[1], data)).to(device)
        n, f = x.shape
        params, noises = art._draw(0, FIT_STEPS, x)
        k3 = _k3_fit(params, x, noises)
        k3_scores = K.score(k3[0], x)
        check(_same_fit(_shard_fit(params, x, noises,
                                   M.virtual_mesh(1, device)), k3),
              f"K5 {name} [{n},{f}] over 1 shard: not bit-identical to K3")
        for shards in (1, *MESH_SHARDS):
            _routes_agree(f"K5 {name} [{n},{f}] over {shards} shards",
                          params, x, noises, M.virtual_mesh(shards, device))
        for shards in MESH_SHARDS:
            mesh = M.virtual_mesh(shards, device)
            tag = f"K5 {name} [{n},{f}] over {shards} shards"
            sp, s_loss = _shard_fit(params, x, noises, mesh)
            err = _max_abs(sp, k3[0])
            check(err <= FIT_PARAM_ATOL,
                  f"{tag}: params off K3's by {err:.3g}")
            ok, lerr = _close(s_loss, k3[1], rtol=MESH_LOSS_RTOL)
            check(ok, f"{tag}: losses off K3's by {lerr:.3g}")
            scores = M.score_shards(M.shard_params(sp, mesh),
                                    M.shard_rows(x, mesh))
            check(torch.equal(scores, K.score(sp, x)),
                  f"{tag}: the sharded score is not K1's bit for bit")
            ok, serr = _close(scores, k3_scores, rtol=MESH_SCORE_RTOL,
                              atol=MESH_SCORE_ATOL)
            check(ok, f"{tag}: scores off K3's by {serr:.3g}")
            print(f"{tag}: the one-launch fit is the per-step route's "
                  f"bits, twice the same; off K3's fit: params "
                  f"{err:.3g}, losses {_rel(s_loss, k3[1]):.3g} relative, "
                  f"scores {_rel(scores, k3_scores):.3g} relative (rtol "
                  f"{MESH_SCORE_RTOL}); the sharded score is K1's bit for "
                  f"bit")
        timings.update(shard_timings(params, x, noises))
    return timings


def _enqueue_us(fn, reps: int = 20) -> float:
    """Median host us to enqueue ``fn`` (the card idle, no synchronize
    inside the clock)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def shard_timings(params, x, noises) -> dict:
    """K5's time per fit at TIMED_SHARDS shards of one card beside K3's,
    all in this call: the one-launch fit's and K3's device time by
    ``event_ms`` (events behind a spin kernel) and the host's enqueue per
    fit; the per-step route's device time (the fit captured in one CUDA
    graph); at TIMED_SHAPE also the plain sharded fit's time, the
    one-launch fit's phase trace over TRACED_SHARDS shards beside K3's,
    and each per-step launch's device time, plain time and bound at
    MAIN_PATH_SHARDS shards.  -> {kernel: (ms, plain, bound, by)} at
    MAIN_PATH_SHARDS shards (empty off TIMED_SHAPE)."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = x.shape
    steps = len(noises)
    timed = (n, f) == TIMED_SHAPE
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    losses = torch.empty(steps, device=x.device)
    tq = tuple(p.clone() for p in params)

    def k3_fit():
        K.fit_(tq, x, noises, lr=1e-2, sigma=0.25, losses_out=losses)

    k3_ms, k3_enq = event_ms(k3_fit), _enqueue_us(k3_fit)
    bound, by = fit_bound(n, f, steps)
    out = {}
    for shards in TIMED_SHARDS:
        mesh = M.virtual_mesh(shards, x.device)
        xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
        rows = [len(t) for t in xs]
        scratch = torch.empty(K.shard_scratch_floats(rows, f),
                              device=x.device)
        replicas = [tuple(p.clone() for p in params)]
        by_dev = {x.device: replicas[0]}
        slots = scratch[K.staged_floats(f):]

        def fit():
            K.fit_shard_(replicas, xs, ns, lr=1e-2, sigma=0.25,
                         losses_out=losses, scratch=scratch)

        def per_step():
            K._fit_shard_steps(by_dev, xs, ns, rows, f, lr=1e-2, sigma=0.25,
                               slots=slots, losses_out=losses)

        ms, enq = event_ms(fit), _enqueue_us(fit)
        per_ms = cuda_ms(per_step, batches=5, per_batch=1)
        plain = ""
        if timed:
            plain_ms = event_ms(
                lambda: R.fit_shard(*params, xs, ns, 1e-2, 0.25), reps=3)
            plain = f"; plain sharded fit {plain_ms:.3f} ms (host-bound)"
            if shards == MAIN_PATH_SHARDS:
                out[K.FIT_SHARD] = (ms, plain_ms, bound, by)
        plan = K.shard_fit_plan(rows, sms, f)
        print(f"K5 [{n},{f}] x{steps} over {shards} shard(s) of one card: "
              f"one launch {ms:.4f} ms per fit (device), host enqueue "
              f"{enq:.2f} us per fit, {K.shard_slot_offsets(rows)[-1]} "
              f"items on {sms} blocks (at most "
              f"{max(map(len, plan.items))} a block, "
              f"{plan.resident_tiles} x tiles resident a block); per-step "
              f"route {per_ms:.4f} ms per fit (device, one CUDA graph), "
              f"{steps * (shards + 1)} launches; K3 {k3_ms:.4f} ms per fit, "
              f"host enqueue {k3_enq:.2f} us; bound {bound:.4f} ms by {by}"
              f"{plain}")
    if not timed:
        return out
    k3_split, k3_sub = phase_split(params, x, noises)
    print(f"K3 [{n},{f}] per step, mean us of the phase trace: phase A "
          f"{k3_split[0]:.2f}, barrier {k3_split[1]:.2f}, phase B "
          f"{k3_split[2]:.2f}, barrier {k3_split[3]:.2f}; phase A's "
          f"sub-stages " + ", ".join(f"{k} {v:.2f}"
                                     for k, v in zip(A_SUBSTAGES, k3_sub)))
    for shards in TRACED_SHARDS:
        mesh = M.virtual_mesh(shards, x.device)
        stamps = torch.zeros((steps, K.FIT_STAMPS, sms), dtype=torch.int64,
                             device=x.device)
        _shard_fit(params, x, noises, mesh, stamps=stamps)
        rows = [len(t) for t in M.shard_rows(x, mesh)]
        split, sub = _split(stamps, min(K.shard_slot_offsets(rows)[-1], sms))
        print(f"K5 [{n},{f}] over {shards} shards per step, mean us of the "
              f"phase trace: phase A {split[0]:.2f}, barrier {split[1]:.2f}"
              f", phase B {split[2]:.2f}, barrier {split[3]:.2f}; phase A's "
              f"sub-stages (each block's last item) "
              + ", ".join(f"{k} {v:.2f}" for k, v in zip(A_SUBSTAGES, sub)))
    # each launch of the per-step route alone, at the main path's shards
    mesh = M.virtual_mesh(MAIN_PATH_SHARDS, x.device)
    xs, ns = M.shard_rows(x, mesh), M.shard_rows(noises[0], mesh)
    rows = [len(t) for t in xs]
    total = K.shard_slot_offsets(rows)[-1]
    slots = torch.empty(K.shard_slot_floats(rows, f), device=x.device)
    kp = tuple(p.clone() for p in params)
    K.fit_shard_step_([kp], xs, ns, lr=1e-2, sigma=0.25, loss_out=losses,
                      slots=slots)
    c_partials = K.kernel(K.FIT_SHARD_PARTIALS)
    c_reduce = K.kernel(K.FIT_SHARD_REDUCE)

    def partials():
        stream = torch.cuda.current_stream().cuda_stream
        K._launched(K.FIT_SHARD_PARTIALS, c_partials(
            xs[0].data_ptr(), ns[0].data_ptr(), 0.25,
            *(p.data_ptr() for p in params), slots.data_ptr(), slots.numel(),
            rows[0], n, f, stream))

    def reduce():
        stream = torch.cuda.current_stream().cuda_stream
        K._launched(K.FIT_SHARD_REDUCE, c_reduce(
            slots.data_ptr(), slots.numel(), total,
            *(p.data_ptr() for p in kp), losses.data_ptr(), 1e-2, n, f,
            stream))

    a_bound, b_bound = shard_bound(rows, f)
    for name, kernel_call, plain_call, (bound, by) in (
            (K.FIT_SHARD_PARTIALS, partials,
             lambda: R.step_grads(*params, xs[0], ns[0], 0.25, count=n * f),
             a_bound),
            (K.FIT_SHARD_REDUCE, reduce,
             lambda: plain_reduce(params, slots, total, n, f, 1e-2),
             b_bound)):
        ms, plain = cuda_ms(kernel_call), cuda_ms(plain_call)
        out[name] = (ms, plain, bound, by)
        print(f"kernel {name} [{n},{f}] over {MAIN_PATH_SHARDS} shards "
              f"(shard 0: {rows[0]} rows; {total} slots), the per-step "
              f"route's launch: device {ms * 1e3:.2f} us a launch (plain "
              f"{plain * 1e3:.2f} us, bound {bound * 1e3:.3f} us by {by})")
    return out


def graft_phase() -> dict:
    """The graft entry on the card: ``entry()``'s score against its plain
    version, ``dryrun_multichip(8)`` (K5's per-step route and K1 over 8
    shards of the card, counted), and ``python -m
    clawker_tpu_torch.graft_entry``.  -> dryrun_multichip's launches."""
    import torch

    from clawker_tpu_torch import graft_entry
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    fn, (params, x) = graft_entry.entry()
    out = fn(params, x)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (256,) and out.device.type == "cuda",
          f"entry: scores {tuple(out.shape)} on {out.device}")
    ok, err = _close(out, R.score(*params, x), rtol=SCORE_RTOL,
                     atol=SCORE_ATOL)
    check(ok, f"entry: score off the plain score by {err:.3g}")
    _, counts = _counted(lambda: graft_entry.dryrun_multichip(8))
    want = {K.SCORE: 8, K.FIT_STEP: 0, K.FIT: 0, K.FIT_SHARD: 0,
            K.FIT_SHARD_PARTIALS: 16, K.FIT_SHARD_REDUCE: 2}
    check(counts == want,
          f"dryrun_multichip(8): launches {counts}, want {want}")
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch.graft_entry"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "multichip dryrun ok" in proc.stdout,
          f"python -m clawker_tpu_torch.graft_entry exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    print(f"graft entry: entry() scores (256,) on the card (off the plain "
          f"score by {err:.3g}); dryrun_multichip(8) over a 4x2 mesh of 8 "
          f"shards of cuda:0, launches {json.dumps(counts)}; python -m "
          f"clawker_tpu_torch.graft_entry: "
          f"{' / '.join(proc.stdout.strip().splitlines())}")
    return counts


def bench_lane_phase(device) -> None:
    """``runtime.bench_lane`` on the bench fleet, on the card."""
    from clawker_tpu_torch.analytics import runtime as art

    doc = art.bench_lane(synth_egress_records(), device=device)
    check(set(doc) == {"windows", "featurize_ms", "train_ms", "train_steps",
                       "score_step_us", "device"}
          and doc["windows"] == 520 and doc["device"].startswith("cuda"),
          f"bench_lane: {doc}")
    print(f"bench_lane: {json.dumps(doc)}")


# --------------------------------------------------------- main-path phase


def _counted(fn):
    """Run ``fn`` with the launch counters zeroed before and read after."""
    from clawker_tpu_torch.kernels import anomaly as K

    K.reset_launches()
    out = fn()
    return out, dict(K.LAUNCHES)


def fit_report(name: str, X, steps: int, device, reps: int = 5) -> None:
    """Prints the fit of the padded windows of X, as ``_fit_and_score``
    runs it (one K3 launch), and its noise draw (K4): the host's us to
    enqueue the fit and the fit's wall ms, medians over ``reps`` fits (the
    host clock stops once the launch is queued, and again after a
    synchronize); the enqueue's parts; K3's and the noise draw's device
    time by ``event_ms``, each beside its bound; K3's phase split.  Not
    counted: the caller runs it outside ``_counted``."""
    import torch

    from clawker_tpu_torch.analytics import runtime as art

    x = torch.from_numpy(art._pad_rows(X, X.shape[1])).to(device)
    enqueue, wall = [], []
    for _ in range(reps):
        params, noises = art._draw(0, steps, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art._fit(params, x, noises, 1e-2)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e6)
        wall.append((t2 - t0) * 1e3)
    params, noises = art._draw(0, steps, x)
    parts = enqueue_parts(params, x, noises)
    fit_ms = event_ms(lambda: art._fit(params, x, noises, 1e-2))
    split, sub = phase_split(params, x, noises)
    gen = torch.Generator(device=x.device).manual_seed(1)
    draw_ms = event_ms(lambda: torch.randn(noises.shape, device=x.device,
                                           generator=gen))
    n, f = x.shape
    bound, by = fit_bound(n, f, steps)
    nbound, _ = noise_bound(n, f, steps)
    print(f"main path {name}: fit enqueue "
          f"{statistics.median(enqueue):.2f} us per fit on the host, fit "
          f"wall {statistics.median(wall):.3f} ms (median of {reps}); K3 "
          f"device {fit_ms:.4f} ms per {steps}-step fit, "
          f"{fit_ms / steps * 1e3:.2f} us per step (bound {bound:.4f} ms by "
          f"{by}); noise draw (K4) device {draw_ms * 1e3:.2f} us (bound "
          f"{nbound * 1e3:.2f} us by bytes)")
    print(f"main path {name}: fit enqueue parts, median us: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + " (the C call makes the device and occupancy queries on every "
            "launch)")
    print(f"main path {name}: K3 per step, mean us of the phase trace: "
          f"phase A {split[0]:.2f}, barrier {split[1]:.2f}, phase B "
          f"{split[2]:.2f}, barrier {split[3]:.2f}")
    print(f"main path {name}: K3 phase A's sub-stages, mean us per step "
          f"and block: "
          + ", ".join(f"{k} {v:.2f}" for k, v in zip(A_SUBSTAGES, sub))
          + f" (sum {sum(sub):.2f})")


# phase A's sub-stages in the order of the trace's points 1-6
A_SUBSTAGES = ("noise wait", "noisy x + weights wait", "forward", "dh/da",
               "weight sums", "slot")


def enqueue_parts(params, x, noises, reps: int = 50) -> dict:
    """The parts of ``fit_``'s enqueue, median host us of each alone: the
    wrapper's checks, the scratch's allocation (``runtime._fit`` passes
    none), the stream's lookup, and the C call with its arguments made:
    the device and occupancy queries that size the launch, and the
    launch."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K

    n, f = x.shape
    losses = torch.empty(len(noises), device=x.device)
    scratch = torch.empty(K.scratch_floats(n, f), device=x.device)
    c_fit = K.kernel(K.FIT)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), noises.data_ptr(), 0.25,
            *(p.data_ptr() for p in params), scratch.data_ptr(),
            scratch.numel(), losses.data_ptr(), 1e-2, n, f, len(noises), 0,
            0, stream)

    def stream_lookup():
        with torch.cuda.device(x.device):
            return torch.cuda.current_stream().cuda_stream

    def c_call():
        check(c_fit(*args) == 0, "K3's C call failed")

    parts = {
        "checks": lambda: K._check_fit(params, x, noises, losses, None,
                                       None),
        "scratch alloc": lambda: torch.empty(K.scratch_floats(n, f),
                                             device=x.device),
        "stream lookup": stream_lookup,
        "C call": c_call,
    }
    times = {name: [] for name in parts}
    for _ in range(reps):            # the parts in turn, so drift hits all
        for name, fn in parts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {name: statistics.median(t) * 1e6 for name, t in times.items()}


def phase_split(params, x, noises) -> tuple[list[float], list[float]]:
    """One K3 fit with its phase trace on: -> the mean us per step of
    phase A (first block in to last block out), the first barrier (last
    block in to first block out), phase B and the second barrier; and of
    phase A's sub-stages (``A_SUBSTAGES``), each the mean over the steps
    and phase A's blocks of that block's time in it."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K

    steps = len(noises)
    n, f = x.shape
    ga = K.fit_slots(n)
    blocks = max(ga, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    stamps = torch.zeros((steps, K.FIT_STAMPS, blocks), dtype=torch.int64,
                         device=x.device)
    K.fit_(params, x, noises, lr=1e-2, sigma=0.25,
           losses_out=torch.empty(steps, device=x.device), stamps=stamps)
    return _split(stamps, ga)


def _split(stamps, ga: int) -> tuple[list[float], list[float]]:
    """A fit's trace [steps, FIT_STAMPS, blocks] -> ``phase_split``'s
    spans, and the sub-stages over the first ``ga`` blocks (phase A's)."""
    t = stamps.double().cpu()
    first, last = t.min(2).values, t.max(2).values
    spans = [last[:, 6] - first[:, 0], first[:, 7] - last[:, 6],
             last[:, 8] - first[:, 7], first[1:, 0] - last[:-1, 8]]
    sub = t[:, 1:7, :ga] - t[:, 0:6, :ga]
    return ([float(v.mean()) / 1e3 for v in spans],
            [float(v) / 1e3 for v in sub.mean(dim=(0, 2))])


def _check_report(name: str, raw, z, n_windows: int) -> None:
    import numpy as np

    check(raw.shape == (n_windows,) and z.shape == (n_windows,),
          f"{name}: scores of shape {raw.shape}, want ({n_windows},)")
    check(bool(np.isfinite(raw).all() and np.isfinite(z).all()),
          f"{name}: non-finite scores")
    check(bool((raw >= 0).all()), f"{name}: negative squared error")


def _check_fit_launches(name: str, counts: dict, cards: int = 1) -> None:
    """One fit is one K3 launch and no K2 or K5 launch; one score one K1.
    Over ``cards`` > 1 (the sentinel on a host with several cards, which
    scores over the fleet mesh): no K3 or K2 and K5's per-step route,
    ``cards`` K5 partials per K5 reduce and no one-launch K5 fit, and one
    K1 per card."""
    from clawker_tpu_torch.kernels import anomaly as K

    partials = counts[K.FIT_SHARD_PARTIALS]
    reduces = counts[K.FIT_SHARD_REDUCE]
    if cards > 1:
        check(counts[K.FIT] == counts[K.FIT_STEP] == counts[K.FIT_SHARD] == 0
              and reduces > 0 and partials == cards * reduces
              and counts[K.SCORE] == cards,
              f"{name}: launches {counts} over {cards} cards")
        return
    check(counts[K.FIT] == 1 and counts[K.FIT_STEP] == 0,
          f"{name}: {counts[K.FIT]} fit and {counts[K.FIT_STEP]} fit-step "
          f"launches, want 1 and 0")
    check(partials == reduces == counts[K.FIT_SHARD] == 0,
          f"{name}: {partials}, {reduces} and {counts[K.FIT_SHARD]} K5 "
          f"launches, want none")
    check(counts[K.SCORE] == 1,
          f"{name}: {counts[K.SCORE]} score launches, want 1")


def main_path_phase(device) -> dict:
    """Drives the port's entry points; -> launches summed over the runs."""
    import torch

    from clawker_tpu_torch.analytics import features as F
    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.analytics import runtime as art
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.sentinel import ScoringEngine, featurize_fused

    total = {name: 0 for name in K.LAUNCHES}
    step_us = {}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    fleets = {
        "bench fleet 8x64x40": synth_egress_records(),
        "hour of 64 agents 64x64x24": synth_egress_records(
            agents=64, windows=64, per_window=24),
    }
    unsharded = {}
    for name, records in fleets.items():
        keys, X = F.featurize(records)
        rep, counts = _counted(lambda: art.score_windows(
            X, keys, train_steps=FIT_STEPS, device=device))
        _check_report(name, rep.raw, rep.z, len(keys))
        _check_fit_launches(name, counts)
        add(counts)
        unsharded[name] = (X, rep.raw)
        # steady-state score step on the fitted params (not counted)
        _, params, x, _ = art._fit_and_score(
            X, train_steps=FIT_STEPS, lr=1e-2, seed=0, device=device)
        us = host_us(lambda: K.score(params, x), reps=100)
        step_us[name] = us
        print(f"main path {name}: windows {len(keys)} padded "
              f"{tuple(x.shape)}, fit {FIT_STEPS} steps train_ms "
              f"{rep.train_ms:.2f}, score {rep.score_ms:.3f} ms, "
              f"score step {us:.2f} us, launches {json.dumps(counts)}, "
              f"device {rep.device}")
        fit_report(name, X, FIT_STEPS, device)

    # the sentinel's 64-agent fused tick
    recs = synth_egress_records(agents=64, windows=4, per_window=16)
    for i, r in enumerate(recs):
        r["worker"] = f"fake-{i % 4}"
    keys, X, worker_of = featurize_fused(recs, None)
    eng = ScoringEngine(train_steps=40, device=device)
    ticks = []
    for _ in range(3):
        t0 = time.perf_counter()
        rep, counts = _counted(lambda: eng.score_tick(keys, X, worker_of))
        ticks.append((time.perf_counter() - t0) * 1e3)
        _check_report("sentinel tick", rep.raw, rep.z, len(keys))
        _check_fit_launches("sentinel tick", counts,
                            torch.cuda.device_count())
        add(counts)
    print(f"main path sentinel tick [{len(keys)},{X.shape[1]}]: "
          f"{eng.train_steps} steps, train_ms {rep.train_ms:.2f}, score "
          f"{rep.score_ms:.3f} ms, tick ms {[round(t, 2) for t in ticks]}, "
          f"device {rep.device}")
    fit_report("sentinel tick", X, eng.train_steps, device)

    # a seeded exfil burst must score hottest
    recs = synth_egress_records() + exfil_burst("clawker.loop-3", window=63)
    keys, X = F.featurize(recs)
    rep, counts = _counted(lambda: art.score_windows(
        X, keys, train_steps=FIT_STEPS, device=device))
    _check_fit_launches("exfil", counts)
    add(counts)
    hottest = max(rep.agents, key=lambda a: a.peak)
    check(hottest.agent == "clawker.loop-3",
          f"exfil agent not hottest: {hottest.agent} peak {hottest.peak:.2f}")
    print(f"main path exfil: clawker.loop-3 hottest, peak z "
          f"{hottest.peak:.2f}, train_ms {rep.train_ms:.2f}")

    # the sharded path: the hour's fit and score over a 2x2 mesh of
    # MAIN_PATH_SHARDS shards of the card: one K5 launch, a K1 per shard
    name = "hour of 64 agents 64x64x24"
    X, raw = unsharded[name]
    mesh = M.virtual_mesh(MAIN_PATH_SHARDS, device)
    (got, _, x, t), counts = _counted(lambda: art._fit_and_score(
        X, train_steps=FIT_STEPS, lr=1e-2, seed=0, mesh=mesh))
    _check_report(f"{name} sharded", got, art._robust_z(got), len(X))
    want = {K.SCORE: MAIN_PATH_SHARDS, K.FIT_STEP: 0, K.FIT: 0,
            K.FIT_SHARD: 1, K.FIT_SHARD_PARTIALS: 0, K.FIT_SHARD_REDUCE: 0}
    check(counts == want,
          f"{name} sharded: launches {counts}, want {want}")
    check(t["device"].startswith("cuda") and t["device"].endswith(
        f"mesh={mesh.desc}"), f"{name} sharded: device {t['device']!r}")
    got_t, raw_t = torch.from_numpy(got), torch.from_numpy(raw)
    ok, err = _close(got_t, raw_t, rtol=MESH_SCORE_RTOL,
                     atol=MESH_SCORE_ATOL)
    check(ok, f"{name} sharded: scores off the unsharded ones by {err:.3g}")
    add(counts)
    print(f"main path {name} sharded: padded {tuple(x.shape)}, fit "
          f"{FIT_STEPS} steps train_ms {t['train_ms']:.2f}, score "
          f"{t['score_ms']:.3f} ms, launches {json.dumps(counts)}, device "
          f"{t['device']}; scores off the unsharded run's by "
          f"{_rel(got_t, raw_t):.3g} relative")
    print(f"main path launches: {json.dumps(total)}")
    return {"launches": total, "step_us": step_us}


# --------------------------------------------------------- sentinel phase


class _Cfg:
    def __init__(self, logs_dir: Path):
        self.logs_dir = logs_dir


def _timed(stages: dict, name: str, fn):
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            stages[name] = (time.perf_counter() - t0) * 1e3
    return run


@contextlib.contextmanager
def stage_timers(stages: dict):
    """While open, the featurizer the sentinel calls and the runtime's
    fit-and-score write their host ms into ``stages``."""
    from clawker_tpu_torch.analytics import runtime as art

    sent = importlib.import_module("clawker_tpu_torch.sentinel.sentinel")
    saved = [(sent, "featurize_fused"), (art, "_fit_and_score")]
    originals = [getattr(mod, name) for mod, name in saved]
    for (mod, name), fn in zip(saved, originals):
        setattr(mod, name, _timed(stages, name, fn))
    try:
        yield stages
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


class TickLog:
    """Every tick of one ``FleetSentinel``, whoever calls it (the caller,
    or the ticking thread, which calls ``refresh_once`` through the
    instance too), run through ``_counted``: -> ``ticks``, each (windows
    scored, launches, host ms of the tick and of its stages, the
    TickReport or None).  The sentinel's ``on_error`` messages land in
    ``errors``."""

    def __init__(self, sentinel, stages: dict):
        self.sentinel = sentinel
        self.ticks: list[tuple] = []
        self.errors: list[str] = []
        sentinel.on_error = self.errors.append
        col, eng = sentinel.collector, sentinel.engine
        col.poll = _timed(stages, "poll", col.poll)
        col.records = _timed(stages, "records", col.records)
        eng.score_tick = _timed(stages, "score_tick", eng.score_tick)
        tick = sentinel.refresh_once

        def refresh_once() -> int:
            stages.clear()
            t0 = time.perf_counter()
            n, counts = _counted(tick)
            ms = dict(stages, wall=(time.perf_counter() - t0) * 1e3)
            self.ticks.append((n, counts, ms, sentinel.last_tick if n
                               else None))
            return n

        sentinel.refresh_once = refresh_once

    def check(self, name: str, entry, *, scored: bool) -> None:
        """A scored tick is one K3 and one K1 launch on the CUDA device;
        an idle one launches nothing; no tick reports an error."""
        n, counts, _, rep = entry
        check(not self.errors and not self.sentinel.last_error,
              f"{name}: the sentinel reported {self.errors or [self.sentinel.last_error]}")
        if scored:
            import torch

            check(n > 0, f"{name}: a tick that should score scored nothing")
            _check_fit_launches(name, counts, torch.cuda.device_count())
            check(rep.device.startswith("cuda"),
                  f"{name}: scored on {rep.device!r}")
        else:
            check(n == 0 and not any(counts.values()),
                  f"{name}: an idle tick scored {n} windows with launches "
                  f"{counts}")

    def tick(self, name: str, *, scored: bool) -> int:
        self.sentinel.refresh_once()
        self.check(name, self.ticks[-1], scored=scored)
        return self.ticks[-1][0]

    def launches(self) -> collections.Counter:
        total = collections.Counter()
        for _, counts, _, _ in self.ticks:
            total.update(counts)
        return total

    def stage_line(self) -> str:
        """Median host ms of each stage over the scored ticks."""
        rows = [(ms, rep) for n, _, ms, rep in self.ticks if n]
        parts = {
            "refresh_once": [ms["wall"] for ms, _ in rows],
            "collector.poll": [ms["poll"] for ms, _ in rows],
            "collector.records": [ms["records"] for ms, _ in rows],
            "featurize_fused": [ms["featurize_fused"] for ms, _ in rows],
            "score_tick": [ms["score_tick"] for ms, _ in rows],
            "_fit_and_score": [ms["_fit_and_score"] for ms, _ in rows],
            "train_ms": [rep.train_ms for _, rep in rows],
            "score_ms": [rep.score_ms for _, rep in rows],
            "score_tick rest (worker z, host copies, fold)": [
                ms["score_tick"] - ms["_fit_and_score"] for ms, _ in rows],
            "emit + _save_state rest": [
                ms["wall"] - ms["poll"] - ms["records"]
                - ms["featurize_fused"] - ms["score_tick"]
                for ms, _ in rows],
        }
        return (f"median host ms over {len(rows)} scored ticks: "
                + ", ".join(f"{k} {statistics.median(v)!r}"
                            for k, v in parts.items()))


def _write_workers(out: Path, records: list[dict], workers: int) -> list[Path]:
    """Records tagged ``fake-{i % workers}``, one file per worker."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    paths = [out / f"fake-{w}.jsonl" for w in range(workers)]
    files = [open(p, "w") for p in paths]
    try:
        for i, r in enumerate(records):
            r["worker"] = f"fake-{i % workers}"
            files[i % workers].write(json.dumps(r) + "\n")
    finally:
        for f in files:
            f.close()
    return paths


def _append(path: Path, records: list[dict]) -> None:
    with open(path, "a") as f:
        f.write("".join(json.dumps(r) + "\n" for r in records))


def _sentinel(out: Path, paths: list[Path], device, stages: dict, **kw):
    from clawker_tpu_torch.sentinel import FleetSentinel, StreamCollector

    col = StreamCollector()
    for w, p in enumerate(paths):
        col.add_local(f"fake-{w}", p)
    s = FleetSentinel(_Cfg(out), train_steps=SENTINEL_STEPS, collector=col,
                      device=device, **kw)
    return s, TickLog(s, stages)


def fused_tick_case(out: Path, device, stages: dict) -> collections.Counter:
    """(a): the 64-agent fused tick, an idle tick, a seeded exfil flagged
    within two ticks, the bus event, the registry, the state file."""
    from clawker_tpu_torch import telemetry
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, AnomalyFlagEvent, EventBus
    from clawker_tpu_torch.sentinel import FleetSentinel, featurize_fused, state_path

    recs = synth_egress_records(agents=64, windows=4, per_window=16)
    paths = _write_workers(out, recs, 4)
    windows = len(featurize_fused(recs, None)[0])
    s, log = _sentinel(out, paths, device, stages, run_id="chip-smoke",
                       interval_s=999)
    bus_records = []
    bus = EventBus()
    bus.add_tap(bus_records.append)
    s.bind_run(events=bus)
    name = "sentinel (a)"
    n = log.tick(name, scored=True)
    check(n == windows, f"{name}: first tick scored {n} of {windows} windows")
    log.tick(name, scored=False)
    hot, worker = "clawker.loop-hot", "fake-1"
    _append(paths[1], exfil_burst(hot, window=3))
    for tick in (1, 2):
        log.tick(name, scored=True)
        flag = next((f for f in s.flags() if f["agent"] == hot), None)
        if flag is not None:
            break
    check(flag is not None, f"{name}: {hot} not flagged within two ticks")
    check(flag["worker"] == worker and flag["kind"] == "egress",
          f"{name}: flag {flag}, want worker {worker} kind egress")
    ev = next((r for r in bus_records if r.event == ANOMALY_FLAG
               and r.agent == hot), None)
    check(ev is not None, f"{name}: no {ANOMALY_FLAG} event on the bus")
    parsed = AnomalyFlagEvent.parse(ev.agent, ev.detail)
    check((parsed.agent, parsed.worker, parsed.kind) == (hot, worker,
                                                         "egress")
          and parsed.z >= s.engine.threshold,
          f"{name}: bus event {parsed}")
    text = telemetry.REGISTRY.exposition()
    check("anomaly_flags_total" in text
          and f'anomaly_score{{agent="{hot}"}}' in text,
          f"{name}: the flag metrics are not in the registry")
    for k in range(3):      # more scored ticks for the stage medians
        _append(paths[0], benign_window(f"clawker.loop-{k}", 5 + k, 16))
        log.tick(name, scored=True)
    s.stop()
    check(state_path(out, "chip-smoke").exists(), f"{name}: no state file")
    resumed = FleetSentinel(_Cfg(out), run_id="chip-smoke", device=device)
    check(resumed.engine.baseline_depth() == s.engine.baseline_depth() > 0
          and resumed.ticks == s.ticks,
          f"{name}: resumed depth {resumed.engine.baseline_depth()} ticks "
          f"{resumed.ticks}, want {s.engine.baseline_depth()} and {s.ticks}")
    check(not any(s.audit().values()), f"{name}: audit {s.audit()}")
    padded = -(-windows // 128) * 128
    print(f"sentinel (a) 64-agent fused tick [{padded},40] x"
          f"{SENTINEL_STEPS}, {len(recs)} records over 4 workers: "
          f"{windows} windows, {hot} flagged at tick {tick} after the burst "
          f"(z {flag['z']}, worker {flag['worker']}, kind {flag['kind']}), "
          f"{len(log.ticks)} ticks, state reloaded with "
          f"{resumed.engine.baseline_depth()} baseline samples")
    print(f"sentinel (a): {log.stage_line()}")
    return log.launches()


def full_buffer_case(out: Path, device, stages: dict) -> collections.Counter:
    """(b): a collector buffer near its bound (98,304 of 100,000
    records): what a long-running sentinel re-featurizes on every tick
    that has news."""
    recs = synth_egress_records(agents=64, windows=64, per_window=24)
    paths = _write_workers(out, recs, 4)
    s, log = _sentinel(out, paths, device, stages, interval_s=999)
    name = "sentinel (b)"
    counts = [log.tick(name, scored=True)]
    for k in range(2):      # one new window between ticks: none is idle
        _append(paths[k], benign_window(f"clawker.loop-{k}", 66 + k, 24))
        counts.append(log.tick(name, scored=True))
    held = len(s.collector.records())
    check(held == s.collector.total() == len(recs) + 48,
          f"{name}: the buffer holds {held} of {s.collector.total()} "
          f"records collected")
    check(counts[1:] == [counts[0] + 1, counts[0] + 2],
          f"{name}: windows per tick {counts}")
    s.stop()
    print(f"sentinel (b) full buffer: {held} records over 4 workers, "
          f"windows per tick {counts}, padded "
          f"[{-(-counts[-1] // 128) * 128},40] x{SENTINEL_STEPS}; "
          f"the first tick's collector.poll {log.ticks[0][2]['poll']!r} ms")
    print(f"sentinel (b): {log.stage_line()}")
    return log.launches()


def flag_latency_case(out: Path, device, stages: dict) -> collections.Counter:
    """(c): the reference bench's scenario: 8 agents x 6 windows x 16
    records over 2 workers, ticking every 0.05 s on the sentinel's
    thread after two warm ticks; a 60-record deny storm is appended to
    fake-1, and the time to its ``anomaly.flag`` on the bus is taken."""
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, EventBus

    total = collections.Counter()
    lat = []
    hot = "clawker.hot"
    for rep in range(FLAG_REPS):
        d = out / f"rep{rep}"
        paths = _write_workers(d, synth_egress_records(
            agents=8, windows=6, per_window=16), 2)
        flags = {}
        bus = EventBus(lambda agent, ev, detail:
                       flags.setdefault(agent, time.perf_counter())
                       if ev == ANOMALY_FLAG else None)
        s, log = _sentinel(d, paths, device, stages, interval_s=0.05,
                           window_s=60)
        s.bind_run(events=bus)
        name = f"sentinel (c) rep {rep}"
        log.tick(name, scored=True)
        log.tick(name, scored=False)
        s.start()
        storm = exfil_burst(hot, window=2, n=60)
        for r in storm:
            r["worker"] = "fake-1"
        t0 = time.perf_counter()
        _append(paths[1], storm)
        deadline = t0 + FLAG_DEADLINE_S
        while hot not in flags and time.perf_counter() < deadline:
            time.sleep(0.005)
        s.stop()
        bus.close()
        check(not s._thread.is_alive(), f"{name}: the ticking thread lives")
        check(hot in flags,
              f"{name}: no flag within {FLAG_DEADLINE_S} s")
        for entry in log.ticks:
            log.check(name, entry, scored=bool(entry[0]))
        lat.append(flags[hot] - t0)
        total.update(log.launches())
    lat.sort()
    print(f"sentinel (c) flag latency, s, over {FLAG_REPS} reps: p50 "
          f"{lat[len(lat) // 2]!r}, max {lat[-1]!r} (all {lat!r})")
    return total


def sentinel_phase(device) -> collections.Counter:
    """Drives the live sentinel; -> launches summed over its ticks."""
    out = ROOT / "build" / "chip_smoke" / "sentinel"
    total = collections.Counter()
    with stage_timers({}) as stages:
        for case, sub in ((fused_tick_case, "a"), (full_buffer_case, "b"),
                          (flag_latency_case, "c")):
            total.update(case(out / sub, device, stages))
    print(f"sentinel launches: {json.dumps(total)}")
    return total


def cli_phase(device: str) -> None:
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "egress.jsonl"
    recs = synth_egress_records() + exfil_burst("clawker.loop-3", window=63)
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    env = dict(os.environ, CLAWKER_TORCH_DEVICE=device)
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "monitor", "anomalies",
         "--input", str(path), "--format", "json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    check(device in doc["device"], f"CLI scored on {doc['device']!r}")
    check(doc["agents"][0]["agent"] == "clawker.loop-3",
          f"CLI hottest agent {doc['agents'][0]['agent']}")
    print(f"cli: exit 0, {doc['windows']} windows on {doc['device']}, "
          f"fit {doc['train_ms']} ms, hottest {doc['agents'][0]['agent']}")


def fleet_cli_phase(device: str) -> None:
    """``fleet anomaly`` on two workers' streams, one of which holds a
    hot agent: exit 2, the agent flagged with kind egress, rows from
    both workers."""
    out = ROOT / "build" / "chip_smoke" / "sentinel" / "cli"
    paths = _write_workers(out, synth_egress_records(
        agents=8, windows=6, per_window=16), 2)
    hot = "clawker.hot"
    _append(paths[1], exfil_burst(hot, window=2, n=60))
    env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
               CLAWKER_TPU_STATE_DIR=str(out / "state"))
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "fleet", "anomaly",
         "--no-daemon", "--format", "json",
         "--stream", f"fake-0={paths[0]}", "--stream", f"fake-1={paths[1]}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 2,
          f"fleet anomaly exited {proc.returncode}, want 2: "
          f"{proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    flags = {(f["agent"], f["kind"]) for f in doc["flags"]}
    workers = {r["worker"] for r in doc["rows"]}
    check((hot, "egress") in flags, f"fleet anomaly flags {flags}")
    check({"fake-0", "fake-1"} <= workers, f"fleet anomaly rows on {workers}")
    print(f"cli fleet anomaly: exit 2, {len(doc['rows'])} agents on "
          f"{sorted(workers)}, flags {sorted(flags)}")


def check_no_reference_imports() -> None:
    leaked = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and (
                        m == "jax" or m.startswith("jax.")
                        or m == "clawker_tpu" or m.startswith("clawker_tpu.")))
    check(not leaked, f"reference modules imported: {leaked}")


def cards_phase() -> None:
    """``--cards``, on a host with several cards: the paths that exist
    only across cards, alone.  K1, K2 and K3 on every card and K5 over the
    fleet mesh of all of them (``every_device_check``); the sentinel's
    fused tick and ``bench_lane``, both sharded over that mesh; and K5's
    fit of the hour's shape over the cards beside the same shards on one
    card (host wall ms around a synchronized fit, median of 5)."""
    import torch

    from clawker_tpu_torch.analytics import features as F
    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.analytics import runtime as art
    from clawker_tpu_torch.sentinel import ScoringEngine, featurize_fused

    cards = torch.cuda.device_count()
    check(cards > 1, f"--cards needs several cards, {cards} visible")
    every_device_check()
    mesh = M.fleet_mesh()
    recs = synth_egress_records(agents=64, windows=4, per_window=16)
    for i, r in enumerate(recs):
        r["worker"] = f"fake-{i % 4}"
    keys, X, worker_of = featurize_fused(recs, None)
    rep, counts = _counted(lambda: ScoringEngine(
        train_steps=SENTINEL_STEPS).score_tick(keys, X, worker_of))
    _check_report("sentinel tick over the cards", rep.raw, rep.z, len(keys))
    _check_fit_launches("sentinel tick over the cards", counts, cards)
    check(rep.device.endswith(f"mesh={mesh.desc}"),
          f"sentinel tick over the cards: device {rep.device!r}")
    print(f"sentinel tick over the cards [{len(keys)},{X.shape[1]}]: "
          f"launches {json.dumps(counts)}, train_ms {rep.train_ms:.2f}, "
          f"device {rep.device}")
    doc = art.bench_lane(synth_egress_records())
    check(doc["windows"] == 520 and doc["device"].endswith(
        f"mesh={mesh.desc}"), f"bench_lane over the cards: {doc}")
    print(f"bench_lane over the cards: {json.dumps(doc)}")
    _, X = F.featurize(synth_egress_records(agents=64, windows=64,
                                            per_window=24))
    x = torch.from_numpy(art._pad_rows(X, X.shape[1], mesh.data)).to("cuda")
    params, noises = art._draw(0, FIT_STEPS, x)
    for name, m in (("the cards", mesh),
                    ("one card", M.virtual_mesh(cards, "cuda:0"))):
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            _shard_fit(params, x, noises, m)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"K5 [{x.shape[0]},{x.shape[1]}] x{FIT_STEPS} over {cards} "
              f"shards on {name} ({m.desc}): wall {statistics.median(walls)!r}"
              f" ms per synchronized fit, median of 5")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"build: {build.build_all():.1f} s")
    if sys.argv[1:] == ["--cards"]:
        cards_phase()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    ptxas_report(K.SCORE)
    ptxas_report(K.FIT_STEP)
    ptxas_report(K.FIT)
    ptxas_report(SHARD_SOURCE)
    device = "cuda"
    kernels = kernel_phase(device)
    shard_errs = shard_kernel_phase(device)
    every_device_check()
    main_path = main_path_phase(device)
    shard_times = mesh_fit_phase(device)
    for k, v in graft_phase().items():
        main_path["launches"][k] += v
    bench_lane_phase(device)
    for k, v in sentinel_phase(device).items():
        main_path["launches"][k] += v
    cli_phase(device)
    fleet_cli_phase(device)
    check_no_reference_imports()

    n, f = TIMED_SHAPE
    replaces = {
        K.SCORE: "clawker_tpu/analytics/anomaly.py:59",
        K.FIT_STEP: "clawker_tpu/analytics/anomaly.py:96",
        K.FIT: "clawker_tpu/analytics/runtime.py:128-144",
        K.FIT_SHARD: "clawker_tpu/analytics/anomaly.py:117-156",
        K.FIT_SHARD_PARTIALS: "clawker_tpu/analytics/anomaly.py:117-156",
        K.FIT_SHARD_REDUCE: "clawker_tpu/analytics/runtime.py:170-172,187-194",
    }
    # every kernel of the paths ran on them (K2's body runs inside K3)
    idle = [name for name in replaces
            if name != K.FIT_STEP and not main_path["launches"][name]]
    check(not idle, f"kernels never launched on their paths: {idle}")
    timings = dict(kernels["timings"][(n, f)], **shard_times)
    errs = dict(kernels["errs"], **shard_errs)
    record = []
    for name in replaces:
        ms, plain, bound, by = timings[name]
        source = SHARD_SOURCE if name in shard_times else name
        record.append({
            "name": name, "route": "cuda",
            "source": f"clawker_tpu_torch/kernels/csrc/{source}.cu",
            "replaces": replaces[name],
            "launches": main_path["launches"][name],
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
