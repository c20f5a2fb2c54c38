"""Process-local phase stopwatch: cold-start attribution for bench.py.

The port's copy of ``clawker_tpu/util/phases.py``, whole.

Disabled by default and free when off (one truthiness check per phase).
bench.py enables it around each measured `clawker run` and reads the
per-stage totals, so BENCH_r{N}.json can say WHERE the milliseconds
went (config load / mounts / engine create / harness seed / identity
bootstrap / pre-start / engine start / post-start) instead of only the
headline p50 -- the round-4 verdict's "creep with no owner" gap.

Not a tracing system: for spans shipped to the collector use
controlplane/otel.py.  This is a single-process accumulator with zero
dependencies, safe to call from any layer -- including concurrently:
the loop scheduler drives orchestrator create/start on per-worker
threads, so the accumulation (a read-modify-write) rides a lock.
"""

from __future__ import annotations

import contextlib
import threading
import time

_enabled = False
_totals: dict[str, float] = {}
_counts: dict[str, int] = {}
_mutex = threading.Lock()


def enable() -> None:
    global _enabled
    with _mutex:
        _enabled = True
        _totals.clear()
        _counts.clear()


def disable() -> dict[str, float]:
    """Stop recording; returns {phase: total_seconds}."""
    global _enabled
    with _mutex:
        _enabled = False
        return dict(_totals)


def totals() -> dict[str, float]:
    with _mutex:
        return dict(_totals)


def counts() -> dict[str, int]:
    with _mutex:
        return dict(_counts)


def incr(name: str, n: int = 1) -> None:
    """Count-only marker for discrete occurrences (breaker transitions,
    dial retries): shows up in :func:`counts` with no duration half.
    Same contract as :func:`phase` -- free when recording is off."""
    if not _enabled:
        return
    with _mutex:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def phase(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _mutex:
            _totals[name] = _totals.get(name, 0.0) + dt
            _counts[name] = _counts.get(name, 0) + 1
