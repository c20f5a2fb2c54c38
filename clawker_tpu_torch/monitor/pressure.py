"""Disk-pressure degradation ladder (docs/durability.md#ladder).

The port's copy of ``clawker_tpu/monitor/pressure.py``, whole.

Production disks fill up.  When they do, the WAL chain must lose the
RIGHT data: post-mortem niceties first, crash evidence last.  The
:class:`DiskPressureMonitor` watches free space on the logs filesystem
(one statvfs per ``check_interval_s``, ticked from the scheduler run
loop and the loopd supervisor) and walks a two-watermark ladder:

- **soft watermark**: non-durable streams shed, in priority order --
  flight spans first (pure post-mortem), then shipper batches (the
  index re-ingests from files later), then sentinel state (rebuilt
  from live observation).  Streams stay functional, they just stop
  consuming disk; every shed record moves ``storage_shed_total``.
- **hard watermark**: emergency retention GC -- journals and flight
  files of DONE runs past the retention window are deleted (they
  otherwise live forever), reclaiming space BEFORE a durable journal
  append is allowed to fail.

The monitor never raises and never blocks the hot path: streams
consult :meth:`is_shedding` (a set lookup) and the statvfs happens at
tick cadence only.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from .. import telemetry
from .events import StorageFaultEvent

# the shed ladder, least-precious stream first; stream i sheds when
# free space falls below soft - i * (soft-hard)/len (evenly spaced
# rungs between the watermarks)
SHED_LADDER = ("flight", "shipper", "sentinel")

_SHED = telemetry.counter(
    "storage_shed_total",
    "records/batches shed under disk pressure, by stream",
    labels=("stream",))
_LEVEL = telemetry.gauge(
    "storage_pressure_level",
    "disk-pressure ladder level (0 ok, 1 soft: shedding, 2 hard: GC)")
_FREE = telemetry.gauge(
    "storage_disk_free_ratio",
    "free-space fraction of the logs filesystem at the last tick")
_GC_REMOVED = telemetry.counter(
    "storage_gc_removed_total",
    "done-run journal/flight file sets deleted by the emergency GC")
_GC_FREED = telemetry.counter(
    "storage_gc_freed_bytes_total",
    "bytes reclaimed by the emergency retention GC")

_GC_COOLDOWN_S = 30.0           # don't re-run the GC every tick at hard


def note_shed(stream: str, n: int = 1) -> None:
    """Count records a stream dropped under pressure (the stream calls
    this at its own append site -- only it knows a record was due)."""
    _SHED.labels(stream).inc(n)


class DiskPressureMonitor:
    """statvfs watermark monitor driving the shed ladder + emergency GC.

    ``gc`` is the hard-watermark reclaim callback (typically
    ``loop.journal.retention_gc`` partial-applied to the logs dir); it
    returns ``{"removed", "freed_bytes", ...}``.  ``on_event`` receives
    a :class:`StorageFaultEvent` per ladder transition and GC pass --
    the scheduler/loopd forward it onto their event bus.  Construction
    and ticking never raise: an unstatable filesystem reads as
    "no pressure verdict" and the ladder holds its last state.
    """

    def __init__(self, path: Path, *, soft_free_pct: float = 10.0,
                 hard_free_pct: float = 3.0, check_interval_s: float = 5.0,
                 gc=None, on_event=None, clock=time.monotonic,
                 statvfs=os.statvfs):
        self.path = Path(path)
        self.soft = max(0.0, float(soft_free_pct)) / 100.0
        self.hard = min(max(0.0, float(hard_free_pct)) / 100.0, self.soft)
        self.check_interval_s = max(0.05, float(check_interval_s))
        self.gc = gc
        self.on_event = on_event
        self._clock = clock
        self._statvfs = statvfs
        self.level = 0              # 0 ok | 1 soft | 2 hard
        self.shedding: frozenset[str] = frozenset()
        self.free_ratio: float | None = None
        self.gc_removed = 0
        self.gc_freed_bytes = 0
        self._next_check = 0.0
        self._gc_after = 0.0

    # ------------------------------------------------------------- queries

    def is_shedding(self, stream: str) -> bool:
        return stream in self.shedding

    def summary(self) -> dict:
        return {"level": self.level, "free_ratio": self.free_ratio,
                "shedding": sorted(self.shedding),
                "gc_removed": self.gc_removed,
                "gc_freed_bytes": self.gc_freed_bytes}

    # ---------------------------------------------------------------- tick

    def _emit(self, ev: StorageFaultEvent) -> None:
        if self.on_event is not None:
            try:
                self.on_event(ev)
            except Exception:   # noqa: BLE001 -- surfacing pressure must
                pass            # never become the pressure

    def _free_fraction(self) -> float | None:
        try:
            st = self._statvfs(str(self.path))
            total = st.f_blocks * st.f_frsize
            if total <= 0:
                return None
            return (st.f_bavail * st.f_frsize) / total
        except (OSError, ValueError, ZeroDivisionError):
            return None

    def tick(self, now: float | None = None) -> bool:
        """One ladder evaluation (rate-limited to the check interval).
        Returns True when the shed set or level changed."""
        now = self._clock() if now is None else now
        if now < self._next_check:
            return False
        self._next_check = now + self.check_interval_s
        free = self._free_fraction()
        if free is None:
            return False        # no verdict: hold the last state
        self.free_ratio = free
        _FREE.set(free)
        shed: set[str] = set()
        span = max(self.soft - self.hard, 1e-9)
        for i, stream in enumerate(SHED_LADDER):
            rung = self.soft - (i * span / len(SHED_LADDER))
            if free < rung:
                shed.add(stream)
        level = 0 if free >= self.soft else (1 if free >= self.hard else 2)
        changed = (level != self.level
                   or frozenset(shed) != self.shedding)
        if changed:
            self._emit(StorageFaultEvent(
                "pressure", "shed" if shed else "ok",
                error=(f"free={free:.1%} level={level} "
                       f"shedding={','.join(sorted(shed)) or '-'}")))
        self.level = level
        self.shedding = frozenset(shed)
        _LEVEL.set(level)
        if level >= 2 and self.gc is not None and now >= self._gc_after:
            self._gc_after = now + _GC_COOLDOWN_S
            try:
                out = self.gc() or {}
            except Exception:   # noqa: BLE001 -- a GC crash must never
                out = {}        # take the scheduler tick with it
            removed = int(out.get("removed", 0))
            freed = int(out.get("freed_bytes", 0))
            self.gc_removed += removed
            self.gc_freed_bytes += freed
            if removed:
                _GC_REMOVED.inc(removed)
            if freed:
                _GC_FREED.inc(freed)
            self._emit(StorageFaultEvent(
                "pressure", "gc", error=(f"removed={removed} "
                                         f"freed_bytes={freed}")))
        return changed
