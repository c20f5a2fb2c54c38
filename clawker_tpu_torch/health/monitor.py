"""Fleet health monitor: one lightweight prober per pod worker.

The port's copy of ``clawker_tpu/health/monitor.py``, whole.

Each worker gets a daemon prober thread that round-trips the driver's
probe hook (engine ``ping`` + a cheap ``list_containers`` -- see
``RuntimeDriver.probe``) under a hard deadline and feeds the verdict
into that worker's :class:`~clawker_tpu.health.breaker.CircuitBreaker`.
The deadline is enforced with a per-attempt side thread: a wedged
engine call must cost the prober one blocked daemon thread, never the
probe cadence itself (the same isolation stance as the scheduler's
per-worker lanes).

External signals ride in from the scheduler: consecutive poll failures
(``report_failure``) accelerate the breaker past probe cadence, and a
wedged lane (``report_wedge``) trips it immediately.

Every breaker transition publishes a typed ``worker.health`` event on
the shared :class:`~clawker_tpu.monitor.events.EventBus` (so loop
consumers see ``closed->open`` interleaved with their agent streams, in
order) and bumps a ``health.<state>`` phases counter for bench
attribution.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .. import logsetup, telemetry
from ..engine.drivers import Worker
from ..monitor.events import WORKER_HEALTH, EventBus, WorkerHealthEvent
from ..util import phases
from .breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    BreakerConfig,
    CircuitBreaker,
)

log = logsetup.get("health.monitor")

LATENCY_WINDOW = 256    # per-worker probe-latency samples kept for p50/p95

# Registry metrics (docs/telemetry.md): the breaker-state gauge encodes
# closed=0 / half_open=1 / open=2 so a flat scrape can alert on any
# non-zero worker without string matching.
BREAKER_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}
_PROBE_SECONDS = telemetry.histogram(
    "health_probe_seconds", "Worker probe round-trip latency (successes)",
    labels=("worker",))
_PROBE_FAILURES = telemetry.counter(
    "health_probe_failures_total", "Failed worker probes", labels=("worker",))
_BREAKER_STATE = telemetry.gauge(
    "health_breaker_state",
    "Worker circuit-breaker state (0=closed 1=half_open 2=open)",
    labels=("worker",))
_ORPHANED = telemetry.counter(
    "health_orphaned_total", "Loops orphaned off a worker by its breaker",
    labels=("worker",))
_MIGRATIONS = telemetry.counter(
    "health_migrations_total", "Loop migrations between workers",
    labels=("src", "dst"))


@dataclass(frozen=True)
class HealthConfig:
    probe_interval_s: float = 1.0
    probe_deadline_s: float = 2.0
    breaker: BreakerConfig = field(default_factory=BreakerConfig)


@dataclass(frozen=True)
class ProbeResult:
    ok: bool
    latency_s: float
    error: str = ""


def _quantile(samples: list[float], q: float) -> float:
    if not samples:
        return 0.0
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[idx]


class HealthMonitor:
    """Drives one CircuitBreaker per worker from probes + scheduler signals."""

    def __init__(self, driver, workers: list[Worker] | None = None, *,
                 config: HealthConfig | None = None,
                 events: EventBus | None = None,
                 on_verdict=None):
        self.driver = driver
        self.workers = list(workers if workers is not None else driver.workers())
        self.config = config or HealthConfig()
        self.events = events if events is not None else EventBus(None)
        self.on_verdict = on_verdict        # (worker_id, old, new, reason)
        self._by_id = {w.id: w for w in self.workers}
        self.breakers: dict[str, CircuitBreaker] = {
            w.id: CircuitBreaker(w.id, self.config.breaker,
                                 on_transition=self._transition)
            for w in self.workers
        }
        self._lock = threading.Lock()
        self._last_probe: dict[str, tuple[float, bool]] = {}  # (mono, ok)
        self._latency: dict[str, deque[float]] = {
            w.id: deque(maxlen=LATENCY_WINDOW) for w in self.workers}
        self._counts: dict[str, dict[str, int]] = {
            w.id: {"probes": 0, "probe_failures": 0,
                   "orphaned": 0, "migrations_out": 0, "migrations_in": 0}
            for w in self.workers}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # a worker that never dialed is KNOWN dead: pre-open its breaker
        # so placement routes around it from tick one instead of burning
        # K probe failures (and a strand per loop slotted there) first
        for w in self.workers:
            # seed the gauge so a scrape sees every worker from tick one
            # (pre-opened breakers below overwrite via their transition)
            _BREAKER_STATE.labels(w.id).set(BREAKER_GAUGE[BREAKER_CLOSED])
        for w in self.workers:
            if w.engine is None:
                self.breakers[w.id].trip(
                    w.meta.get("dial_error", "engine not connected"))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for w in self.workers:
            t = threading.Thread(target=self._probe_loop, args=(w,),
                                 daemon=True, name=f"health-probe-{w.id}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=0.5)   # daemonic; a deadline-blocked attempt
        self._threads.clear()     # thread dies with the process

    # -------------------------------------------------------------- probing

    def _probe_loop(self, worker: Worker) -> None:
        while not self._stop.is_set():
            self.probe_worker(worker)
            self._stop.wait(self.config.probe_interval_s)

    def probe_worker(self, worker: Worker) -> ProbeResult:
        """One probe round for one worker (breaker-gated): runs the
        driver probe hook under the deadline and records the verdict."""
        br = self.breakers[worker.id]
        if not br.probe_due():
            return ProbeResult(False, 0.0, "breaker open (backoff)")
        res = self._probe_once(worker)
        with self._lock:
            self._counts[worker.id]["probes"] += 1
            self._last_probe[worker.id] = (time.monotonic(), res.ok)
            if res.ok:
                self._latency[worker.id].append(res.latency_s)
            else:
                self._counts[worker.id]["probe_failures"] += 1
        if res.ok:
            _PROBE_SECONDS.labels(worker.id).observe(res.latency_s)
            br.record_success()
        else:
            _PROBE_FAILURES.labels(worker.id).inc()
            br.record_failure(res.error)
        return res

    def probe_all(self) -> dict[str, ProbeResult]:
        """One probe round across the fleet, all workers concurrently
        (CLI one-shot): a round costs ONE deadline, not n_dead x
        deadline -- each attempt already rides its own side thread, so
        serializing here would only stack their waits."""
        out: dict[str, ProbeResult] = {}
        rounds = []
        for w in self.workers:
            t = threading.Thread(
                target=lambda w=w: out.__setitem__(w.id, self.probe_worker(w)),
                daemon=True, name=f"health-round-{w.id}")
            t.start()
            rounds.append(t)
        for t in rounds:
            t.join(self.config.probe_deadline_s + 1.0)
        return out

    @staticmethod
    def _bounded(fn, deadline_s: float, name: str) -> tuple[bool, dict]:
        """Run ``fn(out_dict)`` on a daemon side thread with a hard
        deadline; -> (finished_in_time, out_dict).  The shared shape for
        anything that might wedge (engine probes, ssh diagnosis): a hung
        call costs one blocked thread, never the prober's cadence."""
        out: dict = {}
        done = threading.Event()

        def attempt() -> None:
            try:
                fn(out)
            except Exception as e:      # noqa: BLE001 -- failure IS the answer
                out["error"] = str(e) or repr(e)
            done.set()

        threading.Thread(target=attempt, daemon=True, name=name).start()
        return done.wait(deadline_s), out

    def _probe_once(self, worker: Worker) -> ProbeResult:
        """Run the driver probe hook with a hard deadline.  The attempt
        rides its own daemon thread: a wedged engine (hung socket, fake
        'wedge' fault) blocks that thread, not the prober."""
        def attempt(out: dict) -> None:
            t0 = time.perf_counter()
            with phases.phase("health.probe"):
                self.driver.probe(worker)
            out["latency"] = time.perf_counter() - t0

        deadline = self.config.probe_deadline_s
        in_time, out = self._bounded(attempt, deadline,
                                     f"health-attempt-{worker.id}")
        if not in_time:
            err = f"probe deadline {deadline:g}s exceeded"
            extra = self._diagnose(worker)
            if extra:
                err = f"{err}; {extra}"
            return ProbeResult(False, deadline, err)
        if "error" in out:
            return ProbeResult(False, 0.0, out["error"])
        return ProbeResult(True, out["latency"])

    def _diagnose(self, worker: Worker) -> str:
        """The driver's why-is-it-failing one-liner, itself bounded -- a
        wedged transport must not wedge the prober that just survived a
        wedged engine call."""
        def attempt(out: dict) -> None:
            out["msg"] = self.driver.diagnose(worker)

        _, out = self._bounded(attempt, self.config.probe_deadline_s,
                               f"health-diagnose-{worker.id}")
        return out.get("msg", "")

    # ----------------------------------------------- signals from the fleet

    def report_success(self, worker_id: str) -> None:
        br = self.breakers.get(worker_id)
        if br is not None:
            br.record_success()

    def report_failure(self, worker_id: str, reason: str = "") -> None:
        br = self.breakers.get(worker_id)
        if br is not None:
            br.record_failure(reason)

    def report_wedge(self, worker_id: str, reason: str = "") -> None:
        """A wedged lane (poll future pending past the deadline) is
        conclusive: trip the breaker, don't wait out K probe failures."""
        br = self.breakers.get(worker_id)
        if br is not None:
            br.trip(reason or "lane wedged")

    def note_orphaned(self, worker_id: str, n: int = 1) -> None:
        _ORPHANED.labels(worker_id).inc(n)
        with self._lock:
            if worker_id in self._counts:
                self._counts[worker_id]["orphaned"] += n

    def note_migration(self, src_id: str, dst_id: str) -> None:
        _MIGRATIONS.labels(src_id, dst_id).inc()
        with self._lock:
            if src_id in self._counts:
                self._counts[src_id]["migrations_out"] += 1
            if dst_id in self._counts:
                self._counts[dst_id]["migrations_in"] += 1

    # ------------------------------------------------------------- verdicts

    def state(self, worker_id: str) -> str:
        br = self.breakers.get(worker_id)
        return br.state if br is not None else BREAKER_CLOSED

    def probe_says_alive(self, worker_id: str,
                         max_age_s: float | None = None) -> bool:
        """True when the most recent COMPLETED probe of this worker
        succeeded and is fresh.  This is direct evidence -- unlike the
        breaker state, it cannot be perturbed by failure reports from
        other signal sources, so callers use it to tell 'the daemon is
        provably alive, this is a deterministic fault' apart from
        'the worker may be dying' without racing the breaker."""
        rec = self._last_probe.get(worker_id)
        if rec is None:
            return False
        ts, ok = rec
        if not ok:
            return False
        if max_age_s is None:
            max_age_s = 2.0 * (self.config.probe_interval_s
                               + self.config.probe_deadline_s)
        return time.monotonic() - ts <= max_age_s

    def latency_p50_s(self, worker_id: str) -> float:
        """Median recent probe latency in seconds (0.0 = no samples).
        The placement policies read this to rebalance slot shares: a
        slow-but-alive worker gets proportionally fewer placements."""
        with self._lock:
            lat = self._latency.get(worker_id)
            samples = list(lat) if lat else []
        return _quantile(samples, 0.50)

    def healthy_ids(self) -> list[str]:
        return [w.id for w in self.workers
                if self.breakers[w.id].state == BREAKER_CLOSED]

    def pick_target(self, load: dict[str, int],
                    exclude: set[str] | None = None) -> Worker | None:
        """Healthiest placement target: least-loaded worker whose breaker
        is CLOSED.  Half-open workers are mid-trial and never receive
        migrations (one flap would bounce the loop right back); ties
        break on pod worker order."""
        exclude = exclude or set()
        candidates = [w for w in self.workers
                      if w.id not in exclude
                      and self.breakers[w.id].state == BREAKER_CLOSED]
        if not candidates:
            return None
        return min(candidates, key=lambda w: (load.get(w.id, 0), w.index))

    def stats(self) -> list[dict]:
        out = []
        with self._lock:
            for w in self.workers:
                lat = list(self._latency[w.id])
                counts = dict(self._counts[w.id])
                snap = self.breakers[w.id].snapshot()
                out.append({
                    "worker": w.id,
                    "state": snap["state"],
                    "breaker_state_gauge": BREAKER_GAUGE.get(snap["state"], -1),
                    "probe_p50_ms": round(_quantile(lat, 0.50) * 1000, 2),
                    "probe_p95_ms": round(_quantile(lat, 0.95) * 1000, 2),
                    "retry_in_s": round(snap["retry_in_s"], 2),
                    "last_error": snap["last_error"],
                    **counts,
                })
        return out

    # ------------------------------------------------------------ internals

    def _transition(self, worker_id: str, old: str, new: str,
                    reason: str) -> None:
        phases.incr(f"health.{new}")
        _BREAKER_STATE.labels(worker_id).set(BREAKER_GAUGE.get(new, -1))
        ev = WorkerHealthEvent(worker_id, old, new, reason)
        self.events.emit(worker_id, WORKER_HEALTH, ev.detail())
        log.info("worker %s: %s -> %s (%s)", worker_id, old, new, reason)
        if self.on_verdict is not None:
            try:
                self.on_verdict(worker_id, old, new, reason)
            except Exception:
                log.exception("health verdict consumer failed for %s",
                              worker_id)
