"""FleetSentinel: the online fleet-wide anomaly scorer.

Port of ``clawker_tpu/sentinel/sentinel.py``.  Glues the three halves
together on one tick thread: the :class:`~.collector.StreamCollector`
(fused multi-worker egress tails), the :class:`~.features.BehaviorTracker`
(typed EventBus records), and the :class:`~.engine.ScoringEngine` (one
fit and one score of the whole fleet per tick: on one GPU, one K3 and
one K1 launch).  ``device`` (default ``"cuda"``) goes to the engine;
without a GPU a scoring tick fails like any broken scorer, through
``on_error``, and never scores on the CPU unless ``device="cpu"`` was
asked for.  Each tick the sentinel

1. polls the collector and featurizes every agent's open windows into
   the 40-dim extended ABI,
2. scores them against per-worker rolling baselines,
3. publishes: typed ``anomaly.flag`` bus events (once per flagged
   (agent, window)), ``anomaly_score{agent}`` /
   ``anomaly_flags_total{worker,kind}`` registry metrics, and a
   ``sentinel.tick`` span into the run's flight recorder.

**Strictly observe-only.**  The sentinel holds no engine, placement, or
admission reference; its only outputs are events, metrics, spans, and
its own state file.  ``audit()`` returns the mutation counters the
chaos observe-only invariant checks (they are zero by construction --
the counter exists so the invariant can PROVE it, not merely trust it).

The sentinel exposes the AnomalyWatch surface (``scores`` /
``score_for`` / ``on_anomaly`` / ``on_error`` / ``refresh_once`` /
``start`` / ``stop``), so the loop dashboard's ANOM-Z column, the
scheduler's status rows, and ``attach_anomaly_watch`` all work
unchanged.

State (per-worker baselines + already-flagged windows) persists to
``logs/sentinel/<run>.json`` each tick; a ``--resume`` of the run picks
the normal profile back up instead of re-learning it.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

from .. import logsetup, telemetry
from ..analytics import runtime as art
from ..analytics.features import WINDOW_S, AgentScore
from ..monitor.events import ANOMALY_FLAG, AnomalyFlagEvent
from ..util.fs import atomic_write
from .collector import StreamCollector, wire_fleet
from .engine import DEFAULT_THRESHOLD, ScoringEngine
from .features import BehaviorTracker, featurize_fused

log = logsetup.get("sentinel")

STATE_DIR = "sentinel"          # under Config.logs_dir

_SCORE = telemetry.gauge(
    "anomaly_score", "Latest sentinel anomaly z-score per agent",
    labels=("agent",))
_FLAGS = telemetry.counter(
    "anomaly_flags_total", "Sentinel anomaly flags raised",
    labels=("worker", "kind"))
_TICKS = telemetry.counter(
    "sentinel_ticks_total", "Sentinel scoring ticks executed",
    labels=("result",))         # result: scored | empty | error


def state_path(logs_dir: Path, run_id: str) -> Path:
    return Path(logs_dir) / STATE_DIR / f"{run_id}.json"


class FleetSentinel:
    """Live fleet-wide anomaly scoring as a production security signal."""

    def __init__(self, cfg, driver=None, *, run_id: str = "",
                 interval_s: float = 5.0, window_s: int = WINDOW_S,
                 train_steps: int = 40,
                 threshold: float = DEFAULT_THRESHOLD,
                 baseline_window: int = 256,
                 collector: StreamCollector | None = None,
                 on_anomaly=None, on_error=None,
                 device: str = art.DEFAULT_DEVICE):
        self.cfg = cfg
        self.run_id = run_id
        self.interval_s = interval_s
        self.window_s = window_s
        self.collector = collector if collector is not None else (
            StreamCollector())
        if collector is None and driver is not None:
            wire_fleet(self.collector, driver, cfg)
        self.behavior = BehaviorTracker(window_s=window_s)
        self.engine = ScoringEngine(train_steps=train_steps,
                                    threshold=threshold,
                                    baseline_window=baseline_window,
                                    device=device)
        self.on_anomaly = on_anomaly or (lambda agent, z: None)
        self.on_error = on_error or (lambda msg: None)
        self.last_error = ""
        self.flight = None          # FlightRecorder, bound by the scheduler
        self._events = None         # EventBus, bound by the scheduler
        self._scores: dict[str, AgentScore] = {}
        self._worker_of: dict[str, str] = {}
        self._flagged: set[tuple[str, int]] = set()   # (agent, window)
        self._flag_rows: list[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.last_tick = None       # TickReport | None
        self._scored_at = (-1, -1)  # (collector total, behavior version)
        #                             of the last SCORED tick: an idle
        #                             tick (nothing new on any stream or
        #                             the bus) must not re-featurize the
        #                             whole bounded buffer
        # observe-only audit counters: the sentinel has NO path that
        # could increment these -- the chaos invariant asserts they
        # stay zero, turning the design promise into checked evidence
        self._mutations = {"engine_calls": 0, "breaker_reports": 0,
                           "placement_calls": 0}
        if run_id:
            self._load_state()

    # ------------------------------------------------------------ binding

    def bind_run(self, *, run_id: str = "", events=None, flight=None) -> None:
        """Attach the sentinel to a live run: the bus (typed flag emits
        + the behavioral tap) and the run's flight recorder.  Called by
        ``LoopScheduler.attach_sentinel``."""
        if run_id and run_id != self.run_id:
            self.run_id = run_id
            self._load_state()
        if events is not None:
            self._events = events
            events.add_tap(self.behavior)
        if flight is not None:
            self.flight = flight

    # ------------------------------------------------------------ surface

    def scores(self) -> dict[str, AgentScore]:
        with self._lock:
            return dict(self._scores)

    def score_for(self, agent_or_container: str) -> AgentScore | None:
        """AnomalyWatch-compatible lookup: exact row, else match the
        loop agent against container-name dot segments."""
        if not agent_or_container:
            return None
        with self._lock:
            hit = self._scores.get(agent_or_container)
            if hit is not None:
                return hit
            for name, sc in self._scores.items():
                if agent_or_container in name.split("."):
                    return sc
        return None

    def rows(self) -> list[dict]:
        """Render-ready per-agent rows (CLI table / loopd status)."""
        counts = self.collector.counts()
        with self._lock:
            scores = dict(self._scores)
            worker_of = dict(self._worker_of)
            flagged_agents = {a for a, _w in self._flagged}
        out = []
        for agent, sc in sorted(scores.items()):
            worker = worker_of.get(agent, "")
            out.append({
                "agent": agent,
                "worker": worker,
                "windows": sc.windows,
                "latest_z": round(sc.latest, 2),
                "peak_z": round(sc.peak, 2),
                "flagged": agent in flagged_agents,
                "stream_records": counts.get(worker, 0),
            })
        return out

    def flags(self) -> list[dict]:
        with self._lock:
            return list(self._flag_rows)

    def audit(self) -> dict:
        """Observe-only evidence for the chaos invariant."""
        return dict(self._mutations)

    def status_doc(self) -> dict:
        return {
            "enabled": True,
            "run": self.run_id,
            "ticks": self.ticks,
            "collector_alive": self.collector.alive,
            "threshold": self.engine.threshold,
            "baseline_samples": self.engine.baseline_depth(),
            "stream_counts": self.collector.counts(),
            "rows": self.rows(),
            "flags": self.flags(),
        }

    # --------------------------------------------------------------- tick

    def refresh_once(self) -> int:
        """One synchronous collect -> featurize -> score -> emit tick;
        returns windows scored.  The tick must never raise into its
        thread: a broken scorer surfaces once per distinct failure via
        ``on_error`` and leaves the previous scores standing."""
        t0 = time.time()
        try:
            self.collector.poll()
            seen = (self.collector.total(), self.behavior.version)
            if seen == self._scored_at:
                # nothing new arrived on any stream or the bus: the
                # previous scores stand, and re-featurizing the whole
                # bounded buffer (100k records of strptime) for an
                # identical answer would burn a core forever on an
                # idle fleet
                _TICKS.labels("idle").inc()
                return 0
            records = self.collector.records()
            keys, X, worker_of = featurize_fused(
                records, self.behavior, window_s=self.window_s)
            rep = self.engine.score_tick(keys, X, worker_of)
            self._scored_at = seen
        except Exception as e:      # noqa: BLE001 -- watcher must not die
            msg = f"{e.__class__.__name__}: {e}"
            if msg != self.last_error:
                self.last_error = msg
                self.on_error(msg)
            _TICKS.labels("error").inc()
            return 0
        self.last_error = ""
        self.ticks += 1
        if rep is None:
            _TICKS.labels("empty").inc()
            return 0
        self.last_tick = rep
        newly: list[tuple[str, str, float, str]] = []
        with self._lock:
            self._scores = {a.agent: a for a in rep.agents}
            for agent, worker in worker_of.items():
                self._worker_of[agent] = worker
            for i, (key, z) in enumerate(zip(rep.keys, rep.z)):
                if float(z) < self.engine.threshold:
                    continue
                if (rep.supports is not None
                        and float(rep.supports[i])
                        < self.engine.min_support):
                    continue    # off-manifold but evidence-starved (a
                    #             partial boundary window): scored, shown,
                    #             never flagged
                mark = (key.agent, key.start_unix)
                if mark in self._flagged:
                    continue        # one flag per (agent, window)
                self._flagged.add(mark)
                kind = self.engine.flag_kind(i)
                worker = self._worker_of.get(key.agent, "")
                newly.append((key.agent, worker, float(z), kind))
        for agent, worker, z, kind in newly:
            _FLAGS.labels(worker or "unknown", kind).inc()
            row = {"agent": agent, "worker": worker, "z": round(z, 2),
                   "kind": kind, "at": time.time()}
            with self._lock:
                self._flag_rows.append(row)
                del self._flag_rows[:-256]
            if self._events is not None:
                self._events.emit(agent, ANOMALY_FLAG, AnomalyFlagEvent(
                    agent, worker, z, kind).detail())
            self.on_anomaly(agent, z)
        for a in rep.agents:
            _SCORE.labels(a.agent).set(round(float(a.latest), 4))
        _TICKS.labels("scored").inc()
        self._record_span(t0, rep, len(newly))
        self._save_state()
        return rep.windows

    def _record_span(self, t0: float, rep, n_flags: int) -> None:
        if self.flight is None:
            return
        from ..telemetry.spans import SPAN_SENTINEL_TICK, SpanRecord
        from ..util import ids

        self.flight.append(SpanRecord(
            trace_id=self.run_id or "sentinel", span_id=ids.short_id(),
            parent_id="", name=SPAN_SENTINEL_TICK, agent="sentinel",
            worker="", t_start=t0, t_end=time.time(), status="ok",
            attrs={"windows": rep.windows, "flags": n_flags,
                   "device": rep.device,
                   "train_ms": round(rep.train_ms, 1)}).to_json())

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "FleetSentinel":
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-sentinel", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.refresh_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
        if self._events is not None:
            self._events.remove_tap(self.behavior)
        self.collector.stop()
        self._save_state()

    def kill_collector(self) -> None:
        """Chaos seam: SIGKILL the collection half mid-run.  Scoring
        keeps running over the stale buffer; the fleet must not notice."""
        self.collector.kill()

    # -------------------------------------------------------- persistence

    def _state_path(self) -> Path | None:
        if not self.run_id:
            return None
        return state_path(self.cfg.logs_dir, self.run_id)

    def _save_state(self) -> None:
        path = self._state_path()
        if path is None:
            return
        with self._lock:
            flagged = sorted([a, s] for a, s in self._flagged)
        doc = {"run": self.run_id, "ticks": self.ticks,
               "baselines": self.engine.baseline_doc(),
               "flagged": flagged}
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write(path, (json.dumps(doc) + "\n").encode())
        except OSError:
            pass            # state is an accelerator, never a dependency

    def _load_state(self) -> None:
        path = self._state_path()
        if path is None or not path.exists():
            return
        try:
            doc = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return
        n = self.engine.load_baselines(doc.get("baselines") or {})
        with self._lock:
            for pair in doc.get("flagged") or []:
                try:
                    agent, start = pair
                    self._flagged.add((str(agent), int(start)))
                except (TypeError, ValueError):
                    continue
        self.ticks = int(doc.get("ticks") or 0)
        if n:
            log.info("sentinel: resumed %d baseline sample(s) for run %s",
                     n, self.run_id)
