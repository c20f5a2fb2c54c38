"""Extended feature ABI: fused egress windows + scheduler behavior.

A copy of ``clawker_tpu/sentinel/features.py`` pointed at the port's
own ``analytics.features`` (the reference package loads jax on import).

The offline anomaly lane scores 32-dim egress window vectors
(analytics/features.py).  The sentinel extends each (agent, window)
vector with ``BEHAVIOR_FEATURES`` dims derived from the typed EventBus
stream -- exit codes, orphans, migrations, restarts -- so an agent that
goes quiet on the network while crash-looping (or that keeps exiting 0
while spraying denies) is off-manifold in ONE vector.  numpy only; the
TPU half stays analytics/anomaly.py, which is feature-width agnostic.

Extension layout (dims 32..39, appended after the egress 32):

  32  log1p(iterations completed in window)
  33  log1p(nonzero exits)
  34  failure ratio (nonzero / completed)
  35  log1p(orphan events)
  36  log1p(migrations)
  37  log1p(iteration starts)
  38  log1p(distinct workers whose stream carried the agent this window)
  39  log1p(total behavioral events)

The fused record stream tags every egress record with the worker whose
stream carried it (collector.py); behavioral events are bucketed at
arrival time into the same aligned windows.  An agent with behavior but
zero egress still yields a row (zeroed egress dims): a suddenly-silent
stream is itself a signal.

(In this package the model half is ``analytics/anomaly.py``, the same
feature-width agnostic autoencoder, run by the CUDA kernels.)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from ..analytics import features as F

BEHAVIOR_FEATURES = 8
EXT_FEATURES = F.FEATURES + BEHAVIOR_FEATURES      # 40

# bus events the tracker folds into behavioral windows
_TRACKED = ("iteration_start", "iteration_done", "orphaned", "migrated",
            "resumed", "adopted", "failed")


@dataclass
class _Window:
    starts: int = 0
    done: int = 0
    failures: int = 0
    orphans: int = 0
    migrations: int = 0
    total: int = 0


@dataclass
class BehaviorTracker:
    """Thread-safe per-(agent, aligned-window) fold of bus records.

    Attached to a scheduler's EventBus as a tap; records are stamped at
    ARRIVAL time (bus records carry no timestamp), which is within the
    scoring window for anything the sentinel can act on.  Bounded: only
    ``keep_windows`` windows per agent are retained.
    """

    window_s: int = F.WINDOW_S
    keep_windows: int = 16
    clock: object = time.time
    version: int = 0        # bumped per folded record: the sentinel's
    #                         idle-tick short-circuit reads it
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _by_agent: dict = field(default_factory=dict)   # agent -> {start: _Window}

    def __call__(self, rec) -> None:               # EventBus tap signature
        self.observe(rec.agent, rec.event, rec.detail)

    def observe(self, agent: str, event: str, detail: str = "") -> None:
        if event not in _TRACKED:
            return
        now = int(self.clock())
        start = now - now % self.window_s
        with self._lock:
            self.version += 1
            windows = self._by_agent.setdefault(agent, {})
            w = windows.get(start)
            if w is None:
                w = windows[start] = _Window()
                if len(windows) > self.keep_windows:
                    del windows[min(windows)]
            w.total += 1
            if event == "iteration_start":
                w.starts += 1
            elif event == "iteration_done":
                w.done += 1
                # detail is "<iteration>:<code>"
                code = detail.rpartition(":")[2]
                if code not in ("", "0"):
                    w.failures += 1
            elif event == "failed":
                w.failures += 1
            elif event == "orphaned":
                w.orphans += 1
            elif event == "migrated":
                w.migrations += 1

    def snapshot(self) -> dict:
        """{agent: {window_start: _Window}} deep-enough copy."""
        with self._lock:
            return {a: dict(ws) for a, ws in self._by_agent.items()}


def _behavior_vec(w: _Window | None, n_workers: int) -> np.ndarray:
    v = np.zeros(BEHAVIOR_FEATURES, np.float32)
    if w is not None:
        v[0] = np.log1p(w.done)
        v[1] = np.log1p(w.failures)
        v[2] = w.failures / w.done if w.done else (1.0 if w.failures else 0.0)
        v[3] = np.log1p(w.orphans)
        v[4] = np.log1p(w.migrations)
        v[5] = np.log1p(w.starts)
        v[7] = np.log1p(w.total)
    v[6] = np.log1p(n_workers)
    return v


def _loop_agent_of(container: str, behavior_agents: Iterable[str]) -> str:
    """Map a container-named egress key back to its loop agent name.
    Container names are dot-separated (``clawker.<proj>.<agent>``), so
    match whole segments -- the same rule AnomalyWatch.score_for uses."""
    segments = container.split(".")
    for agent in behavior_agents:
        if agent in segments:
            return agent
    return container


def featurize_fused(records: Iterable[dict],
                    behavior: BehaviorTracker | None = None, *,
                    window_s: int = F.WINDOW_S,
                    ) -> tuple[list[F.WindowKey], np.ndarray, dict[str, str]]:
    """Fused records (+ optional behavior) -> (keys, X[n, EXT_FEATURES],
    worker_of).

    ``keys`` keep analytics' deterministic (agent, window-start) sort so
    jit shapes and row order are stable for a given input; ``worker_of``
    maps each key's agent to the worker whose stream(s) dominated its
    records (for per-worker baselines and flag attribution).  Behavior
    windows with no matching egress window become zero-egress rows keyed
    by the loop agent name itself.
    """
    records = list(records)
    keys, X_egress = F.featurize(records, window_s=window_s)

    # per (container-agent, window): worker tags of the records
    workers_by_key: dict[F.WindowKey, set] = {}
    for rec in records:
        ts = F.parse_ts(rec.get("@timestamp", ""))
        if not ts:
            continue
        key = F.WindowKey(str(rec.get("container") or rec.get("cgroup_id")
                              or "unknown"), ts - ts % window_s)
        wid = str(rec.get("worker") or "")
        if wid:
            workers_by_key.setdefault(key, set()).add(wid)

    snap = behavior.snapshot() if behavior is not None else {}
    behavior_agents = list(snap)
    covered: set[tuple[str, int]] = set()
    rows: list[np.ndarray] = []
    worker_of: dict[str, str] = {}
    for i, key in enumerate(keys):
        agent = _loop_agent_of(key.agent, behavior_agents)
        w = snap.get(agent, {}).get(key.start_unix)
        if w is not None:
            covered.add((agent, key.start_unix))
        tags = sorted(workers_by_key.get(key, ()))
        rows.append(np.concatenate(
            [X_egress[i], _behavior_vec(w, len(tags))]))
        if tags:
            worker_of.setdefault(key.agent, tags[0])

    # behavior-only windows: an agent with scheduler events but a silent
    # egress stream still gets a (zero-egress) row
    extra_keys: list[F.WindowKey] = []
    for agent, windows in sorted(snap.items()):
        for start, w in sorted(windows.items()):
            if (agent, start) in covered:
                continue
            extra_keys.append(F.WindowKey(agent, start))
            rows.append(np.concatenate(
                [np.zeros(F.FEATURES, np.float32), _behavior_vec(w, 0)]))
    all_keys = list(keys) + extra_keys
    if not all_keys:
        return [], np.zeros((0, EXT_FEATURES), np.float32), {}
    X = np.stack(rows).astype(np.float32)
    # keep the deterministic (agent, start) global sort across both halves
    order = sorted(range(len(all_keys)),
                   key=lambda j: (all_keys[j].agent, all_keys[j].start_unix))
    return ([all_keys[j] for j in order], X[order], worker_of)
