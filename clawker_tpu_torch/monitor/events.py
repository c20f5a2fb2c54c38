"""Ordered event fan-in for the concurrent fleet control plane.

A copy of ``clawker_tpu/monitor/events.py``, whole, so the port's
sentinel and later daemons share the typed events of the reference.

With the loop scheduler fanned out across per-worker lanes, per-agent
``wait_container`` threads, and the anomaly watch's scoring thread,
``on_event`` callbacks fire from many threads at once.  Every consumer
(CLI stderr lines, the loop dashboard, the final status JSON) assumes
per-agent event order -- ``iteration_start 1`` must never be delivered
before ``iteration_done 0``.  :class:`EventBus` restores that guarantee:
emits are stamped with a global and a per-agent sequence number under
one lock, and a single drainer thread delivers them to the sink in
stamp order.

Delivery rides its own thread on purpose: holding the stamp lock across
the sink call would couple every lane, waiter, and the run loop to sink
latency -- one consumer blocked on a wedged stderr (terminal flow
control, a stalled pipe reader) would halt the whole pod's control
plane, exactly the coupling the per-worker lanes exist to prevent.  The
cost is that delivery is asynchronous: callers that need "everything
emitted so far has reached the sink" (the scheduler before returning
final states, tests) call :meth:`flush`.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable

from .. import logsetup

log = logsetup.get("monitor.events")

HISTORY_LIMIT = 4096    # long unbounded loops must not grow without bound

# Event name the health subsystem publishes breaker transitions under.
# The record's ``agent`` field carries the WORKER id (workers are the
# subjects of fleet health, agents of everything else on the bus).
WORKER_HEALTH = "worker.health"

# Event name completed trace spans ride the bus under (telemetry/spans):
# the record's agent is the loop agent, the detail the span's compact
# one-liner.  Consumers wanting structure read the flight recorder.
TRACE_SPAN = "trace.span"

# Event name placement decisions ride the bus under (placement/ +
# docs/loop-placement.md): where a loop landed (or why it could not),
# typed so the fleet placement view and tests can round-trip it.
PLACEMENT_DECISION = "placement.decision"

# Event name sentinel verdicts ride the bus under (clawker_tpu/sentinel
# + docs/analytics-online.md): a live per-agent anomaly flag.  Strictly
# observational -- nothing on the bus consumes it to change scheduling.
ANOMALY_FLAG = "anomaly.flag"

# Event name elastic-capacity decisions ride the bus under
# (clawker_tpu/capacity + docs/elastic-capacity.md): pool-target /
# token-cap / queue-mode / fleet-scale changes, typed so the console
# and tests can replay what the controller did and why.
CAPACITY_DECISION = "capacity.decision"


@dataclass(frozen=True)
class CapacityDecisionEvent:
    """Typed payload of a ``capacity.decision`` event.

    ``kind`` names the control loop that acted: ``pool`` (adaptive
    warm-pool target), ``tokens`` (SLO-scaled bucket cap), ``queue``
    (reject-with-retry-after flip), ``provision`` / ``drain`` /
    ``drain_blocked`` (fleet autoscale).  ``value`` is the compact
    outcome (``target=4``, ``cap=8``, ``reject retry_after_s=0.40``);
    ``reason`` carries the telemetry that drove it.  Rides as the
    detail string like the other typed events; structured consumers
    round-trip with :meth:`parse`.
    """

    kind: str
    worker: str
    value: str
    reason: str = ""

    def detail(self) -> str:
        base = f"{self.kind} {self.worker or '-'} {self.value}"
        return f"{base}: {self.reason}" if self.reason else base

    @classmethod
    def parse(cls, detail: str) -> "CapacityDecisionEvent":
        head, _, reason = detail.partition(": ")
        kind, _, rest = head.partition(" ")
        worker, _, value = rest.partition(" ")
        return cls(kind, "" if worker == "-" else worker, value, reason)


# Event name gitguard proxy verdicts ride the bus under
# (clawker_tpu/gitguard + docs/git-policy.md): every advertisement
# filter / push refusal / allow the git firewall made for this run,
# typed so status surfaces and tests can replay what was enforced.
GITGUARD_DECISION = "gitguard.decision"

# Event name storage faults ride the bus under (docs/durability.md):
# a durable journal append that failed or recovered through a poisoned
# handle, an unwritable journal at open, or a disk-pressure watermark
# transition.  The chaos no-silent-drop invariant audits this stream --
# a dropped or poisoned write with no storage.fault event is a bug.
STORAGE_FAULT = "storage.fault"


@dataclass(frozen=True)
class StorageFaultEvent:
    """Typed payload of a ``storage.fault`` event.

    ``op`` is the failed storage operation (``open`` / ``write`` /
    ``fsync`` / ``close`` -- or ``pressure`` for a watermark
    transition); ``action`` what the fault handler did (``recovered``,
    ``degraded``, ``fail_stop``, ``shed``, ``gc``); ``dropped`` how
    many records that fault lost (0 when recovery re-appended the
    unsynced ring).  Rides as the detail string like the other typed
    events; structured consumers round-trip with :meth:`parse`.
    """

    op: str
    action: str
    dropped: int = 0
    error: str = ""

    def detail(self) -> str:
        base = f"{self.op} {self.action} dropped={self.dropped}"
        return f"{base}: {self.error}" if self.error else base

    @classmethod
    def parse(cls, detail: str) -> "StorageFaultEvent":
        head, _, error = detail.partition(": ")
        parts = head.split(" ")
        op = parts[0] if parts else ""
        action = parts[1] if len(parts) > 1 else ""
        dropped = 0
        for p in parts[2:]:
            if p.startswith("dropped="):
                try:
                    dropped = int(p.split("=", 1)[1])
                except ValueError:
                    dropped = 0
        return cls(op, action, dropped, error)


@dataclass(frozen=True)
class GitguardDecisionEvent:
    """Typed payload of a ``gitguard.decision`` event.

    ``verdict`` is ``allow`` / ``deny`` / ``down_refused``; ``service``
    the smart-HTTP service judged (``git-receive-pack`` for pushes,
    ``git-upload-pack`` for fetch wants); ``ref`` the ref the verdict
    is about; ``reason`` the git-readable refusal text ("" on allow).
    Rides as the detail string like the other typed events; structured
    consumers round-trip with :meth:`parse`.
    """

    verdict: str
    service: str
    ref: str
    reason: str = ""

    def detail(self) -> str:
        base = f"{self.verdict} {self.service or '-'} {self.ref or '-'}"
        return f"{base}: {self.reason}" if self.reason else base

    @classmethod
    def parse(cls, detail: str) -> "GitguardDecisionEvent":
        head, _, reason = detail.partition(": ")
        verdict, _, rest = head.partition(" ")
        service, _, ref = rest.partition(" ")
        return cls(verdict, "" if service == "-" else service,
                   "" if ref == "-" else ref, reason)


@dataclass(frozen=True)
class AnomalyFlagEvent:
    """Typed payload of an ``anomaly.flag`` event.

    ``kind`` names the dominant feature family of the reconstruction
    error: ``egress`` (network behavior) or ``behavior`` (exit codes /
    orphans / migrations).  Rides as the detail string like the other
    typed events so every existing sink renders it unchanged;
    structured consumers round-trip with :meth:`parse`.
    """

    agent: str
    worker: str
    z: float
    kind: str = "egress"

    def detail(self) -> str:
        return f"{self.kind} z={self.z:.2f} worker={self.worker}"

    @classmethod
    def parse(cls, agent: str, detail: str) -> "AnomalyFlagEvent":
        kind, _, rest = detail.partition(" z=")
        zs, _, worker = rest.partition(" worker=")
        try:
            z = float(zs)
        except ValueError:
            z = 0.0
        return cls(agent, worker, z, kind)


@dataclass(frozen=True)
class PlacementEvent:
    """Typed payload of a ``placement.decision`` event.

    ``action`` is one of ``placed`` (initial slot), ``replaced``
    (failover/rescue re-placement), or ``rejected`` (admission queue
    full -- the loop went back to the rescue pass).  Same stance as
    :class:`WorkerHealthEvent`: rides as the detail string so every
    existing sink renders it unchanged; structured consumers parse.
    """

    agent: str
    worker: str
    policy: str
    tenant: str
    action: str
    reason: str = ""
    retry_after_s: float = 0.0      # rejected only: the backoff hint the
    #                                 admission controller handed back --
    #                                 how long until the queue is expected
    #                                 to have room (docs/elastic-capacity.md)

    def detail(self) -> str:
        base = f"{self.action} {self.worker} [{self.policy}/{self.tenant}]"
        if self.retry_after_s > 0:
            base += f" retry_after_s={self.retry_after_s:.3f}"
        return f"{base}: {self.reason}" if self.reason else base

    @classmethod
    def parse(cls, agent: str, detail: str) -> "PlacementEvent":
        head, _, reason = detail.partition(": ")
        action, _, rest = head.partition(" ")
        worker, _, tagged = rest.partition(" [")
        tagged, _, retry_raw = tagged.partition(" retry_after_s=")
        policy, _, tenant = tagged.rstrip("]").partition("/")
        try:
            retry = float(retry_raw) if retry_raw else 0.0
        except ValueError:
            retry = 0.0
        return cls(agent, worker, policy, tenant.rstrip("]"), action,
                   reason, retry)


@dataclass(frozen=True)
class WorkerHealthEvent:
    """Typed payload of a ``worker.health`` event.

    Rides the bus as the record's detail string so every existing sink
    (CLI stderr lines, the loop dashboard, status JSON) renders it with
    zero changes; structured consumers (``clawker fleet health``, tests)
    round-trip it with :meth:`parse`.
    """

    worker: str
    old_state: str
    new_state: str
    reason: str = ""

    def detail(self) -> str:
        base = f"{self.old_state}->{self.new_state}"
        return f"{base}: {self.reason}" if self.reason else base

    @classmethod
    def parse(cls, worker: str, detail: str) -> "WorkerHealthEvent":
        states, _, reason = detail.partition(": ")
        old, _, new = states.partition("->")
        return cls(worker, old, new, reason)


@dataclass(frozen=True)
class EventRecord:
    seq: int            # position in the global event stream
    agent_seq: int      # position within this agent's event stream
    agent: str
    event: str
    detail: str = ""


class EventBus:
    """Thread-safe, order-preserving emitter over an ``on_event`` sink."""

    def __init__(self, sink: Callable[..., None] | None = None,
                 *, history: int = HISTORY_LIMIT):
        self._sink = sink
        self._lock = threading.Lock()
        self._delivered_cond = threading.Condition(self._lock)
        self._seq = 0
        self._delivered = 0
        self._agent_seq: dict[str, int] = {}
        self._closed = False
        self.history: deque[EventRecord] = deque(maxlen=history)
        # per-agent index over the SAME records: for_agent() used to scan
        # the whole history deque under the stamp lock on every call --
        # a dashboard polling one agent contended with every hot-path
        # emit.  Kept in lockstep with history's bounded eviction.
        self._by_agent: dict[str, deque[EventRecord]] = {}
        # taps see every stamped record synchronously on the EMITTER
        # thread (no ordering loss, no drainer dependency): the seam the
        # fleet sentinel's behavioral featurizer rides.  A tap must be
        # O(dict update) cheap and never raise into the hot path.
        self._taps: list[Callable[[EventRecord], None]] = []
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        if sink is not None:
            threading.Thread(target=self._drain, daemon=True,
                             name="event-bus").start()

    def add_tap(self, tap: Callable[[EventRecord], None]) -> None:
        """Attach a synchronous observer of every stamped record.  Runs
        on the emitting thread AFTER the stamp lock is released -- a
        slow tap delays only its own emitter, never the stamp order."""
        self._taps.append(tap)

    def remove_tap(self, tap: Callable[[EventRecord], None]) -> None:
        try:
            self._taps.remove(tap)
        except ValueError:
            pass

    def emit(self, agent: str, event: str, detail: str = "") -> EventRecord:
        with self._lock:
            self._seq += 1
            aseq = self._agent_seq.get(agent, 0) + 1
            self._agent_seq[agent] = aseq
            rec = EventRecord(self._seq, aseq, agent, event, detail)
            maxlen = self.history.maxlen
            # `maxlen and len(...)`: a maxlen-0 history retains nothing,
            # so there is nothing to evict (and nothing to index below --
            # the index must mirror the history exactly)
            evicted = (self.history[0]
                       if maxlen and len(self.history) == maxlen else None)
            self.history.append(rec)
            if evicted is not None:
                # the global deque just dropped its oldest record; its
                # agent's index holds records in stamp order, so the
                # evicted one is necessarily that index's head
                idx = self._by_agent.get(evicted.agent)
                if idx:
                    idx.popleft()
                    if not idx:
                        del self._by_agent[evicted.agent]
            if maxlen != 0:
                self._by_agent.setdefault(agent, deque()).append(rec)
            if self._sink is not None and not self._closed:
                # stamped and enqueued under the same lock: queue order
                # is stamp order, and the single drainer preserves it
                self._q.put(rec)
            else:
                self._delivered = max(self._delivered, self._seq)
        for tap in self._taps:
            try:
                tap(rec)
            except Exception:       # noqa: BLE001 -- observers never wedge emits
                log.exception("event tap failed for %s/%s", agent, event)
        return rec

    def close(self) -> None:
        """Retire the drainer thread once everything queued so far has
        been delivered.  Later emits still stamp + record history; they
        just no longer reach the sink.  Without this, every scheduler
        would leak one blocked drainer (plus its sink closure) for the
        life of the process."""
        with self._lock:
            if self._sink is None or self._closed:
                return
            self._closed = True
            self._q.put(None)

    def _drain(self) -> None:
        while True:
            rec = self._q.get()
            if rec is None:
                return
            try:
                self._sink(rec.agent, rec.event, rec.detail)
            except Exception:
                # a broken consumer must never stall the event stream
                log.exception("event sink failed for %s/%s",
                              rec.agent, rec.event)
            with self._delivered_cond:
                self._delivered = max(self._delivered, rec.seq)
                self._delivered_cond.notify_all()

    def flush(self, timeout: float | None = 5.0) -> bool:
        """Block until every event stamped so far has been handed to the
        sink; False if the sink could not keep up within ``timeout``."""
        with self._delivered_cond:
            target = self._seq
            return self._delivered_cond.wait_for(
                lambda: self._delivered >= target, timeout)

    def for_agent(self, agent: str) -> list[EventRecord]:
        """This agent's records, oldest first.  O(k) copy of the
        per-agent index -- never a scan of the whole history under the
        stamp lock (loop-dashboard reads must not contend with hot-path
        emits beyond the copy itself)."""
        with self._lock:
            idx = self._by_agent.get(agent)
            return list(idx) if idx else []
