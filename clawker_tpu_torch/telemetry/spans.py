"""Iteration trace spans: typed records + tree reconstruction.

A copy of ``clawker_tpu/telemetry/spans.py`` over the port's own
``monitor.ledger.parse_jsonl`` and ``util.ids``.

Every loop iteration becomes a span tree::

    iteration                       (root; agent/worker/epoch attributes)
      +- create                     (fresh container only)
      +- start                      (engine start + bootstrap)
      +- wait                       (container executing the harness)
      +- exit | orphan | migrate    (how the iteration ended / moved)
      +- resume                     (zero-width: --resume adopted it)

Spans are recorded COMPLETE (start + end timestamps known at record
time) because the scheduler knows both ends of every phase it drives;
there is no context-propagation machinery to pay for on the hot path.
Each record is emitted as a typed EventBus record (so dashboards see
spans interleaved with agent events, in order) and appended to the
per-run JSONL flight recorder (:class:`~clawker_tpu_torch.monitor.ledger.
FlightRecorder`); ``clawker loop trace`` rebuilds the tree offline.

Reconstruction (:func:`build_trees`) is defensive by design: the flight
recorder is append-only from many threads, so records land OUT OF
ORDER, and a crashed run may leave root spans unclosed or children
whose parent never flushed.  Orphan children are promoted to roots
rather than dropped -- a post-mortem tool must show what it has, not
only what is well-formed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable

from ..monitor.ledger import parse_jsonl
from ..util import ids

# span names
SPAN_ITERATION = "iteration"
SPAN_CREATE = "create"
SPAN_START = "start"
SPAN_WAIT = "wait"
SPAN_EXIT = "exit"
SPAN_ORPHAN = "orphan"
SPAN_MIGRATE = "migrate"
SPAN_RESUME = "resume"      # zero-width hop: --resume adopted/continued
#                             this iteration across a scheduler death
SPAN_SENTINEL_TICK = "sentinel.tick"    # one fleet-wide scoring tick
#                             (clawker_tpu/sentinel); a run-level span

# Root spans that are NOT iteration roots by design (run-level
# subsystems recording into the same flight file).  `loop trace` and
# the chaos span-tree invariant treat any OTHER non-iteration root as
# evidence of a writer that died mid-flush.
STANDALONE_SPANS = frozenset({SPAN_SENTINEL_TICK})


@dataclass(frozen=True)
class SpanRecord:
    """One completed span.  ``trace_id`` is the loop run id; the
    (agent, iteration, attempt) triple plus parent links rebuild the
    tree without any in-order delivery guarantee."""

    trace_id: str
    span_id: str
    parent_id: str          # "" = root (an iteration span)
    name: str
    agent: str
    worker: str
    t_start: float          # unix seconds
    t_end: float
    status: str = "ok"      # ok | failed | orphaned | stopped
    attrs: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        return max(0.0, self.t_end - self.t_start)

    def to_json(self) -> dict:
        return {
            "kind": "span", "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "name": self.name, "agent": self.agent, "worker": self.worker,
            "t_start": self.t_start, "t_end": self.t_end,
            "status": self.status, "attrs": dict(self.attrs),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "SpanRecord":
        return cls(
            trace_id=str(doc.get("trace_id", "")),
            span_id=str(doc.get("span_id", "")),
            parent_id=str(doc.get("parent_id", "")),
            name=str(doc.get("name", "")),
            agent=str(doc.get("agent", "")),
            worker=str(doc.get("worker", "")),
            t_start=float(doc.get("t_start", 0.0)),
            t_end=float(doc.get("t_end", 0.0)),
            status=str(doc.get("status", "ok")),
            attrs=dict(doc.get("attrs") or {}),
        )

    # compact EventBus detail: "<name> <worker> <ms>ms [k=v ...]"
    def detail(self) -> str:
        base = f"{self.name} {self.worker} {self.wall_s * 1000:.1f}ms"
        extras = " ".join(f"{k}={v}" for k, v in sorted(self.attrs.items()))
        return f"{base} {extras}" if extras else base


@dataclass
class SpanNode:
    """Reconstructed tree node."""

    record: SpanRecord
    children: list["SpanNode"] = field(default_factory=list)


def build_trees(records: Iterable[SpanRecord]) -> list[SpanNode]:
    """Span records (any order) -> roots sorted by (t_start, agent).

    Children sort by start time under their parent.  A child whose
    parent is missing (lost write, crashed run) becomes a root so the
    data still renders.
    """
    nodes: dict[str, SpanNode] = {}
    order: list[SpanNode] = []
    for rec in records:
        node = SpanNode(rec)
        # a duplicated span_id (double flush) keeps the LAST record:
        # re-emits happen on retry paths where the later one is complete
        if rec.span_id in nodes:
            nodes[rec.span_id].record = rec
            continue
        nodes[rec.span_id] = node
        order.append(node)
    roots: list[SpanNode] = []
    for node in order:
        parent = nodes.get(node.record.parent_id) if node.record.parent_id else None
        if parent is None or parent is node:
            roots.append(node)
        else:
            parent.children.append(node)
    for node in order:
        node.children.sort(key=lambda n: (n.record.t_start, n.record.name))
    roots.sort(key=lambda n: (n.record.t_start, n.record.agent))
    return roots


def tree_to_dict(node: SpanNode) -> dict:
    doc = node.record.to_json()
    doc.pop("kind", None)
    doc["wall_ms"] = round(node.record.wall_s * 1000, 3)
    doc["children"] = [tree_to_dict(c) for c in node.children]
    return doc


class Tracer:
    """The scheduler's span factory: opens iteration roots, records
    phase children, and flushes every completed span to the sinks.

    Thread-safety: lane threads open/extend iteration spans while the
    run thread ends them; the open-span table rides one lock.  Sinks
    (EventBus emit + FlightRecorder append) are called OUTSIDE it --
    both are internally synchronized and must not serialize tracing.
    """

    def __init__(self, trace_id: str, *, on_span=None, clock=time.time):
        self.trace_id = trace_id
        self.on_span = on_span          # callable(SpanRecord)
        self._clock = clock
        import threading

        self._lock = threading.Lock()
        # (agent, iteration) -> open root: [span_id, t_start, worker, attrs]
        self._open: dict[tuple[str, int], list] = {}

    # ------------------------------------------------------------ plumbing

    def now(self) -> float:
        return self._clock()

    def _flush(self, rec: SpanRecord) -> None:
        if self.on_span is not None:
            try:
                self.on_span(rec)
            except Exception:   # noqa: BLE001 -- telemetry never raises into
                pass            # the scheduler hot path

    # ------------------------------------------------------------- surface

    def begin_iteration(self, agent: str, iteration: int, worker: str,
                        **attrs) -> str:
        """Open (idempotently) the root span for this (agent, iteration)
        attempt.  A re-placed iteration opens a FRESH root: the orphaned
        attempt's root was already closed when the worker died.

        A repeat begin on an open root merges attrs the root does not
        hold yet (first value wins): the rescue pass opens a migrated
        attempt's root before the lane task measures its queue wait, and
        the later begin must attach ``queue_ms`` rather than drop it.
        """
        with self._lock:
            entry = self._open.get((agent, iteration))
            if entry is not None:
                for k, v in attrs.items():
                    entry[3].setdefault(k, v)
                return entry[0]
            span_id = ids.short_id(16)
            self._open[(agent, iteration)] = [span_id, self.now(), worker,
                                              dict(attrs)]
            return span_id

    def open_root(self, agent: str, iteration: int) -> str:
        """The open root's span id, or "" -- a PEEK (never opens): the
        workerd dispatch path asks for a traceparent to stamp on adopt
        intents, and must not conjure roots for iterations that have
        not begun."""
        with self._lock:
            entry = self._open.get((agent, iteration))
            return entry[0] if entry is not None else ""

    def child(self, agent: str, iteration: int, name: str,
              t_start: float, t_end: float, *, worker: str = "",
              status: str = "ok", **attrs) -> SpanRecord | None:
        with self._lock:
            entry = self._open.get((agent, iteration))
            if entry is None:
                return None     # span already closed (stale lane task)
            parent_id, _, root_worker, _ = entry
        rec = SpanRecord(
            trace_id=self.trace_id, span_id=ids.short_id(16),
            parent_id=parent_id, name=name, agent=agent,
            worker=worker or root_worker, t_start=t_start, t_end=t_end,
            status=status, attrs={"iteration": iteration, **attrs})
        self._flush(rec)
        return rec

    def end_iteration(self, agent: str, iteration: int, status: str = "ok",
                      **attrs) -> SpanRecord | None:
        with self._lock:
            entry = self._open.pop((agent, iteration), None)
        if entry is None:
            return None
        span_id, t_start, worker, open_attrs = entry
        rec = SpanRecord(
            trace_id=self.trace_id, span_id=span_id, parent_id="",
            name=SPAN_ITERATION, agent=agent, worker=worker,
            t_start=t_start, t_end=self.now(), status=status,
            attrs={"iteration": iteration, **open_attrs, **attrs})
        self._flush(rec)
        return rec

    def close_open(self, status: str = "stopped") -> int:
        """Flush every still-open root (run stopped / crashed) so the
        flight record never loses an iteration that was in flight."""
        with self._lock:
            entries = list(self._open.items())
            self._open.clear()
        for (agent, iteration), (span_id, t_start, worker, attrs) in entries:
            self._flush(SpanRecord(
                trace_id=self.trace_id, span_id=span_id, parent_id="",
                name=SPAN_ITERATION, agent=agent, worker=worker,
                t_start=t_start, t_end=self.now(), status=status,
                attrs={"iteration": iteration, **attrs}))
        return len(entries)


def load_spans(lines: Iterable[str]) -> list[SpanRecord]:
    """Parse flight-recorder JSONL into span records, skipping non-span
    records and corrupt lines (one shared tolerant parse --
    monitor.ledger.parse_jsonl -- so this reader can never diverge from
    FlightRecorder.read)."""
    return [SpanRecord.from_json(doc) for doc in parse_jsonl(lines)
            if doc.get("kind") == "span"]
