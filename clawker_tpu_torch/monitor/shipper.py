"""Fleet-telemetry bulk ingestion: registry + bus + spans -> OpenSearch.

The port's copy of ``clawker_tpu/monitor/shipper.py``, whole.

The missing half of BASELINE config #4: the compose stack (stack.py)
and its seeded index corpus (corpus.py) existed, but fleet telemetry
never reached the index -- metrics lived on the scrape port, typed
events on the in-process bus, spans in the per-run flight recorder.
:class:`TelemetryShipper` closes the loop: it batches three doc types
into the OpenSearch bulk API --

- ``clawker-fleet-metrics``: :class:`~clawker_tpu_torch.telemetry.registry.
  MetricsRegistry` snapshots (one doc per series sample);
- ``clawker-fleet-events``: typed bus events (placement decisions,
  worker health transitions, anomaly flags), parsed back into their
  structured payloads so the index gets fields, not detail strings;
- ``clawker-fleet-spans``: completed flight-recorder span records.

**Backpressure contract** (docs/fleet-console.md#degrade-matrix): the
shipper may lose telemetry, it may never delay the system it observes.
``ingest``/``bus_tap``/``span_sink`` are O(append) under one lock and
never touch the network; all sink I/O rides the pump thread.  At most
``max_batches`` sealed batches wait in memory -- when the index is slow
or down the OLDEST batches drop first (counted in
``monitor_ingest_dropped_total``), so a recovered index sees the most
recent fleet state, and a wedged one bounds memory instead of the bus.
The journal and flight recorder stay the durable history; the index is
a live view, exactly like the loopd attach stream.

loopd hosts one shipper for its daemon lifetime (every hosted run
attaches at construction); in-process runs attach via
``clawker loop --ship-telemetry``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque

from .. import logsetup, telemetry
from .events import ANOMALY_FLAG, PLACEMENT_DECISION, TRACE_SPAN, WORKER_HEALTH

log = logsetup.get("monitor.shipper")

FLEET_METRICS_INDEX = "clawker-fleet-metrics"
FLEET_EVENTS_INDEX = "clawker-fleet-events"
FLEET_SPANS_INDEX = "clawker-fleet-spans"
FLEET_INDICES = (FLEET_METRICS_INDEX, FLEET_EVENTS_INDEX, FLEET_SPANS_INDEX)

# bus event kinds worth indexing, and the doc "type" each maps to
_TYPED_EVENTS = {
    PLACEMENT_DECISION: "placement",
    WORKER_HEALTH: "health",
    ANOMALY_FLAG: "anomaly",
}

_DOCS = telemetry.counter(
    "monitor_ingest_docs_total",
    "Fleet-telemetry docs accepted into shipper batches",
    labels=("type",))
_DROPPED = telemetry.counter(
    "monitor_ingest_dropped_total",
    "Fleet-telemetry docs dropped with their batch under backpressure "
    "(slow/down index, bounded buffer)")
_BATCHES = telemetry.counter(
    "monitor_ingest_batches_total",
    "Bulk batches flushed to the monitor stack", labels=("result",))
_LAG = telemetry.histogram(
    "monitor_ingest_lag_seconds",
    "Batch seal -> bulk-ack latency (how stale the index view runs)")


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)) + (
        ".%03dZ" % int((ts % 1) * 1000))


def bulk_payload(items: list[tuple[str, dict]]) -> bytes:
    """(index, doc) pairs -> the ndjson body the _bulk API takes."""
    lines = []
    for index, doc in items:
        lines.append(json.dumps({"index": {"_index": index}},
                                separators=(",", ":")))
        lines.append(json.dumps(doc, separators=(",", ":"), default=str))
    return ("\n".join(lines) + "\n").encode()


class BulkSink:
    """POST ``/_bulk`` against a real OpenSearch endpoint.

    The shipper's sink contract: ``bulk(payload) -> bool``, never
    raises, bounded by ``timeout_s`` -- a hung index must cost the pump
    thread one deadline, not forever."""

    def __init__(self, url: str, *, timeout_s: float = 5.0):
        self.url = url.rstrip("/") + "/_bulk"
        self.timeout_s = timeout_s

    def bulk(self, payload: bytes) -> bool:
        req = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": "application/x-ndjson"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                if r.status >= 300:
                    return False
                body = json.loads(r.read() or b"{}")
                return not body.get("errors", False)
        except (OSError, ValueError, urllib.error.URLError) as e:
            log.debug("bulk POST failed: %s", e)
            return False


def resolve_sink(cfg) -> BulkSink:
    """The configured bulk sink: settings ``monitoring.shipper.url``
    override or the local stack's opensearch port."""
    ms = cfg.settings.monitoring
    url = ms.shipper.url or f"http://127.0.0.1:{ms.opensearch_port}"
    return BulkSink(url, timeout_s=ms.shipper.timeout_s)


# ------------------------------------------------------------ doc builders


def metric_docs(snapshot: list[dict], *, source: str = "",
                ts: float | None = None) -> list[dict]:
    """Registry snapshot rows -> one doc per series sample.  Histogram
    buckets stay nested (the index template maps them as an object);
    ``value`` is the headline scalar either way."""
    stamp = _iso(ts if ts is not None else time.time())
    out = []
    for row in snapshot:
        doc = {
            "@timestamp": stamp, "type": "metric", "source": source,
            "metric": row["metric"], "kind": row["kind"],
            "labels": dict(row.get("labels") or {}),
            "value": float(row.get("value", 0.0)),
        }
        if "sum" in row:
            doc["sum"] = float(row["sum"])
        out.append(doc)
    return out


def event_doc(rec, *, run: str = "", source: str = "",
              ts: float | None = None) -> dict | None:
    """Typed EventRecord -> structured doc, or None for kinds the index
    does not carry (lifecycle noise, trace.span -- spans arrive
    structured via :meth:`TelemetryShipper.span_sink`)."""
    kind = _TYPED_EVENTS.get(rec.event)
    if kind is None:
        return None
    doc = {
        "@timestamp": _iso(ts if ts is not None else time.time()),
        "type": kind, "event": rec.event, "run": run, "source": source,
        "agent": rec.agent, "seq": rec.seq, "detail": rec.detail,
    }
    # re-hydrate the typed payload: the bus carries compact detail
    # strings so every sink renders them; the index wants fields
    from .events import AnomalyFlagEvent, PlacementEvent, WorkerHealthEvent

    if rec.event == PLACEMENT_DECISION:
        ev = PlacementEvent.parse(rec.agent, rec.detail)
        doc.update({"worker": ev.worker, "policy": ev.policy,
                    "tenant": ev.tenant, "action": ev.action,
                    "reason": ev.reason})
    elif rec.event == WORKER_HEALTH:
        ev = WorkerHealthEvent.parse(rec.agent, rec.detail)
        doc.update({"worker": ev.worker, "old_state": ev.old_state,
                    "new_state": ev.new_state, "reason": ev.reason})
    elif rec.event == ANOMALY_FLAG:
        ev = AnomalyFlagEvent.parse(rec.agent, rec.detail)
        doc.update({"worker": ev.worker, "z": round(ev.z, 3),
                    "kind": ev.kind})
    return doc


def span_doc(rec, *, run: str = "", source: str = "") -> dict:
    doc = rec.to_json()
    doc.pop("kind", None)
    doc.update({
        "@timestamp": _iso(rec.t_end),
        "type": "span", "run": run or rec.trace_id, "source": source,
        "wall_ms": round(rec.wall_s * 1000, 3),
    })
    return doc


# ---------------------------------------------------------------- shipper


class TelemetryShipper:
    """Bounded-buffer bulk ingester (see module docstring).

    ``sink`` is anything with ``bulk(payload: bytes) -> bool``
    (:class:`BulkSink` in production, ``testenv.FakeBulkIndex`` in
    tests/bench).  One shipper serves many runs: loopd constructs one
    and every hosted scheduler attaches; taps and span sinks are
    per-run closures so docs carry their run id."""

    def __init__(self, sink, *, registry=None, interval_s: float = 2.0,
                 batch_docs: int = 256, max_batches: int = 64,
                 source: str = ""):
        self.sink = sink
        self.registry = registry if registry is not None else telemetry.REGISTRY
        self.interval_s = interval_s
        self.batch_docs = max(1, int(batch_docs))
        self.max_batches = max(1, int(max_batches))
        self.source = source
        self._lock = threading.Lock()
        self._open: list[tuple[str, dict]] = []
        # sealed batches awaiting flush: (seal_monotonic, items)
        self._pending: deque[tuple[float, list[tuple[str, dict]]]] = deque()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # plain tallies mirrored into the registry counters: stats()
        # must work against a reset/shared registry (tests, loopd
        # status RPC) without scraping exposition text
        self.ingested = 0
        self.dropped = 0
        self.flushed_batches = 0
        self.flushed_docs = 0
        self.failed_flushes = 0

    @classmethod
    def from_config(cls, cfg, *, sink=None, source: str = ""
                    ) -> "TelemetryShipper":
        ss = cfg.settings.monitoring.shipper
        return cls(sink if sink is not None else resolve_sink(cfg),
                   interval_s=ss.interval_s, batch_docs=ss.batch_docs,
                   max_batches=ss.max_batches, source=source)

    # ------------------------------------------------------------- intake

    def ingest(self, index: str, doc: dict, *, doc_type: str = "doc") -> None:
        """Accept one doc; never blocks, never raises.  Seals the open
        batch at ``batch_docs`` and applies drop-oldest past
        ``max_batches`` -- backpressure lands HERE, on the intake side,
        so a wedged sink bounds memory without touching callers."""
        dropped = 0
        with self._lock:
            self._open.append((index, doc))
            self.ingested += 1
            if len(self._open) >= self.batch_docs:
                dropped = self._seal_locked()
        _DOCS.labels(doc_type).inc()
        if dropped:
            _DROPPED.inc(dropped)

    def _seal_locked(self) -> int:
        """Move the open batch to pending; returns docs dropped off the
        oldest end to hold ``max_batches``.  Caller holds the lock."""
        if not self._open:
            return 0
        self._pending.append((time.monotonic(), self._open))
        self._open = []
        dropped = 0
        while len(self._pending) > self.max_batches:
            _, lost = self._pending.popleft()
            dropped += len(lost)
            self.dropped += len(lost)
        return dropped

    # per-run adapters ----------------------------------------------------

    def bus_tap_for(self, run_id: str):
        """An EventBus tap shipping this run's typed events.  Runs on
        the emitting thread: O(parse + append), no I/O."""

        def tap(rec) -> None:
            if rec.event == TRACE_SPAN:
                return      # spans arrive structured via span_sink_for
            doc = event_doc(rec, run=run_id, source=self.source)
            if doc is not None:
                self.ingest(FLEET_EVENTS_INDEX, doc, doc_type="event")

        return tap

    def span_sink_for(self, run_id: str):
        def sink(rec) -> None:
            self.ingest(FLEET_SPANS_INDEX,
                        span_doc(rec, run=run_id, source=self.source),
                        doc_type="span")

        return sink

    # -------------------------------------------------------------- pump

    def snapshot_once(self) -> int:
        """One registry snapshot into the metrics index; returns docs."""
        docs = metric_docs(self.registry.snapshot(), source=self.source)
        for doc in docs:
            self.ingest(FLEET_METRICS_INDEX, doc, doc_type="metric")
        return len(docs)

    def flush_once(self, *, budget_s: float | None = None) -> int:
        """Drain pending batches to the sink within ``budget_s``;
        returns batches flushed.  A failed POST requeues the batch at
        the FRONT (it is still the oldest) and stops -- the next tick
        retries, and intake's drop-oldest reclaims the space if the
        outage outlasts the buffer."""
        deadline = (time.monotonic() + budget_s) if budget_s else None
        n = 0
        with self._lock:
            dropped = self._seal_locked()
        if dropped:
            _DROPPED.inc(dropped)
        while True:
            with self._lock:
                if not self._pending:
                    return n
                sealed_at, items = self._pending.popleft()
            ok = False
            try:
                ok = bool(self.sink.bulk(bulk_payload(items)))
            except Exception as e:  # noqa: BLE001 -- sink contract: degrade
                log.debug("shipper sink raised: %s", e)
            if not ok:
                self.failed_flushes += 1
                _BATCHES.labels("error").inc()
                with self._lock:
                    if len(self._pending) >= self.max_batches:
                        # the buffer filled while we were stuck in the
                        # POST: this batch IS the oldest -- drop it
                        self.dropped += len(items)
                        _DROPPED.inc(len(items))
                    else:
                        self._pending.appendleft((sealed_at, items))
                return n
            n += 1
            self.flushed_batches += 1
            self.flushed_docs += len(items)
            _BATCHES.labels("ok").inc()
            _LAG.observe(max(0.0, time.monotonic() - sealed_at))
            if deadline is not None and time.monotonic() >= deadline:
                return n

    def _pump(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.snapshot_once()
            self.flush_once(budget_s=self.interval_s)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "TelemetryShipper":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._pump, daemon=True,
                                            name="monitor-shipper")
            self._thread.start()
        return self

    def _retire_pump(self, timeout: float) -> bool:
        """Signal the pump and wait for it to exit; False when it is
        still wedged inside the sink past ``timeout``.  A wedged pump
        keeps ``_thread`` set: callers must not run their own
        snapshot/flush concurrently with it (unsynchronized counter
        updates), and a later start() must not spawn a second pump."""
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout=timeout)
        if t.is_alive():
            return False
        self._thread = None
        return True

    def stop(self) -> None:
        """Final snapshot + one bounded flush attempt: a short run's
        telemetry still lands when the index is up, and a down index
        costs one sink deadline, never a hang.  A pump still wedged in
        the sink past the join deadline skips the final flush -- racing
        it would corrupt the drop/flush accounting."""
        if not self._retire_pump(5.0):
            return
        self.snapshot_once()
        self.flush_once(budget_s=self.interval_s)

    def kill(self) -> bool:
        """Stop the pump with NO final snapshot/flush (the simulated-
        SIGKILL path chaos and loopd.kill() exercise): a killed process
        ships nothing on the way down.  Returns False when the pump is
        still wedged in the sink -- the caller must not touch the
        shipper's flush path until it drains."""
        return self._retire_pump(2.0)

    # ------------------------------------------------------------- status

    def stats(self) -> dict:
        with self._lock:
            pending = len(self._pending)
            pending_docs = sum(len(items) for _, items in self._pending)
            open_docs = len(self._open)
        return {
            "ingested_docs": self.ingested,
            "dropped_docs": self.dropped,
            "flushed_batches": self.flushed_batches,
            "flushed_docs": self.flushed_docs,
            "failed_flushes": self.failed_flushes,
            "pending_batches": pending,
            "pending_docs": pending_docs,
            "open_docs": open_docs,
            "max_batches": self.max_batches,
            "batch_docs": self.batch_docs,
        }
