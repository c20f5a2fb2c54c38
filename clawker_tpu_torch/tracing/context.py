"""Trace-context propagation: W3C-traceparent-style ids as frame fields.

A :class:`TraceContext` is the (trace_id, span_id, flags) triple that
crosses every RPC boundary.  On the wire it is one string field --
``tp`` on loopd/workerd JSON frames, the standard ``traceparent``
header on engine HTTP calls -- in the W3C shape::

    00-<trace_id>-<span_id>-<flags as 2 hex digits>

with the repo's own id widths (run ids and span ids are
``ids.short_id`` strings, not 16/8-byte hex), so a context survives a
round-trip through any of our frames without re-encoding.  Propagation
NEVER adds a round-trip: the ids ride frames that were already being
sent (docs/tracing.md#propagation).

The thread-local ambient context (:func:`use` / :func:`current`) exists
for the one boundary that has no frame of its own to extend: engine
HTTP calls.  The scheduler (or workerd) activates the current span's
context around an engine call; ``engine/httpapi.py`` reads it, adds the
``traceparent`` header, and records an ``engine.request`` child span
through the context's sink.  No active context means zero work on the
engine hot path -- health probes and CLI one-shots pay nothing.

The port's copy of ``clawker_tpu/tracing/context.py``, whole.  The
port's engines are the fake one only, so nothing reads the ambient
context yet: the Docker HTTP client that records ``engine.request``
spans comes with the real engines (ROADMAP §1 item 12).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

from ..util import ids
from .names import SPAN_ENGINE_REQUEST

TRACEPARENT_VERSION = "00"


@dataclass(frozen=True)
class TraceContext:
    """One propagated span identity: the parent under which the next
    hop's spans land.  ``sink`` (never serialized) receives any span
    recorded *through* this context -- e.g. ``engine.request``."""

    trace_id: str
    span_id: str
    flags: int = 1
    agent: str = ""
    worker: str = ""
    sink: object = field(default=None, compare=False, repr=False)

    def to_header(self) -> str:
        return (f"{TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}"
                f"-{self.flags & 0xFF:02x}")

    @classmethod
    def from_header(cls, header: str) -> "TraceContext | None":
        """Parse a traceparent string; None on anything malformed (an
        unparseable context degrades to an unlinked trace, never an
        error on the RPC path).  An empty span id is LEGAL: the workerd
        launch path sends a root-less header -- the run id is known but
        the iteration root only opens when the created event lands --
        and the merge layer attaches those spans by (agent, iteration)
        instead of by parent id."""
        parts = str(header or "").split("-")
        if len(parts) != 4 or not parts[1]:
            return None
        try:
            flags = int(parts[3], 16)
        except ValueError:
            return None
        return cls(trace_id=parts[1], span_id=parts[2], flags=flags)

    def child(self, span_id: str = "", *, agent: str = "",
              worker: str = "") -> "TraceContext":
        """A context one hop down: same trace, new parent span id."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=span_id or ids.short_id(16),
            flags=self.flags,
            agent=agent or self.agent, worker=worker or self.worker,
            sink=self.sink)

    def record(self, name: str, t_start: float, t_end: float,
               status: str = "ok", **attrs):
        """Record a completed leaf span under this context through its
        sink.  A sink-less context records nothing (propagate-only)."""
        if self.sink is None:
            return None
        from ..telemetry.spans import SpanRecord

        rec = SpanRecord(
            trace_id=self.trace_id, span_id=ids.short_id(16),
            parent_id=self.span_id, name=name, agent=self.agent,
            worker=self.worker, t_start=t_start, t_end=t_end,
            status=status, attrs=dict(attrs))
        try:
            self.sink(rec)
        except Exception:   # noqa: BLE001 -- tracing never raises into
            pass            # the caller's hot path
        return rec


_tls = threading.local()


def current() -> TraceContext | None:
    """The thread's ambient context, or None outside any ``use()``."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use(ctx: TraceContext | None):
    """Activate ``ctx`` as the thread's ambient context for the block.
    ``use(None)`` is a no-op guard, so call sites need no conditional."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def record_engine_request(verb: str, path: str, t_start: float,
                          ok: bool = True) -> None:
    """Called by engine/httpapi on every unary request that ran under
    an ambient context: one ``engine.request`` span through the
    context's sink.  No context, no work."""
    ctx = current()
    if ctx is None:
        return
    ctx.record(SPAN_ENGINE_REQUEST, t_start, time.time(),
               status="ok" if ok else "failed", verb=verb, path=path)
