"""Keep-alive connection pool for the engine HTTP client.

Every unary Engine-API call used to dial a brand-new socket and close it
after one request.  Over a local ``/var/run/docker.sock`` that is merely
wasteful; over the SSH-forwarded socket of a TPU-VM worker each dial is
a fresh forwarded-stream setup (an extra round trip on the mux), so one
``clawker run`` orchestration paid dozens of avoidable RTTs -- and the
parallel per-worker loop lanes multiply that churn across 8+ threads
sharing an engine endpoint.

:class:`ConnectionPool` keeps a bounded LIFO of idle persistent
connections per endpoint (one pool per :class:`~.httpapi.HTTPDockerAPI`
instance).  Checkout is thread-safe: a connection is owned exclusively
by one request between :meth:`checkout` and :meth:`checkin`, so the
scheduler's per-worker lanes never interleave bytes on a socket.
Streams, ``/events`` and hijacked attach/exec connections use
:meth:`dedicated` sockets that are never pooled.

Telemetry: dials, reuses and stale retries are counted
(:meth:`stats`), and each dial rides the ``util/phases`` stopwatch
under ``engine.dial`` so bench.py's cold-start attribution can say how
many sockets a run opened and what the dialing cost.

The port's copy of ``clawker_tpu/engine/pool.py``, whole.
"""

from __future__ import annotations

import http.client
import socket
import threading
import time
from typing import Callable

from ..util import phases
from .. import telemetry

SocketFactory = Callable[[], socket.socket]

# Registry metrics (telemetry subsystem): one process-wide family each,
# shared by every pool instance -- a process talks to one fleet.
_DIALS = telemetry.counter(
    "engine_dials_total", "Engine-API socket dials")
_REUSES = telemetry.counter(
    "engine_reuses_total", "Engine-API pooled-connection reuses")
_STALE_RETRIES = telemetry.counter(
    "engine_stale_retries_total",
    "Unary requests retried on a fresh dial after a reaped idle socket")
_SUPPRESSED_RETRIES = telemetry.counter(
    "engine_retries_suppressed_total",
    "Stale-socket retries suppressed because the verb is not idempotent")

# Sized for the loop scheduler's fan-out: 8 per-worker lanes plus the
# event feeder can share one endpoint without churning sockets.
DEFAULT_MAX_IDLE = 8
# The docker daemon reaps idle keep-alive connections after ~5 minutes;
# reap ours first so a checkout rarely hands back a socket the daemon
# already closed (the stale-retry path covers the race when it does).
DEFAULT_IDLE_TTL_S = 60.0


class _SockConnection(http.client.HTTPConnection):
    """HTTPConnection over an arbitrary pre-dialed socket."""

    def __init__(self, factory: SocketFactory,
                 on_dial: Callable[[], None] | None = None):
        super().__init__("localhost")
        self._factory = factory
        self._on_dial = on_dial
        self.idle_since = 0.0  # set by ConnectionPool.checkin

    def connect(self) -> None:  # type: ignore[override]
        with phases.phase("engine.dial"):
            self.sock = self._factory()
        if self._on_dial is not None:
            self._on_dial()


def _close_quietly(conn: http.client.HTTPConnection) -> None:
    try:
        conn.close()
    except Exception:
        pass


class ConnectionPool:
    """Bounded, thread-safe pool of idle keep-alive daemon connections.

    ``max_idle=0`` disables pooling entirely (every checkout dials
    fresh) -- the pre-pool behavior, kept reachable for the bench's
    dial-per-request baseline.
    """

    def __init__(self, factory: SocketFactory, *,
                 max_idle: int = DEFAULT_MAX_IDLE,
                 idle_ttl: float = DEFAULT_IDLE_TTL_S):
        self._factory = factory
        self.max_idle = max_idle
        self.idle_ttl = idle_ttl
        self._idle: list[_SockConnection] = []
        self._lock = threading.Lock()
        self._closed = False
        self._dials = 0
        self._reuses = 0
        self._stale_retries = 0
        self._suppressed_retries = 0

    # ---------------------------------------------------------- lifecycle

    def _count_dial(self) -> None:
        with self._lock:
            self._dials += 1
        _DIALS.inc()

    def _new(self) -> _SockConnection:
        return _SockConnection(self._factory, on_dial=self._count_dial)

    def checkout(self) -> tuple[_SockConnection, bool]:
        """-> (connection, reused).  Reaps idle connections past the TTL;
        the returned connection is exclusively owned until checkin."""
        now = time.monotonic()
        reaped: list[_SockConnection] = []
        conn: _SockConnection | None = None
        with self._lock:
            while self._idle:
                c = self._idle.pop()  # LIFO: warmest socket first
                if c.sock is None or now - c.idle_since > self.idle_ttl:
                    reaped.append(c)
                    continue
                self._reuses += 1
                conn = c
                break
        if conn is not None:
            _REUSES.inc()
        for c in reaped:
            _close_quietly(c)
        if conn is not None:
            return conn, True
        return self._new(), False

    def fresh(self) -> _SockConnection:
        """A guaranteed-fresh-dial connection (the stale-retry path must
        not be handed a second possibly-reaped idle socket)."""
        return self._new()

    def dedicated(self, *, unbounded: bool = True) -> _SockConnection:
        """Dial a connection that will never be pooled (streams, hijacks,
        ``/events``).  Dials eagerly so the factory's read timeout can be
        cleared: long-lived streams legitimately sit silent for hours."""
        conn = self._new()
        conn.connect()
        if unbounded and conn.sock is not None:
            conn.sock.settimeout(None)
        return conn

    def checkin(self, conn: _SockConnection) -> None:
        """Return a connection whose response was fully read.  Dropped
        (closed) when the pool is full, closed, or the socket died."""
        if conn.sock is None:
            return
        drop: _SockConnection | None = None
        with self._lock:
            if self._closed or len(self._idle) >= self.max_idle:
                drop = conn
            else:
                conn.idle_since = time.monotonic()
                self._idle.append(conn)
        if drop is not None:
            _close_quietly(drop)

    def note_stale_retry(self) -> None:
        with self._lock:
            self._stale_retries += 1
        _STALE_RETRIES.inc()

    def note_suppressed_retry(self) -> None:
        """A reused socket died before the status line under a
        NON-idempotent verb: the retry the idempotent path would take
        was suppressed (httpapi's allowlist) and the failure surfaced."""
        with self._lock:
            self._suppressed_retries += 1
        _SUPPRESSED_RETRIES.inc()

    # ---------------------------------------------------------- accessors

    def stats(self) -> dict:
        with self._lock:
            return {
                "dials": self._dials,
                "reuses": self._reuses,
                "stale_retries": self._stale_retries,
                "suppressed_retries": self._suppressed_retries,
                "idle": len(self._idle),
            }

    def close(self) -> None:
        """Drain-on-shutdown: close every idle connection.  Later
        checkouts still work (fresh dials); later checkins are dropped."""
        with self._lock:
            drain, self._idle = self._idle, []
            self._closed = True
        for c in drain:
            _close_quietly(c)
