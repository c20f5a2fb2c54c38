"""Thin control client for the loopd socket (docs/loopd.md).

The CLI side of the daemon split: connect, hello, submit/attach/stream
over the agentd JSON-frame protocol.  ``discover`` is the degrade
seam -- it returns a connected client only when settings allow it AND
a daemon actually answers; every caller falls back to the in-process
scheduler on ``None``, so a missing/dead daemon costs one failed
``connect`` and nothing else.

The port's copy of ``clawker_tpu/loopd/client.py``, whole.  The
federation verbs (leases, ``adopt_run``) speak to the port's daemon
too: it adopts a journaled run from the shared logs dir and resumes it.
"""

from __future__ import annotations

import os
import socket
from pathlib import Path

from ..agentd import protocol
from ..errors import ClawkerError
from . import LoopdError, socket_path

DISCOVER_TIMEOUT_S = 2.0


class LoopdClient:
    """One connection to a loopd daemon.  Unary verbs are
    request/response; ``submit_run(stream=True)`` / ``attach`` turn the
    connection into an event stream consumed via :meth:`events`."""

    def __init__(self, path: Path | str, *, timeout: float = 10.0):
        self.path = Path(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        try:
            self._sock.connect(str(self.path))
        except OSError as e:
            self._sock.close()
            raise LoopdError(f"loopd socket {self.path}: {e}") from e
        self._hello: dict = {}
        self._detach_sent = False

    # --------------------------------------------------------- unary verbs

    def _call(self, msg: dict) -> dict:
        protocol.write_msg(self._sock, msg)
        reply = protocol.read_msg(self._sock)
        if reply.get("type") == "error":
            raise LoopdError(str(reply.get("error", "loopd error")))
        return reply

    def hello(self) -> dict:
        """Introduce this client; the daemon keys tenant accounting on
        the returned identity when a run names no tenant."""
        if not self._hello:
            self._hello = self._call({
                "type": "hello", "pid": os.getpid(), "uid": os.getuid(),
                "user": os.environ.get("USER", "")})
        return self._hello

    def ping(self) -> dict:
        return self._call({"type": "ping"})

    def status(self) -> dict:
        return self._call({"type": "status"})

    def daemon_project(self) -> str:
        """The project the daemon serves ('' when it has none)."""
        return str(self.hello().get("project", ""))

    def daemon_pod(self) -> str:
        """The pod name the daemon carries in a federation."""
        return str(self.hello().get("pod", ""))

    # -------------------------------------------- federation verbs
    # Capacity leases + run adoption (docs/federation.md): the router
    # side of the lease protocol and cross-pod migration.

    def lease_acquire(self, *, tenant: str = "", tokens: int = 0,
                      ttl_s: float = 0.0) -> dict:
        """Acquire a bounded block of launch credits from this pod's
        admission controller (0 = the pod's configured defaults).
        Returns the lease doc; ``tokens`` may come back clamped (or 0
        with ``retry_after_s`` when the pod's credit pool is out)."""
        return self._call({"type": "lease_acquire", "tenant": tenant,
                           "tokens": tokens, "ttl_s": ttl_s})

    def lease_renew(self, lease_id: str) -> dict:
        """Refresh a lease's TTL and credit block.  Raises
        :class:`LoopdError` when the lease already lapsed -- the
        caller must re-acquire."""
        return self._call({"type": "lease_renew", "lease": lease_id})

    def lease_release(self, lease_id: str) -> dict:
        return self._call({"type": "lease_release", "lease": lease_id})

    def adopt_run(self, run_ref: str, *, orphan_grace_s: float | None = None,
                  keep: bool = False, stream: bool = False) -> dict:
        """Ask this pod to adopt a dead pod's journaled run (replay +
        resume under its own admission; cross-pod migration).  With
        ``stream`` the connection then carries the adopted run's event
        frames via :meth:`events`."""
        msg: dict = {"type": "adopt_run", "run": run_ref, "keep": keep,
                     "stream": stream}
        if orphan_grace_s is not None:
            msg["orphan_grace_s"] = orphan_grace_s
        return self._call(msg)

    def submit_run(self, spec_doc: dict, *, keep: bool = False,
                   stream: bool = True, tp: str = "",
                   clock_offset_s: float = 0.0) -> dict:
        """Submit a loop run; returns the ack (``run`` id, tenant,
        agent names).  With ``stream`` the connection then carries the
        run's event frames -- consume them via :meth:`events`.

        ``tp`` / ``clock_offset_s`` are the federation router's trace
        propagation fields (docs/tracing.md): its submit span's
        traceparent and its cumulative clock-offset estimate for this
        pod, riding the frame the submit already pays for."""
        msg: dict = {"type": "submit_run", "spec": spec_doc,
                     "keep": keep, "stream": stream}
        if tp:
            msg["tp"] = tp
        if clock_offset_s:
            msg["clock_offset_s"] = round(clock_offset_s, 6)
        return self._call(msg)

    def attach(self, run_ref: str) -> dict:
        """Attach to a hosted run (id or unambiguous prefix); returns
        the snapshot ack and switches this connection to streaming."""
        return self._call({"type": "attach", "run": run_ref})

    def stop_run(self, run_ref: str) -> dict:
        return self._call({"type": "stop_run", "run": run_ref})

    def shutdown(self) -> dict:
        """Ask the daemon to drain every hosted run and exit."""
        return self._call({"type": "shutdown"})

    # ----------------------------------------------------------- streaming

    def events(self):
        """Yield event frames after ``submit_run(stream=True)`` /
        ``attach``, ending after the ``run_done`` frame.  Raises
        :class:`~clawker_tpu_torch.agentd.protocol.ConnectionClosed` when the
        daemon (or a concurrent :meth:`detach`) drops the stream."""
        self._sock.settimeout(None)
        while True:
            frame = protocol.read_msg(self._sock)
            yield frame
            if frame.get("type") == "run_done":
                return

    def detach(self) -> None:
        """Leave the stream WITHOUT stopping the run: best-effort
        detach frame, then shut the socket down so a reader blocked in
        :meth:`events` wakes immediately (the Ctrl-C path runs this
        from the signal handler)."""
        if self._detach_sent:
            return
        self._detach_sent = True
        try:
            protocol.write_msg(self._sock, {"type": "detach"})
        except (OSError, ClawkerError):
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "LoopdClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def discover(cfg, *, sock_path: Path | None = None,
             require_project: str | None = None) -> LoopdClient | None:
    """A connected client when a daemon is discoverable, else None.

    ``None`` on: settings ``loopd.enable`` off, no socket file, nothing
    answering (stale socket from a SIGKILLed daemon), a handshake
    error, or -- when ``require_project`` is given -- a daemon serving
    a DIFFERENT project (container names and labels key on the project,
    so submitting across projects would run the wrong workload).
    """
    if not cfg.settings.loopd.enable:
        return None
    path = sock_path if sock_path is not None else socket_path(cfg)
    if not path.exists():
        return None
    try:
        client = LoopdClient(path, timeout=DISCOVER_TIMEOUT_S)
    except ClawkerError:
        return None
    try:
        client.hello()
    except (ClawkerError, OSError):
        client.close()
        return None
    if require_project is not None:
        served = client.daemon_project()
        if served and served != require_project:
            client.close()
            return None
    return client


def discover_all(cfg, *, require_project: str | None = None
                 ) -> list[LoopdClient]:
    """EVERY project-matching daemon endpoint, one connected client per
    pod: the canonical single-pod socket first, then each settings
    ``federation.pods`` entry (docs/federation.md).  Duplicate paths
    collapse; dead/foreign sockets are skipped exactly as
    :func:`discover` skips them.  With no federation configured this is
    ``[discover(cfg)]``-or-``[]`` -- the single-pod behavior unchanged."""
    if not cfg.settings.loopd.enable:
        return []
    seen: set[str] = set()
    clients: list[LoopdClient] = []
    candidates = [socket_path(cfg)]
    candidates += [Path(p) for p in cfg.settings.federation.pods]
    for path in candidates:
        key = str(path)
        if key in seen:
            continue
        seen.add(key)
        client = discover(cfg, sock_path=path,
                          require_project=require_project)
        if client is not None:
            clients.append(client)
    return clients
