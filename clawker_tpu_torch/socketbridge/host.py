"""Host-side bridge: relay container connections to the real agent sockets.

One ``Bridge`` per container: it launches the container-side endpoint
over ``docker exec`` (stdio hijack) and, for every OPEN frame, dials the
corresponding host socket (``SSH_AUTH_SOCK`` / gpg-agent extra socket)
and pumps bytes both ways.  ``SocketBridgeManager`` keys bridges by
container and tears them down on container stop.

Parity reference: internal/socketbridge Manager (manager.go:43) +
Bridge (bridge.go:59).

The port's copy of ``clawker_tpu/socketbridge/host.py``, whole: the
container-side command names ``clawker_tpu_torch.socketbridge.container``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading

from .. import consts, logsetup
from ..errors import ClawkerError
from .protocol import K_CLOSE, K_DATA, K_OPEN, W_GPG, W_SSH, chunked, pack, read_frame

log = logsetup.get("socketbridge")

CONTAINER_CMD = [
    "python3", "-c",
    # zipapp on sys.path -> the package imports resolve from inside it
    "import sys; sys.path.insert(0, '" + consts.AGENTD_PYZ_PATH + "'); "
    "from clawker_tpu_torch.socketbridge.container import main; sys.exit(main())",
]


_gpgconf_cache: str | None = None


def _gpgconf_extra_socket() -> str:
    """One SUCCESSFUL gpgconf subprocess per process: the answer depends
    only on the gpg home, and the probe was a fixed per-create cost.
    Failures stay retryable -- a host that grows a gpg setup mid-process
    must not be locked out of agent forwarding until restart."""
    global _gpgconf_cache
    if _gpgconf_cache is not None:
        return _gpgconf_cache
    try:
        res = subprocess.run(
            ["gpgconf", "--list-dirs", "agent-extra-socket"],
            capture_output=True, text=True, timeout=5,
        )
        if res.returncode == 0:
            _gpgconf_cache = res.stdout.strip()
            return _gpgconf_cache
    except (OSError, subprocess.SubprocessError):
        pass
    return ""


def default_host_sockets() -> dict[int, str]:
    out: dict[int, str] = {}
    ssh = os.environ.get("SSH_AUTH_SOCK", "")
    if ssh:
        out[W_SSH] = ssh
    gpg = os.environ.get("GPG_AGENT_EXTRA_SOCK", "") or _gpgconf_extra_socket()
    if gpg and os.path.exists(gpg):
        out[W_GPG] = gpg
    return out


class Bridge:
    """Pump frames between one exec stream and the host agent sockets.

    ``stream`` needs ``read(n)``, ``write(bytes)`` and ``close()`` --
    satisfied by the engine's HijackedStream and by test pipes alike.
    """

    def __init__(self, stream, host_sockets: dict[int, str]):
        self.stream = stream
        self.host_sockets = host_sockets
        self._conns: dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.closed = threading.Event()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._pump, name="sockbridge",
                                        daemon=True)
        self._thread.start()

    def _send(self, frame: bytes) -> None:
        with self._lock:
            self.stream.write(frame)

    def _pump(self) -> None:
        try:
            while True:
                frame = read_frame(self.stream)
                if frame is None:
                    break
                channel, kind, which, payload = frame
                if kind == K_OPEN:
                    self._open(channel, which)
                elif kind == K_DATA:
                    conn = self._conns.get(channel)
                    if conn is not None:
                        try:
                            conn.sendall(payload)
                        except OSError:
                            self._drop(channel, which, notify=True)
                elif kind == K_CLOSE:
                    self._drop(channel, which, notify=False)
        except OSError:
            pass
        finally:
            self.close()

    def _open(self, channel: int, which: int) -> None:
        path = self.host_sockets.get(which)
        if not path:
            self._send(pack(channel, K_CLOSE, which))
            return
        try:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.connect(path)
        except OSError as e:
            log.warning("bridge open %d: %s: %s", which, path, e)
            self._send(pack(channel, K_CLOSE, which))
            return
        with self._lock:
            self._conns[channel] = conn
        threading.Thread(target=self._pump_host, args=(channel, which, conn),
                         daemon=True).start()

    def _pump_host(self, channel: int, which: int, conn: socket.socket) -> None:
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    break
                for frame in chunked(channel, which, data):
                    self._send(frame)
        except OSError:
            pass
        self._drop(channel, which, notify=True)

    def _drop(self, channel: int, which: int, *, notify: bool) -> None:
        with self._lock:
            conn = self._conns.pop(channel, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            if notify:
                try:
                    self._send(pack(channel, K_CLOSE, which))
                except OSError:
                    pass

    def close(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        with self._lock:
            for conn in self._conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()

        # off-thread: closing a buffered stream another thread is blocked
        # reading deadlocks on CPython's buffered-IO lock; sockets (the
        # real exec channel) close instantly, pipes unblock on peer EOF
        def _close_stream():
            try:
                self.stream.close()
            except OSError:
                pass

        threading.Thread(target=_close_stream, daemon=True).start()


class SocketBridgeManager:
    """Per-container bridges over docker exec (EnsureBridge semantics)."""

    def __init__(self, engine, host_sockets: dict[int, str] | None = None):
        self.engine = engine
        self.host_sockets = (host_sockets if host_sockets is not None
                             else default_host_sockets())
        self._bridges: dict[str, Bridge] = {}
        self._lock = threading.Lock()
        self._closed = False

    def ensure_bridge(self, container_ref: str) -> Bridge | None:
        if not self.host_sockets:
            log.debug("no host agent sockets to forward; bridge skipped")
            return None
        with self._lock:
            existing = self._bridges.get(container_ref)
            if existing is not None and not existing.closed.is_set():
                return existing
        # the exec is an engine round-trip (and on tpu_vm a WAN hop):
        # doing it under the lock coupled every other caller -- and
        # close() -- to the daemon's latency.  Dial outside, then
        # settle the install race under the lock; the loser's bridge
        # (and its exec stream) is closed, the winner is shared.
        _eid, stream = self.engine.exec(
            container_ref, CONTAINER_CMD, stdin=True, tty=False,
        )
        if stream is None:
            raise ClawkerError(
                f"socketbridge: exec into {container_ref} gave no stream")
        bridge = Bridge(_RawStream(stream), self.host_sockets)
        bridge.start()
        with self._lock:
            if self._closed:
                # manager torn down while our exec was in flight: a
                # bridge installed now would outlive every close()
                winner, loser = None, bridge
            else:
                existing = self._bridges.get(container_ref)
                if existing is not None and not existing.closed.is_set():
                    winner, loser = existing, bridge
                else:
                    self._bridges[container_ref] = bridge
                    winner, loser = bridge, None
        if loser is not None:
            loser.close()
            return winner
        log.info("socket bridge up for %s (%s)", container_ref,
                 ",".join(str(w) for w in self.host_sockets))
        return winner

    def drop_bridge(self, container_ref: str) -> None:
        with self._lock:
            bridge = self._bridges.pop(container_ref, None)
        if bridge is not None:
            bridge.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            bridges, self._bridges = list(self._bridges.values()), {}
        for b in bridges:
            b.close()


class _RawStream:
    """Adapt a HijackedStream (frames() for non-tty) to read/write bytes."""

    def __init__(self, stream):
        self._stream = stream
        self._frames = stream.frames() if hasattr(stream, "frames") else None
        self._buf = b""

    def read(self, n: int) -> bytes:
        if self._frames is None:
            return self._stream.read(n)
        while len(self._buf) < n:
            try:
                fd, payload = next(self._frames)
            except StopIteration:
                break
            if fd == 2:  # container-side stderr: surface, don't mux
                log.warning("bridge stderr: %s",
                            payload.decode(errors="replace").strip())
                continue
            self._buf += payload
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def write(self, data: bytes) -> None:
        self._stream.write(data)

    def close(self) -> None:
        self._stream.close()
