"""Client for the native clawker-supervisord control socket.

Wire format (native/agentsup/supervisor.cpp): netstring frames
``<len>:<payload>,`` with NUL-separated fields; field 0 is the verb on
requests and the status on replies.

The port's copy of ``clawker_tpu/agentd/supervisor_client.py``, whole.
"""

from __future__ import annotations

import socket
from pathlib import Path

from ..errors import ClawkerError


class SupervisorError(ClawkerError):
    pass


def _encode(fields: list[str]) -> bytes:
    payload = b"\x00".join(f.encode() for f in fields)
    return str(len(payload)).encode() + b":" + payload + b","


class _FrameReader:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def read_frame(self, timeout: float | None = None) -> list[str]:
        self._sock.settimeout(timeout)
        while True:
            colon = self._buf.find(b":")
            if colon >= 0:
                length = int(self._buf[:colon])
                end = colon + 1 + length
                if len(self._buf) > end:
                    if self._buf[end : end + 1] != b",":
                        raise SupervisorError("malformed frame from supervisor")
                    payload = self._buf[colon + 1 : end]
                    self._buf = self._buf[end + 1 :]
                    return [f.decode() for f in payload.split(b"\x00")]
            chunk = self._sock.recv(4096)
            if not chunk:
                raise SupervisorError("supervisor closed the connection")
            self._buf += chunk


class SupervisorClient:
    """One connection to the supervisor socket; one blocking call at a time."""

    def __init__(self, sock_path: str | Path):
        self.path = str(sock_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(self.path)
        self._reader = _FrameReader(self._sock)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, fields: list[str], timeout: float | None = 10.0) -> list[str]:
        self._sock.sendall(_encode(fields))
        reply = self._reader.read_frame(timeout)
        if reply and reply[0] == "ERR":
            raise SupervisorError(reply[1] if len(reply) > 1 else "supervisor error")
        return reply

    # ------------------------------------------------------------- verbs

    def spawn(
        self,
        argv: list[str],
        *,
        uid: int = 0,
        gid: int = 0,
        cwd: str = "",
        env: dict[str, str] | None = None,
    ) -> int:
        """Start the user CMD (single-shot; second spawn raises).  Returns pid."""
        fields = ["SPAWN", str(uid), str(gid), cwd]
        fields.extend(f"{k}={v}" for k, v in (env or {}).items())
        fields.append("--")
        fields.extend(argv)
        reply = self._call(fields)
        return int(reply[1])

    def signal(self, signum: int) -> None:
        self._call(["SIGNAL", str(signum)])

    def status(self) -> tuple[str, int]:
        """-> ("idle" | "running" | "exited", pid-or-exit-code)."""
        reply = self._call(["STATUS"])
        kind = reply[0].lower()
        val = int(reply[1]) if len(reply) > 1 else 0
        return kind, val

    def wait(self, timeout: float | None = None) -> int:
        """Block until the user CMD exits; returns its bash-convention code."""
        reply = self._call(["WAIT"], timeout=timeout)
        if reply[0] != "EXIT":
            raise SupervisorError(f"unexpected WAIT reply: {reply}")
        return int(reply[1])

    def shutdown(self, grace_ms: int = 5000) -> None:
        """TERM the user CMD; after ``grace_ms`` the watchdog SIGKILLs."""
        self._call(["SHUTDOWN", str(grace_ms)])
