"""CP-side session client: dial agentd, run plans, stream shell output.

Parity reference: controlplane/agent/dialer.go (DialAgent :211) and
exec.go Step plans -- the CP is the dialing side of the CP->agentd mTLS
session; the client cert is the CP identity, server verification is
CA-grounded but hostname-free (containers are dialed by IP; the reference
uses permissive trust with thumbprint classification, dialer.go:123).

The port's copy of ``clawker_tpu/controlplane/session_client.py``, whole.
"""

from __future__ import annotations

import socket
import ssl
import time
from dataclasses import dataclass, field
from pathlib import Path

from .. import consts, logsetup
from ..agentd.protocol import ConnectionClosed, read_msg, unb64, write_msg
from ..errors import ClawkerError

log = logsetup.get("cp.session")


class SessionError(ClawkerError):
    pass


@dataclass
class ShellResult:
    code: int
    stdout: bytes = b""
    stderr: bytes = b""
    stage_codes: list[int] = field(default_factory=list)


@dataclass
class Hello:
    initialized: bool
    cmd_running: bool
    pid: int = 0


class SessionClient:
    """One mTLS session to one agentd.  Not thread-safe; the executor owns it."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        cert_file: Path,
        key_file: Path,
        ca_file: Path,
        timeout: float = 10.0,
    ):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(cert_file, key_file)
        ctx.load_verify_locations(ca_file)
        ctx.check_hostname = False          # dialed by IP; CA signature grounds trust
        ctx.verify_mode = ssl.CERT_REQUIRED
        raw = socket.create_connection((host, port), timeout=timeout)
        self._sock = ctx.wrap_socket(raw, server_hostname=host)
        self._seq = 0

    def close(self) -> None:
        try:
            write_msg(self._sock, {"type": "bye"})
        except (OSError, ClawkerError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- verbs

    def hello(self) -> Hello:
        write_msg(self._sock, {"type": "hello"})
        ack = read_msg(self._sock)
        if ack.get("type") != "hello_ack":
            raise SessionError(f"expected hello_ack, got {ack.get('type')}")
        return Hello(
            initialized=bool(ack.get("initialized")),
            cmd_running=bool(ack.get("cmd_running")),
            pid=int(ack.get("pid") or 0),
        )

    def run_shell(
        self,
        stages: list[dict],
        *,
        env: dict[str, str] | None = None,
        cwd: str = "",
        stdin: bytes | None = None,
        timeout: float = 120.0,
    ) -> ShellResult:
        """Run a pipeline to completion, collecting output.

        ``stages`` = [{"argv": [...], "uid": 0, "gid": 0}, ...].
        """
        self._seq += 1
        job_id = f"s{self._seq}"
        write_msg(
            self._sock,
            {"type": "shell", "id": job_id, "stages": stages, "env": env or {}, "dir": cwd},
        )
        prev_timeout = self._sock.gettimeout()
        res = ShellResult(code=-1)
        started = False
        deadline = time.monotonic() + timeout
        try:
            return self._collect_shell(job_id, res, started, deadline, stdin)
        finally:
            self._sock.settimeout(prev_timeout)

    def _collect_shell(self, job_id, res, started, deadline, stdin) -> ShellResult:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise SessionError(f"shell {job_id}: timeout")
            self._sock.settimeout(remaining)
            msg = read_msg(self._sock)
            t = msg.get("type")
            if t == "started" and msg.get("id") == job_id:
                started = True
                if stdin is not None:
                    from ..agentd.protocol import b64

                    write_msg(self._sock, {"type": "stdin", "id": job_id, "data": b64(stdin)})
                    write_msg(self._sock, {"type": "close_stdin", "id": job_id})
            elif t == "output" and msg.get("id") == job_id:
                data = unb64(msg.get("data", ""))
                if msg.get("fd") == 2:
                    res.stderr += data
                else:
                    res.stdout += data
            elif t == "stage_exit" and msg.get("id") == job_id:
                res.stage_codes.append(int(msg.get("code") or 0))
            elif t == "done" and msg.get("id") == job_id:
                res.code = int(msg.get("code") or 0)
                return res
            elif t == "error":
                raise SessionError(f"shell {job_id}: {msg.get('error')} (started={started})")
            # unrelated frames (other jobs' output) are skipped

    def agent_ready(
        self,
        argv: list[str],
        *,
        uid: int = 0,
        gid: int = 0,
        env: dict[str, str] | None = None,
        cwd: str = "",
    ) -> int:
        write_msg(
            self._sock,
            {
                "type": "agent_ready",
                "argv": argv,
                "uid": uid,
                "gid": gid,
                "env": env or {},
                "cwd": cwd,
            },
        )
        ack = read_msg(self._sock)
        if ack.get("type") != "ready_ack":
            raise SessionError(f"agent_ready failed: {ack.get('error', ack)}")
        return int(ack.get("pid") or 0)

    def agent_initialized(self) -> None:
        write_msg(self._sock, {"type": "agent_initialized"})
        ack = read_msg(self._sock)
        if ack.get("type") != "init_ack":
            raise SessionError(f"agent_initialized failed: {ack.get('error', ack)}")

    def register_required(self, cp_host: str, cp_port: int) -> None:
        write_msg(
            self._sock,
            {"type": "register_required", "cp_host": cp_host, "cp_port": cp_port},
        )
        ack = read_msg(self._sock)
        if ack.get("type") != "register_done" or not ack.get("ok"):
            raise SessionError(f"register failed: {ack.get('error', ack)}")


def dial_with_retry(
    host: str,
    port: int,
    *,
    cert_file: Path,
    key_file: Path,
    ca_file: Path,
    deadline_s: float = 30.0,
    base_delay_s: float = 0.2,
) -> SessionClient:
    """Dial with capped exponential backoff (reference: dialer.go:703-829
    retry/backoff with deadline)."""
    deadline = time.monotonic() + deadline_s
    delay = base_delay_s
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            return SessionClient(
                host, port, cert_file=cert_file, key_file=key_file, ca_file=ca_file
            )
        except (OSError, ssl.SSLError, ConnectionClosed) as e:
            last = e
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2, 5.0)
    raise SessionError(f"dial {host}:{port} failed within {deadline_s}s: {last}")
