"""The gitguard proxy: smart-HTTP in, policy-filtered git out.

The port's copy of ``clawker_tpu/gitguard/server.py``, whole.

Topology (docs/git-policy.md): an agent container's ``git push`` dials
the MITM'd git host; Envoy terminates TLS, verifies the client
leaf, stamps ``X-Clawker-Identity``, and forwards the request over this
server's unix socket (0600 socket / 0700 dir -- the loopd/workerd
hardening pattern, so only the envoy/loopd user can reach it).  The
guard filters the advertisement, judges every receive-pack command,
and only then lets bytes touch the upstream.

Upstreams are pluggable because the two deployment lanes differ:

- :class:`LocalRepoUpstream` -- the swarm-on-a-repo lane.  The "git
  host" is the run's own seed repository on this host; stateless-RPC
  git subprocesses (``upload-pack``/``receive-pack``) serve it exactly
  the way ``git http-backend`` would.
- :class:`FakeGitUpstream` -- an in-memory ref store for the chaos
  soak and the push-overhead bench: no subprocesses, but it *records
  every acknowledged ref update*, which is precisely the evidence the
  ``ref-isolation-at-proxy`` invariant audits.

Fail-closed: the guard is the only allowed git path (ssh/22 and
git/9418 carry run-scoped deny pins), so killing this process turns
every push into a connection error at the client -- refused, never
passed through.  The chaos ``gitguard_down`` fault proves it.
"""

from __future__ import annotations

import os
import socket
import socketserver
import subprocess
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from pathlib import Path
from typing import Callable
from urllib.parse import parse_qs, urlparse

from .. import telemetry
from ..errors import ClawkerError
from .pktline import (
    DATA,
    FLUSH_PKT,
    PktError,
    encode_pkt,
    encode_sideband,
    iter_pkts,
)
from .protocol import (
    GIT_RECEIVE_PACK,
    GIT_UPLOAD_PACK,
    SERVICES,
    PushRequest,
    error_response,
    filter_advertisement,
    parse_receive_commands,
    parse_upload_pack_wants,
    refusal_response,
)
from .refpolicy import (
    ALLOW,
    DENY,
    IDENTITY_HEADER,
    AgentIdentity,
    Decision,
    RefPolicy,
)

M_REQUESTS = telemetry.counter(
    "gitguard_requests_total",
    "smart-HTTP requests through the gitguard proxy", ("service",))
M_REFS_HIDDEN = telemetry.counter(
    "gitguard_refs_hidden_total",
    "refs hidden from advertisements by namespace policy")
M_ALLOWED = telemetry.counter(
    "gitguard_updates_allowed_total",
    "receive-pack ref updates allowed through to the upstream")
M_REFUSED = telemetry.counter(
    "gitguard_updates_refused_total",
    "receive-pack ref updates refused by policy", ("reason",))
M_DECISION_S = telemetry.histogram(
    "gitguard_decision_seconds",
    "policy decision + filter latency per request")


def reason_class(reason: str) -> str:
    """Collapse a free-text refusal reason to a bounded metric label."""
    if not reason:
        return "none"
    if "namespace" in reason:
        return "namespace"
    if "merge-queue" in reason or "integration" in reason:
        return "integration"
    if "unauthenticated" in reason:
        return "unauth"
    if "run" in reason and "match" in reason:
        return "run_mismatch"
    if "ref name" in reason or "refs/" in reason:
        return "badref"
    return "malformed"


class GitguardError(ClawkerError):
    """Proxy-side failure (upstream subprocess died, bad configuration)."""


# --------------------------------------------------------------- upstreams


class LocalRepoUpstream:
    """Serve a local repository over stateless-RPC git subprocesses.

    This is what ``git http-backend`` execs after its CGI parsing; by
    invoking ``upload-pack``/``receive-pack`` directly the guard skips
    the CGI layer (and its env-smuggling surface) entirely.
    """

    def __init__(self, repo: str | Path, *, git_bin: str = "git",
                 timeout_s: float = 30.0):
        self.repo = str(repo)
        self.git_bin = git_bin
        self.timeout_s = timeout_s

    def _run(self, args: list[str], stdin: bytes = b"") -> bytes:
        env = dict(os.environ)
        # Never let a guarded push recurse through hooks into the
        # network, and keep receive-pack quiet about its identity.
        env.setdefault("GIT_CONFIG_NOSYSTEM", "1")
        try:
            proc = subprocess.run(
                [self.git_bin, *args], input=stdin,
                capture_output=True, timeout=self.timeout_s, env=env)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise GitguardError(f"git upstream failed: {exc}") from exc
        if proc.returncode != 0 and not proc.stdout:
            raise GitguardError(
                "git upstream exited "
                f"{proc.returncode}: {proc.stderr.decode(errors='replace')}")
        return proc.stdout

    def advertise(self, service: str) -> bytes:
        sub = service.removeprefix("git-")
        body = self._run([sub, "--stateless-rpc", "--advertise-refs",
                          self.repo])
        head = encode_pkt(f"# service={service}\n") + FLUSH_PKT
        return head + body

    def call(self, service: str, body: bytes) -> bytes:
        sub = service.removeprefix("git-")
        return self._run([sub, "--stateless-rpc", self.repo], stdin=body)


@dataclass
class FakeGitUpstream:
    """In-memory git host: a ref map + an acknowledged-update log.

    ``acknowledged`` is the ground truth the chaos invariant audits: a
    tuple per ref update the upstream actually applied.  If isolation
    holds at the proxy, no cross-agent ref ever lands here.
    """

    refs: dict[str, str] = field(default_factory=dict)
    acknowledged: list[tuple[float, str, str]] = field(default_factory=list)
    #             (monotonic_ts, identity_header, ref)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    caller: str = ""            # set per-request by the server

    def advertise(self, service: str) -> bytes:
        head = encode_pkt(f"# service={service}\n") + FLUSH_PKT
        caps = ("report-status side-band-64k agent=clawker-fake"
                if service == GIT_RECEIVE_PACK
                else "side-band-64k agent=clawker-fake")
        body = bytearray()
        first = True
        with self._lock:
            items = sorted(self.refs.items())
        for ref, sha in items:
            if first:
                body += encode_pkt(f"{sha} {ref}".encode() + b"\x00" +
                                   caps.encode() + b"\n")
                first = False
            else:
                body += encode_pkt(f"{sha} {ref}\n")
        if first:
            body += encode_pkt(("0" * 40 + " capabilities^{}").encode() +
                               b"\x00" + caps.encode() + b"\n")
        body += FLUSH_PKT
        return head + bytes(body)

    def call(self, service: str, body: bytes) -> bytes:
        if service != GIT_RECEIVE_PACK:
            return error_response("fake upstream serves pushes only")
        push = parse_receive_commands(body)
        status = bytearray()
        status += encode_pkt("unpack ok\n")
        with self._lock:
            for cmd in push.commands:
                self.refs[cmd.ref] = cmd.new_sha
                self.acknowledged.append(
                    (time.monotonic(), self.caller, cmd.ref))
                status += encode_pkt(f"ok {cmd.ref}\n")
        status += FLUSH_PKT
        if push.wants_sideband:
            return encode_sideband(1, bytes(status)) + FLUSH_PKT
        return bytes(status)


# ------------------------------------------------------------------ server


class _UnixHTTPServer(socketserver.ThreadingMixIn, socketserver.TCPServer):
    address_family = socket.AF_UNIX
    allow_reuse_address = False
    daemon_threads = True

    def __init__(self, sock: socket.socket, handler):
        # The hardened, already-bound + listening socket is adopted
        # whole: bind/umask/chmod happen in GitguardServer.start so
        # the 0600 pin covers the bind itself.
        socketserver.BaseServer.__init__(self, sock.getsockname(), handler)
        self.socket = sock

    def get_request(self):
        request, _ = self.socket.accept()
        return request, ("local", 0)


class _TcpHTTPServer(socketserver.ThreadingMixIn, socketserver.TCPServer):
    allow_reuse_address = True
    daemon_threads = True


class GitguardServer:
    """The proxy server: bind, filter, judge, forward (or refuse)."""

    def __init__(self, upstream, policy: RefPolicy, *,
                 socket_path: str | Path | None = None,
                 tcp_addr: tuple[str, int] | None = None,
                 on_decision: Callable[[Decision], None] | None = None):
        if (socket_path is None) == (tcp_addr is None):
            raise GitguardError(
                "exactly one of socket_path / tcp_addr required")
        self.upstream = upstream
        self.policy = policy
        self.socket_path = Path(socket_path) if socket_path else None
        self.tcp_addr = tcp_addr
        self.on_decision = on_decision
        self._httpd: socketserver.TCPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle

    def start(self) -> "GitguardServer":
        handler = _make_handler(self)
        if self.socket_path is not None:
            rt = self.socket_path.parent
            rt.mkdir(parents=True, exist_ok=True)
            os.chmod(rt, 0o700)
            if self.socket_path.exists():
                self.socket_path.unlink()
            listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            old_umask = os.umask(0o177)     # cover the bind itself
            try:
                listener.bind(str(self.socket_path))
            finally:
                os.umask(old_umask)
            os.chmod(self.socket_path, 0o600)   # umask-proof pin
            listener.listen(64)
            httpd = _UnixHTTPServer(listener, handler)
        else:
            httpd = _TcpHTTPServer(self.tcp_addr, handler)
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="gitguard", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        """Bound TCP port (tests bind port 0 and read it back here)."""
        if self._httpd is None or self.tcp_addr is None:
            return 0
        return self._httpd.server_address[1]

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self.socket_path is not None:
            try:
                self.socket_path.unlink()
            except OSError:
                pass

    @property
    def running(self) -> bool:
        return self._httpd is not None

    # -- decision plumbing

    def _emit(self, d: Decision) -> None:
        if d.verdict == ALLOW:
            M_ALLOWED.labels().inc()
        else:
            M_REFUSED.labels(reason_class(d.reason)).inc()
        if self.on_decision is not None:
            try:
                self.on_decision(d)
            except Exception:
                pass        # observers never take the data plane down

    # -- request handling (called from the HTTP handler)

    def handle_info_refs(self, service: str,
                         identity: AgentIdentity | None,
                         ) -> tuple[int, str, bytes]:
        M_REQUESTS.labels(service).inc()
        t0 = time.monotonic()
        raw = self.upstream.advertise(service)
        body, hidden = filter_advertisement(
            raw, service, self.policy, identity)
        if hidden:
            M_REFS_HIDDEN.labels().inc(hidden)
        M_DECISION_S.labels().observe(time.monotonic() - t0)
        ctype = f"application/x-{service}-advertisement"
        return 200, ctype, body

    def handle_receive_pack(self, body: bytes,
                            identity: AgentIdentity | None,
                            ) -> tuple[int, str, bytes]:
        M_REQUESTS.labels(GIT_RECEIVE_PACK).inc()
        ctype = f"application/x-{GIT_RECEIVE_PACK}-result"
        t0 = time.monotonic()
        try:
            push = parse_receive_commands(body)
        except PktError as exc:
            d = Decision(DENY, f"malformed push: {exc}",
                         service=GIT_RECEIVE_PACK,
                         agent=identity.agent if identity else "",
                         run=self.policy.run)
            self._emit(d)
            M_DECISION_S.labels().observe(time.monotonic() - t0)
            empty = PushRequest(commands=(), caps=(), pack=b"")
            return 200, ctype, refusal_response(
                empty, [d], unpack_error=f"error {exc}")
        verdicts = [self.policy.may_update(identity, cmd.ref)
                    for cmd in push.commands]
        for d in verdicts:
            self._emit(d)
        M_DECISION_S.labels().observe(time.monotonic() - t0)
        if any(not d.allowed for d in verdicts) or not push.commands:
            return 200, ctype, refusal_response(push, verdicts)
        if hasattr(self.upstream, "caller"):
            self.upstream.caller = identity.header_value() if identity \
                else ""
        return 200, ctype, self.upstream.call(GIT_RECEIVE_PACK, body)

    def handle_upload_pack(self, body: bytes,
                           identity: AgentIdentity | None,
                           ) -> tuple[int, str, bytes]:
        M_REQUESTS.labels(GIT_UPLOAD_PACK).inc()
        ctype = f"application/x-{GIT_UPLOAD_PACK}-result"
        t0 = time.monotonic()
        wants = parse_upload_pack_wants(body)
        visible = self._visible_shas(identity)
        hidden_wants = [w for w in wants if visible is not None
                        and w not in visible]
        M_DECISION_S.labels().observe(time.monotonic() - t0)
        if hidden_wants:
            d = Decision(DENY, "want of a hidden ref refused",
                         service=GIT_UPLOAD_PACK, ref=hidden_wants[0],
                         agent=identity.agent if identity else "",
                         run=self.policy.run)
            self._emit(d)
            return 200, ctype, error_response(
                "upload-pack: not our ref " + hidden_wants[0])
        return 200, ctype, self.upstream.call(GIT_UPLOAD_PACK, body)

    def _visible_shas(self, identity: AgentIdentity | None,
                      ) -> set[str] | None:
        """Tip shas the caller may want.  None = cannot determine (then
        depth/tag wants would false-positive, so we do not block)."""
        try:
            raw = self.upstream.advertise(GIT_UPLOAD_PACK)
        except Exception:
            return None
        visible: set[str] = set()
        for p in iter_pkts(raw, tolerate_truncated=True):
            if p.kind != DATA or p.payload.startswith(b"# service="):
                continue
            line = p.payload.split(b"\x00", 1)[0].decode(
                "utf-8", "replace").rstrip("\n")
            parts = line.split(" ", 1)
            if len(parts) != 2:
                continue
            sha, ref = parts
            base_ref = ref[:-3] if ref.endswith("^{}") else ref
            if self.policy.may_read(identity, base_ref):
                visible.add(sha)
        return visible


def _make_handler(guard: GitguardServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "gitguard"

        def address_string(self):   # unix sockets have no peer addr
            return "local"

        def log_message(self, fmt, *args):
            pass

        def _identity(self) -> AgentIdentity | None:
            # Duplicate identity headers are a smuggling shape (a
            # client-supplied header riding alongside Envoy's): treat
            # conflicting values as no identity at all -- fail closed.
            values = {v.strip() for v in
                      (self.headers.get_all(IDENTITY_HEADER) or [])}
            if len(values) != 1:
                return None
            return AgentIdentity.from_header(next(iter(values)))

        def _read_body(self) -> bytes:
            if (self.headers.get("Transfer-Encoding", "")
                    .lower() == "chunked"):
                chunks = bytearray()
                while True:
                    size_line = self.rfile.readline(64).strip()
                    try:
                        size = int(size_line.split(b";")[0], 16)
                    except ValueError:
                        break
                    if size == 0:
                        self.rfile.readline(8)      # trailing CRLF
                        break
                    chunks += self.rfile.read(size)
                    self.rfile.readline(8)          # chunk CRLF
                return bytes(chunks)
            length = int(self.headers.get("Content-Length", "0") or 0)
            return self.rfile.read(length) if length else b""

        def _respond(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urlparse(self.path)
            if not parsed.path.endswith("/info/refs"):
                self._respond(404, "text/plain", b"not found\n")
                return
            service = (parse_qs(parsed.query).get("service") or [""])[0]
            if service not in SERVICES:
                # dumb-protocol fallback is an unfiltered lane: refuse.
                self._respond(403, "text/plain",
                              b"smart protocol required\n")
                return
            try:
                code, ctype, body = guard.handle_info_refs(
                    service, self._identity())
            except (PktError, GitguardError) as exc:
                self._respond(502, "text/plain",
                              f"gitguard: {exc}\n".encode())
                return
            self._respond(code, ctype, body)

        def do_POST(self):
            parsed = urlparse(self.path)
            body = self._read_body()
            identity = self._identity()
            try:
                if parsed.path.endswith("/" + GIT_RECEIVE_PACK):
                    code, ctype, out = guard.handle_receive_pack(
                        body, identity)
                elif parsed.path.endswith("/" + GIT_UPLOAD_PACK):
                    code, ctype, out = guard.handle_upload_pack(
                        body, identity)
                else:
                    self._respond(404, "text/plain", b"not found\n")
                    return
            except (PktError, GitguardError) as exc:
                self._respond(502, "text/plain",
                              f"gitguard: {exc}\n".encode())
                return
            self._respond(code, ctype, out)

    return Handler
