"""BuildKit client session: secrets + ssh-agent forwarding over /session.

Docker's BuildKit lane can dial BACK into the client during a solve: the
client POSTs /session with an h2c upgrade, keeps the hijacked duplex
connection open, and serves gRPC on it; the daemon then calls the
client's services mid-build (secret mounts, ssh-agent forwarding, auth).
`RUN --mount=type=secret` and `--mount=type=ssh` only work on this lane.

Implementation: grpcio cannot serve on an already-connected socket, so
the session server listens on a private unix socket (inside a 0700
tmpdir -- never loopback TCP, which any local user could dial; ADVICE
r5) and a byte pump bridges the hijacked connection to it -- the
daemon's h2c traffic flows through the pump into a stock gRPC server.
Service payloads are hand-coded
protobufs (tiny messages; field numbers below are the wire contract):

  moby.buildkit.secrets.v1.Secrets/GetSecret
      req  field1 string id          resp field1 bytes data
  moby.sshforward.v1.SSH/CheckAgent
      req  field1 string id          resp (empty)
  moby.sshforward.v1.SSH/ForwardAgent   (bidi stream)
      both directions: field1 bytes data  <-> local ssh-agent socket

Parity reference: pkg/whail/buildkit/{client,solve}.go -- session-based
solve with secrets provider + ssh forwarding; re-designed on grpcio +
the loopback bridge instead of a vendored buildkit session library.

No dockerd exists in this build environment, so the wire behavior is
pinned by tests/test_bksession.py's daemon simulator: a real gRPC
CLIENT dialing through the same hijacked-socket bridge the daemon
would use.

The port's copy of ``clawker_tpu/engine/bksession.py``, whole.
"""

from __future__ import annotations

import os
import secrets as _secrets
import shutil
import socket
import tempfile
import threading
import uuid
from concurrent import futures

from .. import logsetup

log = logsetup.get("engine.bksession")

SECRETS_GET = "/moby.buildkit.secrets.v1.Secrets/GetSecret"
SSH_CHECK = "/moby.sshforward.v1.SSH/CheckAgent"
SSH_FORWARD = "/moby.sshforward.v1.SSH/ForwardAgent"
HEALTH_CHECK = "/grpc.health.v1.Health/Check"


# ------------------------------------------------------------ protobuf bits


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_varint(num: int, value: int) -> bytes:
    """Wire type 0 (varint): enums and ints -- NOT length-delimited."""
    return _varint(num << 3) + _varint(value)


def _parse_fields(data: bytes) -> dict[int, list[bytes]]:
    """Length-delimited fields only (all these messages use strings/bytes);
    varint/fixed fields are skipped."""
    out: dict[int, list[bytes]] = {}
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        num, wt = tag >> 3, tag & 7
        if wt == 2:
            ln, i = _read_varint(data, i)
            out.setdefault(num, []).append(data[i:i + ln])
            i += ln
        elif wt == 0:
            _, i = _read_varint(data, i)
        elif wt == 5:
            i += 4
        elif wt == 1:
            i += 8
        else:
            break
    return out


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = n = 0
    while i < len(data):
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
    return n, i


# ----------------------------------------------------------------- services


class SessionServices:
    """What this session exposes to the daemon."""

    def __init__(self, *, secrets: dict[str, bytes] | None = None,
                 ssh_auth_sock: str = ""):
        self.secrets = dict(secrets or {})
        self.ssh_auth_sock = ssh_auth_sock

    def exposed_methods(self) -> list[str]:
        out = [HEALTH_CHECK]
        if self.secrets:
            out.append(SECRETS_GET)
        if self.ssh_auth_sock:
            out += [SSH_CHECK, SSH_FORWARD]
        return out


def _grpc_handler(services: SessionServices):
    import grpc

    def get_secret(request: bytes, context):
        fields = _parse_fields(request)
        sid = (fields.get(1) or [b""])[0].decode("utf-8", "replace")
        if sid not in services.secrets:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"secret {sid} not found")
        return _field_bytes(1, services.secrets[sid])

    def check_agent(request: bytes, context):
        if not services.ssh_auth_sock:
            context.abort(grpc.StatusCode.NOT_FOUND, "no ssh agent")
        return b""

    def forward_agent(request_iterator, context):
        """Bidi byte stream <-> the local ssh-agent unix socket."""
        agent = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            agent.connect(services.ssh_auth_sock)
        except OSError as e:
            context.abort(grpc.StatusCode.UNAVAILABLE, f"agent: {e}")
        stop = threading.Event()

        def pump_in():
            try:
                for msg in request_iterator:
                    data = (_parse_fields(msg).get(1) or [b""])[0]
                    if data:
                        agent.sendall(data)
            except Exception:  # noqa: BLE001 - stream teardown
                pass
            finally:
                stop.set()
                try:
                    agent.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

        threading.Thread(target=pump_in, daemon=True).start()
        agent.settimeout(0.2)
        try:
            while True:
                try:
                    chunk = agent.recv(65536)
                except socket.timeout:
                    if stop.is_set():
                        break
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                yield _field_bytes(1, chunk)
        finally:
            agent.close()

    def health(request: bytes, context):
        # HealthCheckResponse.status = SERVING (field 1, enum -> varint):
        # buildkit polls this every second per session; a wire-type
        # mismatch here makes the daemon cancel the whole session
        return _field_varint(1, 1)

    ident = lambda x: x  # noqa: E731 - raw-bytes (de)serializers

    class Generic(grpc.GenericRpcHandler):
        def service(self, call_details):
            m = call_details.method
            if m == SECRETS_GET and services.secrets:
                return grpc.unary_unary_rpc_method_handler(
                    get_secret, request_deserializer=ident,
                    response_serializer=ident)
            if m == SSH_CHECK and services.ssh_auth_sock:
                return grpc.unary_unary_rpc_method_handler(
                    check_agent, request_deserializer=ident,
                    response_serializer=ident)
            if m == SSH_FORWARD and services.ssh_auth_sock:
                return grpc.stream_stream_rpc_method_handler(
                    forward_agent, request_deserializer=ident,
                    response_serializer=ident)
            if m == HEALTH_CHECK:
                return grpc.unary_unary_rpc_method_handler(
                    health, request_deserializer=ident,
                    response_serializer=ident)
            return None

    return Generic()


# ------------------------------------------------------------------ session


class Session:
    """One client session: private-socket gRPC server + hijack bridge.

    The bridge's gRPC server used to listen unauthenticated on loopback
    TCP (``127.0.0.1:0``) -- any local user could dial the ephemeral
    port and read build secrets or drive the ssh-agent forwarder while
    a build ran (ADVICE r5).  It now binds a unix socket inside a fresh
    ``0700`` tmpdir: filesystem permissions ARE the authentication, and
    nothing is reachable from the host's TCP namespace at all."""

    def __init__(self, services: SessionServices, *, name: str = "clawker"):
        import grpc

        self.services = services
        self.session_id = uuid.uuid4().hex
        self.name = name
        self.shared_key = _secrets.token_hex(16)
        # mkdtemp creates the dir 0700 already; chmod pins it against a
        # permissive umask-less override and documents the contract
        self._sock_dir = tempfile.mkdtemp(prefix="clawker-bk-")
        os.chmod(self._sock_dir, 0o700)
        self.socket_path = os.path.join(self._sock_dir, "session.sock")
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            handlers=(_grpc_handler(services),))
        self._server.add_insecure_port(f"unix:{self.socket_path}")
        self._server.start()
        self._pumps: list[threading.Thread] = []
        self._hijack = None

    # -- docker /session request surface --------------------------------

    def headers(self) -> dict[str, str]:
        return {
            "X-Docker-Expose-Session-Uuid": self.session_id,
            "X-Docker-Expose-Session-Name": self.name,
            "X-Docker-Expose-Session-Sharedkey": self.shared_key,
        }

    def method_headers(self) -> list[tuple[str, str]]:
        return [("X-Docker-Expose-Session-Grpc-Method", m)
                for m in self.services.exposed_methods()]

    # -- bridging --------------------------------------------------------

    def attach(self, hijacked) -> None:
        """Bridge a hijacked /session connection to the gRPC server: the
        daemon's h2c bytes flow into the private unix socket and back."""
        self._hijack = hijacked
        local = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        local.connect(self.socket_path)

        def daemon_to_grpc():
            try:
                while True:
                    data = hijacked.read(65536)
                    if not data:
                        break
                    local.sendall(data)
            except OSError:
                pass
            finally:
                try:
                    local.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

        def grpc_to_daemon():
            try:
                while True:
                    data = local.recv(65536)
                    if not data:
                        break
                    hijacked.write(data)
            except OSError:
                pass
            finally:
                try:
                    hijacked.close_write()
                except Exception:  # noqa: BLE001
                    pass

        for fn in (daemon_to_grpc, grpc_to_daemon):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"bksession-{fn.__name__}")
            t.start()
            self._pumps.append(t)

    def close(self) -> None:
        if self._hijack is not None:
            try:
                self._hijack.close()
            except Exception:  # noqa: BLE001
                pass
        self._server.stop(grace=0.5)
        for t in self._pumps:
            t.join(timeout=1.0)
        shutil.rmtree(self._sock_dir, ignore_errors=True)


def default_ssh_auth_sock() -> str:
    return os.environ.get("SSH_AUTH_SOCK", "")
