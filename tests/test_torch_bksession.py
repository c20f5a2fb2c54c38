"""The port's BuildKit session lane against the reference's, on the CPU.

Twins of tests/test_bksession.py's 12.  As there, the daemon's side of
the ``/session`` contract is a real gRPC client (grpcio) dialing through
the hijacked-socket bridge that dockerd would use: a socketpair end is
the "hijacked connection" handed to ``Session.attach``, the other end
is pumped to a loopback listener that a channel connects to.  Each twin
runs the same calls against the reference's ``bksession`` and the
port's and holds the port's answers, status codes and details to the
reference's.  Outputs are normalised only for the session's uuid, its
shared key and the buildid; no numeric tolerance is involved.
"""

from __future__ import annotations

import os
import socket
import stat
import threading
from types import SimpleNamespace

import click
import pytest

import clawker_tpu.cli.cmd_build as ref_cmd_build
import clawker_tpu.engine.bksession as ref_bksession
import clawker_tpu.engine.buildkit as ref_buildkit
import clawker_tpu.errors as ref_errors
import clawker_tpu_torch.cli.cmd_build as port_cmd_build
import clawker_tpu_torch.engine.bksession as port_bksession
import clawker_tpu_torch.engine.buildkit as port_buildkit
import clawker_tpu_torch.errors as port_errors

grpc = pytest.importorskip("grpc")

PKGS = {
    "ref": SimpleNamespace(B=ref_bksession, buildkit=ref_buildkit,
                           errors=ref_errors, cmd_build=ref_cmd_build),
    "port": SimpleNamespace(B=port_bksession, buildkit=port_buildkit,
                            errors=port_errors, cmd_build=port_cmd_build),
}
IDENT = lambda x: x  # noqa: E731


def both(fn):
    """``fn(m)`` for the reference's modules, then the port's: ->
    (reference's result, port's)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


class FakeHijack:
    """engine.httpapi.HijackedStream surface over a socketpair end."""

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def read(self, n: int = 65536) -> bytes:
        try:
            return self._sock.recv(n)
        except OSError:
            return b""

    def write(self, data: bytes) -> None:
        self._sock.sendall(data)

    def close_write(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self) -> None:
        self._sock.close()


@pytest.fixture()
def wired():
    """``wire(m, services_kw)`` -> a grpc channel whose bytes traverse
    the hijack bridge into package ``m``'s session server."""
    created = []

    def build(m, **services):
        a, b = socket.socketpair()
        session = m.B.Session(m.B.SessionServices(**services))
        session.attach(FakeHijack(a))
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        port = lst.getsockname()[1]

        def bridge():
            conn, _ = lst.accept()

            def pump(src, dst):
                try:
                    while True:
                        d = src.recv(65536)
                        if not d:
                            break
                        dst.sendall(d)
                except OSError:
                    pass
                finally:
                    try:
                        dst.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
            threading.Thread(target=pump, args=(conn, b), daemon=True).start()
            pump(b, conn)

        threading.Thread(target=bridge, daemon=True).start()
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        created.append((ch, session, lst))
        return ch

    yield build
    for ch, session, lst in created:
        ch.close()
        session.close()
        lst.close()


def _unary(ch, method: str, payload: bytes, timeout: float = 5.0) -> bytes:
    fn = ch.unary_unary(method, request_serializer=IDENT,
                        response_deserializer=IDENT)
    return fn(payload, timeout=timeout)


def _rpc_error(call) -> tuple:
    with pytest.raises(grpc.RpcError) as ei:
        call()
    return ei.value.code(), ei.value.details()


def test_protobuf_helpers_roundtrip():
    def run(m):
        msg = m.B._field_bytes(1, b"token-id") + m.B._field_bytes(2, b"extra")
        return msg, m.B._parse_fields(msg), m.B._parse_fields(b"")

    want, got = both(run)
    assert got == want
    assert got[1][1] == [b"token-id"] and got[1][2] == [b"extra"]
    assert got[2] == {}


def test_exposed_methods_follow_configuration():
    def run(m):
        bare = m.B.SessionServices().exposed_methods()
        full = m.B.SessionServices(secrets={"t": b"x"},
                                   ssh_auth_sock="/tmp/a").exposed_methods()
        return sorted(bare), sorted(full), (m.B.SECRETS_GET, m.B.SSH_FORWARD,
                                            m.B.SSH_CHECK, m.B.HEALTH_CHECK)

    want, got = both(run)
    assert got == want
    bare, full, (secrets_get, ssh_forward, _, _) = got
    assert secrets_get not in bare
    assert secrets_get in full and ssh_forward in full


def test_session_headers_carry_identity():
    def run(m):
        s = m.B.Session(m.B.SessionServices(secrets={"t": b"x"}))
        try:
            h = s.headers()
            assert h["X-Docker-Expose-Session-Uuid"] == s.session_id
            ids = {s.session_id: "<UUID>",
                   h.get("X-Docker-Expose-Session-Sharedkey"): "<KEY>"}
            return ({k: ids.get(v, v) for k, v in h.items()},
                    sorted(s.method_headers()))
        finally:
            s.close()

    want, got = both(run)
    assert got == want
    assert ("X-Docker-Expose-Session-Grpc-Method", port_bksession.SECRETS_GET) \
        in got[1]


def test_session_server_binds_private_unix_socket_not_tcp():
    """The session's gRPC server listens on a unix socket in a fresh
    0700 directory, removed at close, never on loopback TCP."""
    def run(m):
        s = m.B.Session(m.B.SessionServices(secrets={"t": b"x"}))
        try:
            no_port = not hasattr(s, "_port")
            dir_mode = stat.S_IMODE(os.stat(s._sock_dir).st_mode)
            is_sock = stat.S_ISSOCK(os.stat(s.socket_path).st_mode)
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.connect(s.socket_path)
            probe.close()
            sock_dir = s._sock_dir
        finally:
            s.close()
        return no_port, oct(dir_mode), is_sock, os.path.exists(sock_dir)

    want, got = both(run)
    assert got == want == (True, "0o700", True, False)


def test_secret_round_trip_over_hijack_bridge(wired):
    def run(m):
        ch = wired(m, secrets={"apitoken": b"s3cr3t-bytes"})
        resp = _unary(ch, m.B.SECRETS_GET, m.B._field_bytes(1, b"apitoken"))
        return m.B._parse_fields(resp)

    want, got = both(run)
    assert got == want
    assert got[1] == [b"s3cr3t-bytes"]


def test_unknown_secret_is_not_found(wired):
    def run(m):
        ch = wired(m, secrets={"known": b"x"})
        return _rpc_error(lambda: _unary(ch, m.B.SECRETS_GET,
                                         m.B._field_bytes(1, b"missing")))

    want, got = both(run)
    assert got == want
    assert got[0] == grpc.StatusCode.NOT_FOUND and "not found" in got[1]


def test_health_check_serves_varint_status(wired):
    def run(m):
        return _unary(wired(m, secrets={"k": b"v"}), m.B.HEALTH_CHECK, b"")

    want, got = both(run)
    # HealthCheckResponse.status=SERVING: field 1, wire type 0 (varint)
    assert got == want == b"\x08\x01"


def test_ssh_check_and_forward_agent(wired, tmp_path):
    def run(m):
        agent_path = tmp_path / f"agent-{id(m)}.sock"
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(str(agent_path))
        srv.listen(1)

        def agent():
            conn, _ = srv.accept()
            while True:
                d = conn.recv(65536)
                if not d:
                    break
                conn.sendall(b"AGENT-REPLY:" + d)
            conn.close()

        threading.Thread(target=agent, daemon=True).start()
        ch = wired(m, ssh_auth_sock=str(agent_path))
        check = _unary(ch, m.B.SSH_CHECK, m.B._field_bytes(1, b"default"))
        fwd = ch.stream_stream(m.B.SSH_FORWARD, request_serializer=IDENT,
                               response_deserializer=IDENT)
        replies = fwd(iter([m.B._field_bytes(1, b"sign-request")]), timeout=5.0)
        got = b"".join((m.B._parse_fields(r).get(1) or [b""])[0]
                       for r in replies)
        srv.close()
        return check, got

    want, got = both(run)
    assert got == want == (b"", b"AGENT-REPLY:sign-request")


def test_ssh_unavailable_without_agent(wired):
    def run(m):
        ch = wired(m, secrets={"k": b"v"})      # no ssh
        return _rpc_error(lambda: _unary(ch, m.B.SSH_CHECK,
                                         m.B._field_bytes(1, b"default")))

    want, got = both(run)
    assert got == want
    assert got[0] == grpc.StatusCode.UNIMPLEMENTED


class _SessionApi:
    """Stub daemon api recording the session wiring the Builder does."""

    def __init__(self):
        self.attached = None
        self.build_query = {}
        self._a, self._b = socket.socketpair()

    def info(self):
        return {"BuilderVersion": "2"}

    def session_attach(self, headers, method_headers):
        self.attached = (headers, method_headers)
        return FakeHijack(self._a)

    def image_build_buildkit(self, tar, **kw):
        self.build_query = kw
        return iter([{"stream": "ok\n"}])


def test_builder_threads_session_through_build():
    def run(m):
        api = _SessionApi()
        out = list(m.buildkit.Builder(api).build(b"tar", secrets={"tok": b"v"},
                                                 tags=["t:1"]))
        headers, methods = api.attached
        sid = headers["X-Docker-Expose-Session-Uuid"]
        query = {k: ("<UUID>" if v == sid else v)
                 for k, v in api.build_query.items() if k != "buildid"}
        api._b.close()
        return out, sorted(methods), query, len(api.build_query["buildid"])

    want, got = both(run)
    assert got == want
    out, methods, query, bid_len = got
    assert out == [{"stream": "ok\n"}]
    assert query["session"] == "<UUID>" and bid_len == 32
    assert ("X-Docker-Expose-Session-Grpc-Method",
            port_bksession.SECRETS_GET) in methods


def test_builder_refuses_secret_build_without_session_lane():
    class LegacyApi:
        def info(self):
            return {"BuilderVersion": "1"}

        def image_build(self, tar, **kw):
            raise AssertionError("must not reach the legacy lane")

    def run(m):
        with pytest.raises(m.errors.DriverError) as ei:
            list(m.buildkit.Builder(LegacyApi()).build(b"tar",
                                                       secrets={"t": b"v"}))
        return str(ei.value)

    want, got = both(run)
    assert got == want
    assert "session" in got


def test_cli_secret_parsing(tmp_path, monkeypatch):
    p = tmp_path / "tok"
    p.write_bytes(b"file-secret")
    monkeypatch.setenv("MY_TOKEN", "env-secret")
    monkeypatch.setenv("SSH_AUTH_SOCK", "/run/agent.sock")

    def run(m):
        parse, ssh = m.cmd_build._parse_secrets, m.cmd_build._parse_ssh
        out = [parse((f"id=a,src={p}", "id=b,env=MY_TOKEN")), parse(())]
        for bad in (("src=/nope",), ("id=x",), ("id=y,env=UNSET_VAR_X",)):
            with pytest.raises(click.BadParameter) as ei:
                parse(bad)
            out.append(ei.value.message)
        out += [ssh("default"), ssh("default=/custom.sock"), ssh("")]
        return out

    want, got = both(run)
    assert got == want
    assert got[0] == {"a": b"file-secret", "b": b"env-secret"}
    assert got[1] is None
    assert got[-3:] == ["/run/agent.sock", "/custom.sock", ""]
