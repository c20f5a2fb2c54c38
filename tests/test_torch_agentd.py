"""The port's agentd session daemon and supervisor client against the
reference's, on the CPU.

Twins of tests/test_agentd.py's 13 (the mTLS policy, the session
protocol, shell pipelines, stdin, AgentReady/AgentInitialized, the
ready file), tests/test_agentd_integration.py's 2 (AgentReady through
the native supervisor, the register flow against a stub control plane)
and tests/test_supervisor.py's 12 (the native supervisor driven through
each package's ``SupervisorClient``).

The daemon twins run both pairings across the packages: the port's
``Agentd`` under the reference's ``SessionClient`` and the reference's
``Agentd`` under the port's.  Each is held to the reference's own
pairing on the same inputs: the daemon's material is minted by the
daemon's package, the control plane's certificate by the same CA, and
the transcripts (results, exit codes, error texts, files) must be equal.
Outputs are normalised only for pids and temporary paths.  The
supervisor is built from ``native/`` into a temporary directory.
"""

from __future__ import annotations

import contextlib
import signal
import socket
import ssl
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.agentd as ref_agentd
import clawker_tpu.agentd.daemon as ref_daemon
import clawker_tpu.agentd.protocol as ref_protocol
import clawker_tpu.controlplane.identity as ref_identity
import clawker_tpu.controlplane.session_client as ref_session_client
import clawker_tpu.firewall.pki as ref_pki
import clawker_tpu_torch.agentd as port_agentd
import clawker_tpu_torch.agentd.daemon as port_daemon
import clawker_tpu_torch.agentd.protocol as port_protocol
import clawker_tpu_torch.controlplane.identity as port_identity
import clawker_tpu_torch.controlplane.session_client as port_session_client
import clawker_tpu_torch.firewall.pki as port_pki

ROOT = Path(__file__).resolve().parents[1]

PKGS = {
    "ref": SimpleNamespace(agentd=ref_agentd, daemon=ref_daemon,
                           protocol=ref_protocol, identity=ref_identity,
                           sc=ref_session_client, pki=ref_pki),
    "port": SimpleNamespace(agentd=port_agentd, daemon=port_daemon,
                            protocol=port_protocol, identity=port_identity,
                            sc=port_session_client, pki=port_pki),
}
# (daemon's package, client's package)
PAIRINGS = {"port-daemon/ref-client": ("port", "ref"),
            "ref-daemon/port-client": ("ref", "port")}


@pytest.fixture(scope="module")
def supervisor_bin(tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("native")
    subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={out}"],
                   check=True, capture_output=True)
    return out / "clawker-supervisord"


def _write_cp_certs(m, ca, d: Path) -> Path:
    d.mkdir(parents=True)
    pair = m.pki.generate_cp_cert(ca)
    (d / "cp.crt").write_bytes(pair.cert_pem)
    (d / "cp.key").write_bytes(pair.key_pem)
    (d / "ca.crt").write_bytes(ca.cert_pem)
    return d


def _mint(m, ca, base: Path, container_id: str) -> Path:
    bdir = base / "bootstrap"
    bdir.mkdir()
    material = m.identity.mint_bootstrap_material(ca, "proj", "dev",
                                                  container_id=container_id)
    for name, data in material.files().items():
        (bdir / name).write_bytes(data)
    return bdir


@contextlib.contextmanager
def agentd(m, base: Path, **cfg_kw):
    """Package ``m``'s daemon on localhost over material that ``m``
    mints from a fresh CA: -> namespace with ``d``, ``base``, ``certs``
    (the control plane's), ``ca`` and ``m``."""
    base.mkdir(parents=True)
    ca = m.pki.generate_ca()
    certs = _write_cp_certs(m, ca, base / "cp-certs")
    cfg = m.daemon.AgentdConfig(
        bootstrap_dir=_mint(m, ca, base, cfg_kw.pop("container_id", "c1")),
        port=0, host="127.0.0.1", ready_file=base / "ready",
        init_marker=base / "initialized", **cfg_kw)
    d = m.daemon.Agentd(cfg)
    threading.Thread(target=d.serve_forever, daemon=True).start()
    deadline = time.time() + 5
    while d.bound_port == 0 and time.time() < deadline:
        time.sleep(0.01)
    assert d.bound_port
    try:
        yield SimpleNamespace(d=d, base=base, certs=certs, ca=ca, m=m)
    finally:
        d.stop()


def dial(a, client):
    return client.sc.dial_with_retry(
        "127.0.0.1", a.d.bound_port, cert_file=a.certs / "cp.crt",
        key_file=a.certs / "cp.key", ca_file=a.certs / "ca.crt", deadline_s=5)


def paired(tmp_path: Path, pairing: str, scenario, **cfg_kw):
    """``scenario(a, client)`` on the reference's own pairing, then on
    ``pairing``: -> (reference's transcript, pairing's), paths under
    each run's base written ``<BASE>``."""
    out = []
    for daemon, client in (("ref", "ref"), PAIRINGS[pairing]):
        base = tmp_path / f"{daemon}-{client}"
        with agentd(PKGS[daemon], base, **dict(cfg_kw)) as a:
            got = scenario(a, PKGS[client])
        out.append(_norm(got, str(base)))
    return tuple(out)


def _norm(obj, base: str):
    if isinstance(obj, str):
        return obj.replace(base, "<BASE>")
    if isinstance(obj, bytes):
        return obj.replace(base.encode(), b"<BASE>")
    if isinstance(obj, (list, tuple)):
        return type(obj)(_norm(x, base) for x in obj)
    if isinstance(obj, dict):
        return {k: _norm(v, base) for k, v in obj.items()}
    return obj


pairings = pytest.mark.parametrize("pairing", sorted(PAIRINGS))


# ------------------------------------------------------------ TLS policy

@pairings
def test_no_client_cert_rejected(tmp_path, pairing):
    def scenario(a, client):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        raw = socket.create_connection(("127.0.0.1", a.d.bound_port), timeout=5)
        try:
            tls = ctx.wrap_socket(raw)
            tls.recv(1)   # TLS 1.3: the rejection may surface on first read
            return "served"
        except (ssl.SSLError, ConnectionResetError, OSError):
            return "rejected"
        finally:
            raw.close()

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == "rejected"


@pairings
def test_wrong_cn_rejected(tmp_path, pairing):
    def scenario(a, client):
        rogue = a.m.pki.generate_agent_cert(a.ca, "proj.other")
        (a.base / "r.crt").write_bytes(rogue.cert_pem)
        (a.base / "r.key").write_bytes(rogue.key_pem)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(a.base / "r.crt", a.base / "r.key")
        ctx.load_verify_locations(a.certs / "ca.crt")
        ctx.check_hostname = False
        raw = socket.create_connection(("127.0.0.1", a.d.bound_port), timeout=5)
        tls = ctx.wrap_socket(raw)
        got = b""
        try:
            got = tls.recv(4)
        except (ssl.SSLError, ConnectionResetError, OSError):
            pass
        tls.close()
        return got

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == b""


@pairings
def test_foreign_ca_rejected(tmp_path, pairing):
    def scenario(a, client):
        other_ca = a.m.pki.generate_ca("other CA")
        pair = a.m.pki.generate_cp_cert(other_ca)
        (a.base / "f.crt").write_bytes(pair.cert_pem)
        (a.base / "f.key").write_bytes(pair.key_pem)
        (a.base / "fca.crt").write_bytes(other_ca.cert_pem)
        try:
            client.sc.SessionClient(
                "127.0.0.1", a.d.bound_port, cert_file=a.base / "f.crt",
                key_file=a.base / "f.key", ca_file=a.base / "fca.crt").hello()
            return "served"
        except (client.sc.SessionError, ssl.SSLError):
            return "rejected"

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == "rejected"


# --------------------------------------------------------------- session

@pairings
def test_hello_reports_state(tmp_path, pairing):
    def scenario(a, client):
        with dial(a, client) as s:
            h = s.hello()
            return h.initialized, h.cmd_running, h.pid > 0

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == (False, False, True)


@pairings
def test_shell_collects_output_and_code(tmp_path, pairing):
    def scenario(a, client):
        with dial(a, client) as s:
            r = s.run_shell([{"argv": ["/bin/sh", "-c",
                                       "echo out; echo err >&2; exit 4"]}])
        return r.stdout, r.stderr, r.code, r.stage_codes

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == (b"out\n", b"err\n", 4, [4])


@pairings
def test_pipeline_stages(tmp_path, pairing):
    def scenario(a, client):
        with dial(a, client) as s:
            r = s.run_shell([{"argv": ["/bin/sh", "-c", "printf 'b\\na\\nb\\n'"]},
                             {"argv": ["/usr/bin/sort", "-u"]}])
        return r.stdout, r.stage_codes

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == (b"a\nb\n", [0, 0])


@pairings
def test_stdin_roundtrip(tmp_path, pairing):
    def scenario(a, client):
        with dial(a, client) as s:
            r = s.run_shell([{"argv": ["/bin/cat"]}], stdin=b"hello agentd\n")
        return r.stdout, r.code

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == (b"hello agentd\n", 0)


@pairings
def test_shell_env_and_cwd(tmp_path, pairing):
    def scenario(a, client):
        with dial(a, client) as s:
            r = s.run_shell([{"argv": ["/bin/sh", "-c", "echo $MARKER-$PWD"]}],
                            env={"MARKER": "m1"}, cwd=str(a.base))
        return r.stdout.decode().strip()

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == "m1-<BASE>"


@pairings
def test_spawn_failure_reports_error(tmp_path, pairing):
    def scenario(a, client):
        with dial(a, client) as s:
            with pytest.raises(client.sc.SessionError) as ei:
                s.run_shell([{"argv": ["/definitely/not/a/binary"]}])
        return str(ei.value)

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want
    assert "spawn" in got


@pairings
def test_concurrent_jobs_interleave(tmp_path, pairing):
    def scenario(a, client):
        proto = client.protocol
        with dial(a, client) as s:
            sock = s._sock
            proto.write_msg(sock, {"type": "shell", "id": "slow", "stages": [
                {"argv": ["/bin/sh", "-c", "sleep 0.4; echo slow-done"]}]})
            proto.write_msg(sock, {"type": "shell", "id": "fast", "stages": [
                {"argv": ["/bin/sh", "-c", "echo fast-done"]}]})
            done = {}
            deadline = time.time() + 10
            while len(done) < 2 and time.time() < deadline:
                msg = proto.read_msg(sock)
                if msg["type"] == "done":
                    done[msg["id"]] = msg["code"]
        return done

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == {"slow": 0, "fast": 0}


@pairings
def test_agent_initialized_marker(tmp_path, pairing):
    def scenario(a, client):
        with dial(a, client) as s:
            before = s.hello().initialized
            s.agent_initialized()
            marker = (a.base / "initialized").exists()
        with dial(a, client) as s2:
            after = s2.hello().initialized       # survives reconnect
        return before, marker, after

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == (False, True, True)


@pairings
def test_agent_ready_direct_spawn_cas(tmp_path, pairing):
    def scenario(a, client):
        marker = a.base / "cmd-ran"
        with dial(a, client) as s:
            pid = s.agent_ready(["/bin/sh", "-c", f"touch {marker}; sleep 3"],
                                cwd=str(a.base))
            with pytest.raises(client.sc.SessionError) as ei:
                s.agent_ready(["/bin/true"])
            running = s.hello().cmd_running
        deadline = time.time() + 5
        while not marker.exists() and time.time() < deadline:
            time.sleep(0.02)
        a.d._direct_child.kill()
        return pid > 0, str(ei.value), running, marker.exists()

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want
    assert got[0] and "already running" in got[1] and got[2] and got[3]


@pairings
def test_ready_written_on_listen(tmp_path, pairing):
    def scenario(a, client):
        ready = a.base / "ready"
        deadline = time.time() + 5
        while not ready.exists() and time.time() < deadline:
            time.sleep(0.01)
        return ready.read_text()

    want, got = paired(tmp_path, pairing, scenario)
    assert got == want == "ok\n"


# ---------------------------------------- agentd + the native supervisor

@pairings
def test_agent_ready_via_native_supervisor(tmp_path, pairing, supervisor_bin):
    """AgentReady through the supervisor's socket: the supervisor, not
    agentd, reaps and records the exit."""
    out = []
    for daemon, client in (("ref", "ref"), PAIRINGS[pairing]):
        base = tmp_path / f"{daemon}-{client}"
        marker = base / "cmd-ran"
        with supervisor(supervisor_bin, base / "sup") as (_proc, sock), \
                agentd(PKGS[daemon], base / "agentd", container_id="c9",
                       supervisor_socket=str(sock)) as a:
            with dial(a, PKGS[client]) as s:
                pid = s.agent_ready(
                    ["/bin/sh", "-c", f"touch {marker}; exit 11"],
                    cwd=str(base))
            with PKGS[client].agentd.SupervisorClient(sock) as c:
                code = c.wait(timeout=5)
        out.append((pid > 0, code, marker.exists()))
    assert out[1] == out[0] == (True, 11, True)


class _StubCP(threading.Thread):
    """Minimal AgentService of package ``m``: an mTLS listener that
    verifies the assertion with the CA's public key."""

    def __init__(self, m, ca, certs_dir: Path):
        super().__init__(daemon=True)
        self.m = m
        self.ca = ca
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(certs_dir / "cp.crt", certs_dir / "cp.key")
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(certs_dir / "ca.crt")
        self._ctx = ctx
        self._ls = socket.socket()
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind(("127.0.0.1", 0))
        self._ls.listen(1)
        self.port = self._ls.getsockname()[1]
        self.seen: list[dict] = []
        self.claims: dict = {}

    def run(self):
        raw, _ = self._ls.accept()
        tls = self._ctx.wrap_socket(raw, server_side=True)
        msg = self.m.protocol.read_msg(tls)
        self.seen.append(msg)
        try:
            self.claims = self.m.identity.verify_jwt_es256(
                self.ca.cert.public_key(), msg.get("assertion", ""))
            ok = self.claims.get("scope") == "self.register"
            self.m.protocol.write_msg(tls, {"type": "register_ack", "ok": ok,
                                            "sub": self.claims.get("sub")})
        except self.m.identity.IdentityError as e:
            self.m.protocol.write_msg(tls, {"type": "register_ack", "ok": False,
                                            "error": str(e)})
        tls.close()
        self._ls.close()


@pairings
def test_register_flow_end_to_end(tmp_path, pairing):
    """RegisterRequired: the daemon's one outbound call, to a stub
    control plane of the client's package."""
    def scenario(a, client):
        stub = _StubCP(client, a.ca, a.certs)
        stub.start()
        with dial(a, client) as s:
            s.register_required("127.0.0.1", stub.port)
        stub.join(5)
        msg = stub.seen[0] if stub.seen else {}
        return (sorted(msg), msg.get("type"), stub.claims.get("scope"),
                stub.claims.get("sub"))

    want, got = paired(tmp_path, pairing, scenario, container_id="c9")
    assert got == want
    keys, kind, scope, sub = got
    assert "assertion" in keys and scope == "self.register" and sub


# ------------------------------------------------- the native supervisor

@contextlib.contextmanager
def supervisor(binary: Path, base: Path):
    base.mkdir(parents=True)
    sock, ready = base / "sup.sock", base / "ready"
    proc = subprocess.Popen([str(binary), "--socket", str(sock),
                             "--ready-file", str(ready)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.time() + 5
    while not ready.exists() and time.time() < deadline:
        time.sleep(0.02)
        assert proc.poll() is None, proc.stderr.read().decode()
    assert ready.exists(), "supervisor never wrote ready file"
    try:
        yield proc, sock
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(5)
        proc.stderr.close()


def both_clients(binary: Path, tmp_path: Path, scenario):
    """``scenario(proc, sock, m, base)`` on a fresh supervisor with the
    reference's client, then with the port's: -> (reference's, port's)."""
    out = []
    for pkg in ("ref", "port"):
        base = tmp_path / pkg
        with supervisor(binary, base) as (proc, sock):
            out.append(_norm(scenario(proc, sock, PKGS[pkg], base), str(base)))
    return tuple(out)


def test_exit_code_propagates(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            idle = c.status()
            pid = c.spawn(["/bin/sh", "-c", "exit 3"])
            return idle, pid > 0, c.wait(timeout=5), c.status()

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == (("idle", 0), True, 3, ("exited", 3))


def test_signal_death_is_128_plus_signum(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            c.spawn(["/bin/sh", "-c", "kill -TERM $$"])
            return c.wait(timeout=5)

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == 128 + signal.SIGTERM


def test_single_shot_cas(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            c.spawn(["/bin/sleep", "5"])
            with pytest.raises(m.agentd.SupervisorError) as ei:
                c.spawn(["/bin/sleep", "5"])
            c.signal(signal.SIGKILL)
            return str(ei.value), c.wait(timeout=5)

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want
    assert "already running" in got[0] and got[1] == 137


def test_wait_from_second_client(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c1, \
                m.agentd.SupervisorClient(sock) as c2:
            c1.spawn(["/bin/sh", "-c", "sleep 0.2; exit 7"])
            # both a parked waiter and a late waiter see the exit
            return c2.wait(timeout=5), c1.wait(timeout=5)

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == (7, 7)


def test_env_cwd_and_exec_failure(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        out = base / "out.txt"
        with m.agentd.SupervisorClient(sock) as c:
            c.spawn(["/bin/sh", "-c", f"echo $FOO-$PWD > {out}"], cwd=str(base),
                    env={"FOO": "bar", "PATH": "/usr/bin:/bin"})
            first = c.wait(timeout=5)
        with m.agentd.SupervisorClient(sock) as c:
            # the supervisor allows a respawn after an exit
            c.spawn(["/nonexistent-binary"])
            second = c.wait(timeout=5)
        return first, out.read_text().strip(), second

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == (0, "bar-<BASE>", 127)


def test_signal_reaches_process_group(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        marker = base / "trapped"
        with m.agentd.SupervisorClient(sock) as c:
            c.spawn(["/bin/sh", "-c",
                     f"trap 'touch {marker}; exit 9' USR1; sleep 10 & wait"])
            time.sleep(0.3)
            # USR1 to the supervisor process (the PID-1 path) reaches the
            # user command's process group
            proc.send_signal(signal.SIGUSR1)
            with m.agentd.SupervisorClient(sock) as c2:
                code = c2.wait(timeout=5)
        return code, marker.exists()

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == (9, True)


def test_graceful_term(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            c.spawn(["/bin/sh", "-c", "trap 'exit 0' TERM; sleep 30 & wait"])
            time.sleep(0.2)
            c.shutdown(grace_ms=5000)
        proc.wait(5)
        return proc.returncode

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == 0


def test_watchdog_kills_stubborn_command(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            # ignores TERM; the watchdog SIGKILLs it
            c.spawn(["/bin/sh", "-c", "trap '' TERM; sleep 30 & wait"])
            time.sleep(0.2)
            t0 = time.time()
            c.shutdown(grace_ms=300)
        proc.wait(10)
        return proc.returncode, 0.2 < time.time() - t0 < 8

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == (137, True)


def test_sigterm_to_pid1_exits_cleanly_when_idle(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            idle = c.status()
        proc.send_signal(signal.SIGTERM)
        proc.wait(5)
        return idle, proc.returncode

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == (("idle", 0), 0)


def test_sigterm_to_pid1_terminates_user_cmd(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            c.spawn(["/bin/sh", "-c", "trap 'exit 0' TERM; sleep 30 & wait"])
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        proc.wait(10)
        return proc.returncode

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == 0


def test_sigterm_watchdog_kills_stubborn_cmd(supervisor_bin, tmp_path):
    def scenario(proc, sock, m, base):
        with m.agentd.SupervisorClient(sock) as c:
            c.spawn(["/bin/sh", "-c", "trap '' TERM; sleep 30 & wait"])
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        # the default grace is 5 s; the watchdog fires well before 30 s
        proc.wait(12)
        return proc.returncode

    want, got = both_clients(supervisor_bin, tmp_path, scenario)
    assert got == want == 137


def test_service_child_lifecycle(supervisor_bin, tmp_path):
    """--child daemon: the supervisor exits with the child's code when no
    user command is active (the container-done condition); the
    agentd zipapp's ``SupervisorClient`` of each package sees no
    supervisor left to dial."""
    def run(m):
        sock = tmp_path / f"{m.agentd.__name__}.sock"
        proc = subprocess.Popen([str(supervisor_bin), "--socket", str(sock),
                                 "--child", "/bin/sh", "-c",
                                 "sleep 0.3; exit 5"],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        proc.wait(10)
        try:
            with m.agentd.SupervisorClient(sock) as c:
                c.status()
            left = "answered"
        except (m.agentd.SupervisorError, OSError):
            left = "gone"
        return proc.returncode, left

    want, got = run(PKGS["ref"]), run(PKGS["port"])
    assert got == want == (5, "gone")
