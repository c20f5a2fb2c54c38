"""The port's control plane against the reference's, on the CPU.

Twins of tests/test_controlplane.py's cases but its three watcher cases
(those are in test_torch_controlplane_bus.py with the bus): the
executor's plans, the executor and the dialer over a live agentd, the
AgentService's register binding, the AdminService's auth, the daemon's
health and drain.  Each scenario runs once through each package, each
package over its own objects (its own CA, agentd, fake daemon and
registry), and the two transcripts are compared: results, outcomes,
registry rows, error texts and status codes.  A daemon's drain, and an
AgentService's stop, wait 5 s on each of two threads nothing wakes (the
dialer's consumer of a topic that drain never closes, and a blocking
``accept`` that closing the listener does not interrupt): kept from the
reference, so the twins whose objects live only in their own
directories run the two packages side by side (``both_at_once``).

Then what the reference's tests leave out: the drain order against the
reference's list (firewall queue first, the netlogger before teardown,
teardown only after drain-to-zero), a subsystem that fails landing in
``health()["unavailable"]`` while the daemon serves on, ``ListAgents``
over the registry, the manager's read path without material, and the
``controlplane up|status|agents|down`` verbs with the daemon forked
over each package's fake driver.  No daemon of these tests outlives its
test: each is drained, or stopped with ``controlplane down``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import socket
import threading
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.agentd.daemon as ref_agentd
import clawker_tpu.agentd.register as ref_register
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.consts as ref_consts
import clawker_tpu.controlplane.adminapi as ref_adminapi
import clawker_tpu.controlplane.agentservice as ref_agentservice
import clawker_tpu.controlplane.daemon as ref_daemon
import clawker_tpu.controlplane.dialer as ref_dialer
import clawker_tpu.controlplane.dockerevents as ref_dockerevents
import clawker_tpu.controlplane.executor as ref_executor
import clawker_tpu.controlplane.identity as ref_identity
import clawker_tpu.controlplane.manager as ref_manager
import clawker_tpu.controlplane.pubsub as ref_pubsub
import clawker_tpu.controlplane.registry as ref_registry
import clawker_tpu.controlplane.session_client as ref_session_client
import clawker_tpu.controlplane.watcher as ref_watcher
import clawker_tpu.config as ref_config
import clawker_tpu.engine.api as ref_api
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.firewall.pki as ref_pki
import clawker_tpu.testenv as ref_testenv
import clawker_tpu_torch.agentd.daemon as port_agentd
import clawker_tpu_torch.agentd.register as port_register
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.controlplane.adminapi as port_adminapi
import clawker_tpu_torch.controlplane.agentservice as port_agentservice
import clawker_tpu_torch.controlplane.daemon as port_daemon
import clawker_tpu_torch.controlplane.dialer as port_dialer
import clawker_tpu_torch.controlplane.dockerevents as port_dockerevents
import clawker_tpu_torch.controlplane.executor as port_executor
import clawker_tpu_torch.controlplane.identity as port_identity
import clawker_tpu_torch.controlplane.manager as port_manager
import clawker_tpu_torch.controlplane.pubsub as port_pubsub
import clawker_tpu_torch.controlplane.registry as port_registry
import clawker_tpu_torch.controlplane.session_client as port_session_client
import clawker_tpu_torch.controlplane.watcher as port_watcher
import clawker_tpu_torch.engine.api as port_api
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.firewall.pki as port_pki
import clawker_tpu_torch.testenv as port_testenv

PKGS = {
    "ref": SimpleNamespace(
        tag="ref", agentd=ref_agentd, register=ref_register,
        consts=ref_consts, adminapi=ref_adminapi,
        agentservice=ref_agentservice, daemon=ref_daemon, dialer=ref_dialer,
        dockerevents=ref_dockerevents, executor=ref_executor,
        identity=ref_identity, manager=ref_manager, pubsub=ref_pubsub,
        registry=ref_registry, sc=ref_session_client, watcher=ref_watcher,
        config=ref_config, api=ref_api, drivers=ref_drivers, fake=ref_fake,
        pki=ref_pki, testenv=ref_testenv, cli=ref_root.cli,
        Factory=ref_factory.Factory),
    "port": SimpleNamespace(
        tag="port", agentd=port_agentd, register=port_register,
        consts=port_consts, adminapi=port_adminapi,
        agentservice=port_agentservice, daemon=port_daemon,
        dialer=port_dialer, dockerevents=port_dockerevents,
        executor=port_executor, identity=port_identity,
        manager=port_manager, pubsub=port_pubsub, registry=port_registry,
        sc=port_session_client, watcher=port_watcher, config=port_config,
        api=port_api, drivers=port_drivers, fake=port_fake, pki=port_pki,
        testenv=port_testenv, cli=port_cli.cli, Factory=port_cli.Factory),
}
# the reference's drain sequence (daemon.py ``drain``, ordering
# INV-B2-007): the firewall queue first, the netlogger before teardown
DRAIN_ORDER = ["firewall_queue", "admin", "agent_service", "watcher",
               "dialer", "netlogger", "firewall_teardown", "feeder",
               "registry"]


def both(fn):
    """``fn(m)`` in the reference, then in the port: -> (want, got)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def both_at_once(fn):
    """``fn(m)`` in the reference and the port on two threads at once:
    -> (want, got).  Only for scenarios that touch no process-wide
    state (environment, ``TestEnv``, monkeypatches)."""
    out: dict = {}

    def one(tag: str) -> None:
        try:
            out[tag] = ("ok", fn(PKGS[tag]))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out[tag] = ("raised", e)

    t = threading.Thread(target=one, args=("ref",))
    t.start()
    one("port")
    t.join()
    for tag in ("ref", "port"):
        if out[tag][0] == "raised":
            raise out[tag][1]
    return out["ref"][1], out["port"][1]


def tcp_free_port() -> int:
    """A loopback port no TCP socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(pred, timeout: float = 5.0, step: float = 0.01) -> bool:
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            return False
        time.sleep(step)
    return True


def cp_material(m, ca, d: Path) -> Path:
    """The control plane's cert, key and CA under ``d`` (the reference
    tests' ``cp_material`` fixture), minted by ``m`` from ``ca``."""
    d.mkdir(parents=True)
    pair = m.pki.generate_cp_cert(ca)
    (d / "cp.crt").write_bytes(pair.cert_pem)
    (d / "cp.key").write_bytes(pair.key_pem)
    (d / "ca.crt").write_bytes(ca.cert_pem)
    return d


@contextlib.contextmanager
def agentd_env(m, base: Path):
    """Package ``m``'s agentd on loopback over bootstrap material minted
    by ``m`` (the reference tests' ``agentd_env`` fixture): -> namespace
    with ``d``, ``material``, ``ca``, ``certs`` (the control plane's)."""
    ca = m.pki.generate_ca()
    certs = cp_material(m, ca, base / "cp-pki")
    bdir = base / "bootstrap"
    bdir.mkdir()
    material = m.identity.mint_bootstrap_material(ca, "proj", "dev",
                                                  container_id="c1")
    for name, data in material.files().items():
        (bdir / name).write_bytes(data)
    d = m.agentd.Agentd(m.agentd.AgentdConfig(
        bootstrap_dir=bdir, port=0, host="127.0.0.1",
        ready_file=base / "ready", init_marker=base / "initialized"))
    threading.Thread(target=d.serve_forever, daemon=True).start()
    assert wait_for(lambda: d.bound_port != 0)
    try:
        yield SimpleNamespace(d=d, material=material, ca=ca, certs=certs)
    finally:
        d.stop()


def dial(m, env):
    return m.sc.dial_with_retry(
        "127.0.0.1", env.d.bound_port, cert_file=env.certs / "cp.crt",
        key_file=env.certs / "cp.key", ca_file=env.certs / "ca.crt",
        deadline_s=5)


def sh(script: str) -> list[dict]:
    return [{"argv": ["/bin/sh", "-c", script], "uid": 0, "gid": 0}]


def plan_doc(steps) -> list:
    return [dataclasses.astuple(s) for s in steps]


def result_doc(res) -> dict:
    return {"ok": res.ok, "aborted_at": res.aborted_at,
            "steps": [(s.name, s.code, s.stdout, s.skipped, s.ok)
                      for s in res.steps]}


# ---------------------------------------------------------------- plans


def test_init_plan_step_order():
    def run(m):
        p = m.executor.AgentProfile(
            project="p", agent="a", post_init="/opt/post-init.sh",
            host_proxy_url="http://172.17.0.1:18374")
        return plan_doc(m.executor.init_plan(p))

    want, got = both(run)
    assert got == want
    assert [s[0] for s in got] == ["config", "git", "git-credentials", "ssh",
                                   "post-init"]


def test_init_plan_minimal():
    want, got = both(lambda m: plan_doc(m.executor.init_plan(
        m.executor.AgentProfile(project="p", agent="a"))))
    assert got == want
    assert [s[0] for s in got] == ["config", "git", "ssh"]


def test_boot_plan():
    def run(m):
        p = m.executor.AgentProfile(project="p", agent="a",
                                    docker_socket=True, pre_run="/opt/pre.sh")
        return [plan_doc(m.executor.boot_plan(p)),
                plan_doc(m.executor.boot_plan(
                    m.executor.AgentProfile(project="p", agent="a")))]

    want, got = both(run)
    assert got == want
    assert [s[0] for s in got[0]] == ["docker-socket", "pre-run"]
    assert got[1] == []


def test_stage_uid_drop():
    def run(m):
        p = m.executor.AgentProfile(project="p", agent="a", uid=1000,
                                    gid=1000, git_user_name="A B",
                                    git_user_email="a@b")
        return plan_doc(m.executor.init_plan(p))

    want, got = both(run)
    assert got == want
    git = next(s for s in got if s[0] == "git")
    assert git[1][0]["uid"] == 1000


# ------------------------------------------------------------- executor


def test_runs_plan_over_real_agentd(tmp_path):
    def run(m):
        with agentd_env(m, tmp_path / m.tag) as env, dial(m, env) as sess:
            Step = m.executor.Step
            res = m.executor.Executor(sess, full_name="proj.dev").run_plan(
                "t", [Step(name="one", stages=sh("echo hi")),
                      Step(name="two", stages=sh("exit 3"), best_effort=True),
                      Step(name="three", stages=[{"argv": ["/bin/true"],
                                                  "uid": 0, "gid": 0}])])
        return result_doc(res)

    want, got = both(run)
    assert got == want
    assert got["ok"] and [s[0] for s in got["steps"]] == ["one", "two",
                                                           "three"]
    assert got["steps"][0][2].strip() == b"hi" and got["steps"][1][1] == 3


def test_hard_failure_aborts(tmp_path):
    def run(m):
        with agentd_env(m, tmp_path / m.tag) as env, dial(m, env) as sess:
            Step = m.executor.Step
            res = m.executor.Executor(sess).run_plan(
                "t", [Step(name="bad", stages=sh("exit 7")),
                      Step(name="never", stages=sh("true"))])
        return result_doc(res)

    want, got = both(run)
    assert got == want
    assert not got["ok"] and got["aborted_at"] == "bad"
    assert len(got["steps"]) == 1


# --------------------------------------------------------------- dialer


def _dialer(m, env, registry, profile):
    return m.dialer.Dialer(
        m.dialer.DialerConfig(
            cert_file=env.certs / "cp.crt", key_file=env.certs / "cp.key",
            ca_file=env.certs / "ca.crt", cp_host="", dial_deadline_s=5),
        registry, resolve=lambda cid: ("127.0.0.1", env.d.bound_port),
        build_profile=lambda cid: profile)


def _bound_registry(m, env, path: Path):
    registry = m.registry.Registry(path)
    registry.bind("proj.dev", "proj", "dev", container_id="c1",
                  cert_sha256=m.identity.cert_fingerprint(
                      env.material.agent_cert))
    return registry


def test_drive_full_flow(tmp_path):
    def run(m):
        with agentd_env(m, tmp_path / m.tag) as env:
            registry = _bound_registry(m, env, tmp_path / m.tag / "agents.db")
            profile = m.executor.AgentProfile(
                project="proj", agent="dev", cmd=["/bin/sleep", "5"],
                workdir="/")
            dialer = _dialer(m, env, registry, profile)
            first = dialer.drive("c1")
            rec = registry.get("proj.dev")
            # idempotent reconnect: hello reports initialized + cmd_running
            again = dialer.drive("c1")
            out = [first, rec.initialized, rec.state, again,
                   dict(dialer.outcomes), bool(rec.registered_at)]
            registry.close()
        return out

    want, got = both_at_once(run)
    assert got == want
    assert got[:4] == ["ready", True, "ready", "ready"]
    assert got[5] is False          # no register leg without cp_host


def test_register_leg(tmp_path):
    def run(m):
        with agentd_env(m, tmp_path / m.tag) as env:
            registry = _bound_registry(m, env, tmp_path / m.tag / "agents.db")
            svc = m.agentservice.AgentService(
                registry, cert_file=env.certs / "cp.crt",
                key_file=env.certs / "cp.key", ca_file=env.certs / "ca.crt",
                host="127.0.0.1", port=0)
            svc.start()
            try:
                profile = m.executor.AgentProfile(
                    project="proj", agent="dev", cmd=["/bin/sleep", "5"],
                    workdir="/")
                dialer = _dialer(m, env, registry, profile)
                dialer.cfg.cp_host = "127.0.0.1"
                dialer.cfg.cp_agent_port = svc.bound_port
                out = [dialer.drive("c1"),
                       registry.get("proj.dev").registered_at > 0,
                       registry.get("proj.dev").state]
            finally:
                svc.stop()
                registry.close()
        return out

    want, got = both_at_once(run)
    assert got == want
    assert got == ["ready", True, "ready"]


# -------------------------------------------------------- agent service


@contextlib.contextmanager
def agent_service(m, base: Path):
    ca = m.pki.generate_ca()
    certs = cp_material(m, ca, base / "cp-pki")
    registry = m.registry.Registry(base / "agents.db")
    svc = m.agentservice.AgentService(
        registry, cert_file=certs / "cp.crt", key_file=certs / "cp.key",
        ca_file=certs / "ca.crt", host="127.0.0.1", port=0)
    svc.start()
    try:
        yield svc, registry, ca
    finally:
        svc.stop()
        registry.close()


def _register(m, port: int, material, base: Path) -> dict:
    bdir = base / "bs"
    bdir.mkdir(exist_ok=True)
    for name, data in material.files().items():
        (bdir / name).write_bytes(data)
    try:
        return m.register.register_with_cp(bdir, host="127.0.0.1", port=port)
    except m.register.RegisterError as e:
        return {"RegisterError": str(e)}


def test_accepts_bound_agent(tmp_path):
    def run(m):
        with agent_service(m, tmp_path / m.tag) as (svc, registry, ca):
            mat = m.identity.mint_bootstrap_material(ca, "proj", "dev",
                                                     container_id="c1")
            registry.bind("proj.dev", "proj", "dev", container_id="c1",
                          cert_sha256=m.identity.cert_fingerprint(
                              mat.agent_cert))
            reply = _register(m, svc.bound_port, mat, tmp_path / m.tag)
            return [reply, registry.get("proj.dev").registered_at > 0]

    want, got = both_at_once(run)
    assert got == want
    assert got[0]["ok"] and got[1]


def test_rejects_unknown_agent(tmp_path):
    def run(m):
        with agent_service(m, tmp_path / m.tag) as (svc, _, ca):
            mat = m.identity.mint_bootstrap_material(ca, "ghost", "dev")
            return _register(m, svc.bound_port, mat, tmp_path / m.tag)

    want, got = both_at_once(run)
    assert got == want
    assert "unknown agent" in got["RegisterError"]


def test_rejects_thumbprint_mismatch(tmp_path):
    """A stolen assertion presented with another agent's leaf fails."""
    def run(m):
        with agent_service(m, tmp_path / m.tag) as (svc, registry, ca):
            m1 = m.identity.mint_bootstrap_material(ca, "proj", "dev",
                                                    container_id="c1")
            registry.bind("proj.dev", "proj", "dev", container_id="c1",
                          cert_sha256=m.identity.cert_fingerprint(
                              m1.agent_cert))
            m2 = m.identity.mint_bootstrap_material(ca, "proj", "other")
            stolen = m.identity.BootstrapMaterial(
                agent_cert=m2.agent_cert, agent_key=m2.agent_key,
                ca_cert=m1.ca_cert, assertion_jwt=m1.assertion_jwt,
                session_key=m1.session_key)
            reply = _register(m, svc.bound_port, stolen, tmp_path / m.tag)
            return [reply, registry.get("proj.dev").registered_at]

    want, got = both_at_once(run)
    assert got == want
    assert "thumbprint" in got[0]["RegisterError"] and got[1] == 0


# ------------------------------------------------------------ admin api


@contextlib.contextmanager
def admin_server(m, base: Path):
    ca = m.pki.generate_ca()
    certs = cp_material(m, ca, base / "cp-pki")
    srv = m.adminapi.AdminServer(
        cert_file=certs / "cp.crt", key_file=certs / "cp.key",
        ca_file=certs / "ca.crt", host="127.0.0.1", port=0)
    srv.register("ListAgents", lambda req: {"agents": [],
                                            "echo": req.get("project", "")})
    srv.start()

    def client(token: str):
        return m.adminapi.AdminClient(
            "127.0.0.1", srv.bound_port, cert_file=certs / "cp.crt",
            key_file=certs / "cp.key", ca_file=certs / "ca.crt", token=token)

    try:
        yield SimpleNamespace(srv=srv, ca=ca, client=client)
    finally:
        srv.stop()


def _call(m, c, method: str, payload: dict | None = None):
    try:
        return c.call(method, payload)
    except m.adminapi.AdminError as e:
        return {"AdminError": str(e)}


def admin_twin(tmp_path: Path, scenario):
    def run(m):
        with admin_server(m, tmp_path / m.tag) as a:
            return scenario(m, a)
    return both(run)


def test_call_roundtrip(tmp_path):
    def scenario(m, a):
        c = a.client(m.adminapi.mint_admin_token(a.ca))
        t = c.call("GetSystemTime")
        return [abs(t["unix"] - time.time()) < 5,
                c.call("ListAgents", {"project": "x"}), a.srv.registered()]

    want, got = admin_twin(tmp_path, scenario)
    assert got == want
    assert got[0] and got[1] == {"agents": [], "echo": "x"}


def test_bad_token_rejected(tmp_path):
    want, got = admin_twin(tmp_path, lambda m, a: _call(
        m, a.client("garbage.token.here"), "GetSystemTime"))
    assert got == want
    assert "HTTP 401" in got["AdminError"]


def test_wrong_scope_rejected(tmp_path):
    def scenario(m, a):
        now = int(time.time())
        bad = m.identity.sign_jwt_es256(
            a.ca.key, {"scope": "self.register", "iat": now, "exp": now + 60})
        return _call(m, a.client(bad), "GetSystemTime")

    want, got = admin_twin(tmp_path, scenario)
    assert got == want
    assert got == {"AdminError": "GetSystemTime: HTTP 403 scope 'admin' "
                                 "required"}


def test_unregistered_method_501(tmp_path):
    want, got = admin_twin(tmp_path, lambda m, a: _call(
        m, a.client(m.adminapi.mint_admin_token(a.ca)), "FirewallStatus"))
    assert got == want
    assert got == {"AdminError": "FirewallStatus: HTTP 501 FirewallStatus "
                                 "not available"}


def test_unknown_method_404(tmp_path):
    def scenario(m, a):
        c = a.client(m.adminapi.mint_admin_token(a.ca))
        with pytest.raises(m.adminapi.AdminError) as e:
            a.srv.register("Nope", lambda req: {})
        return [_call(m, c, "Nope"), str(e.value)]

    want, got = admin_twin(tmp_path, scenario)
    assert got == want
    assert "HTTP 404" in got[0]["AdminError"]


def test_handler_exception_is_500_not_crash(tmp_path):
    def scenario(m, a):
        a.srv.register("FirewallReload", lambda req: 1 / 0)
        c = a.client(m.adminapi.mint_admin_token(a.ca))
        return [_call(m, c, "FirewallReload"),
                c.call("GetSystemTime")["unix"] > 0]

    want, got = admin_twin(tmp_path, scenario)
    assert got == want
    assert got == [{"AdminError": "FirewallReload: HTTP 500 internal error"},
                   True]


# --------------------------------------------------------------- daemon


def _engine(m):
    api = m.fake.FakeDockerAPI()
    api.add_image("img")
    return m.api.Engine(api)


def _start_agent(m, engine, name="clawker.p.a") -> str:
    cid = engine.create_container(name, m.api.ContainerSpec(
        image="img", labels={m.consts.LABEL_ROLE: "agent"}))
    engine.start_container(cid)
    return cid




def _cfg(m, base: Path, **kw):
    kw = {"host": "127.0.0.1", "admin_port": 0, "agent_port": 0,
          "health_port": 0, **kw}
    return m.daemon.CPConfig(pki_dir=base / "pki",
                             registry_path=base / "agents.db", **kw)


def _admin(m, daemon, base: Path):
    ca = m.pki.ensure_ca(base / "pki")
    return m.adminapi.AdminClient(
        "127.0.0.1", daemon.subs.admin.bound_port,
        cert_file=base / "pki" / "cp.crt", key_file=base / "pki" / "cp.key",
        ca_file=base / "pki" / "ca.crt", token=m.adminapi.mint_admin_token(ca))


def _health_doc(h: dict) -> dict:
    return {k: v for k, v in h.items() if k != "uptime_s"}


def test_boot_health_drain(tmp_path):
    def run(m):
        base = tmp_path / m.tag
        daemon = m.daemon.ControlPlaneDaemon(
            _cfg(m, base, watch_interval_s=0.2), _engine(m))
        daemon.start()
        try:
            healthy = daemon.healthy()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{daemon.health_bound_port}/healthz",
                    timeout=3) as r:
                h = json.loads(r.read())
            client = _admin(m, daemon, base)
            status = client.call("Status")
            out = [healthy, _health_doc(h), client.call("ListAgents"),
                   status["healthy"], _health_doc(status["health"]),
                   daemon.subs.admin.registered()]
        finally:
            daemon.request_stop()
            daemon.drain()
        return out

    want, got = both_at_once(run)
    assert got == want
    assert got[0] and got[1]["admin"] and got[1]["agent_service"] \
        and got[1]["feeder"]
    assert got[2] == {"agents": []} and got[3]


def test_drain_to_zero_stops_daemon(tmp_path):
    def run(m):
        engine = _engine(m)
        daemon = m.daemon.ControlPlaneDaemon(
            _cfg(m, tmp_path / m.tag, watch_interval_s=0.05,
                 drain_to_zero=True, drain_grace_polls=2), engine)
        daemon.start()
        try:
            cid = _start_agent(m, engine)
            time.sleep(0.2)
            engine.remove_container(cid, force=True)
            fired = daemon._stop.wait(5.0)
            return [fired, daemon._drained_to_zero]
        finally:
            daemon.drain()

    want, got = both_at_once(run)
    assert got == want
    assert got == [True, True]


def test_ensure_cp_material_idempotent(tmp_path):
    def run(m):
        d = tmp_path / m.tag
        a = m.daemon.ensure_cp_material(d)
        first = (d / "cp.crt").read_bytes()
        b = m.daemon.ensure_cp_material(d)
        return [a == b, (d / "cp.crt").read_bytes() == first,
                [p.name for p in a], oct((d / "cp.key").stat().st_mode & 0o777)]

    want, got = both(run)
    assert got == want
    assert got[:3] == [True, True, ["cp.crt", "cp.key", "ca.crt"]]


class _Firewall:
    """What the daemon calls on a firewall handler, recorded."""

    def __init__(self, calls: list):
        self.calls = calls

    def register_on(self, admin):
        self.calls.append("register_on")

    def clear_expired_bypass(self):
        self.calls.append("clear_expired_bypass")
        return 0

    def gc_tick(self):
        return {}

    def close(self):
        self.calls.append("firewall_queue")

    def teardown(self):
        self.calls.append("firewall_teardown")


class _NetLogger:
    def __init__(self, calls: list, fail: bool = False):
        self.calls, self.fail = calls, fail

    def start(self):
        self.calls.append("netlogger.start")
        if self.fail:
            raise OSError("ring unavailable")

    def stop(self):
        self.calls.append("netlogger")


def _record_stops(daemon, calls: list) -> None:
    """Wrap each subsystem's stop (``close`` for the registry) so the
    drain order lands in ``calls`` under the drain's own names."""
    s = daemon.subs
    for name, obj, meth in (("admin", s.admin, "stop"),
                            ("agent_service", s.agent_service, "stop"),
                            ("watcher", s.watcher, "stop"),
                            ("dialer", s.dialer, "stop"),
                            ("feeder", s.feeder, "stop"),
                            ("registry", s.registry, "close")):
        orig = getattr(obj, meth)

        def rec(*a, _n=name, _f=orig, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        setattr(obj, meth, rec)


@pytest.mark.parametrize("to_zero", [False, True])
def test_drain_runs_in_the_reference_order(tmp_path, to_zero):
    """Boot calls ``register_on`` and ``clear_expired_bypass`` and starts
    the netlogger; drain closes the firewall queue first, stops the
    netlogger before teardown, and tears the data plane down only after
    drain-to-zero (otherwise the maps keep enforcing: fail-closed)."""
    def run(m):
        calls: list = []
        daemon = m.daemon.ControlPlaneDaemon(
            _cfg(m, tmp_path / m.tag, dns_gc_interval_s=0), _engine(m),
            firewall=_Firewall(calls), netlogger=_NetLogger(calls))
        daemon.start()
        boot = list(calls)
        calls.clear()
        _record_stops(daemon, calls)
        if to_zero:
            daemon._on_drained_to_zero()
        daemon.drain()
        return [boot, calls, daemon.subs.unavailable]

    want, got = both_at_once(run)
    assert got == want
    boot, order, unavailable = got
    assert boot == ["register_on", "clear_expired_bypass", "netlogger.start"]
    assert order == [n for n in DRAIN_ORDER
                     if to_zero or n != "firewall_teardown"]
    assert unavailable == []


def test_failing_subsystem_degrades_to_unavailable(tmp_path):
    """The admin port and the healthz port held by another socket, and a
    netlogger that cannot start: each lands in ``unavailable``, healthz
    is gone, and the daemon serves on (the AgentService registers, the
    feeder runs) until drained."""
    def run(m):
        with socket.socket() as admin_hold, socket.socket() as health_hold:
            for s in (admin_hold, health_hold):
                s.bind(("127.0.0.1", 0))
                s.listen(1)
            calls: list = []
            daemon = m.daemon.ControlPlaneDaemon(
                _cfg(m, tmp_path / m.tag,
                     admin_port=admin_hold.getsockname()[1],
                     health_port=health_hold.getsockname()[1]),
                _engine(m), netlogger=_NetLogger(calls, fail=True))
            daemon.start()
            try:
                h = daemon.health()
                out = [_health_doc(h), daemon.healthy(),
                       daemon.health_bound_port,
                       daemon.subs.agent_service.bound_port > 0,
                       daemon._stop.is_set()]
            finally:
                daemon.request_stop()
                daemon.drain()
        return out

    want, got = both_at_once(run)
    assert got == want
    h, healthy, health_port, agent_up, stopped = got
    assert h["unavailable"] == ["admin", "netlogger", "healthz"]
    assert not h["admin"] and h["agent_service"] and h["feeder"]
    assert not healthy and health_port == 0 and agent_up and not stopped


def test_list_agents_over_the_registry(tmp_path):
    def run(m):
        base = tmp_path / m.tag
        reg = m.registry.Registry(base / "agents.db")
        for agent in ("dev", "ops"):
            reg.bind(f"proj.{agent}", "proj", agent, container_id=f"c-{agent}",
                     cert_sha256="ab" * 32)
        reg.bind("other.x", "other", "x", container_id="c-x",
                 cert_sha256="cd" * 32)
        reg.mark_initialized("proj.dev")
        reg.close()
        daemon = m.daemon.ControlPlaneDaemon(_cfg(m, base), _engine(m))
        daemon.start()
        try:
            c = _admin(m, daemon, base)
            every = c.call("ListAgents")["agents"]
            proj = c.call("ListAgents", {"project": "proj"})["agents"]
        finally:
            daemon.request_stop()
            daemon.drain()
        for a in every + proj:
            a.pop("last_seen")
        return [every, proj]

    want, got = both_at_once(run)
    assert got == want
    assert [a["full_name"] for a in got[1]] == ["proj.dev", "proj.ops"]
    assert len(got[0]) == 3 and got[1][0]["initialized"]


# -------------------------------------------------- manager and the verbs


def test_admin_client_without_material_is_refused(tmp_path):
    """The read path mints no PKI a running control plane would reject;
    ``ensure_material`` mints the control plane's."""
    def run(m):
        with m.testenv.TestEnv(base=tmp_path / m.tag):
            cfg = m.config.load_config(tmp_path / m.tag)
            with pytest.raises(m.manager.ControlPlaneError) as e:
                m.manager.admin_client(cfg)
            c = m.manager.admin_client(cfg, ensure_material=True)
            return [str(e.value), c.base,
                    sorted(p.name for p in cfg.pki_dir.iterdir())]

    want, got = both(run)
    assert got == want
    assert got[1] == "https://127.0.0.1:7443"


def _uptime_free(text: str) -> str:
    import re

    text = re.sub(r'"uptime_s": [0-9.]+', '"uptime_s": 0', text)
    return re.sub(r"uptime +\d+s", "uptime Ns", text)


def test_forked_controlplane_verbs_over_a_fake_driver(tmp_path, monkeypatch):
    """``controlplane up`` forks each package's daemon over the fake
    driver on free ports; ``status --format json`` answers healthy with
    nothing unavailable, ``agents --format json`` lists the registry
    (empty), ``down`` stops it, and ``status`` after ``down`` exits 1."""
    monkeypatch.setenv("CLAWKER_TPU_DRIVER", "fake")

    def run(m):
        ports = [tcp_free_port() for _ in range(3)]
        with m.testenv.TestEnv(base=tmp_path / m.tag) as tenv:
            tenv.write_settings(
                "host_proxy:\n  enable: false\n"
                f"control_plane:\n  admin_port: {ports[0]}\n"
                f"  agent_port: {ports[1]}\n  health_port: {ports[2]}\n")
            proj = tenv.base / "proj"
            tenv.make_project(proj, "project: cpverbs\n")
            out = []
            try:
                for argv in (["up"], ["status", "--format", "json"],
                             ["status"], ["agents", "--format", "json"],
                             ["agents"], ["down"], ["status"],
                             ["status", "--format", "json"], ["down"]):
                    res = CliRunner().invoke(
                        m.cli, ["controlplane", *argv],
                        obj=m.Factory(cwd=proj,
                                      driver=m.drivers.FakeDriver()))
                    out.append([argv, res.exit_code,
                                _uptime_free(res.output)])
            finally:
                m.manager.stop(m.config.load_config(proj))
            pid_left = (tenv.state / "cp.pid").exists()
        return out, pid_left

    want, got = both(run)
    assert got == want
    out, pid_left = got
    status = json.loads(out[1][2])
    assert out[0][1:] == [0, "control plane running\n"]
    assert status["running"] and status["unavailable"] == []
    assert status["admin"] and status["agent_service"] and status["feeder"]
    assert out[3][1:] == [0, "[]\n"] and out[4][2] == "no agents\n"
    assert out[5][1:] == [0, "control plane stopped\n"]
    assert out[6][1:] == [1, "control plane: not running\n"]
    assert out[7][1:] == [1, '{"running": false}\n']
    assert out[8][1:] == [0, "control plane not running\n"]
    assert not pid_left
