"""The port's firewall handler against the reference's: the action
queue, the stack, enrollment, the 13 verbs, the run-path hooks and the
``firewall`` verbs.

Twins of tests/test_firewall_handler.py (its two control-plane daemon
cases, ``test_cp_daemon_runs_periodic_map_gc`` and
``test_cp_daemon_serves_firewall_verbs``, over each package's
in-process daemon), of tests/test_rule_validation.py's handler cases and of
tests/test_race_stress.py's action queue case.  Each scenario runs once
through each package, each under its own ``TestEnv`` over its own
``FakeDriver`` and ``FakeMaps`` with the DNS gate on loopback, and the
verbs' replies, the maps' state (every record packed to its wire bytes,
``test_torch_firewall_core.snap``), the enrollments, the Envoy
container's spec and the CLI's output are compared.  The fake daemons
mint their ids from one seeded generator in both packages, so container
ids, and the cgroup ids ``FakeCgroupResolver`` takes from their first
bytes, agree.  Paths under a package's ``TestEnv`` read ``<BASE>``.
A rig's gate listens on a loopback port that was free for TCP a moment
before (``tcp_free_port``), not on port 0: ``DnsGate.start`` binds UDP
and then TCP on the UDP socket's number, and port 0 can hand it a number
another TCP socket of the host holds (ROADMAP §3 item 16, kept from the
reference and held by ``test_torch_dnsgate.py``).  The verbs' and the
run path's handlers bind port 0, as the reference's monitor mode does.

Then the lanes: the control plane (``control_plane.enable``, or pinned
programs present), where each package's verbs and run-path hooks reach
its daemon's handler over the AdminService; the pinned maps and the
in-process kernel lane, each held against the reference's choice on
this host; and strict mode without the kernel half
(``FirewallUnavailable`` with the reference's text).
"""

from __future__ import annotations

import contextlib
import json
import random
import re
import socket
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from click.testing import CliRunner
from test_torch_firewall_core import snap
from test_torch_runtime import injected  # noqa: F401

import chip_smoke

import clawker_tpu.analytics.runtime as ref_art
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.config.schema as ref_schema
import clawker_tpu.consts as ref_consts
import clawker_tpu.controlplane.adminapi as ref_adminapi
import clawker_tpu.controlplane.bootstrap as ref_bootstrap
import clawker_tpu.controlplane.daemon as ref_cpdaemon
import clawker_tpu.engine.api as ref_api
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.firewall.dnsgate as ref_dnsgate
import clawker_tpu.firewall.enroll as ref_enroll
import clawker_tpu.firewall.envoy as ref_envoy
import clawker_tpu.firewall.hashes as ref_hashes
import clawker_tpu.firewall.lifecycle as ref_lifecycle
import clawker_tpu.firewall.maps as ref_maps
import clawker_tpu.firewall.model as ref_model
import clawker_tpu.firewall.pki as ref_pki
import clawker_tpu.firewall.policy as ref_policy
import clawker_tpu.firewall.queue as ref_queue
import clawker_tpu.firewall.rules as ref_rules
import clawker_tpu.firewall.runtime as ref_runtime
import clawker_tpu.monitor.netlogger as ref_netlogger
import clawker_tpu.testenv as ref_testenv
import clawker_tpu_torch.analytics.runtime as port_art
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.controlplane.adminapi as port_adminapi
import clawker_tpu_torch.controlplane.bootstrap as port_bootstrap
import clawker_tpu_torch.controlplane.daemon as port_cpdaemon
import clawker_tpu_torch.engine.api as port_api
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.firewall.dnsgate as port_dnsgate
import clawker_tpu_torch.firewall.enroll as port_enroll
import clawker_tpu_torch.firewall.envoy as port_envoy
import clawker_tpu_torch.firewall.hashes as port_hashes
import clawker_tpu_torch.firewall.lifecycle as port_lifecycle
import clawker_tpu_torch.firewall.maps as port_maps
import clawker_tpu_torch.firewall.model as port_model
import clawker_tpu_torch.firewall.pki as port_pki
import clawker_tpu_torch.firewall.policy as port_policy
import clawker_tpu_torch.firewall.queue as port_queue
import clawker_tpu_torch.firewall.rules as port_rules
import clawker_tpu_torch.firewall.runtime as port_runtime
import clawker_tpu_torch.monitor.netlogger as port_netlogger
import clawker_tpu_torch.testenv as port_testenv

PKGS = {
    "ref": SimpleNamespace(
        tag="ref", config=ref_config, schema=ref_schema, consts=ref_consts,
        api=ref_api, drivers=ref_drivers, fake=ref_fake, errors=ref_errors,
        enroll=ref_enroll, envoy=ref_envoy, hashes=ref_hashes,
        lifecycle=ref_lifecycle, maps=ref_maps, model=ref_model,
        queue=ref_queue, rules=ref_rules, runtime=ref_runtime,
        testenv=ref_testenv, bootstrap=ref_bootstrap, cli=ref_root.cli,
        Factory=ref_factory.Factory, dnsgate=ref_dnsgate, policy=ref_policy,
        netlogger=ref_netlogger, art=ref_art, adminapi=ref_adminapi,
        cpdaemon=ref_cpdaemon, pki=ref_pki),
    "port": SimpleNamespace(
        tag="port", config=port_config, schema=port_schema,
        consts=port_consts, api=port_api, drivers=port_drivers,
        fake=port_fake, errors=port_errors, enroll=port_enroll,
        envoy=port_envoy, hashes=port_hashes, lifecycle=port_lifecycle,
        maps=port_maps, model=port_model, queue=port_queue,
        rules=port_rules, runtime=port_runtime, testenv=port_testenv,
        bootstrap=port_bootstrap, cli=port_cli.cli,
        Factory=port_cli.Factory, dnsgate=port_dnsgate, policy=port_policy,
        netlogger=port_netlogger, art=port_art, adminapi=port_adminapi,
        cpdaemon=port_cpdaemon, pki=port_pki),
}
ENVOY_IMAGE = "envoyproxy/envoy:v1.30.2"
PROJECT = ("project: fwtest\n"
           "security:\n"
           "  egress:\n"
           "    - dst: '*.example.com'\n"
           "      proto: https\n")
PROXY_OFF = "host_proxy:\n  enable: false\n"
MONITOR = "firewall:\n  enable: true\n  default_deny: false\n"
ID_SEED = 20260823


@pytest.fixture(autouse=True)
def seeded_ids(monkeypatch):
    """Each package's fake daemon mints ids from its own generator with
    the same seed, so both mint the same ids in the same order."""
    for m in PKGS.values():
        rng = random.Random(ID_SEED)
        monkeypatch.setattr(m.fake, "short_id", lambda n=12, r=rng: "".join(
            r.choice("0123456789abcdef") for _ in range(n)))


def both(fn):
    """``fn(m)`` in the reference, then in the port: -> (want, got)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def tcp_free_port() -> int:
    """A loopback port no TCP socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(handler) -> None:
    handler.close()
    if handler.stack.gate is not None:
        handler.stack.gate.stop()


@contextlib.contextmanager
def cp_daemon(m, cfg, engine, handler, *, admin_port: int = 0,
              health_port: int = 0, **kw):
    """Package ``m``'s control-plane daemon in process on loopback,
    over ``cfg``'s PKI dir and registry and holding ``handler``; drained
    on the way out: -> (daemon, calls), ``calls`` counting the
    AdminService's calls by method."""
    daemon = m.cpdaemon.ControlPlaneDaemon(
        m.cpdaemon.CPConfig(pki_dir=cfg.pki_dir,
                            registry_path=cfg.data_dir / "agents.db",
                            host="127.0.0.1", admin_port=admin_port,
                            agent_port=0, health_port=health_port, **kw),
        engine, firewall=handler)
    daemon.start()
    calls: dict = {}
    handlers = daemon.subs.admin._handlers
    for method, fn in list(handlers.items()):
        def counted(req, _m=method, _f=fn):
            calls[_m] = calls.get(_m, 0) + 1
            return _f(req)
        handlers[method] = counted
    try:
        yield daemon, calls
    finally:
        daemon.request_stop()
        daemon.drain()


def admin_client(m, daemon, cfg):
    ca = m.pki.ensure_ca(cfg.pki_dir)
    return m.adminapi.AdminClient(
        "127.0.0.1", daemon.subs.admin.bound_port,
        cert_file=cfg.pki_dir / "cp.crt", key_file=cfg.pki_dir / "cp.key",
        ca_file=cfg.pki_dir / "ca.crt", token=m.adminapi.mint_admin_token(ca))


class Rig:
    """One package's ``env`` fixture of tests/test_firewall_handler.py:
    a project with a ``*.example.com`` rule, a ``FakeDriver`` holding the
    Envoy image, a ``FakeMaps`` and ``build_handler`` over the fake
    cgroup seams, the gate on loopback."""

    def __init__(self, m, base: Path, *, project: str = PROJECT):
        self.m = m
        self.tenv = m.testenv.TestEnv(base=base)
        self.tenv.__enter__()
        self.proj = self.tenv.base / "proj"
        self.proj.mkdir()
        (self.proj / m.consts.PROJECT_FLAT_FORM).write_text(project)
        self.cfg = m.config.load_config(self.proj)
        self.driver = m.drivers.FakeDriver()
        self.driver.api.add_image(ENVOY_IMAGE)
        self.maps = m.maps.FakeMaps()
        self.handler = self.build()

    def build(self):
        return self.m.runtime.build_handler(
            self.cfg, self.driver.engine(), maps=self.maps,
            resolver=self.m.enroll.FakeCgroupResolver(),
            attacher=self.m.enroll.FakeAttacher(),
            dns_host="127.0.0.1", dns_port=tcp_free_port())

    def start_agent(self, name: str = "clawker.fwtest.dev") -> str:
        self.driver.api.add_image("agent:latest")
        eng = self.driver.engine()
        cid = eng.create_container(name, self.m.api.ContainerSpec(
            image="agent:latest"))
        eng.start_container(cid)
        return cid

    def envoy(self) -> dict:
        return self.driver.engine().inspect_container(
            self.m.consts.ENVOY_CONTAINER)

    def norm(self, obj):
        """``obj`` as JSON with this rig's base path read ``<BASE>``."""
        return json.loads(json.dumps(obj, default=str).replace(
            str(self.tenv.base), "<BASE>"))

    def close(self) -> None:
        try:
            _close(self.handler)
        finally:
            self.tenv.__exit__(None, None, None)


def twin(tmp_path: Path, scenario):
    """``scenario(rig)`` under each package's rig: -> (want, got)."""
    out = []
    for tag in ("ref", "port"):
        rig = Rig(PKGS[tag], tmp_path / tag)
        try:
            out.append(rig.norm(scenario(rig)))
        finally:
            rig.close()
    return tuple(out)


def maps_state(rig) -> dict:
    state = snap(rig.maps)
    return {k: (sorted(v.items()) if isinstance(v, dict) else v)
            for k, v in state.items()}


def route(rig, apex: str, port: int):
    M = rig.m.model
    return rig.maps.lookup_route(M.RouteKey(rig.m.hashes.zone_hash(apex),
                                            port, M.PROTO_TCP))


# ----------------------------------------------------------------- verbs


def test_init_brings_up_data_plane(tmp_path):
    def scenario(r):
        res = r.handler.init({})
        info = r.envoy()
        return {"res": res, "running": info["State"]["Running"],
                "labels": info["Config"]["Labels"],
                "gate": r.handler.stack.gate.bound_port > 0,
                "routes": [route(r, "example.com", 443) is not None,
                           route(r, "api.anthropic.com", 443) is not None],
                "maps": maps_state(r)}

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["res"]["initialized"] and got["res"]["routes"] >= 1
    assert got["running"] and got["gate"] and got["routes"] == [True, True]
    assert got["labels"][port_consts.LABEL_CONTENT_SHA]


def test_init_is_idempotent(tmp_path):
    def scenario(r):
        r.handler.init({})
        sha1, cid1 = r.handler.stack.config_sha(), r.envoy()["Id"]
        r.handler.init({})
        return [sha1, r.handler.stack.config_sha(), cid1, r.envoy()["Id"]]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == got[1] and got[2] == got[3]


def test_enable_disable_enrollment(tmp_path):
    def scenario(r):
        cid = r.start_agent()
        res = r.handler.enable({"container_id": cid})
        pol = r.maps.lookup_container(res["cgroup_id"])
        attached = list(r.handler.attacher.attached)
        state = maps_state(r)
        off = r.handler.disable({"container_id": cid})
        return {"res": res, "policy": pol.pack().hex(),
                "envoy_ip": pol.envoy_ip == r.handler.stack.envoy_ip(),
                "attached": attached, "state": state, "off": off,
                "after": r.maps.lookup_container(res["cgroup_id"]),
                "left": r.handler.attacher.attached}

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["envoy_ip"] and got["attached"] and got["off"]["disabled"]
    assert got["after"] is None and got["left"] == []


def test_enrollment_carries_bridge_subnet(tmp_path):
    import ipaddress

    def scenario(r):
        cid = r.start_agent()
        pol = r.maps.lookup_container(
            r.handler.enable({"container_id": cid})["cgroup_id"])
        net = ipaddress.ip_network(f"{pol.net_ip}/{pol.net_prefix}")
        return [pol.net_ip, pol.net_prefix,
                ipaddress.ip_address(r.handler.stack.envoy_ip()) in net,
                ipaddress.ip_address(r.handler.stack.gateway_ip()) in net]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[1] > 0 and got[2:] == [True, True]


def test_enable_requires_running_container(tmp_path):
    def scenario(r):
        r.driver.api.add_image("agent:latest")
        cid = r.driver.engine().create_container(
            "clawker.fwtest.stopped", r.m.api.ContainerSpec(
                image="agent:latest"))
        with pytest.raises(r.m.errors.ClawkerError) as e:
            r.handler.enable({"container_id": cid})
        return [type(e.value).__name__, str(e.value), maps_state(r)]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == "EnrollError" and "not running" in got[1]


def test_init_reenrolls_and_prunes(tmp_path):
    def scenario(r):
        cid = r.start_agent()
        r.handler.enable({"container_id": cid})
        gone = r.start_agent("clawker.fwtest.gone")
        r.handler.enable({"container_id": gone})
        r.driver.engine().remove_container(gone, force=True)
        res = r.handler.init({})
        return [res, sorted(r.handler.enrollments), cid, gone, maps_state(r)]

    want, got = twin(tmp_path, scenario)
    assert got == want
    res, enrolled, cid, gone, _ = got
    assert res["reenrolled"] == 1 and res["stale_removed"] == 1
    assert enrolled == [cid]


def test_bypass_deadman(tmp_path):
    def scenario(r):
        cid = r.start_agent()
        cgid = r.handler.enable({"container_id": cid})["cgroup_id"]
        t0 = time.time()
        res = r.handler.bypass({"container_id": cid, "duration_s": 0.2})
        on = r.maps.bypassed(cgid)
        deadline = time.time() + 10
        while r.maps.bypassed(cgid) and time.time() < deadline:
            time.sleep(0.05)
        return [res["bypassed"], 0 <= res["until_unix"] - t0 <= 1.2, on,
                r.maps.bypassed(cgid), maps_state(r)["bypass"]]

    want, got = twin(tmp_path, scenario)
    assert got == want == [True, True, True, False, []]


def test_bypass_expires_without_userspace_timer(tmp_path):
    def scenario(r):
        cid = r.start_agent()
        cgid = r.handler.enable({"container_id": cid})["cgroup_id"]
        r.handler.bypass({"container_id": cid, "duration_s": 3600})
        r.handler.close()          # cancels the timer, leaves the entry
        out = [r.maps.bypassed(cgid)]
        r.maps.set_bypass(cgid, int(time.time()) - 1)
        return out + [r.maps.bypassed(cgid), len(snap(r.maps)["bypass"])]

    want, got = twin(tmp_path, scenario)
    assert got == want and got[:2] == [True, False]


def test_enrollments_persist_across_handler_restart(tmp_path):
    def scenario(r):
        cid = r.start_agent()
        r.handler.enable({"container_id": cid})
        r.handler.close()
        path = r.cfg.data_dir / "firewall" / "enrollments.json"
        saved = {k: {f: v for f, v in e.items() if f != "enrolled_at"}
                 for k, e in json.loads(path.read_text()).items()}
        fresh = r.build()
        try:
            return [cid in fresh.enrollments, fresh.init({}), saved]
        finally:
            _close(fresh)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] and got[1]["reenrolled"] == 1 and len(got[2]) == 1


def test_add_remove_rules_resyncs(tmp_path):
    def scenario(r):
        r.handler.init({})
        res = r.handler.add_rules({"rules": [
            {"dst": "github.com", "proto": "tcp", "port": 22},
            {"dst": "github.com", "proto": "tcp", "port": 22},  # dupe
        ]})
        rt = route(r, "github.com", 22)
        stored = [x.key() for x in r.m.rules.RulesStore(
            r.cfg.egress_rules_path).load()]
        routes = maps_state(r)["routes"]
        removed = r.handler.remove_rule({"key": "github.com:tcp:22"})
        return [res, rt.action.name, rt.redirect_port, stored, routes,
                removed, route(r, "github.com", 22),
                r.cfg.egress_rules_path.read_text()]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0]["added"] == ["github.com:tcp:22"] and got[1] == "REDIRECT"
    assert got[2] >= port_consts.ENVOY_TCP_PORT_BASE
    assert "github.com:tcp:22" in got[3] and got[5]["removed"]
    assert got[6] is None


def test_base_rules_cannot_be_removed(tmp_path):
    def scenario(r):
        r.handler.init({})
        return [r.handler.remove_rule({"key": "api.anthropic.com:https:443"}),
                r.handler.list_rules({})]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert not got[0]["removed"]
    assert any(x["key"] == "api.anthropic.com:https:443"
               for x in got[1]["rules"])


def test_list_rules_sources(tmp_path):
    def scenario(r):
        r.handler.add_rules({"rules": [{"dst": "pypi.org",
                                        "proto": "https"}]})
        return r.handler.list_rules({})

    want, got = twin(tmp_path, scenario)
    assert got == want
    rules = {x["key"]: x for x in got["rules"]}
    assert rules["pypi.org:https:443"]["source"] == "dynamic"
    assert rules["api.anthropic.com:https:443"]["source"] == "base"
    assert rules["*.example.com:https:443"]["source"] == "base"


def test_reload_detects_config_drift(tmp_path):
    def scenario(r):
        r.handler.init({})
        cid1, sha1 = r.envoy()["Id"], r.handler.stack.config_sha()
        r.handler.add_rules({"rules": [{"dst": "crates.io",
                                        "proto": "https"}]})
        reloaded = r.handler.reload({})
        return [cid1, r.envoy()["Id"], sha1, r.handler.stack.config_sha(),
                r.handler.stack.gate.policy.match("crates.io") is not None,
                reloaded, (r.handler.stack.conf_dir / "envoy.yaml")
                .read_text()]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] != got[1] and got[2] != got[3] and got[4]
    assert got[5]["reloaded"]


def test_rotate_ca_regenerates_mitm_certs(tmp_path):
    """Certificates carry fresh keys on each side: compared by subject
    and SANs, and the rotation by each side's own bytes."""
    from cryptography import x509

    def scenario(r):
        r.handler.add_rules({"rules": [
            {"dst": "api.example.org", "proto": "https", "paths": ["/v1/"]},
        ]})
        cert = r.handler.stack.conf_dir / "certs" / "api.example.org.crt"
        before = cert.read_bytes()
        res = r.handler.rotate_ca({})
        after = x509.load_pem_x509_certificate(cert.read_bytes())
        sans = after.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value.get_values_for_type(
                x509.DNSName)
        return [res, cert.read_bytes() != before, after.subject.rfc4514_string(),
                after.issuer.rfc4514_string(), sorted(sans)]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0]["rotated"] and got[1] and "api.example.org" in got[4]


def test_resolve_hostname_debug(tmp_path):
    def scenario(r):
        r.handler.init({})
        return [r.handler.resolve_hostname({"hostname": "Sub.Example.COM."}),
                r.handler.resolve_hostname({"hostname": "evil.net"})]

    want, got = twin(tmp_path, scenario)
    assert got == want
    hit, miss = got
    assert hit["allowed"] and hit["zone"] == "example.com" and hit["wildcard"]
    assert any(x["action"] == "REDIRECT" for x in hit["routes"])
    assert not miss["allowed"]


def test_status_and_remove(tmp_path):
    def scenario(r):
        cid = r.start_agent()
        r.handler.enable({"container_id": cid})
        st = r.handler.status({})
        res = r.handler.remove({})
        return [st, res, r.handler.enrollments, r.maps.enrolled(),
                r.driver.engine().container_exists(
                    r.m.consts.ENVOY_CONTAINER), r.handler.stack.gate]

    want, got = twin(tmp_path, scenario)
    assert got == want
    st, res, enrollments, enrolled, envoy, gate = got
    assert st["initialized"] and len(st["enrolled"]) == 1
    assert st["stack"]["envoy_running"] and st["stack"]["dns_gate_up"]
    assert res["removed"] and enrollments == {} and enrolled == {}
    assert not envoy and gate is None


def test_restart_drift_guard(tmp_path):
    def scenario(r):
        cid = r.start_agent()
        cg1 = r.handler.enable({"container_id": cid})["cgroup_id"]
        r.driver.engine().remove_container(cid, force=True)
        cid2 = r.start_agent()
        cg2 = r.handler.enable({"container_id": cid2})["cgroup_id"]
        return [cid != cid2, cg1 != cg2, r.maps.lookup_container(cg1) is None,
                r.maps.lookup_container(cg2) is not None, maps_state(r),
                sorted(r.handler.enrollments)]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[3]
    if got[1]:
        assert got[2] or got[0]


def test_gc_tick_expires_dns_and_bypass(tmp_path):
    def scenario(r):
        r.handler.init({})
        now = int(time.time())
        zh = r.m.hashes.zone_hash("example.com")
        r.maps.cache_dns("1.2.3.4", r.m.maps.DnsEntry(zh, expires_unix=now - 5))
        r.maps.cache_dns("5.6.7.8", r.m.maps.DnsEntry(zh,
                                                      expires_unix=now + 300))
        cid = r.start_agent()
        r.handler.enable({"container_id": cid})
        r.maps.set_bypass(r.handler.enrollments[cid].cgroup_id, now - 5)
        return [r.handler.gc_tick(), r.maps.lookup_dns("1.2.3.4") is None,
                r.maps.lookup_dns("5.6.7.8") is not None,
                snap(r.maps)["bypass"]]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == {"dns_expired": 1, "bypass_cleared": 1}
    assert got[1] and got[2] and got[3] == {}


def test_cp_daemon_runs_periodic_map_gc(tmp_path):
    """The daemon ticks ``gc_tick`` (``dns_gc_interval_s``), not only
    ``clear_expired_bypass`` at boot: an expired DNS entry goes, a live
    one stays."""
    def scenario(r):
        r.handler.init({})
        now = int(time.time())
        zone = r.m.hashes.zone_hash("example.com")
        r.maps.cache_dns("9.9.9.9", r.m.maps.DnsEntry(zone,
                                                      expires_unix=now - 5))
        r.maps.cache_dns("8.8.4.4", r.m.maps.DnsEntry(zone,
                                                      expires_unix=now + 300))
        with cp_daemon(r.m, r.cfg, r.driver.engine(), r.handler,
                       dns_gc_interval_s=0.05) as (daemon, _):
            deadline = time.time() + 5.0
            while r.maps.lookup_dns("9.9.9.9") is not None \
                    and time.time() < deadline:
                time.sleep(0.02)
            return [r.maps.lookup_dns("9.9.9.9"),
                    r.maps.lookup_dns("8.8.4.4") is not None,
                    daemon._gc_thread.is_alive()]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got == [None, True, True]


def test_cp_daemon_serves_firewall_verbs(tmp_path):
    """The handler registered on the daemon answers over the mTLS admin
    surface, and drain closes the action queue first while enforcement
    state stays (fail-closed)."""
    def scenario(r):
        with cp_daemon(r.m, r.cfg, r.driver.engine(), r.handler,
                       watch_interval_s=5.0) as (daemon, calls):
            client = admin_client(r.m, daemon, r.cfg)
            init = client.call("FirewallInit")
            cid = r.start_agent()
            enable = client.call("FirewallEnable", {"container_id": cid})
            status = client.call("FirewallStatus")
            registered = daemon.subs.admin.registered()
        with pytest.raises(r.m.queue.QueueClosed):
            r.handler.queue.submit(lambda: None)
        return [init, enable, status, calls, registered,
                sorted(r.maps.enrolled()), maps_state(r)]

    want, got = twin(tmp_path, scenario)
    assert got == want
    init, enable, status, calls, registered, enrolled, _ = got
    assert init["initialized"] and enable["enabled"] and status["enrolled"]
    assert calls == {"FirewallInit": 1, "FirewallEnable": 1,
                     "FirewallStatus": 1}
    assert len(registered) == 16 and enrolled


def test_envoy_container_resolves_through_the_gate(tmp_path):
    def scenario(r):
        r.handler.init({})
        info = r.envoy()
        stack = r.handler.stack
        sha_loopback = stack.config_sha()
        saved = stack.dns_host, stack.dns_port
        stack.dns_host, stack.dns_port = "", r.m.consts.DNS_PORT
        try:
            pinned = [stack._envoy_dns() == [stack.gateway_ip()],
                      stack.config_sha() != sha_loopback]
        finally:
            stack.dns_host, stack.dns_port = saved
        return [info["HostConfig"].get("Dns"), pinned, info["Config"],
                info["HostConfig"]]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert not got[0] and got[1] == [True, True]


def test_add_rules_rejects_non_mapping_entries(tmp_path):
    """tests/test_rule_validation.py::
    test_handler_add_rules_rejects_non_mapping_entries over this file's
    rig (the reference's ``parity/scenarios._HandlerRig`` builds the
    same handler)."""
    def scenario(r):
        r.handler.init({})
        out = []
        for rules in (["example.com"], [{"dst": "example.com",
                                          "action": "denied"}]):
            with pytest.raises(r.m.errors.ClawkerError) as e:
                r.handler.add_rules({"rules": rules})
            out.append([type(e.value).__name__, str(e.value)])
        return out + [maps_state(r)]

    want, got = twin(tmp_path, scenario)
    assert got == want


def test_sync_data_plane_refuses_invalid_bootstrap(tmp_path, monkeypatch):
    """tests/test_rule_validation.py::
    test_sync_data_plane_refuses_invalid_bootstrap: a mutation whose
    bootstrap fails validation fails the call, the old data plane keeps
    serving and the rule is not kept."""
    def scenario(r):
        r.handler.init({})
        before = r.handler.status({})
        stored = {x.key() for x in r.handler.rules_store.load()}
        real = r.m.envoy.validate_bundle
        monkeypatch.setattr(r.m.envoy, "validate_bundle",
                            lambda b: ["synthetic validation failure"])
        with pytest.raises(r.m.errors.ClawkerError,
                           match="refusing data-plane swap") as e:
            r.handler.add_rules({"rules": [{"dst": "new.example.com"}]})
        monkeypatch.setattr(r.m.envoy, "validate_bundle", real)
        after = r.handler.status({})
        return [str(e.value), after["stack"]["running"],
                after["routes"] == before["routes"],
                {x.key() for x in r.handler.rules_store.load()} == stored,
                r.handler.add_rules({"rules": [{"dst": "ok.example.com"}]})]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[1:4] == [True, True, True]
    assert got[4]["added"] == ["ok.example.com:https:443"]


# ------------------------------------------------------------ action queue


def test_action_queue_serializes_and_survives_errors():
    def run(m):
        q = m.queue.ActionQueue("test")
        order = []

        def slow():
            order.append("a")
            time.sleep(0.05)
            order.append("b")

        f1 = q.submit(slow)
        f2 = q.submit(lambda: order.append("c"))
        with pytest.raises(ValueError):
            q.run(lambda: (_ for _ in ()).throw(ValueError("boom")))
        f1.result(5)
        f2.result(5)
        q.close()
        with pytest.raises(m.queue.QueueClosed) as e:
            q.submit(lambda: None)
        return [order, str(e.value), q._thread.is_alive()]

    want, got = both(run)
    assert got == want == [["a", "b", "c"],
                           "firewall action queue is closed (draining)",
                           False]


def test_action_queue_serializes_mutations(tmp_path):
    """tests/test_race_stress.py::test_action_queue_serializes_mutations:
    8 threads x 100 rounds of rule mutations and reads through one
    queue end in a consistent store, every add applied exactly once."""
    threads, rounds = 8, 100

    def run(m):
        store = m.rules.RulesStore(tmp_path / m.tag / "rules.yaml")
        queue = m.queue.ActionQueue()
        applied = []
        errors = []

        def worker(ti):
            try:
                for ri in range(rounds):
                    if ri % 10 == 0:
                        dst = f"d{ti}-{ri}.example.com"
                        queue.run(lambda d=dst: applied.append(
                            store.add([m.schema.EgressRule(dst=d)])))
                    else:
                        queue.run(store.load)
            except Exception as e:  # surfaced below
                errors.append(repr(e))

        pool = [threading.Thread(target=worker, args=(t,))
                for t in range(threads)]
        try:
            for t in pool:
                t.start()
            for t in pool:
                t.join(60)
        finally:
            queue.close()
        added = {r.dst for batch in applied for r in batch}
        return [errors, sorted(added), sorted(r.dst for r in store.load())]

    want, got = both(run)
    assert got == want
    assert got[0] == [] and got[1] == got[2] and len(got[1]) == threads * 10


# ------------------------------------------------------------ rules store


def test_rules_store_roundtrip(tmp_path):
    def run(m):
        store = m.rules.RulesStore(tmp_path / m.tag / "egress-rules.yaml")
        R = m.schema.EgressRule
        added = store.add([R(dst="a.com"), R(dst="a.com")])
        out = [len(added), [r.dst for r in store.load()],
               store.path.read_text()]
        return out + [store.remove("a.com:https:443"), store.load(),
                      store.remove("a.com:https:443")]

    want, got = both(run)
    assert got == want == [1, ["a.com"], want[2], True, [], False]


def test_rules_store_rejects_bad_rules(tmp_path):
    def run(m):
        store = m.rules.RulesStore(tmp_path / m.tag / "r.yaml")
        out = []
        for rule in (m.schema.EgressRule(dst="x.com", proto="not a proto"),
                     m.schema.EgressRule(dst="")):
            with pytest.raises(m.rules.RuleError) as e:
                store.add([rule])
            out.append(str(e.value))
        return out

    want, got = both(run)
    assert got == want and len(got) == 2


# ----------------------------------------------------------- CLI fallback


@contextlib.contextmanager
def cli_side(m, base: Path, settings: str, project: str):
    """A package's ``TestEnv`` with ``settings`` and a project dir; on
    the way out the process's monitor-mode handler for it is closed and
    forgotten, as tests/test_firewall_handler.py's run-path case does."""
    with m.testenv.TestEnv(base=base) as tenv:
        tenv.write_settings(settings)
        proj = tenv.base / "p"
        proj.mkdir()
        (proj / m.consts.PROJECT_FLAT_FORM).write_text(project)
        try:
            yield tenv, proj
        finally:
            for key in [k for k in m.lifecycle._local_handlers
                        if str(tenv.data) in k]:
                _close(m.lifecycle._local_handlers.pop(key))


def local_handler(m, tenv):
    hits = [h for k, h in m.lifecycle._local_handlers.items()
            if str(tenv.data) in k]
    return hits[0] if hits else None


def test_cli_firewall_verbs_cp_less(tmp_path):
    def run(m):
        with cli_side(m, tmp_path / m.tag, MONITOR + PROXY_OFF,
                      "project: cliproj\n") as (tenv, proj):
            driver = m.drivers.FakeDriver()
            driver.api.add_image(ENVOY_IMAGE)
            out = []
            for argv in (["add-rule", "*.pypi.org"], ["rules"],
                         ["resolve", "files.pypi.org"], ["status"],
                         ["remove-rule", "*.pypi.org:https:443"],
                         ["resolve", "files.pypi.org"]):
                res = CliRunner().invoke(
                    m.cli, ["firewall", *argv],
                    obj=m.Factory(cwd=proj, driver=driver))
                out.append([res.exit_code, json.loads(res.stdout)])
            return json.loads(json.dumps(out).replace(str(tenv.base),
                                                      "<BASE>"))

    want, got = both(run)
    assert got == want
    assert [c for c, _ in got] == [0] * 6
    assert "*.pypi.org:https:443" in got[0][1]["added"]
    assert "*.pypi.org:https:443" in {r["key"] for r in got[1][1]["rules"]}
    assert got[2][1]["allowed"] and got[2][1]["zone"] == "pypi.org"
    assert not got[3][1]["initialized"] and got[3][1]["stack"]["running"]
    assert got[4][1]["removed"] and not got[5][1]["allowed"]


def test_cli_firewall_help_lists_the_references_verbs():
    def run(m):
        res = CliRunner().invoke(m.cli, ["firewall", "--help"])
        return [res.exit_code, res.output.split("Commands:")[1]]

    want, got = both(run)
    assert got == want
    verbs = {line.split()[0] for line in got[1].splitlines() if line.strip()}
    assert verbs == {"init", "enable", "disable", "bypass", "add-rule",
                     "remove-rule", "rules", "reload", "status", "rotate-ca",
                     "sync-routes", "resolve", "remove"}


def test_run_path_bootstrap_hooks_monitor_mode(tmp_path):
    """``run --detach`` with the firewall on in monitor mode: pre-start
    brings up the data plane, post-start enrolls the agent -- keyed by
    the ref the run path passes (the container's name here)."""
    def run(m):
        with cli_side(m, tmp_path / m.tag, MONITOR + PROXY_OFF,
                      "project: runfw\n") as (tenv, proj):
            driver = m.drivers.FakeDriver()
            driver.api.add_image("clawker-runfw:default")
            driver.api.add_image(ENVOY_IMAGE)
            res = CliRunner().invoke(
                m.cli, ["run", "--detach", "--workspace", "snapshot"],
                obj=m.Factory(cwd=proj, driver=driver))
            handler = local_handler(m, tenv)
            assert handler is not None, "the run built no local handler"
            return [res.exit_code, res.stdout, handler.initialized,
                    sorted(handler.enrollments),
                    sorted(handler.maps.enrolled()),
                    driver.engine().container_exists(
                        m.consts.ENVOY_CONTAINER), handler.status({})]

    want, got = both(run)
    assert got == want
    code, out, initialized, enrolled, cgroups, envoy, _ = got
    assert code == 0 and initialized and len(enrolled) == 1
    assert len(cgroups) == 1 and envoy


def test_loop_run_enrolls_each_agent_by_container_id(tmp_path):
    """The loop's creates drive the hooks with the container's id
    (``rt.start(cid)``), so ``handler_resolvers`` names an agent's
    egress by its id, in both packages."""
    def run(m):
        from importlib import import_module

        loop = import_module(f"{m.config.__name__.split('.')[0]}.loop")
        netlogger = import_module(
            f"{m.config.__name__.split('.')[0]}.monitor.netlogger")
        with cli_side(m, tmp_path / m.tag, MONITOR + PROXY_OFF,
                      "project: loopfw\n") as (tenv, proj):
            cfg = m.config.load_config(proj)
            driver = m.drivers.FakeDriver()
            driver.api.add_image("clawker-loopfw:default")
            driver.api.add_image(ENVOY_IMAGE)
            # a container that exits at once is gone before post-start
            # can enroll it (the start fails in both packages)
            driver.api.set_behavior("clawker-loopfw:default",
                                    m.fake.exit_behavior(b"ok\n", 0,
                                                         delay=0.3))
            sched = loop.LoopScheduler(cfg, driver, loop.LoopSpec(
                parallel=3, iterations=2), run_id="fwtwin")
            sched.start()
            sched.run(poll_s=0.02)
            handler = local_handler(m, tenv)
            rc, _ = netlogger.handler_resolvers(handler)
            ids = {c.name.lstrip("/"): c.id
                   for c in driver.api.containers.values()}
            keys = sorted(handler.enrollments)
            out = [[r["status"] for r in sched.status()], keys,
                   sorted(rc(e.cgroup_id) for e in
                          handler.enrollments.values()),
                   sorted(n for n, i in ids.items() if i in keys)]
            sched.cleanup(remove_containers=True)
            return out

    want, got = both(run)
    assert got == want
    statuses, keys, resolved, names = got
    assert statuses == ["done"] * 3 and len(keys) == 3 and resolved == keys
    assert all(re.fullmatch(r"[0-9a-f]{64}", k) for k in keys)
    assert names == [f"clawker.loopfw.loop-fwtwin-{i}" for i in range(3)]


# ------------------------------------- the control plane and the kernel lanes


def cp_settings(admin_port: int, health_port: int, enable: bool) -> str:
    return (f"control_plane:\n  enable: {str(enable).lower()}\n"
            f"  admin_port: {admin_port}\n  health_port: {health_port}\n")


def _daemon_handler(m, cfg, driver):
    """The handler a control plane holds in monitor mode, over
    ``FakeMaps`` and the fake cgroup seams, its gate on loopback."""
    driver.api.add_image(ENVOY_IMAGE)
    return m.runtime.build_handler(
        cfg, driver.engine(), maps=m.maps.FakeMaps(),
        resolver=m.enroll.FakeCgroupResolver(),
        attacher=m.enroll.FakeAttacher(), dns_host="127.0.0.1",
        dns_port=tcp_free_port())


def test_control_plane_lane_is_refused_by_name(tmp_path):
    """``control_plane.enable``: each package's ``firewall`` verbs find
    its control plane healthy (``manager.health``) and ride its
    AdminService (``admin_client(ensure_material=True)``) to the handler
    the daemon holds; no monitor-mode handler is built in the verb's
    process."""
    def run(m):
        ports = [tcp_free_port(), tcp_free_port()]
        with cli_side(m, tmp_path / m.tag, MONITOR + PROXY_OFF
                      + cp_settings(*ports, True), "project: cp\n") \
                as (tenv, proj):
            cfg = m.config.load_config(proj)
            driver = m.drivers.FakeDriver()
            handler = _daemon_handler(m, cfg, driver)
            try:
                with cp_daemon(m, cfg, driver.engine(), handler,
                               admin_port=ports[0],
                               health_port=ports[1]) as (_, calls):
                    out = []
                    for argv in (["status"], ["add-rule", "*.pypi.org"],
                                 ["rules"], ["resolve", "files.pypi.org"]):
                        res = CliRunner().invoke(
                            m.cli, ["firewall", *argv],
                            obj=m.Factory(cwd=proj,
                                          driver=m.drivers.FakeDriver()))
                        out.append([res.exit_code, json.loads(res.stdout)])
                    local = local_handler(m, tenv)
            finally:
                _close(handler)
            return json.loads(json.dumps([out, calls, local]).replace(
                str(tenv.base), "<BASE>"))

    want, got = both(run)
    assert got == want
    out, calls, local = got
    assert [c for c, _ in out] == [0] * 4 and local is None
    assert "*.pypi.org:https:443" in out[1][1]["added"]
    assert calls == {"FirewallStatus": 1, "FirewallAddRules": 1,
                     "FirewallListRules": 1, "FirewallResolveHostname": 1}


def test_pinned_programs_lane_is_refused_by_name(tmp_path, monkeypatch):
    """Pinned programs present (``kernel_available`` patched True in
    both packages): the run path's hooks route ``FirewallInit`` and
    ``FirewallEnable`` to the control plane, found healthy on the
    settings' ports, whose handler brings up the data plane and enrolls
    the started container."""
    def run(m):
        ports = [tcp_free_port(), tcp_free_port()]
        with cli_side(m, tmp_path / m.tag, MONITOR + PROXY_OFF
                      + cp_settings(*ports, False), "project: pin\n") \
                as (tenv, proj):
            cfg = m.config.load_config(proj)
            driver = m.drivers.FakeDriver()
            handler = _daemon_handler(m, cfg, driver)
            monkeypatch.setattr(m.runtime, "kernel_available",
                                lambda *a: True)
            try:
                with cp_daemon(m, cfg, driver.engine(), handler,
                               admin_port=ports[0],
                               health_port=ports[1]) as (_, calls):
                    driver.api.add_image("agent:latest")
                    eng = driver.engine()
                    cid = eng.create_container(
                        "clawker.pin.dev", m.api.ContainerSpec(
                            image="agent:latest"))
                    m.bootstrap.pre_start_services(cfg, driver, cid)
                    eng.start_container(cid)
                    m.bootstrap.post_start_services(cfg, driver, cid)
                    out = [calls, handler.initialized,
                           sorted(handler.enrollments) == [cid],
                           local_handler(m, tenv)]
            finally:
                _close(handler)
            return out

    want, got = both(run)
    assert got == want
    assert got == [{"FirewallInit": 1, "FirewallEnable": 1}, True, True,
                   None]


def test_pinned_maps_lane_is_refused_by_name(tmp_path, monkeypatch):
    """``build_handler`` called directly with pinned programs present
    (``kernel_available`` patched True in both packages) reaches the
    pinned-maps lane in both: ``PinnedMaps`` opens the pins under
    ``/sys/fs/bpf/clawker-tpu``, and where they are absent both raise
    the same error type with the same text."""
    def run(m):
        monkeypatch.setattr(m.runtime, "kernel_available", lambda *a: True)
        with cli_side(m, tmp_path / m.tag, MONITOR, "project: pin\n") \
                as (_, proj):
            cfg = m.config.load_config(proj)
            try:
                h = m.runtime.build_handler(
                    cfg, m.drivers.FakeDriver().engine(),
                    monitor_fallback=True)
            except Exception as e:  # noqa: BLE001 - the twin compares it
                return type(e).__name__, str(e)
            try:
                return type(h.maps).__name__, type(h.attacher).__name__
            finally:
                _close(h)
                h.maps.close()

    want, got = both(run)
    assert got == want
    assert got[0] in ("BpfError", "PinnedMaps")


def test_inprocess_kernel_lane_probe_is_out(tmp_path):
    """The in-process lane's probe answers as the reference's does on
    this host.  Where it passes, ``build_handler(...,
    monitor_fallback=True)`` takes the in-process lane in both packages:
    ``LiveMaps`` over a ``KernelAttacher`` whose nine programs passed the
    verifier, and the same log line; both are closed after.  Where it
    fails, both take the monitor fallback and warn that nothing is
    enforced, in the same words."""
    import logging

    probe = ref_runtime.inprocess_kernel_available()
    assert port_runtime.inprocess_kernel_available() is probe

    def run(m):
        said: list = []
        tap = logging.Handler(logging.INFO)
        tap.emit = lambda rec: said.append([rec.levelname, rec.getMessage()])
        level = m.runtime.log.level
        m.runtime.log.setLevel(logging.INFO)
        m.runtime.log.addHandler(tap)
        try:
            with cli_side(m, tmp_path / m.tag, MONITOR, "project: mon\n") \
                    as (_, proj):
                cfg = m.config.load_config(proj)
                driver = m.drivers.FakeDriver()
                driver.api.add_image(ENVOY_IMAGE)
                h = m.runtime.build_handler(cfg, driver.engine(),
                                            monitor_fallback=True)
                try:
                    out = [type(h.maps).__name__, type(h.resolver).__name__,
                           type(h.attacher).__name__,
                           [h.stack.dns_host, h.stack.dns_port]]
                    if isinstance(h.attacher, m.enroll.KernelAttacher):
                        out.append(sorted(h.attacher.kern.progs))
                finally:
                    _close(h)
                    if isinstance(h.attacher, m.enroll.KernelAttacher):
                        h.attacher.close()
        finally:
            m.runtime.log.removeHandler(tap)
            m.runtime.log.setLevel(level)
        return out, said

    want, got = both(run)
    assert got == want
    out, said = got
    if probe:
        assert out[:3] == ["LiveMaps", "CgroupResolver", "KernelAttacher"]
        assert len(out[4]) == 9
        assert said == [["INFO", "firewall: kernel enforcement (in-process "
                                 "verifier-loaded programs)"]]
    else:
        assert out == ["FakeMaps", "FakeCgroupResolver", "FakeAttacher",
                       ["127.0.0.1", 0]]
        assert said == [["WARNING", "firewall: kernel programs not loaded -- "
                                    "userspace monitor mode only, NO "
                                    "enforcement"]]


def test_strict_mode_without_the_kernel_half_is_unavailable(tmp_path):
    """``default_deny: true`` (the default) and no kernel half:
    ``FirewallUnavailable`` with the reference's text, on the run path
    and from a verb."""
    def run(m):
        with cli_side(m, tmp_path / m.tag,
                      "firewall:\n  enable: true\n" + PROXY_OFF,
                      "project: strict\n") as (tenv, proj):
            cfg = m.config.load_config(proj)
            with pytest.raises(m.runtime.FirewallUnavailable) as e:
                m.bootstrap.pre_start_services(cfg, m.drivers.FakeDriver(),
                                               "cid")
            res = CliRunner().invoke(m.cli, ["firewall", "status"],
                                     obj=m.Factory(
                                         cwd=proj,
                                         driver=m.drivers.FakeDriver()))
            return [str(e.value), res.exit_code, res.output,
                    local_handler(m, tenv)]

    want, got = both(run)
    assert got == want
    assert got[0].startswith("firewall enabled but no pinned programs under "
                             "/sys/fs/bpf/clawker-tpu")
    assert got[1] == 1 and got[0] in got[2] and got[3] is None


# ------------------------------------------------ the slice, end to end


E2E_AGENTS = 10
E2E_STORM = 6
E2E_STEPS = 60
NOW = 1_785_000_000          # the netloggers' pinned clock: a Unix second
# ROADMAP §3 item 7: fitted scores agree to ~1e-3 relative
Z_RTOL = 1e-3


def _e2e_project() -> str:
    lines = ["project: fwtest", "security:", "  egress:"]
    for dst, proto, port in chip_smoke.EGRESS_RULES:
        lines += [f"    - dst: '{dst}'", f"      proto: {proto}"]
        lines += [f"      port: {port}"] if port else []
    return "\n".join(lines) + "\n"


def test_slice_end_to_end_scores_the_handlers_egress_like_the_reference(
        tmp_path, monkeypatch, injected):
    """Agents enrolled by each package's handler resolve through its DNS
    gate (a loopback upstream behind the gate's ``_forward`` seam) and
    connect over its maps (chip_smoke's ``_fw_round``: three drains, a
    storm from one agent); a ``NetLogger`` with ``handler_resolvers``
    writes the same file in both packages, keyed by container id, and
    each package's ``score_file`` (the port's on the CPU, both drawing
    the same params and noise) flags the storm agent first."""
    import random

    out = {}
    with chip_smoke.LoopbackUpstream() as up:
        for tag, m in PKGS.items():
            clock = [NOW]
            monkeypatch.setattr(m.netlogger, "time", SimpleNamespace(
                gmtime=lambda c=clock: time.gmtime(c[0]),
                strftime=time.strftime, monotonic=time.monotonic))
            r = Rig(m, tmp_path / tag, project=_e2e_project())
            try:
                r.handler.stack.upstreams = (up.addr,)
                r.handler.init({})
                r.handler.stack.gate._forward = chip_smoke.loopback_forward
                cids = [r.start_agent(f"clawker.fwtest.agent-{i}")
                        for i in range(E2E_AGENTS)]
                for cid in cids:
                    r.handler.enable({"container_id": cid})
                rc, rz = m.netlogger.handler_resolvers(r.handler)
                path = r.cfg.logs_dir / "ebpf-egress.jsonl"
                nl = m.netlogger.NetLogger(r.maps, out_path=path,
                                           resolve_cgroup=rc,
                                           resolve_zone=rz)
                rng = random.Random(chip_smoke.EGRESS_SEED)
                verdicts, drained = [], []
                for k in range(chip_smoke.FW_ROUNDS):
                    chip_smoke._fw_round(m, r.handler, cids, k, rng,
                                         cids[E2E_STORM], verdicts)
                    clock[0] += 1
                    drained.append(chip_smoke._fw_drain(nl))
                kw = {"device": "cpu"} if tag == "port" else {}
                out[tag] = {
                    "cids": cids, "drained": drained,
                    "dropped": r.maps.events_dropped,
                    "verdicts": [(v.action.name, v.reason.name)
                                 for v in verdicts],
                    "gate": dict(vars(r.handler.stack.gate.stats)),
                    "file": path.read_bytes(),
                    "rep": m.art.score_file(path, window_s=1,
                                            train_steps=E2E_STEPS, **kw)}
            finally:
                r.close()
    want, got = out["ref"], out["port"]
    wrep, grep = want.pop("rep"), got.pop("rep")
    assert got == want
    storm = got["cids"][E2E_STORM]
    recs = [json.loads(line) for line in got["file"].splitlines()]
    assert got["dropped"] == 0 and all(got["drained"])
    assert sum(got["drained"]) == len(recs)
    assert {x["container"] for x in recs} == set(got["cids"])
    assert got["gate"]["queries"] == got["gate"]["allowed"] == \
        chip_smoke.FW_ROUNDS * E2E_AGENTS

    def ranked(rep):
        return [a.agent for a in sorted(rep.agents, key=lambda a: -a.latest)]

    def flagged(rep):
        return [a.agent for a in sorted(rep.agents, key=lambda a: -a.latest)
                if a.latest >= chip_smoke.EGRESS_THRESHOLD]

    assert grep.device == "cpu" and len(grep.keys) == len(wrep.keys)
    assert flagged(grep) == flagged(wrep)
    assert flagged(grep)[0] == ranked(grep)[0] == storm
    np.testing.assert_allclose(grep.raw, wrep.raw, rtol=Z_RTOL)
    hot = [k for k, z in enumerate(wrep.z) if z >= 1.0]
    np.testing.assert_allclose(grep.z[hot], wrep.z[hot], rtol=Z_RTOL)
