"""The 22-scenario reference firewall parity corpus.

Each scenario re-derives one test from the reference e2e suite
(clawker's test/e2e/firewall_test.go, function/line cited per
scenario) onto this build's enforcement surfaces: socket-level scenarios
run through :class:`~clawker_tpu_torch.parity.world.World` (kernel twin + real
DnsGate socket + executed Envoy bootstrap + real origin/attacker
listeners), and control-plane scenarios drive the real
:class:`~clawker_tpu_torch.firewall.handler.FirewallHandler` over the fake
engine the way the reference drives the CLI against a real daemon.

A scenario is a callable ``(tmp: Path) -> dict`` returning evidence for
the scorecard; it raises :class:`ScenarioFailure` (or any AssertionError)
on a parity miss.  ``python -m clawker_tpu_torch.parity`` prints the N/22
scorecard; ``tests/test_torch_parity.py`` holds every scenario against
the reference's.

The port's copy of ``clawker_tpu/parity/scenarios.py``, whole.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Callable

from .. import consts
from ..config.schema import EgressRule, PathRule
from ..errors import ClawkerError
from ..firewall.model import Action
from ..firewall.rules import RulesStore
from .world import (
    CG_AGENT,
    DNS_IP,
    HOSTPROXY_IP,
    HOSTPROXY_PORT,
    EgressBlocked,
    World,
)

SCENARIOS: list[tuple[str, "Callable[[Path], dict]"]] = []


class ScenarioFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ScenarioFailure(msg)


def scenario(name: str):
    def reg(fn):
        SCENARIOS.append((name, fn))
        return fn
    return reg


def default_rules() -> list[EgressRule]:
    """The required-rule floor (api.anthropic.com is a required rule in
    the reference: firewall_test.go:206 relies on it)."""
    return [EgressRule(dst="api.anthropic.com", proto="https", port=443)]


def _world(tmp: Path, rules: list[EgressRule] | None = None, **kw) -> World:
    w = World(default_rules() if rules is None else rules, tmp, **kw)
    w.add_origin(["api.anthropic.com"])
    return w


# ------------------------------------------------------------------ handler
# Control-plane scenarios build the real FirewallHandler over the fake
# engine + FakeMaps, mirroring tests/test_firewall_handler.py wiring.

class _HandlerRig:
    def __init__(self, tmp: Path, *, base_egress: bool = True):
        from ..config import load_config
        from ..engine.drivers import FakeDriver
        from ..firewall.enroll import FakeAttacher, FakeCgroupResolver
        from ..firewall.maps import FakeMaps
        from ..firewall.runtime import build_handler
        from ..testenv import TestEnv

        self._env = TestEnv(base=tmp / "xdg")
        self._env.__enter__()
        proj = tmp / "proj"
        proj.mkdir(parents=True, exist_ok=True)
        body = "project: paritycp\n"
        if base_egress:
            body += ("security:\n"
                     "  egress:\n"
                     "    - dst: example.com\n"
                     "      proto: https\n")
        (proj / consts.PROJECT_FLAT_FORM).write_text(body)
        self.cfg = load_config(proj)
        self.driver = FakeDriver()
        self.driver.api.add_image("envoyproxy/envoy:v1.30.2")
        self.maps = FakeMaps()
        self.handler = build_handler(
            self.cfg, self.driver.engine(), maps=self.maps,
            resolver=FakeCgroupResolver(), attacher=FakeAttacher(),
            dns_host="127.0.0.1", dns_port=0,
        )

    def start_agent(self, name: str = "clawker.paritycp.dev") -> str:
        from ..engine.api import ContainerSpec

        self.driver.api.add_image("agent:latest")
        eng = self.driver.engine()
        cid = eng.create_container(name, ContainerSpec(image="agent:latest"))
        eng.start_container(cid)
        return cid

    def close(self) -> None:
        try:
            self.handler.close()
        finally:
            if self.handler.stack.gate is not None:
                self.handler.stack.gate.stop()
            self._env.__exit__(None, None, None)


# ------------------------------------------------------------- scenarios


@scenario("BlockedDomain")
def s_blocked_domain(tmp: Path) -> dict:
    """firewall_test.go:77 -- curl to a domain with no rule fails."""
    w = _world(tmp)
    try:
        w.add_origin(["example.com"])
        res = w.curl("https://example.com")
        check(not res.ok, f"blocked domain answered: {res.code}")
        return {"err": res.err}
    finally:
        w.close()


@scenario("UpDown")
def s_up_down(tmp: Path) -> dict:
    """firewall_test.go:85 -- firewall up / status / down verb cycle."""
    rig = _HandlerRig(tmp)
    try:
        up = rig.handler.init({})
        check(up.get("initialized") is True, "init did not initialize")
        st = rig.handler.status({})
        check(st["stack"].get("running") is True,
              f"status after up: {st['stack']}")
        down = rig.handler.remove({})
        check(down.get("removed") is True, "remove failed")
        st2 = rig.handler.status({})
        check(st2["stack"].get("running") is not True,
              "stack still running after down")
        return {"routes": up.get("routes")}
    finally:
        rig.close()


@scenario("ICMPBlocked")
def s_icmp_blocked(tmp: Path) -> dict:
    """firewall_test.go:103 -- ping fails: SOCK_RAW creation is denied in
    the kernel (sock_create hook), closing ICMP tunnels (ptunnel/icmpsh)."""
    w = _world(tmp)
    try:
        v = w.raw_socket_verdict()
        check(v.action is Action.DENY,
              f"raw socket allowed: {v.action}")
        return {"verdict": v.reason.name}
    finally:
        w.close()


@scenario("Bypass")
def s_bypass(tmp: Path) -> dict:
    """firewall_test.go:147 -- bypass composite: explicit stop restore,
    natural dead-man expiry (INV-B2-007), stopped-container drift guard
    (INV-B2-016)."""
    w = _world(tmp)
    try:
        w.add_origin(["example.com"])
        check(not w.curl("https://example.com").ok, "baseline not blocked")
        # explicit --stop arc
        w.maps.set_bypass(CG_AGENT, int(time.time()) + 30)
        res = w.curl("https://example.com")
        check(res.ok, f"curl during bypass failed: {res.err or res.code}")
        w.maps.clear_bypass(CG_AGENT)
        check(not w.curl("https://example.com").ok,
              "still open after bypass --stop")
        # natural-expiry arc (dead-man deadline in the map itself)
        w.maps.set_bypass(CG_AGENT, int(time.time()) + 1)
        check(w.curl("https://example.com").ok, "short bypass not live")
        time.sleep(1.3)
        check(not w.curl("https://example.com").ok,
              "enforcement not restored after bypass expiry")
    finally:
        w.close()
    # stopped-container arc: the real handler must refuse bypass once the
    # container is gone (drift guard INV-B2-016).
    rig = _HandlerRig(tmp / "cp")
    try:
        cid = rig.start_agent()
        rig.handler.init({})
        rig.handler.enable({"container_id": cid})
        rig.driver.engine().stop_container(cid)
        try:
            rig.handler.bypass({"container_id": cid, "duration_s": 30})
            raise ScenarioFailure("bypass on stopped container succeeded")
        except ClawkerError:
            pass
        return {"arcs": ["stop-restore", "expiry", "stopped-container"]}
    finally:
        rig.close()


@scenario("AllowedDomain")
def s_allowed_domain(tmp: Path) -> dict:
    """firewall_test.go:206 -- required rule api.anthropic.com passes."""
    w = _world(tmp)
    try:
        res = w.curl("https://api.anthropic.com")
        check(res.ok, f"allowed domain failed: {res.err or res.code}")
        return {"code": res.code}
    finally:
        w.close()


@scenario("AddRemove")
def s_add_remove(tmp: Path) -> dict:
    """firewall_test.go:219 -- add opens traffic, remove closes it, and
    removing an unknown rule errors (rules_store semantics)."""
    w = _world(tmp)
    try:
        w.add_origin(["example.com"])
        check(not w.curl("https://example.com").ok, "blocked before add")
        added = default_rules() + [EgressRule(dst="example.com")]
        w.reload_rules(added)
        res = w.curl("https://example.com")
        check(res.ok, f"curl after add failed: {res.err or res.code}")
        w.reload_rules(default_rules())
        check(not w.curl("https://example.com").ok, "open after remove")
        # store-level: removing a rule that is not present reports failure
        store = RulesStore(tmp / "egress-rules.yaml")
        store.add([EgressRule(dst="example.com")])
        check(store.remove("example.com:https:443") is True, "remove failed")
        check(store.remove("nonexistent.com:https:443") is False,
              "removing a non-existent rule should fail")
        return {"arcs": ["add", "remove", "remove-nonexistent"]}
    finally:
        w.close()


@scenario("ConfigRules")
def s_config_rules(tmp: Path) -> dict:
    """firewall_test.go:254 -- concurrent config-sync AddRules + CLI add
    serialized by the ActionQueue; store mutations survive firewall down;
    RPCs fail once the CP (queue) is gone."""
    rig = _HandlerRig(tmp, base_egress=False)
    try:
        rig.handler.init({})
        errs: list = [None, None]

        def add_a():
            try:
                rig.handler.add_rules({"rules": [
                    {"dst": "example.com", "proto": "https", "port": 443}]})
            except Exception as e:  # noqa: BLE001 - recorded for the check
                errs[0] = e

        def add_b():
            try:
                rig.handler.add_rules({"rules": [
                    {"dst": "httpbin.org", "proto": "https", "port": 443}]})
            except Exception as e:  # noqa: BLE001
                errs[1] = e

        ta, tb = threading.Thread(target=add_a), threading.Thread(target=add_b)
        ta.start(); tb.start(); ta.join(10); tb.join(10)
        check(errs == [None, None], f"concurrent adds failed: {errs}")
        listed = {r["dst"] for r in rig.handler.list_rules({})["rules"]}
        check({"example.com", "httpbin.org"} <= listed,
              f"rules lost in concurrent sync: {listed}")
        # firewall down, then remove: store mutation without a stack
        rig.handler.remove({})
        rig.handler.remove_rule({"key": "example.com:https:443"})
        listed2 = {r["dst"] for r in rig.handler.list_rules({})["rules"]}
        check("httpbin.org" in listed2 and "example.com" not in listed2,
              f"post-down remove wrong: {listed2}")
        # CP down: queue closed, RPC errors
        rig.handler.close()
        try:
            rig.handler.remove_rule({"key": "httpbin.org:https:443"})
            raise ScenarioFailure("RPC succeeded after CP down")
        except ClawkerError:
            pass
        return {"serialized": True}
    finally:
        rig.close()


@scenario("Status")
def s_status(tmp: Path) -> dict:
    """firewall_test.go:382 -- status reports a running stack + the
    enrolled container."""
    rig = _HandlerRig(tmp)
    try:
        cid = rig.start_agent()
        rig.handler.init({})
        rig.handler.enable({"container_id": cid})
        st = rig.handler.status({})
        check(st["stack"].get("running") is True, f"not running: {st}")
        check(any(e["container_id"] == cid for e in st["enrolled"]),
              "agent not in status enrollment list")
        return {"enrolled": len(st["enrolled"])}
    finally:
        rig.close()


@scenario("IntraNetworkBypass")
def s_intra_network_bypass(tmp: Path) -> dict:
    """firewall_test.go:398 -- a sibling service on the sandbox bridge is
    reachable with NO rule via the CIDR bypass; external stays blocked."""
    w = _world(tmp, intra_net=("10.99.0.0", 24))
    try:
        w.add_origin(["example.com"])
        sibling = w.add_origin(["listener.internal"])
        # place the listener at a bridge address, like a sibling container
        w.endpoints[("10.99.0.77", 8080)] = ("127.0.0.1", sibling.http_port)
        res = w.curl("http://10.99.0.77:8080/")
        check(res.code == 200,
              f"intra-net service unreachable: {res.err or res.code}")
        check(not w.curl("https://example.com").ok,
              "external domain open alongside CIDR bypass")
        # the gateway (= the host) is excluded from the bypass: a non-proxy
        # host port stays blocked (firewall_test.go:497)
        try:
            w.open_tcp(DNS_IP, 9999)
            raise ScenarioFailure("CIDR bypass covered a host port")
        except EgressBlocked:
            pass
        return {"code": res.code}
    finally:
        w.close()


@scenario("HostProxyReachable")
def s_hostproxy_reachable(tmp: Path) -> dict:
    """firewall_test.go:452 -- the host proxy health endpoint is reachable
    through the targeted eBPF RETURN; any other host port stays blocked."""
    w = _world(tmp)
    try:
        res = w.curl(f"http://{HOSTPROXY_IP}:{HOSTPROXY_PORT}/healthz")
        check(res.code == 200, f"host proxy unreachable: {res.err or res.code}")
        try:
            w.open_tcp(HOSTPROXY_IP, 9999)
            raise ScenarioFailure("non-proxy host port not blocked")
        except EgressBlocked as e:
            return {"health": res.code, "blocked_reason": e.reason.name}
    finally:
        w.close()


@scenario("SSHTCPMapping")
def s_ssh_tcp_mapping(tmp: Path) -> dict:
    """firewall_test.go:503 -- ssh proto rule rides the sequential TCP
    listener (eBPF dport 22 -> envoy:10001 -> cluster github.com:22);
    DNS is the sole domain gate for non-TLS protos (gitlab NXDOMAINs)."""
    rules = default_rules() + [EgressRule(dst="github.com", proto="ssh", port=22)]
    w = World(rules, tmp)
    try:
        w.add_origin(["api.anthropic.com"])
        banner = b"SSH-2.0-OpenSSH_9.6\r\n"
        w.add_origin(["github.com"], banner=banner)
        w.add_origin(["gitlab.com"], banner=banner)
        rcode, ips = w.dig("github.com")
        check(rcode == 0 and ips, "github.com did not resolve")
        sock = w.open_tcp(ips[0], 22)
        try:
            sock.settimeout(5.0)
            got = sock.recv(64)
        finally:
            sock.close()
        check(got.startswith(b"SSH-"), f"no SSH banner via TCP map: {got!r}")
        rcode2, ips2 = w.dig("gitlab.com")
        check(rcode2 != 0 or not ips2, "gitlab.com resolved (no rule)")
        return {"banner": got.decode().strip()}
    finally:
        w.close()


@scenario("DockerInternalDNS")
def s_docker_internal_dns(tmp: Path) -> dict:
    """firewall_test.go:568 -- docker.internal zone answers from the
    engine inventory; sibling service names resolve; others NXDOMAIN."""
    w = _world(tmp)
    try:
        w.add_internal_host("host.docker.internal", "192.168.65.2")
        w.add_internal_host("otel-collector", "10.99.0.9")
        rcode, ips = w.dig("host.docker.internal")
        check(rcode == 0 and ips == ["192.168.65.2"],
              f"host.docker.internal: rcode={rcode} ips={ips}")
        rcode2, ips2 = w.dig("otel-collector")
        check(rcode2 == 0 and ips2 == ["10.99.0.9"],
              f"otel-collector: rcode={rcode2} ips={ips2}")
        rcode3, ips3 = w.dig("evil.example.com")
        check(rcode3 != 0 or not ips3, "non-whitelisted domain resolved")
        return {"host": ips[0], "otel": ips2[0]}
    finally:
        w.close()


@scenario("ExactAllowBlocksSubdomain")
def s_exact_allow_blocks_subdomain(tmp: Path) -> dict:
    """firewall_test.go:609 -- DNS subtree exfil regression: an exact
    allow resolves the apex but NXDOMAINs every subdomain; promoting to a
    wildcard forwards the subtree."""
    rules = default_rules() + [EgressRule(dst="example.com")]
    w = _world(tmp, rules)
    try:
        w.add_origin(["example.com", "www.example.com"])
        rcode, ips = w.dig("example.com")
        check(rcode == 0 and ips, "exact-allow apex must resolve")
        rcode2, ips2 = w.dig("www.example.com")
        check(rcode2 != 0 or not ips2,
              "subdomain of an exact rule leaked upstream (DNS subtree)")
        w.reload_rules(rules + [EgressRule(dst=".example.com")])
        rcode3, ips3 = w.dig("www.example.com")
        check(rcode3 == 0 and ips3, "wildcard subdomain must resolve")
        return {"apex": ips[0], "wildcard_sub": ips3[0]}
    finally:
        w.close()


@scenario("DenySubdomainUnderWildcard")
def s_deny_subdomain_under_wildcard(tmp: Path) -> dict:
    """firewall_test.go:653 -- allow .X except sub.X: the more-specific
    deny zone NXDOMAINs while the wildcard apex still resolves."""
    rules = default_rules() + [
        EgressRule(dst=".example.com", action="allow"),
        EgressRule(dst="www.example.com", action="deny"),
    ]
    w = _world(tmp, rules)
    try:
        w.add_origin(["example.com", "www.example.com"])
        rcode, ips = w.dig("example.com")
        check(rcode == 0 and ips, "wildcard apex must resolve")
        rcode2, ips2 = w.dig("www.example.com")
        check(rcode2 != 0 or not ips2,
              "denied subdomain resolved under wildcard allow")
        return {"apex": ips[0]}
    finally:
        w.close()


@scenario("HTTPDomainDetection")
def s_http_domain_detection(tmp: Path) -> dict:
    """firewall_test.go:709 -- plain HTTP rides the consolidated listener:
    Host-header domain match routes allowed domains; others are blocked."""
    rules = default_rules() + [EgressRule(dst="example.com", proto="http", port=80)]
    w = _world(tmp, rules)
    try:
        w.add_origin(["example.com"])
        w.add_origin(["httpbin.org"])
        res = w.curl("http://example.com/")
        check(res.code in (200, 301, 302),
              f"allowed HTTP domain failed: {res.err or res.code}")
        check(not w.curl("http://httpbin.org/").ok,
              "plain HTTP to non-allowed domain not blocked")
        return {"code": res.code}
    finally:
        w.close()


@scenario("FirewallDisabled")
def s_firewall_disabled(tmp: Path) -> dict:
    """firewall_test.go:788 -- firewall.enable: false: the cgroup is never
    enrolled, traffic flows direct (UNMANAGED allow)."""
    w = _world(tmp, enrolled=False)
    try:
        w.add_origin(["example.com"])
        res = w.curl("https://example.com")
        check(res.code == 200,
              f"disabled firewall should pass traffic: {res.err or res.code}")
        return {"code": res.code}
    finally:
        w.close()


def _path_rule_world(tmp: Path, proto: str, rules: list[PathRule],
                     default: str) -> World:
    port = 443 if proto == "https" else 80
    rule = EgressRule(dst="example.com", proto=proto, port=port,
                      path_rules=rules, path_default=default)
    w = _world(tmp, default_rules() + [rule])
    w.add_origin(["example.com"])
    return w


def _check_deny_body(res) -> None:
    check(res.code == 403, f"denied path got {res.code}, want 403")
    check(b"Forbidden" in res.body,
          f"deny body must be the Forbidden page, got {res.body[:80]!r}")
    check(b"clawker" not in res.body.lower(),
          "deny body discloses enforcement product identity")


@scenario("PathRulesDefaultDeny")
def s_path_rules_default_deny(tmp: Path) -> dict:
    """firewall_test.go:842 -- HTTP path rules, default deny: /test passes
    to upstream, /evil gets the centralized 403."""
    w = _path_rule_world(tmp, "http",
                         [PathRule(path="/test", action="allow")], "deny")
    try:
        allowed = w.curl("http://example.com/test")
        check(allowed.code != 403 and allowed.ok,
              f"allowed path blocked: {allowed.err or allowed.code}")
        _check_deny_body(w.curl("http://example.com/evil"))
        return {"allowed": allowed.code}
    finally:
        w.close()


@scenario("PathRulesExplicitDeny")
def s_path_rules_explicit_deny(tmp: Path) -> dict:
    """firewall_test.go:936 -- HTTP path rules, explicit deny: / passes
    (default allow), /evil 403s."""
    w = _path_rule_world(tmp, "http",
                         [PathRule(path="/evil", action="deny")], "allow")
    try:
        allowed = w.curl("http://example.com/")
        check(allowed.code in (200, 301, 302),
              f"default-allow path failed: {allowed.err or allowed.code}")
        _check_deny_body(w.curl("http://example.com/evil"))
        return {"allowed": allowed.code}
    finally:
        w.close()


@scenario("TLSPathRulesDefaultDeny")
def s_tls_path_rules_default_deny(tmp: Path) -> dict:
    """firewall_test.go:1029 -- MITM path rules, default deny."""
    w = _path_rule_world(tmp, "https",
                         [PathRule(path="/test", action="allow")], "deny")
    try:
        allowed = w.curl("https://example.com/test")
        check(allowed.code != 403 and allowed.ok,
              f"allowed path blocked: {allowed.err or allowed.code}")
        _check_deny_body(w.curl("https://example.com/evil"))
        return {"allowed": allowed.code}
    finally:
        w.close()


@scenario("PathRuleNormalizationDefeatsSmuggling")
def s_path_rule_normalization(tmp: Path) -> dict:
    """firewall_test.go:1131 -- URL-encoded traversal out of an allowed
    prefix must collapse to the denied path (normalize_path +
    UNESCAPE_AND_REDIRECT semantics), never reach upstream."""
    w = _path_rule_world(tmp, "https",
                         [PathRule(path="/allowed/", action="allow")], "deny")
    try:
        vectors = {
            "url-encoded %2e%2e": "https://example.com/allowed/%2e%2e/escaped",
            "url-encoded ..%2f": "https://example.com/allowed/..%2fescaped",
            "double-encoded": "https://example.com/allowed/%252e%252e/escaped",
            "merged-slash": "https://example.com/allowed//..//escaped",
        }
        origin = w.origins["example.com"]
        for name, url in vectors.items():
            res = w.curl(url, follow=True)
            check(res.code == 403,
                  f"smuggle vector {name} got {res.code}, want 403")
            check(b"Forbidden" in res.body,
                  f"smuggle vector {name}: not the centralized deny body")
        check(not any("escaped" in path for _, path in origin.requests),
              f"a smuggled path reached upstream: {origin.requests}")
        return {"vectors": len(vectors)}
    finally:
        w.close()


@scenario("TLSPathRulesExplicitDeny")
def s_tls_path_rules_explicit_deny(tmp: Path) -> dict:
    """firewall_test.go:1232 -- MITM path rules, explicit deny."""
    w = _path_rule_world(tmp, "https",
                         [PathRule(path="/evil", action="deny")], "allow")
    try:
        allowed = w.curl("https://example.com/")
        check(allowed.code in (200, 301, 302),
              f"default-allow path failed: {allowed.err or allowed.code}")
        _check_deny_body(w.curl("https://example.com/evil"))
        return {"allowed": allowed.code}
    finally:
        w.close()


@scenario("WildcardAndExactCoexist")
def s_wildcard_and_exact_coexist(tmp: Path) -> dict:
    """firewall_test.go:1326 -- exact (apex) and wildcard (subdomain) MITM
    rules coexist as independent filter chains with separate path rules."""
    rules = default_rules() + [
        EgressRule(dst="clawker.dev", proto="https", port=443,
                   path_rules=[PathRule(path="/quickstart", action="allow")],
                   path_default="deny"),
        EgressRule(dst=".clawker.dev", proto="https", port=443,
                   path_rules=[PathRule(path="/introduction", action="allow")],
                   path_default="deny"),
    ]
    w = _world(tmp, rules)
    try:
        w.add_origin(["clawker.dev"])
        w.add_origin(["docs.clawker.dev"])
        apex_ok = w.curl("https://clawker.dev/quickstart")
        check(apex_ok.code != 403 and apex_ok.ok,
              f"apex allowed path blocked: {apex_ok.err or apex_ok.code}")
        apex_deny = w.curl("https://clawker.dev/introduction")
        check(apex_deny.code == 403,
              f"apex /introduction got {apex_deny.code}, want 403")
        sub_ok = w.curl("https://docs.clawker.dev/introduction")
        check(sub_ok.code != 403 and sub_ok.ok,
              f"wildcard allowed path blocked: {sub_ok.err or sub_ok.code}")
        sub_deny = w.curl("https://docs.clawker.dev/quickstart")
        check(sub_deny.code == 403,
              f"wildcard /quickstart got {sub_deny.code}, want 403")
        return {"apex": apex_ok.code, "sub": sub_ok.code}
    finally:
        w.close()


def _scenario_case(args: tuple[int, str]) -> dict:
    """Run scenario ``i`` (1-based) under ``base``; one scorecard row,
    never raises.  Top-level so a process pool can dispatch it."""
    i, base_str = args
    name, fn = SCENARIOS[i - 1]
    t0 = time.monotonic()
    try:
        evidence = fn(Path(base_str) / f"{i:02d}-{name}")
        return {"name": name, "pass": True,
                "ms": round((time.monotonic() - t0) * 1000),
                "evidence": evidence}
    except Exception as e:  # noqa: BLE001 - scorecard must finish
        return {"name": name, "pass": False,
                "ms": round((time.monotonic() - t0) * 1000),
                "evidence": {"error": f"{e.__class__.__name__}: {e}"}}


def scenario_cases(base: Path) -> list[tuple[int, str]]:
    """One ready-to-dispatch :func:`_scenario_case` arg per scenario."""
    return [(i, str(base)) for i in range(1, len(SCENARIOS) + 1)]


def run_all(base: Path, jobs: int = 1) -> list[dict]:
    """Run every scenario; returns scorecard rows (never raises).

    ``jobs > 1`` fans the independent cases across a bounded PROCESS
    pool (the serial suite is the bulk of ``parity_suite_wall``).  Processes,
    not threads: every case already owns its own tmpdir subtree, but
    the control-plane cases enter a :class:`~clawker_tpu_torch.testenv.TestEnv`
    that swaps process-global XDG env vars -- per-process isolation
    keeps that safe, and each case binds only ephemeral ports so
    parallel worlds never collide."""
    cases = scenario_cases(base)
    if jobs <= 1:
        return [_scenario_case(c) for c in cases]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=min(jobs, len(cases)),
            mp_context=multiprocessing.get_context("fork")) as ex:
        return list(ex.map(_scenario_case, cases))
