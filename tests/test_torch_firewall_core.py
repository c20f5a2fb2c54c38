"""The port's firewall core against the reference's: the zone hash, the
map ABI, the map store and the decision semantics.

Twins of tests/test_firewall_policy.py: every scenario runs through
both packages' ``policy`` over each package's own ``FakeMaps``, and the
verdicts, the maps' state (every record packed to its wire bytes) and
the events ring (packed) are compared byte for byte.  The one clock a
decision reads, ``policy._event``'s ``time.monotonic_ns()``, is pinned
in both packages to the same counter; the bypass and dns-cache clocks
(``time.time()``) stay real, as the reference's cases use them.
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace

import pytest

from clawker_tpu.config import schema as ref_schema
from clawker_tpu.firewall import hashes as ref_hashes
from clawker_tpu.firewall import maps as ref_maps
from clawker_tpu.firewall import model as ref_model
from clawker_tpu.firewall import policy as ref_policy
from clawker_tpu_torch.config import schema as port_schema
from clawker_tpu_torch.firewall import hashes as port_hashes
from clawker_tpu_torch.firewall import maps as port_maps
from clawker_tpu_torch.firewall import model as port_model
from clawker_tpu_torch.firewall import policy as port_policy

PKGS = {
    "ref": SimpleNamespace(policy=ref_policy, maps=ref_maps, model=ref_model,
                           hashes=ref_hashes, schema=ref_schema),
    "port": SimpleNamespace(policy=port_policy, maps=port_maps,
                            model=port_model, hashes=port_hashes,
                            schema=port_schema),
}

CG = 4242  # enrolled cgroup id
ENVOY = "10.99.0.2"
DNSGATE = "10.99.0.3"
HOSTPROXY = "10.99.0.1"


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """``policy._event`` stamps 1, 2, 3, ... in each package."""
    for m in PKGS.values():
        counter = itertools.count(1)
        monkeypatch.setattr(m.policy, "time", SimpleNamespace(
            monotonic_ns=lambda c=counter: next(c)))


def verdict(v) -> tuple:
    return (v.action.name, v.reason.name, v.redirect_ip, v.redirect_port,
            v.zone_hash, v.allowed)


def snap(maps) -> dict:
    """The fake maps' whole state, each record packed to its ABI bytes."""
    with maps._lock:
        return {
            "containers": {cg: p.pack() for cg, p in maps._containers.items()},
            "bypass": dict(maps._bypass),
            "dns": {ip: e.pack() for ip, e in maps._dns.items()},
            "routes": sorted((k.pack(), v.pack())
                             for k, v in maps._routes.items()),
            "udp": [(c, f.pack()) for c, f in maps._udp.items()],
            "tcp": [(c, f.pack()) for c, f in maps._tcp.items()],
            "events": [e.pack() for e in maps._events],
            "dropped": maps.events_dropped,
        }


def enrolled(m, flags=None):
    M = m.model
    maps = m.maps.FakeMaps()
    maps.enroll(CG, M.ContainerPolicy(
        envoy_ip=ENVOY, dns_ip=DNSGATE, hostproxy_ip=HOSTPROXY,
        hostproxy_port=18374,
        flags=M.FLAG_ENFORCE | M.FLAG_HOSTPROXY if flags is None else flags))
    return maps


def cache(m, maps, ip, zone, ttl=300):
    maps.cache_dns(ip, m.model.DnsEntry(
        zone_hash=m.hashes.zone_hash(zone),
        expires_unix=int(time.time()) + ttl))


def route(m, maps, zone, port, proto, val):
    t = maps.routes()
    t[m.model.RouteKey(m.hashes.zone_hash(zone), port, proto)] = val
    maps.sync_routes(t)


def redirect(m, port=10000):
    return m.model.RouteVal(m.model.Action.REDIRECT, redirect_ip=ENVOY,
                            redirect_port=port)


def twin(scenario):
    """``scenario(m, maps)`` over an enrolled ``FakeMaps`` in each
    package: -> its result with the maps' state; both must agree."""
    out = {}
    for tag, m in PKGS.items():
        maps = enrolled(m)
        out[tag] = (scenario(m, maps), snap(maps))
    assert out["port"] == out["ref"]
    return out["port"]


# -- scenario: unmanaged cgroups are never touched --------------------------

def test_unmanaged_cgroup_allowed():
    got, _ = twin(lambda m, maps: verdict(
        m.policy.connect4(maps, 999, "93.184.216.34", 443)))
    assert got[:2] == ("ALLOW", "UNMANAGED")


# -- scenario: allowed domain -> Envoy redirect ------------------------------

def test_allowed_domain_redirects_to_envoy():
    def scenario(m, maps):
        cache(m, maps, "93.184.216.34", "example.com")
        route(m, maps, "example.com", 443, m.model.PROTO_TCP, redirect(m))
        return verdict(m.policy.connect4(maps, CG, "93.184.216.34", 443))

    got, state = twin(scenario)
    assert got == ("REDIRECT", "ROUTE", ENVOY, 10000,
                   port_hashes.zone_hash("example.com"), True)
    assert len(state["events"]) == 1


# -- scenario: blocked domain -> deny ----------------------------------------

def test_blocked_domain_denied():
    got, state = twin(lambda m, maps: verdict(
        m.policy.connect4(maps, CG, "203.0.113.9", 443)))
    assert got[:2] == ("DENY", "NO_DNS_ENTRY")
    ev = port_model.EgressEvent.unpack(state["events"][0])
    assert (ev.ts_ns, ev.cgroup_id, ev.dst_ip, ev.dst_port) == (
        1, CG, "203.0.113.9", 443)


def test_resolved_but_unrouted_zone_denied():
    def scenario(m, maps):
        cache(m, maps, "198.51.100.7", "evil.example.net")
        return verdict(m.policy.connect4(maps, CG, "198.51.100.7", 443))

    got, _ = twin(scenario)
    assert got[:2] == ("DENY", "NO_ROUTE")


# -- scenario: port-specific route + any-port fallback -----------------------

def test_port_specific_route_beats_any_port():
    def scenario(m, maps):
        cache(m, maps, "10.1.2.3", "example.com")
        route(m, maps, "example.com", 0, m.model.PROTO_TCP,
              m.model.RouteVal(m.model.Action.ALLOW))
        route(m, maps, "example.com", 8443, m.model.PROTO_TCP, redirect(m))
        return [verdict(m.policy.connect4(maps, CG, "10.1.2.3", p))
                for p in (8443, 9999)]

    got, _ = twin(scenario)
    assert [g[0] for g in got] == ["REDIRECT", "ALLOW"]


# -- scenario: ICMP blocked via raw-socket deny ------------------------------

def test_raw_socket_denied_blocks_icmp():
    def scenario(m, maps):
        P = m.policy
        return [verdict(P.sock_create(maps, cg, 2, kind)) for cg, kind in (
            (CG, P.SOCK_RAW), (CG, P.SOCK_STREAM), (999, P.SOCK_RAW),
            (CG, P.SOCK_PACKET))]

    got, state = twin(scenario)
    assert [g[:2] for g in got] == [("DENY", "RAW_SOCKET"),
                                    ("ALLOW", "UNMANAGED"),
                                    ("ALLOW", "UNMANAGED"),
                                    ("DENY", "RAW_SOCKET")]
    assert len(state["events"]) == 2


# -- scenario: bypass allows everything, dead-man timed ----------------------

def test_bypass_allows_and_emits_event():
    def scenario(m, maps):
        maps.set_bypass(CG, int(time.time()) + 60)
        out = [verdict(m.policy.connect4(maps, CG, "203.0.113.9", 443)),
               verdict(m.policy.sock_create(maps, CG, 2, m.policy.SOCK_RAW))]
        reasons = [e.reason.name for e in maps.drain_events()]
        maps.clear_bypass(CG)
        return out, reasons

    (got, reasons), _ = twin(scenario)
    assert got[0][:2] == ("ALLOW", "BYPASS") and got[1][0] == "ALLOW"
    assert reasons == ["BYPASS"]


def test_bypass_deadman_expiry():
    def scenario(m, maps):
        maps.set_bypass(CG, int(time.time()) - 1)
        expired = list(m.maps.iter_expired_bypass(maps))
        for cg in expired:
            maps.clear_bypass(cg)
        return expired, verdict(m.policy.connect4(maps, CG, "203.0.113.9",
                                                  443))

    (expired, got), _ = twin(scenario)
    assert expired == [CG] and got[0] == "DENY"


# -- scenario: DNS is forced through the gate --------------------------------

def test_hardcoded_resolver_rewritten_to_gate():
    got, _ = twin(lambda m, maps: verdict(m.policy.connect4(
        maps, CG, "8.8.8.8", 53, m.model.PROTO_UDP)))
    assert got[:4] == ("REDIRECT_DNS", "DNS", DNSGATE, 53)


def test_gate_dns_allowed_directly():
    got, state = twin(lambda m, maps: verdict(m.policy.connect4(
        maps, CG, DNSGATE, 53, m.model.PROTO_UDP)))
    assert got[:2] == ("ALLOW", "DNS") and state["events"] == []


# -- scenario: infra endpoints -----------------------------------------------

def test_envoy_and_loopback_and_hostproxy_allowed():
    got, _ = twin(lambda m, maps: [verdict(m.policy.connect4(
        maps, CG, ip, port)) for ip, port in (
            (ENVOY, 10000), ("127.0.0.1", 8080), (HOSTPROXY, 18374),
            (HOSTPROXY, 22))])
    assert [g[:2] for g in got] == [("ALLOW", "ENVOY"),
                                    ("ALLOW", "LOOPBACK"),
                                    ("ALLOW", "HOSTPROXY"),
                                    ("DENY", "NO_DNS_ENTRY")]


def test_hostproxy_flag_off_denies():
    def scenario(m, maps):
        maps.enroll(CG, m.model.ContainerPolicy(
            envoy_ip=ENVOY, dns_ip=DNSGATE, hostproxy_ip=HOSTPROXY,
            hostproxy_port=18374, flags=m.model.FLAG_ENFORCE))
        return verdict(m.policy.connect4(maps, CG, HOSTPROXY, 18374))

    got, _ = twin(scenario)
    assert got[0] == "DENY"


# -- scenario: UDP reverse NAT via socket cookie -----------------------------

def test_udp_redirect_reverse_nat():
    def scenario(m, maps):
        P, cookie = m.policy, 777
        return (verdict(P.sendmsg4(maps, CG, cookie, "9.9.9.9", 53)),
                P.recvmsg4(maps, CG, cookie, DNSGATE, 53),
                P.recvmsg4(maps, CG, cookie, "1.2.3.4", 9),
                P.getpeername4(maps, CG, cookie, DNSGATE, 53),
                P.recvmsg4(maps, 999, cookie, DNSGATE, 53))

    got, state = twin(scenario)
    assert got[0][0] == "REDIRECT_DNS"
    assert got[1:] == (("9.9.9.9", 53), ("1.2.3.4", 9), ("9.9.9.9", 53),
                       (DNSGATE, 53))
    assert [c for c, _ in state["udp"]] == [777]


def test_tcp_connect_redirect_getpeername_reverse():
    def scenario(m, maps):
        P = m.policy
        cache(m, maps, "93.184.216.34", "example.com")
        route(m, maps, "example.com", 443, m.model.PROTO_TCP, redirect(m))
        v = P.connect4(maps, CG, "93.184.216.34", 443, m.model.PROTO_TCP,
                       sock_cookie=555)
        return (verdict(v), P.getpeername4(maps, CG, 555, ENVOY, 10000),
                P.recvmsg4(maps, CG, 555, ENVOY, 10000),
                maps.lookup_udp_flow(555) is None,
                maps.lookup_tcp_flow(555) is not None)

    got, _ = twin(scenario)
    assert got[0][0] == "REDIRECT"
    assert got[1:] == (("93.184.216.34", 443), (ENVOY, 10000), True, True)


def test_bypass_opens_ipv6_too():
    def scenario(m, maps):
        maps.set_bypass(CG, int(time.time()) + 60)
        v = verdict(m.policy.connect6(maps, CG, "2606:4700::1111", 443))
        maps.clear_bypass(CG)
        return v

    got, _ = twin(scenario)
    assert got[:2] == ("ALLOW", "BYPASS")


def test_udp_flow_lru_bound():
    def run(m):
        fm = m.maps.FakeMaps()
        for c in range(m.maps.UDP_FLOWS_MAX + 10):
            fm.record_udp_flow(c, m.model.UdpFlow("1.1.1.1", 53))
            fm.record_tcp_flow(c, m.model.UdpFlow("2.2.2.2", 443))
        return (fm.lookup_udp_flow(0), fm.lookup_tcp_flow(9),
                fm.lookup_udp_flow(m.maps.UDP_FLOWS_MAX + 9).pack(),
                snap(fm))

    want, got = run(PKGS["ref"]), run(PKGS["port"])
    assert got == want
    assert got[:2] == (None, None) and len(got[3]["udp"]) == \
        port_maps.UDP_FLOWS_MAX == 4096


# -- scenario: IPv6 ----------------------------------------------------------

def test_connect6_v4mapped_routes_native_denied():
    def scenario(m, maps):
        P = m.policy
        cache(m, maps, "93.184.216.34", "example.com")
        route(m, maps, "example.com", 443, m.model.PROTO_TCP, redirect(m))
        return [verdict(P.connect6(maps, cg, ip, 443)) for cg, ip in (
            (CG, "::ffff:93.184.216.34"), (CG, "2606:4700::1111"),
            (CG, "::1"), (999, "2606:4700::1111"))]

    got, _ = twin(scenario)
    assert [g[:2] for g in got] == [("REDIRECT", "ROUTE"), ("DENY", "IPV6"),
                                    ("ALLOW", "LOOPBACK"),
                                    ("ALLOW", "UNMANAGED")]


# -- scenario: monitor (non-enforcing) mode ----------------------------------

def test_monitor_mode_allows_but_logs():
    def scenario(m, maps):
        maps.enroll(CG, m.model.ContainerPolicy(envoy_ip=ENVOY,
                                                dns_ip=DNSGATE, flags=0))
        return verdict(m.policy.connect4(maps, CG, "203.0.113.9", 443))

    got, state = twin(scenario)
    assert got[:2] == ("ALLOW", "MONITOR")
    assert port_model.EgressEvent.unpack(
        state["events"][0]).reason is port_model.Reason.MONITOR


def test_intra_network_bypass_skips_the_gateway():
    """The sandbox bridge's siblings are reachable without rules; the
    DNS gate's and host proxy's addresses are not siblings."""
    def scenario(m, maps):
        maps.enroll(CG, m.model.ContainerPolicy(
            envoy_ip=ENVOY, dns_ip=DNSGATE, hostproxy_ip=HOSTPROXY,
            hostproxy_port=18374, flags=m.model.FLAG_ENFORCE,
            net_ip="10.99.0.0", net_prefix=24))
        return [verdict(m.policy.connect4(maps, CG, ip, 8080)) for ip in (
            "10.99.0.17", HOSTPROXY, DNSGATE, "10.98.0.17")]

    got, _ = twin(scenario)
    assert [g[:2] for g in got] == [("ALLOW", "INTRA_NET"),
                                    ("DENY", "NO_DNS_ENTRY"),
                                    ("DENY", "NO_DNS_ENTRY"),
                                    ("DENY", "NO_DNS_ENTRY")]


# -- scenario: dns cache TTL GC ----------------------------------------------

def test_dns_cache_expiry_gc():
    def scenario(m, maps):
        now = int(time.time())
        maps.cache_dns("1.2.3.4", m.model.DnsEntry(zone_hash=1,
                                                   expires_unix=now - 5))
        maps.cache_dns("5.6.7.8", m.model.DnsEntry(zone_hash=2,
                                                   expires_unix=now + 500))
        return (maps.expire_dns(), maps.lookup_dns("1.2.3.4"),
                sorted(maps.dns_entries()))

    got, _ = twin(scenario)
    assert got == (1, None, ["5.6.7.8"])


# -- route-table construction from egress rules -----------------------------

def _rules(m):
    R = m.schema.EgressRule
    return [R(dst="*.example.com", proto="https"),
            R(dst="plain.example.org", proto="http"),
            R(dst="github.com", proto="tcp", port=22),
            R(dst="ntp.example.net", proto="udp", port=123),
            R(dst="evil.example.com", action="deny"),
            R(dst="git.example.com", proto="ssh", action="deny")]


@pytest.mark.parametrize("tcp_ports", [
    {}, {"github.com:tcp:22": 10001, "plain.example.org:http:80": 10002}],
    ids=["no-lanes", "lanes"])
def test_build_routes_wildcard_and_tcp_mapping(tcp_ports):
    def run(m):
        table = m.policy.build_routes(_rules(m), envoy_ip=ENVOY,
                                      tls_port=10000, tcp_ports=tcp_ports)
        return sorted((k.pack(), v.pack()) for k, v in table.items())

    want, got = run(PKGS["ref"]), run(PKGS["port"])
    assert got == want
    table = {port_model.RouteKey.unpack(k): port_model.RouteVal.unpack(v)
             for k, v in got}
    zh, A = port_hashes.zone_hash, port_model.Action
    https = table[port_model.RouteKey(zh("example.com"), 443, 6)]
    assert https.action is A.REDIRECT and https.redirect_port == 10000
    http = table[port_model.RouteKey(zh("plain.example.org"), 80, 6)]
    assert http.action is (A.REDIRECT if tcp_ports else A.ALLOW)
    ssh = table[port_model.RouteKey(zh("github.com"), 22, 6)]
    assert ssh.redirect_port == (10001 if tcp_ports else 0)
    assert table[port_model.RouteKey(zh("ntp.example.net"), 123, 17)
                 ].action is A.ALLOW
    assert table[port_model.RouteKey(zh("evil.example.com"), 0, 6)
                 ].action is A.DENY
    assert table[port_model.RouteKey(zh("git.example.com"), 22, 6)
                 ].action is A.DENY


def test_events_ring_bounded():
    def run(m):
        fm = m.maps.FakeMaps()
        fm.enroll(CG, m.model.ContainerPolicy(envoy_ip=ENVOY, dns_ip=DNSGATE))
        for _ in range(m.maps.EVENTS_RING_MAX + 7):
            m.policy.connect4(fm, CG, "203.0.113.9", 443)
        first = [e.pack() for e in fm.drain_events(max_events=3)]
        return fm.events_dropped, first, len(fm.drain_events(10_000))

    want, got = run(PKGS["ref"]), run(PKGS["port"])
    assert got == want
    assert got[0] == 7 and got[2] == port_maps.EVENTS_RING_MAX - 3


def test_flush_all_empties_every_map():
    def scenario(m, maps):
        cache(m, maps, "93.184.216.34", "example.com")
        route(m, maps, "example.com", 443, m.model.PROTO_TCP, redirect(m))
        m.policy.connect4(maps, CG, "93.184.216.34", 443, sock_cookie=5)
        m.policy.sendmsg4(maps, CG, 6, "9.9.9.9", 53)
        maps.set_bypass(CG, int(time.time()) + 60)
        before = {k: len(v) for k, v in snap(maps).items()
                  if k not in ("dropped",)}
        maps.flush_all()
        return before

    before, state = twin(scenario)
    assert all(before.values())
    assert not any(v for k, v in state.items() if k != "dropped")


# -- ABI pins: C struct twins must match these exactly ----------------------

def test_abi_struct_sizes():
    sizes = {m: [getattr(PKGS[m].model, c).SIZE for c in (
        "ContainerPolicy", "DnsEntry", "RouteKey", "RouteVal", "UdpFlow",
        "EgressEvent")] for m in PKGS}
    assert sizes["port"] == sizes["ref"] == [28, 16, 12, 8, 8, 40]
    assert port_maps.ALL_MAPS == ref_maps.ALL_MAPS


def _records(m):
    M, zh = m.model, m.hashes.zone_hash
    return [
        M.ContainerPolicy(envoy_ip="10.0.0.2", dns_ip="10.0.0.3",
                          hostproxy_ip="172.17.0.1", hostproxy_port=18374,
                          flags=M.FLAG_ENFORCE | M.FLAG_HOSTPROXY,
                          net_ip="172.30.0.0", net_prefix=16),
        M.DnsEntry(zone_hash=zh("example.com"), expires_unix=1_700_000_123),
        M.RouteKey(zh("example.com"), 443, M.PROTO_TCP),
        M.RouteVal(M.Action.REDIRECT, redirect_ip="10.0.0.2",
                   redirect_port=10000),
        M.UdpFlow("9.9.9.9", 53),
        M.EgressEvent(ts_ns=1, cgroup_id=CG, dst_ip="1.2.3.4", dst_port=443,
                      zone_hash=zh("example.com"), verdict=M.Action.DENY,
                      proto=M.PROTO_TCP, reason=M.Reason.NO_ROUTE),
    ]


def test_abi_pack_roundtrip():
    want = [r.pack() for r in _records(PKGS["ref"])]
    recs = _records(PKGS["port"])
    assert [r.pack() for r in recs] == want
    for r, raw in zip(recs, want):
        assert type(r).unpack(raw) == r
    # the reference's bytes read back into the port's records, and back
    for r, ref_r in zip(recs, _records(PKGS["ref"])):
        assert type(ref_r).unpack(r.pack()) == ref_r


def test_address_helpers_match():
    for m in ("ref", "port"):
        M = PKGS[m].model
        assert M.be_to_ip4(M.ip4_to_be("93.184.216.34")) == "93.184.216.34"
        assert M.be_to_port(M.port_to_be(18374)) == 18374
    assert [port_model.ip4_to_be(ip) for ip in ("1.2.3.4", "10.99.0.3")] == \
        [ref_model.ip4_to_be(ip) for ip in ("1.2.3.4", "10.99.0.3")]
    assert port_model.port_to_be(443) == ref_model.port_to_be(443) == 0xBB01


def test_zone_hash_pinned_vectors():
    """Known vectors: the C fw_zone_hash must reproduce these exactly."""
    for m in PKGS.values():
        zh = m.hashes.zone_hash
        assert zh("") == 0xCBF29CE484222325
        assert zh("a") == 0xAF63DC4C8601EC8C
        assert zh("example.com") == zh("EXAMPLE.COM.")
        assert zh("example.com") != zh("example.org")
    names = ["example.com", "*.x", "api.anthropic.com", " Mixed.Case. ",
             "ünïcode.example", "a" * 300]
    assert [port_hashes.zone_hash(n) for n in names] == \
        [ref_hashes.zone_hash(n) for n in names]
