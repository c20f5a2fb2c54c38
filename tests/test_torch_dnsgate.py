"""The port's DNS gate against the reference's: the wire codec, the zone
policy, serving, the rebind guard and the ``dns_cache`` it feeds.

Twins of tests/test_dnsgate.py: each query goes to both packages'
gates, each over its own ``FakeMaps``, and the reply bytes, the cached
``DnsEntry`` records (packed), the gate's counters and, for the live
case, the bytes served over UDP and TCP are compared.  The gates
forward to a loopback fake upstream (``FakeUpstream``) through the same
``_forward`` seam the reference's cases patch; no query leaves the
host.  The cache's clock (``dnsgate.time.time``) is pinned in both
packages so the entries' expiry agrees.  The stack's
``internal_lookup``, which answers ``<name>.docker.internal`` from the
engine's inventory, is held over each package's ``FakeDriver``.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from dataclasses import asdict
from types import SimpleNamespace

import pytest

from clawker_tpu.config import schema as ref_schema
from clawker_tpu.firewall import dnsgate as ref_dnsgate
from clawker_tpu.firewall import hashes as ref_hashes
from clawker_tpu.firewall import maps as ref_maps
from clawker_tpu_torch.config import schema as port_schema
from clawker_tpu_torch.firewall import dnsgate as port_dnsgate
from clawker_tpu_torch.firewall import hashes as port_hashes
from clawker_tpu_torch.firewall import maps as port_maps

PKGS = {
    "ref": SimpleNamespace(dnsgate=ref_dnsgate, maps=ref_maps,
                           hashes=ref_hashes, schema=ref_schema),
    "port": SimpleNamespace(dnsgate=port_dnsgate, maps=port_maps,
                            hashes=port_hashes, schema=port_schema),
}
NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    for m in PKGS.values():
        monkeypatch.setattr(m.dnsgate, "time", SimpleNamespace(
            time=lambda: NOW, monotonic=time.monotonic))


def make_query(name: str, qtype: int = 1, qid: int = 0x1234) -> bytes:
    hdr = struct.pack(">HHHHHH", qid, 0x0100, 1, 0, 0, 0)
    return hdr + port_dnsgate._encode_name(name) + struct.pack(">HH", qtype, 1)


def make_answer(query: bytes, ips: list[str], ttl: int = 120) -> bytes:
    """Upstream-style response: echoed question + A records (compressed)."""
    qid = struct.unpack(">H", query[:2])[0]
    hdr = struct.pack(">HHHHHH", qid, 0x8180, 1, len(ips), 0, 0)
    body = query[12:]
    for ip in ips:
        body += struct.pack(">HHHIH", 0xC00C, 1, 1, ttl, 4) + socket.inet_aton(ip)
    return hdr + body


class FakeUpstream:
    """Local UDP resolver answering every A query from a fixed table."""

    def __init__(self, table: dict[str, list[str]], ttl: int = 120):
        outer = self

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                data, sock = self.request
                q = ref_dnsgate.parse_query(data)
                ips = outer.table.get(q.qname)
                if ips is None:
                    reply = ref_dnsgate.synthesize(q, ref_dnsgate.RCODE_NXDOMAIN)
                else:
                    reply = make_answer(data, ips, outer.ttl)
                sock.sendto(reply, self.client_address)

        self.table = table
        self.ttl = ttl
        self.srv = socketserver.ThreadingUDPServer(("127.0.0.1", 0), _H)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       kwargs={"poll_interval": 0.05},
                                       daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(2)


def _forward_to_loopback(data, resolvers, *, tcp):
    """The reference cases' ``_forward``: ``up:PORT`` names a loopback
    resolver; ``:None`` one that never answers."""
    target = resolvers[0]
    if "None" in target:
        return None
    port = int(target.split(":")[1]) if ":" in target else 53
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(2)
            s.sendto(data, ("127.0.0.1", port))
            reply, _ = s.recvfrom(4096)
            return reply
    except OSError:
        return None


def _gate(m, rules, maps, upstream_port, internal_port=None):
    """A gate on a loopback port no TCP socket held a moment before: on
    port 0 its TCP bind on the number UDP drew can be lost to another
    socket of the host (ROADMAP §3 item 16)."""
    gate = m.dnsgate.DnsGate(
        m.dnsgate.ZonePolicy.from_rules(rules), maps,
        upstreams=(f"up:{upstream_port}",),
        internal_resolver=f"int:{internal_port}", host="127.0.0.1",
        port=tcp_free_port())
    gate._forward = _forward_to_loopback  # type: ignore[method-assign]
    return gate


def tcp_free_port() -> int:
    """A loopback port no TCP socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rules(m, *dsts, **kw):
    return [m.schema.EgressRule(dst=d, **kw) for d in dsts]


def _state(gate) -> tuple:
    dns = {ip: e.pack() for ip, e in gate.maps.dns_entries().items()}
    return dns, asdict(gate.stats)


def rcode(reply: bytes) -> int:
    return struct.unpack(">H", reply[2:4])[0] & 0xF


def both(fn):
    """``fn(m)`` in the reference, then in the port; both must agree."""
    want, got = fn(PKGS["ref"]), fn(PKGS["port"])
    assert got == want
    return got


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------

def test_codec_roundtrip_and_compression():
    ans = make_answer(make_query("a.example.com"), ["1.2.3.4", "5.6.7.8"],
                      ttl=77)
    got = both(lambda m: (asdict(m.dnsgate.parse_query(
        make_query("Sub.Example.COM"))), m.dnsgate.parse_a_records(ans)))
    assert got[0]["qname"] == "sub.example.com" and got[0]["qtype"] == 1
    assert got[1] == [("1.2.3.4", 77), ("5.6.7.8", 77)]


def test_synthesize_rcodes():
    def run(m):
        D = m.dnsgate
        q = D.parse_query(make_query("x.example.com"))
        return [D.synthesize(q, rc) for rc in (
            D.RCODE_NXDOMAIN, D.RCODE_NOERROR, D.RCODE_SERVFAIL)] + [
            D.synthesize_a(q, "172.28.0.9", ttl=30)]

    nx, ok, fail, a = both(run)
    assert rcode(nx) == 3 and rcode(ok) == 0 and rcode(fail) == 2
    assert struct.unpack(">H", nx[:2])[0] == 0x1234
    assert port_dnsgate.parse_query(nx).qname == "x.example.com"
    assert port_dnsgate.parse_a_records(a) == [("172.28.0.9", 30)]


@pytest.mark.parametrize("raw", [
    b"\x00\x01", struct.pack(">HHHHHH", 1, 0, 0, 0, 0, 0),
    struct.pack(">HHHHHH", 1, 0, 1, 0, 0, 0) + b"\x05ab",
    struct.pack(">HHHHHH", 1, 0, 1, 0, 0, 0) + b"\xc0\x0c"],
    ids=["short", "no-question", "truncated-name", "compression-loop"])
def test_parse_query_rejects_garbage(raw):
    def run(m):
        with pytest.raises(m.dnsgate.DnsWireError) as e:
            m.dnsgate.parse_query(raw)
        return str(e.value)

    both(run)


def test_encode_name_refuses_bad_labels():
    def run(m):
        out = [m.dnsgate._encode_name("api.example.com.")]
        for bad in ("a..b", "x" * 64 + ".com"):
            with pytest.raises(m.dnsgate.DnsWireError):
                m.dnsgate._encode_name(bad)
        return out

    assert both(run) == [b"\x03api\x07example\x03com\x00"]


# --------------------------------------------------------------------------
# zone policy (wildcard vs exact)
# --------------------------------------------------------------------------

def _matches(m, rules, names):
    zp = m.dnsgate.ZonePolicy.from_rules(rules)
    out = []
    for n in names:
        z = zp.match(n)
        out.append(None if z is None else (asdict(z), z.hash))
    return [asdict(z) for z in zp.zones], out


def test_zone_policy_wildcard_vs_exact():
    names = ["sub.wild.example", "deep.sub.wild.example", "wild.example",
             "only.example", "sub.only.example", "unrelated.example"]
    _, got = both(lambda m: _matches(
        m, _rules(m, "*.wild.example", "only.example"), names))
    assert [g and g[0]["apex"] for g in got] == [
        "wild.example", "wild.example", "wild.example", "only.example",
        None, None]


def test_zone_policy_longest_apex_wins_and_internal():
    names = ["v1.api.example.com", "www.example.com", "host.docker.internal"]
    _, got = both(lambda m: _matches(
        m, _rules(m, "*.example.com", "*.api.example.com"), names))
    assert [g[0]["apex"] for g in got] == ["api.example.com", "example.com",
                                           "docker.internal"]
    assert got[2][0]["internal"]


def test_zone_policy_deny_carve_out_and_port_scoped_deny():
    def rules(m):
        R = m.schema.EgressRule
        return [R(dst="*.example.com"), R(dst="*.bad.example.com",
                                          action="deny"),
                R(dst="git.example.com", proto="ssh", action="deny"),
                R(dst=".lead.example")]

    names = ["x.bad.example.com", "git.example.com", "a.lead.example"]
    zones, got = both(lambda m: _matches(m, rules(m), names))
    assert got[0][0]["deny"] and got[0][0]["apex"] == "bad.example.com"
    assert got[1][0]["apex"] == "example.com" and not got[1][0]["deny"]
    assert got[2][0]["apex"] == "lead.example" and got[2][0]["wildcard"]


# --------------------------------------------------------------------------
# gate serving
# --------------------------------------------------------------------------

def test_allowed_query_relays_and_caches():
    with FakeUpstream({"api.example.com": ["93.184.216.34",
                                           "93.184.216.35"]}) as up:
        def run(m):
            gate = _gate(m, _rules(m, "*.example.com"), m.maps.FakeMaps(),
                         up.port)
            return gate.serve_packet(make_query("api.example.com")), \
                _state(gate)

        reply, (dns, stats) = both(run)
    assert [ip for ip, _ in port_dnsgate.parse_a_records(reply)] == [
        "93.184.216.34", "93.184.216.35"]
    entry = port_maps.DnsEntry.unpack(dns["93.184.216.34"])
    assert entry.zone_hash == port_hashes.zone_hash("example.com")
    assert entry.expires_unix == int(NOW) + 120
    assert stats["allowed"] == 1 and stats["cached_ips"] == 2


def test_denied_query_nxdomain_never_forwarded():
    def run(m):
        gate = _gate(m, _rules(m, "*.example.com"), m.maps.FakeMaps(), 1)
        return gate.serve_packet(make_query("evil.exfil.net")), _state(gate)

    reply, (dns, stats) = both(run)
    assert rcode(reply) == 3 and dns == {} and stats["refused"] == 1


def test_ttl_clamped_to_floor_and_ceiling():
    with FakeUpstream({"api.example.com": ["9.9.9.9"],
                       "cdn.example.com": ["9.9.9.10"]}, ttl=1) as up:
        def run(m):
            gate = _gate(m, _rules(m, "*.example.com"), m.maps.FakeMaps(),
                         up.port)
            gate.serve_packet(make_query("api.example.com"))
            up.ttl = 99_999
            gate.serve_packet(make_query("cdn.example.com"))
            up.ttl = 1
            return _state(gate)

        dns, _ = both(run)
    assert port_maps.DnsEntry.unpack(dns["9.9.9.9"]).expires_unix == \
        int(NOW) + port_dnsgate.TTL_MIN_S
    assert port_maps.DnsEntry.unpack(dns["9.9.9.10"]).expires_unix == \
        int(NOW) + port_dnsgate.TTL_MAX_S


def test_aaaa_in_allowed_zone_returns_empty_noerror():
    def run(m):
        gate = _gate(m, _rules(m, "*.example.com"), m.maps.FakeMaps(), 1)
        return gate.serve_packet(make_query("api.example.com", qtype=28)), \
            _state(gate)

    reply, (dns, _) = both(run)
    assert rcode(reply) == 0 and struct.unpack(">H", reply[6:8])[0] == 0
    assert dns == {}


def test_internal_zone_forwards_to_docker_resolver():
    with FakeUpstream({"db.docker.internal": ["172.17.0.5"]}) as internal:
        def run(m):
            gate = _gate(m, [], m.maps.FakeMaps(), 1, internal.port)
            chosen = []

            def forward(data, resolvers, *, tcp):
                chosen.append(resolvers)
                return _forward_to_loopback(data, (f"up:{internal.port}",),
                                            tcp=tcp)

            gate._forward = forward
            return gate.serve_packet(make_query("db.docker.internal")), \
                _state(gate), chosen

        reply, (dns, stats), chosen = both(run)
    assert chosen == [(f"int:{internal.port}",)]
    assert [ip for ip, _ in port_dnsgate.parse_a_records(reply)] == [
        "172.17.0.5"]
    assert "172.17.0.5" in dns and stats["internal"] == 1


def test_internal_zone_answered_from_engine_inventory():
    inventory = {"db.docker.internal": "172.28.0.9", "otel-collector":
                 "172.28.0.4"}

    def run(m):
        gate = m.dnsgate.DnsGate(
            m.dnsgate.ZonePolicy.from_rules([]), m.maps.FakeMaps(),
            upstreams=("up:1",), internal_lookup=inventory.get,
            host="127.0.0.1", port=0)
        replies = [gate.serve_packet(make_query(n, qtype=t)) for n, t in (
            ("db.docker.internal", 1), ("ghost.docker.internal", 1),
            ("db.docker.internal", 16), ("otel-collector", 1))]
        return replies, _state(gate)

    replies, (dns, stats) = both(run)
    assert [ip for ip, _ in port_dnsgate.parse_a_records(replies[0])] == [
        "172.28.0.9"]
    assert rcode(replies[1]) == 3 and rcode(replies[2]) == 0
    assert port_dnsgate.parse_a_records(replies[2]) == []
    # a single-label sibling resolves from the inventory too
    assert [ip for ip, _ in port_dnsgate.parse_a_records(replies[3])] == [
        "172.28.0.4"]
    assert sorted(dns) == ["172.28.0.4", "172.28.0.9"]
    assert stats["internal"] == 4 and stats["cached_ips"] == 2


def test_stack_internal_lookup_resolves_via_inspect(tmp_path):
    """``FirewallStack.internal_lookup``: <name>.docker.internal -> the
    container's clawker-net address via the engine API."""
    from importlib import import_module

    def run(m):
        root = m.dnsgate.__name__.split(".")[0]
        consts = import_module(f"{root}.consts")
        api = import_module(f"{root}.engine.api")
        drivers = import_module(f"{root}.engine.drivers")
        stack_mod = import_module(f"{root}.firewall.stack")
        driver = drivers.FakeDriver()
        driver.api.add_image("img:1")
        eng = driver.engine()
        eng.ensure_network(consts.NETWORK_NAME)
        ip = eng.network_static_ip(consts.NETWORK_NAME, 9)
        cid = eng.create_container("clawker.proj.db", api.ContainerSpec(
            image="img:1", network=consts.NETWORK_NAME, static_ip=ip))
        eng.start_container(cid)
        base = tmp_path / root
        stack = stack_mod.FirewallStack(eng, m.maps.FakeMaps(),
                                        conf_dir=base / "conf",
                                        pki_dir=base / "pki")
        return [ip, stack.internal_lookup("clawker.proj.db.docker.internal"),
                stack.internal_lookup("CLAWKER.proj.db.docker.internal."),
                stack.internal_lookup("clawker.proj.db"),
                stack.internal_lookup("nope.docker.internal"),
                stack.internal_lookup(".docker.internal")]

    got = both(run)
    assert got[1] == got[2] == got[3] == got[0]
    assert got[4] is None and got[5] is None


def test_upstream_down_servfail():
    def run(m):
        gate = _gate(m, _rules(m, "*.example.com"), m.maps.FakeMaps(), 1)
        gate.upstreams = ("up:None",)
        return gate.serve_packet(make_query("api.example.com")), _state(gate)

    reply, (_, stats) = both(run)
    assert rcode(reply) == 2 and stats["upstream_errors"] == 1


def _udp_query(port: int, q: bytes) -> bytes:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(3)
        s.sendto(q, ("127.0.0.1", port))
        return s.recvfrom(4096)[0]


def _tcp_query(port: int, q: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), 3) as s:
        s.settimeout(3)
        s.sendall(struct.pack(">H", len(q)) + q)
        (length,) = struct.unpack(">H", s.recv(2))
        buf = b""
        while len(buf) < length:
            buf += s.recv(length - len(buf))
        return buf


def test_live_udp_and_tcp_serving():
    with FakeUpstream({"api.example.com": ["93.184.216.34"]}) as up:
        def run(m):
            gate = _gate(m, _rules(m, "*.example.com"), m.maps.FakeMaps(),
                         up.port)
            gate.start()
            try:
                out = [_udp_query(gate.bound_port, make_query(n))
                       for n in ("api.example.com", "evil.exfil.net")]
                out.append(_tcp_query(gate.bound_port,
                                      make_query("api.example.com")))
                # a garbage datagram is dropped; the gate keeps serving
                _udp_drop(gate.bound_port)
                out.append(_udp_query(gate.bound_port,
                                      make_query("api.example.com", qid=7)))
            finally:
                gate.stop()
            return out, _state(gate), gate.bound_port != 0

        replies, (dns, stats), bound = both(run)
    assert bound
    assert [ip for ip, _ in port_dnsgate.parse_a_records(replies[0])] == [
        "93.184.216.34"]
    assert rcode(replies[1]) == 3
    assert replies[2] == replies[0]
    assert struct.unpack(">H", replies[3][:2])[0] == 7
    assert stats["queries"] == 4 and stats["refused"] == 1


def _udp_drop(port: int) -> None:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.sendto(b"\x00", ("127.0.0.1", port))


def test_start_on_a_taken_port_raises_and_releases():
    def run(m):
        first = _gate(m, [], m.maps.FakeMaps(), 1)
        first.start()
        try:
            second = m.dnsgate.DnsGate(
                m.dnsgate.ZonePolicy.from_rules([]), m.maps.FakeMaps(),
                host="127.0.0.1", port=first.bound_port)
            # the UDP bind reuses the address; the TCP server on the same
            # port is what fails, and the UDP socket is closed again
            try:
                second.start()
                second.stop()
                return "started"
            except OSError:
                return ("refused", second.bound_port, second._udp_sock)
        finally:
            first.stop()

    assert both(run) == ("refused", 0, None)


def test_policy_hot_swap():
    def run(m):
        gate = _gate(m, _rules(m, "*.example.com"), m.maps.FakeMaps(), 1)
        before = gate.policy.match("api.example.com") is not None
        gate.set_policy(m.dnsgate.ZonePolicy.from_rules(
            _rules(m, "*.other.net")))
        return before, gate.serve_packet(make_query("api.example.com"))

    before, reply = both(run)
    assert before and rcode(reply) == 3


def test_rebind_guard_refuses_private_answers():
    ips = ["127.0.0.1", "10.1.2.3", "169.254.169.254", "192.168.1.1",
           "172.16.0.9", "100.64.0.1", "0.0.0.0", "224.0.0.1",
           "93.184.216.34", "198.51.100.10", "8.8.8.8", "not-an-ip"]
    flags = both(lambda m: [m.dnsgate.is_rebind_ip(ip) for ip in ips])
    assert flags == [True] * 8 + [False] * 3 + [True]

    def run(m):
        gate = m.dnsgate.DnsGate(
            m.dnsgate.ZonePolicy.from_rules(_rules(m, "*.example.com")),
            m.maps.FakeMaps(), host="127.0.0.1", port=0)
        gate._forward = lambda data, resolvers, tcp=False: \
            m.dnsgate.synthesize_a(m.dnsgate.parse_query(data),
                                   "169.254.169.254", ttl=300)
        query = make_query("meta.example.com", qid=9)
        return gate.serve_packet(query), _state(gate)

    reply, (dns, stats) = both(run)
    assert rcode(reply) == 3 and dns == {} and stats["refused"] == 1
