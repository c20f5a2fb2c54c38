"""The egress decision semantics: executable spec for the kernel programs.

The port's copy of ``clawker_tpu/firewall/policy.py``, whole.

Every function here mirrors one eBPF program in native/ebpf/fw.c,
operating over a ``FirewallMaps`` store.  The unit suite drives THIS code
through the reference's e2e firewall scenarios (blocked/allowed domains,
ICMP, bypass, wildcard vs exact subdomains, UDP reverse-NAT, host-proxy
reachability -- reference/test/e2e/firewall_test.go:77-709), making
it the oracle the C implementation is reviewed against -- the same
dual-guard idea the reference applies to its storage merge engine.

Decision order (same contract as the reference's decide_connect /
decide_sendmsg in bpf/common.h, re-derived):

1. cgroup not enrolled            -> ALLOW  (not ours; never interfere)
2. bypass entry present           -> ALLOW  (+ event, dead-man timed)
3. loopback dst (127/8)           -> ALLOW  (in-container services)
4. any :53                        -> dst == our DNS gate ? ALLOW
                                     : REDIRECT_DNS (hardcoded resolvers
                                       still get policy)
5. dst == Envoy                   -> ALLOW  (proxy upstream loop)
6. dst == hostproxy (flagged)     -> ALLOW  (OAuth/browser side channel)
7. dns_cache[dst_ip]              -> miss: DENY (ip-literal egress;
                                     fail-closed default-deny)
8. routes[zone,port,proto] then
   routes[zone,0,proto]           -> ALLOW | DENY | REDIRECT (Envoy)
9. no route                       -> DENY (zone resolved but proto/port
                                     not allowed); monitor-mode containers
                                     (no FLAG_ENFORCE) ALLOW + event
"""

from __future__ import annotations

import time

from .maps import FirewallMaps
from .model import (
    FLAG_ENFORCE,
    FLAG_HOSTPROXY,
    PROTO_TCP,
    PROTO_UDP,
    Action,
    DnsEntry,
    EgressEvent,
    Reason,
    RouteKey,
    RouteVal,
    UdpFlow,
    Verdict,
)

# socket types for sock_create (linux/net.h values)
SOCK_STREAM = 1
SOCK_DGRAM = 2
SOCK_RAW = 3
SOCK_PACKET = 10


def _event(maps: FirewallMaps, cgroup_id: int, dst_ip: str, dst_port: int,
           proto: int, v: Verdict) -> None:
    maps.emit_event(EgressEvent(
        ts_ns=time.monotonic_ns(), cgroup_id=cgroup_id, dst_ip=dst_ip,
        dst_port=dst_port, zone_hash=v.zone_hash, verdict=v.action,
        proto=proto, reason=v.reason,
    ))


def decide(maps: FirewallMaps, cgroup_id: int, dst_ip: str, dst_port: int,
           proto: int) -> Verdict:
    """Core verdict shared by connect4 and sendmsg4 (fw.c fw_decide)."""
    pol = maps.lookup_container(cgroup_id)
    if pol is None:
        return Verdict(Action.ALLOW, Reason.UNMANAGED)

    if maps.bypassed(cgroup_id):
        v = Verdict(Action.ALLOW, Reason.BYPASS)
        _event(maps, cgroup_id, dst_ip, dst_port, proto, v)
        return v

    if dst_ip.startswith("127."):
        return Verdict(Action.ALLOW, Reason.LOOPBACK)

    if dst_port == 53:
        if dst_ip == pol.dns_ip:
            return Verdict(Action.ALLOW, Reason.DNS)
        v = Verdict(Action.REDIRECT_DNS, Reason.DNS,
                    redirect_ip=pol.dns_ip, redirect_port=53)
        _event(maps, cgroup_id, dst_ip, dst_port, proto, v)
        return v

    if dst_ip == pol.envoy_ip:
        return Verdict(Action.ALLOW, Reason.ENVOY)

    if (pol.flags & FLAG_HOSTPROXY and dst_ip == pol.hostproxy_ip
            and dst_port == pol.hostproxy_port):
        return Verdict(Action.ALLOW, Reason.HOSTPROXY)

    if (pol.net_prefix and dst_ip not in (pol.dns_ip, pol.hostproxy_ip)
            and _in_cidr(dst_ip, pol.net_ip, pol.net_prefix)):
        # intra-network bypass: sibling services on the sandbox bridge
        # (CP, otel-collector, project listeners) are reachable without
        # rules -- the network is clawker-managed (reference e2e:
        # firewall_test.go:398 IntraNetworkBypass).  The gateway (= the
        # host, where the gate/hostproxy live) is NOT a sibling: non-proxy
        # host ports stay blocked (firewall_test.go:497).
        return Verdict(Action.ALLOW, Reason.INTRA_NET)

    dns = maps.lookup_dns(dst_ip)
    if dns is None:
        v = _no_route(pol, Reason.NO_DNS_ENTRY)
        _event(maps, cgroup_id, dst_ip, dst_port, proto, v)
        return v

    route = maps.lookup_route(RouteKey(dns.zone_hash, dst_port, proto))
    if route is None:
        route = maps.lookup_route(RouteKey(dns.zone_hash, 0, proto))
    if route is None:
        v = _no_route(pol, Reason.NO_ROUTE, zone=dns.zone_hash)
        _event(maps, cgroup_id, dst_ip, dst_port, proto, v)
        return v

    v = Verdict(route.action, Reason.ROUTE, redirect_ip=route.redirect_ip,
                redirect_port=route.redirect_port, zone_hash=dns.zone_hash)
    _event(maps, cgroup_id, dst_ip, dst_port, proto, v)
    return v


def _in_cidr(ip: str, net: str, prefix: int) -> bool:
    """ip within net/prefix (v4)."""
    import socket as _s
    import struct as _struct

    if not 0 < prefix <= 32:
        return False
    mask = (0xFFFFFFFF << (32 - prefix)) & 0xFFFFFFFF
    try:
        ip_n = _struct.unpack(">I", _s.inet_aton(ip))[0]
        net_n = _struct.unpack(">I", _s.inet_aton(net))[0]
    except OSError:
        return False
    return (ip_n & mask) == (net_n & mask)


def _no_route(pol, reason: Reason, zone: int = 0) -> Verdict:
    if pol.flags & FLAG_ENFORCE:
        return Verdict(Action.DENY, reason, zone_hash=zone)
    return Verdict(Action.ALLOW, Reason.MONITOR, zone_hash=zone)


# --------------------------------------------------------------------------
# per-hook entry points (one per C program)
# --------------------------------------------------------------------------

def connect4(maps: FirewallMaps, cgroup_id: int, dst_ip: str, dst_port: int,
             proto: int = PROTO_TCP, sock_cookie: int = 0) -> Verdict:
    """cgroup/connect4 twin.  REDIRECT verdicts mean the kernel rewrote
    the sockaddr before the connect proceeded; the original destination
    is recorded (TCP and UDP in separate LRUs) so getpeername4 can
    reverse it."""
    v = decide(maps, cgroup_id, dst_ip, dst_port, proto)
    if sock_cookie and v.action in (Action.REDIRECT, Action.REDIRECT_DNS):
        flow = UdpFlow(orig_ip=dst_ip, orig_port=dst_port)
        if proto == PROTO_UDP:
            maps.record_udp_flow(sock_cookie, flow)
        else:
            maps.record_tcp_flow(sock_cookie, flow)
    return v


def sendmsg4(maps: FirewallMaps, cgroup_id: int, sock_cookie: int,
             dst_ip: str, dst_port: int) -> Verdict:
    """cgroup/sendmsg4 twin (unconnected UDP).  On redirect, the original
    destination is recorded by socket cookie so recvmsg4 can reverse-NAT
    the reply's source address."""
    v = decide(maps, cgroup_id, dst_ip, dst_port, PROTO_UDP)
    if v.action in (Action.REDIRECT, Action.REDIRECT_DNS):
        maps.record_udp_flow(sock_cookie, UdpFlow(orig_ip=dst_ip, orig_port=dst_port))
    return v


def recvmsg4(maps: FirewallMaps, cgroup_id: int, sock_cookie: int,
             src_ip: str, src_port: int) -> tuple[str, int]:
    """cgroup/recvmsg4 twin: returns the (possibly rewritten) source the
    app observes.  A reply from the redirect target is rewritten back to
    the destination the app originally sent to."""
    pol = maps.lookup_container(cgroup_id)
    if pol is None:
        return src_ip, src_port
    flow = maps.lookup_udp_flow(sock_cookie)
    if flow is not None and src_ip in (pol.dns_ip, pol.envoy_ip):
        return flow.orig_ip, flow.orig_port
    return src_ip, src_port


def getpeername4(maps: FirewallMaps, cgroup_id: int, sock_cookie: int,
                 peer_ip: str, peer_port: int) -> tuple[str, int]:
    """cgroup/getpeername4 twin: connected sockets (TCP or UDP) report
    the destination the app aimed at, not the rewrite target."""
    pol = maps.lookup_container(cgroup_id)
    if pol is None:
        return peer_ip, peer_port
    flow = maps.lookup_udp_flow(sock_cookie) or maps.lookup_tcp_flow(sock_cookie)
    if flow is not None and peer_ip in (pol.dns_ip, pol.envoy_ip):
        return flow.orig_ip, flow.orig_port
    return peer_ip, peer_port


def connect6(maps: FirewallMaps, cgroup_id: int, dst_ip6: str, dst_port: int,
             proto: int = PROTO_TCP) -> Verdict:
    """cgroup/connect6 twin: IPv4-mapped addresses route through the v4
    decision; native IPv6 is denied for enrolled cgroups (the sandbox
    network is v4-only, so v6 would be an enforcement hole)."""
    pol = maps.lookup_container(cgroup_id)
    if pol is None:
        return Verdict(Action.ALLOW, Reason.UNMANAGED)
    if maps.bypassed(cgroup_id):
        # break-glass must open v6 too, matching decide()'s bypass step
        v = Verdict(Action.ALLOW, Reason.BYPASS)
        _event(maps, cgroup_id, "0.0.0.0", dst_port, proto, v)
        return v
    low = dst_ip6.lower()
    if low.startswith("::ffff:"):
        return decide(maps, cgroup_id, dst_ip6[7:], dst_port, proto)
    if low in ("::1",):
        return Verdict(Action.ALLOW, Reason.LOOPBACK)
    v = Verdict(Action.DENY, Reason.IPV6)
    _event(maps, cgroup_id, "0.0.0.0", dst_port, proto, v)
    return v


def sock_create(maps: FirewallMaps, cgroup_id: int, family: int,
                sock_type: int) -> Verdict:
    """cgroup/sock_create twin: SOCK_RAW / SOCK_PACKET are denied for
    enrolled cgroups -- blocks ICMP (ping exfil) and packet crafting
    (reference e2e: firewall_test.go:103 ICMP scenario)."""
    if maps.lookup_container(cgroup_id) is None:
        return Verdict(Action.ALLOW, Reason.UNMANAGED)
    if maps.bypassed(cgroup_id):
        return Verdict(Action.ALLOW, Reason.BYPASS)
    if sock_type in (SOCK_RAW, SOCK_PACKET):
        v = Verdict(Action.DENY, Reason.RAW_SOCKET)
        _event(maps, cgroup_id, "0.0.0.0", 0, 0, v)
        return v
    return Verdict(Action.ALLOW, Reason.UNMANAGED)


# --------------------------------------------------------------------------
# route-table construction (userspace only; consumed by sync_routes)
# --------------------------------------------------------------------------

def build_routes(rules, *, envoy_ip: str, tls_port: int,
                 tcp_ports: dict[str, int] | None = None) -> dict[RouteKey, RouteVal]:
    """Egress rules -> global route table.

    https rules redirect to the Envoy TLS/SNI listener (MITM or
    passthrough decided by Envoy config, not the kernel); http and tcp
    rules redirect to their allocated sequential Envoy listener; udp
    rules allow directly (no proxy lane for arbitrary UDP).

    ``tcp_ports`` maps rule.key() -> allocated Envoy listener port
    (EnvoyBundle.tcp_ports) so kernel and proxy agree.
    """
    from .hashes import zone_hash

    table: dict[RouteKey, RouteVal] = {}
    tcp_ports = tcp_ports or {}
    # allow rules first so a domain-level deny sharing a zone wins
    ordered = sorted(rules, key=lambda r: getattr(r, "action", "allow") == "deny")
    for rule in ordered:
        apex = rule.dst[2:] if rule.dst.startswith("*.") else rule.dst
        zh = zone_hash(apex)
        port = rule.effective_port()
        if getattr(rule, "action", "allow") == "deny":
            if rule.port or rule.proto in ("ssh", "git"):
                # Port-scoped deny (gitguard's ssh/22 + git/9418 pins,
                # docs/git-policy.md): deny exactly this port lane --
                # written AFTER allows, so it beats a same-key allow --
                # while the zone's other lanes (the guarded https path)
                # stay live and the DNS gate keeps resolving the host.
                table[RouteKey(zh, port, PROTO_TCP)] = RouteVal(Action.DENY)
                if rule.proto == "udp":
                    table[RouteKey(zh, port, PROTO_UDP)] = RouteVal(
                        Action.DENY)
                continue
            # Defense in depth behind the DNS-gate NXDOMAIN: even a stale
            # dns_cache entry for the denied zone denies on every port.
            table[RouteKey(zh, 0, PROTO_TCP)] = RouteVal(Action.DENY)
            table[RouteKey(zh, 0, PROTO_UDP)] = RouteVal(Action.DENY)
            continue
        if rule.proto == "https":
            table[RouteKey(zh, port, PROTO_TCP)] = RouteVal(
                Action.REDIRECT, redirect_ip=envoy_ip, redirect_port=tls_port)
        elif rule.proto == "http":
            lport = tcp_ports.get(rule.key())
            if lport:
                table[RouteKey(zh, port, PROTO_TCP)] = RouteVal(
                    Action.REDIRECT, redirect_ip=envoy_ip, redirect_port=lport)
            else:  # no HTTP lane allocated: direct allow (never the TLS
                # listener -- tls_inspector can't parse cleartext)
                table[RouteKey(zh, port, PROTO_TCP)] = RouteVal(Action.ALLOW)
        elif rule.proto == "udp":
            table[RouteKey(zh, port, PROTO_UDP)] = RouteVal(Action.ALLOW)
        else:
            # TCP-mapped named protocols (tcp, ssh, git, ...) ride their
            # allocated sequential Envoy listener (firewall_test.go:503).
            lport = tcp_ports.get(rule.key())
            if lport:
                table[RouteKey(zh, port, PROTO_TCP)] = RouteVal(
                    Action.REDIRECT, redirect_ip=envoy_ip, redirect_port=lport)
            else:  # no proxy lane allocated: direct allow, still DNS-gated
                table[RouteKey(zh, port, PROTO_TCP)] = RouteVal(Action.ALLOW)
    return table
