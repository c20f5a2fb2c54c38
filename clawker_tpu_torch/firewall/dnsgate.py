"""DNS policy gate: the name-resolution half of kernel egress enforcement.

The port's copy of ``clawker_tpu/firewall/dnsgate.py``, whole.

The kernel rewrites every :53 flow from enrolled containers to this
server.  For a query in an allowed zone it forwards to the upstream
malware-blocking resolvers, writes each answered A record into the
``dns_cache`` map as {ip -> zone hash, ttl} -- the entry the kernel's
connect/sendmsg hooks later route on -- and relays the answer.  Docker-
internal zones forward to the embedded daemon resolver; everything else
gets NXDOMAIN without ever leaving the host.  Name-based kernel
enforcement is only possible because resolution and routing share this
one path (reference: cmd/coredns-clawker + internal/dnsbpf ServeDNS
dnsbpf.go:49 writing A records into the pinned cache; config semantics
from controlplane/firewall/coredns_config.go -- per-zone forwards,
Docker-internal zones, catch-all NXDOMAIN).

Implementation is a first-party minimal DNS codec + threaded UDP/TCP
servers (no CoreDNS, no third-party DNS lib): the gate only needs
question parsing, A-record extraction, and NXDOMAIN/SERVFAIL synthesis.

AAAA policy: allowed zones answer NOERROR/empty (the sandbox data plane
is v4-only and the kernel denies native v6 -- steering dual-stack clients
to A records); denied zones get NXDOMAIN like everything else.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from dataclasses import dataclass, field

from .. import consts, logsetup
from .hashes import zone_hash
from .maps import FirewallMaps
from .model import DnsEntry

log = logsetup.get("firewall.dnsgate")

QTYPE_A = 1
QTYPE_AAAA = 28
RCODE_NOERROR = 0
RCODE_NXDOMAIN = 3
RCODE_SERVFAIL = 2

TTL_MIN_S = 30       # floor so the kernel cache outlives immediate reuse
TTL_MAX_S = 3600
UPSTREAM_TIMEOUT_S = 2.5

# DNS-rebinding guard (dnsmasq --stop-dns-rebind / unbound
# private-address semantics): an EXTERNAL allowed zone answering with a
# local/reserved address would poison the kernel's ip->zone cache into
# allowing direct connects to loopback, the bridge, link-local metadata
# services (169.254.169.254), or RFC1918 space.  Answers carrying any
# such record are treated as hostile and refused outright -- legitimate
# public domains do not mix public and private records.  (TEST-NET
# ranges are deliberately NOT listed: they are reserved-but-unroutable,
# and the parity World uses them as its virtual internet.)
_REBIND_NETS: tuple[tuple[int, int], ...] = tuple(
    (int.from_bytes(socket.inet_aton(net), "big"),
     (0xFFFFFFFF << (32 - prefix)) & 0xFFFFFFFF)
    for net, prefix in (
        ("0.0.0.0", 8), ("10.0.0.0", 8), ("100.64.0.0", 10),
        ("127.0.0.0", 8), ("169.254.0.0", 16), ("172.16.0.0", 12),
        ("192.168.0.0", 16), ("198.18.0.0", 15), ("224.0.0.0", 3),
    )
)


def is_rebind_ip(ip: str) -> bool:
    try:
        n = int.from_bytes(socket.inet_aton(ip), "big")
    except OSError:
        return True  # unparseable rdata: never cache or relay
    return any((n & mask) == net for net, mask in _REBIND_NETS)


# --------------------------------------------------------------------------
# wire codec (only what the gate needs)
# --------------------------------------------------------------------------

class DnsWireError(Exception):
    pass


def _read_name(data: bytes, off: int, depth: int = 0) -> tuple[str, int]:
    """Decode a (possibly compressed) name; returns (name, next offset)."""
    if depth > 8:
        raise DnsWireError("compression loop")
    labels = []
    while True:
        if off >= len(data):
            raise DnsWireError("truncated name")
        n = data[off]
        if n == 0:
            return ".".join(labels), off + 1
        if n & 0xC0 == 0xC0:  # compression pointer
            if off + 1 >= len(data):
                raise DnsWireError("truncated pointer")
            ptr = ((n & 0x3F) << 8) | data[off + 1]
            name, _ = _read_name(data, ptr, depth + 1)
            labels.append(name)
            return ".".join(labels), off + 2
        off += 1
        labels.append(data[off:off + n].decode("ascii", "replace"))
        off += n


def _encode_name(name: str) -> bytes:
    out = b""
    for label in name.strip(".").split("."):
        raw = label.encode("ascii", "ignore")
        if not raw or len(raw) > 63:
            raise DnsWireError(f"bad label in {name!r}")
        out += bytes([len(raw)]) + raw
    return out + b"\x00"


@dataclass
class Question:
    qid: int
    qname: str
    qtype: int
    qclass: int
    flags: int
    raw_question: bytes  # name+type+class, verbatim (for synthesized replies)


def parse_query(data: bytes) -> Question:
    if len(data) < 12:
        raise DnsWireError("short packet")
    qid, flags, qd, _an, _ns, _ar = struct.unpack(">HHHHHH", data[:12])
    if qd < 1:
        raise DnsWireError("no question")
    qname, off = _read_name(data, 12)
    if off + 4 > len(data):
        raise DnsWireError("truncated question")
    qtype, qclass = struct.unpack(">HH", data[off:off + 4])
    return Question(qid, qname.lower().rstrip("."), qtype, qclass, flags,
                    data[12:off + 4])


def synthesize(q: Question, rcode: int) -> bytes:
    """Answerless response (NXDOMAIN / NOERROR-empty / SERVFAIL)."""
    flags = 0x8000 | 0x0400 | (q.flags & 0x0100) | rcode  # QR|AA|RD-echo
    hdr = struct.pack(">HHHHHH", q.qid, flags, 1, 0, 0, 0)
    return hdr + q.raw_question


def synthesize_a(q: Question, ip: str, ttl: int = 60) -> bytes:
    """Single-A-record answer (internal-zone resolution is answered
    directly from the engine's container inventory, never forwarded)."""
    flags = 0x8000 | 0x0400 | (q.flags & 0x0100) | RCODE_NOERROR
    hdr = struct.pack(">HHHHHH", q.qid, flags, 1, 1, 0, 0)
    # answer: pointer to qname at offset 12, A/IN, ttl, rdata
    answer = (
        struct.pack(">HHHIH", 0xC00C, QTYPE_A, 1, ttl, 4)
        + socket.inet_aton(ip)
    )
    return hdr + q.raw_question + answer


def parse_a_records(data: bytes) -> list[tuple[str, int]]:
    """(ip, ttl) for every A record in the answer section."""
    if len(data) < 12:
        return []
    _, _, qd, an, _, _ = struct.unpack(">HHHHHH", data[:12])
    off = 12
    try:
        for _ in range(qd):
            _, off = _read_name(data, off)
            off += 4
        out = []
        for _ in range(an):
            _, off = _read_name(data, off)
            if off + 10 > len(data):
                break
            rtype, _rclass, ttl, rdlen = struct.unpack(">HHIH", data[off:off + 10])
            off += 10
            rdata = data[off:off + rdlen]
            off += rdlen
            if rtype == QTYPE_A and rdlen == 4:
                out.append((socket.inet_ntoa(rdata), ttl))
        return out
    except DnsWireError:
        return []


# --------------------------------------------------------------------------
# zone policy
# --------------------------------------------------------------------------

@dataclass
class Zone:
    apex: str            # normalized, no wildcard marker
    wildcard: bool       # True: apex + any subdomain; False: exact only
    internal: bool = False  # forward to the Docker-embedded resolver
    deny: bool = False   # more-specific NXDOMAIN carve-out under an allow

    @property
    def hash(self) -> int:
        return zone_hash(self.apex)


@dataclass
class ZonePolicy:
    """Longest-apex-wins matcher over allowed + internal + deny zones.

    Wildcard/exact semantics are the reference's e2e contract
    (firewall_test.go:609/:653): ``*.example.com`` admits the apex and
    every subdomain; a bare ``example.com`` rule admits only itself.  An
    ``action: deny`` rule emits a more-specific NXDOMAIN zone that wins
    over a broader wildcard allow via the longest-apex ordering
    (firewall_test.go:653 DenySubdomainUnderWildcard)."""

    zones: list[Zone] = field(default_factory=list)

    @classmethod
    def from_rules(cls, rules, internal_zones: tuple[str, ...] = ("docker.internal",)) -> "ZonePolicy":
        zones: dict[tuple[str, bool, bool], Zone] = {}
        for rule in rules:
            dst = rule.dst.strip().lower().rstrip(".")
            if dst.startswith(".") and len(dst) > 1:
                dst = "*" + dst     # leading-dot wildcard form
            if not dst:
                continue
            wild = dst.startswith("*.")
            apex = dst[2:] if wild else dst
            deny = getattr(rule, "action", "allow") == "deny"
            if deny and (getattr(rule, "port", 0)
                         or getattr(rule, "proto", "") in ("ssh", "git")):
                # Port-scoped deny (gitguard's ssh/22 + git/9418 pins,
                # docs/git-policy.md): the kernel denies exactly that
                # port lane; the zone must keep RESOLVING so the host's
                # other lanes (the guarded https path) stay reachable.
                continue
            z = Zone(apex=apex, wildcard=wild, deny=deny)
            prev = zones.get((z.apex, z.wildcard, False))
            if prev is not None and prev.deny:
                continue            # deny sticks over a same-shape allow
            zones[(z.apex, z.wildcard, False)] = z
        for apex in internal_zones:
            z = Zone(apex=apex.strip(".").lower(), wildcard=True, internal=True)
            zones[(z.apex, z.wildcard, True)] = z
        return cls(sorted(zones.values(),
                          key=lambda z: (len(z.apex), not z.wildcard),
                          reverse=True))

    def match(self, qname: str) -> Zone | None:
        """Longest matching zone; exact beats wildcard at equal apex."""
        q = qname.strip(".").lower()
        for z in self.zones:
            if not z.wildcard:
                if q == z.apex:
                    return z
            elif q == z.apex or q.endswith("." + z.apex):
                return z
        return None


# --------------------------------------------------------------------------
# the gate server
# --------------------------------------------------------------------------

@dataclass
class GateStats:
    queries: int = 0
    allowed: int = 0
    internal: int = 0
    refused: int = 0
    upstream_errors: int = 0
    cached_ips: int = 0


class DnsGate:
    """UDP+TCP DNS server applying ZonePolicy and feeding dns_cache."""

    def __init__(
        self,
        policy: ZonePolicy,
        maps: FirewallMaps,
        *,
        upstreams: tuple[str, ...] = consts.UPSTREAM_DNS,
        internal_resolver: str | None = None,
        internal_lookup=None,   # Callable[[str], str | None]: qname -> IP
        host: str = "0.0.0.0",
        port: int = consts.DNS_PORT,
    ):
        """internal_lookup answers internal zones from the engine's
        container inventory (the gate runs host-resident, where Docker's
        embedded 127.0.0.11 resolver does not exist -- that address is
        only valid inside a container netns, reference coredns_config.go
        runs CoreDNS on the clawker network for exactly this reason).
        internal_resolver is the in-netns fallback for gates that DO run
        on the container network."""
        self._policy_lock = threading.Lock()
        self.policy = policy
        self.maps = maps
        self.upstreams = upstreams
        self.internal_resolver = internal_resolver
        self.internal_lookup = internal_lookup
        self.host, self.port = host, port
        self.bound_port = 0
        self.stats = GateStats()
        self._stats_lock = threading.Lock()
        self._udp_sock = None
        self._tcp: socketserver.ThreadingTCPServer | None = None
        self._threads: list[threading.Thread] = []
        self._stop_evt = threading.Event()
        self._pool = None  # upstream/internal worker pool (start() builds)

    def set_policy(self, policy: ZonePolicy) -> None:
        """Atomic zone swap on rule reload (no restart)."""
        with self._policy_lock:
            self.policy = policy

    # ----------------------------------------------------------- serving

    def _udp_loop(self) -> None:
        """Inline fast path + pooled slow path.

        The previous ThreadingUDPServer spawned a thread PER DATAGRAM
        (~100us before any work).  Now: parse + policy-match ONCE on the
        receive thread; queries answerable from pure memory (denied /
        unknown zones -- notably ALL deny-verdict attack traffic) reply
        inline at wire speed, while anything that may block (upstream
        forwards, internal lookups hitting the engine API) rides the
        pool so one slow resolver or daemon can never stall the deny
        path.  Per-packet failures are isolated: nothing may kill the
        sole receive thread."""
        sock = self._udp_sock
        while not self._stop_evt.is_set():
            try:
                data, addr = sock.recvfrom(8192)
            except socket.timeout:
                continue
            except OSError:
                return
            pool = self._pool
            try:
                q = parse_query(data)
            except DnsWireError:
                continue
            except Exception as e:  # noqa: BLE001 - receive thread survives
                log.error("dnsgate: parse failed: %s", e)
                continue
            try:
                zone = self._match(q)
                fast = zone is None or zone.deny
                if fast or pool is None:
                    self._answer_udp(sock, data, addr, (q, zone))
                else:
                    pool.submit(self._answer_udp, sock, data, addr, (q, zone))
            except RuntimeError:
                return  # pool torn down mid-drain: we are stopping
            except Exception as e:  # noqa: BLE001 - isolate per packet
                log.error("dnsgate: packet handling failed: %s", e)

    def _answer_udp(self, sock, data: bytes, addr, parsed) -> None:
        try:
            reply = self.serve_packet(data, _parsed=parsed)
            if reply:
                sock.sendto(reply, addr)
        except OSError:
            pass
        except Exception as e:  # noqa: BLE001 - per-request isolation,
            # like socketserver.handle_error: log and keep serving
            log.error("dnsgate: serve failed for %s: %s",
                      parsed[0].qname if parsed else "?", e)

    def start(self) -> None:
        gate = self

        class _Tcp(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    hdr = self.request.recv(2)
                    if len(hdr) < 2:
                        return
                    (length,) = struct.unpack(">H", hdr)
                    data = b""
                    while len(data) < length:
                        chunk = self.request.recv(length - len(data))
                        if not chunk:
                            return
                        data += chunk
                    reply = gate.serve_packet(data, tcp=True)
                    if reply:
                        self.request.sendall(struct.pack(">H", len(reply)) + reply)
                except OSError:
                    pass

        from concurrent.futures import ThreadPoolExecutor

        self._stop_evt.clear()
        # bind-order discipline: everything that can FAIL (UDP bind on a
        # taken port, the TCP server on the UDP-chosen ephemeral) happens
        # before anything that must be torn down on failure
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        udp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            udp.bind((self.host, self.port))
            udp.settimeout(0.1)   # shutdown poll
            self.bound_port = udp.getsockname()[1]
            socketserver.ThreadingTCPServer.allow_reuse_address = True
            self._tcp = socketserver.ThreadingTCPServer(
                (self.host, self.bound_port), _Tcp)
        except OSError:
            udp.close()
            self.bound_port = 0
            raise
        self._udp_sock = udp
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="dnsgate-fwd")
        t = threading.Thread(target=self._udp_loop, name="dnsgate-udp",
                             daemon=True)
        t.start()
        self._threads.append(t)
        # tight poll: stop() should not stall a CP drain for the default
        # 0.5s serve_forever poll interval
        t2 = threading.Thread(
            target=self._tcp.serve_forever, kwargs={"poll_interval": 0.05},
            name="dnsgate-tcp", daemon=True)
        t2.start()
        self._threads.append(t2)
        log.info("dns gate listening on %s:%d", self.host, self.bound_port)

    def stop(self) -> None:
        self._stop_evt.set()
        if self._udp_sock is not None:
            try:
                self._udp_sock.close()
            except OSError:
                pass
            self._udp_sock = None
        if self._tcp is not None:
            self._tcp.shutdown()
            self._tcp.server_close()
            self._tcp = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        for t in self._threads:
            t.join(2.0)
        self._threads.clear()

    # ------------------------------------------------------------ policy

    def _tick(self, field: str, n: int = 1) -> None:
        # += on an attribute is a non-atomic read-modify-write; counters
        # are bumped from the receive thread AND pool workers
        with self._stats_lock:
            setattr(self.stats, field, getattr(self.stats, field) + n)

    def _match(self, q: "Question") -> Zone | None:
        """Zone verdict for one parsed question (single-label fallback
        included)."""
        with self._policy_lock:
            zone = self.policy.match(q.qname)
        if zone is None and "." not in q.qname.strip(".") and (
                self.internal_lookup is not None
                or self.internal_resolver is not None):
            # Single-label names are sibling services on the sandbox
            # network, answered by the engine inventory the way Docker's
            # embedded DNS answers bare container names (reference:
            # firewall_test.go:568 resolves `otel-collector`).  Gates with
            # no internal plumbing keep the authoritative NXDOMAIN.
            zone = Zone(apex=q.qname.strip(".").lower(), wildcard=False,
                        internal=True)
        return zone

    def serve_packet(self, data: bytes, *, tcp: bool = False,
                     _parsed=None) -> bytes | None:
        """``_parsed``: (question, zone) when the receive loop already
        classified the packet -- parse + policy-match run once per
        datagram, not twice."""
        if _parsed is not None:
            q, zone = _parsed
        else:
            try:
                q = parse_query(data)
            except DnsWireError:
                return None
            zone = self._match(q)
        self._tick("queries")
        if zone is None or zone.deny:
            self._tick("refused")
            return synthesize(q, RCODE_NXDOMAIN)
        if q.qtype == QTYPE_AAAA:
            # v4-only data plane (internal zones included): empty answer
            # steers dual-stack clients to A records instead of letting
            # them dial native v6 that connect6 would deny
            self._tick("allowed")
            return synthesize(q, RCODE_NOERROR)
        if zone.internal:
            self._tick("internal")
            if self.internal_lookup is not None:
                if q.qtype != QTYPE_A:
                    # only A is answerable from the container inventory;
                    # NOERROR-empty for TXT/SRV/HTTPS etc. (never fabricate
                    # an A answer to a non-A question)
                    return synthesize(q, RCODE_NOERROR)
                ip = None
                try:
                    ip = self.internal_lookup(q.qname)
                except Exception as e:
                    log.warning("internal lookup failed for %s: %s", q.qname, e)
                if ip is None:
                    return synthesize(q, RCODE_NXDOMAIN)
                now = int(time.time())
                self.maps.cache_dns(
                    ip, DnsEntry(zone_hash=zone.hash, expires_unix=now + TTL_MIN_S))
                self._tick("cached_ips")
                return synthesize_a(q, ip, ttl=TTL_MIN_S)
            if self.internal_resolver is None:
                return synthesize(q, RCODE_SERVFAIL)
            reply = self._forward(data, (self.internal_resolver,), tcp=tcp)
            if reply is None:
                return synthesize(q, RCODE_SERVFAIL)
            self._cache_answers(reply, zone)
            return reply
        reply = self._forward(data, self.upstreams, tcp=tcp)
        if reply is None:
            self._tick("allowed")
            self._tick("upstream_errors")
            return synthesize(q, RCODE_SERVFAIL)
        records = parse_a_records(reply)
        rebound = [ip for ip, _ in records if is_rebind_ip(ip)]
        if rebound:
            # rebinding answer: refusing the whole response is the only
            # safe verdict -- relaying it would hand the client a local
            # address, caching it would open a kernel route to it
            log.warning("dns rebind refused: %s -> %s", q.qname, rebound)
            self._tick("refused")
            return synthesize(q, RCODE_NXDOMAIN)
        self._tick("allowed")
        self._cache_answers(records, zone)
        return reply

    def _cache_answers(self, records_or_reply, zone: Zone) -> None:
        records = (parse_a_records(records_or_reply)
                   if isinstance(records_or_reply, (bytes, bytearray))
                   else records_or_reply)
        now = int(time.time())
        for ip, ttl in records:
            if is_rebind_ip(ip) and not zone.internal:
                # defense in depth behind the refusal above; INTERNAL
                # zones legitimately resolve to private bridge addresses
                continue
            ttl = max(TTL_MIN_S, min(TTL_MAX_S, ttl))
            self.maps.cache_dns(ip, DnsEntry(zone_hash=zone.hash, expires_unix=now + ttl))
            self._tick("cached_ips")

    def _forward(self, data: bytes, resolvers: tuple[str, ...], *, tcp: bool) -> bytes | None:
        for resolver in resolvers:
            try:
                if tcp:
                    with socket.create_connection((resolver, 53), UPSTREAM_TIMEOUT_S) as s:
                        s.sendall(struct.pack(">H", len(data)) + data)
                        hdr = s.recv(2)
                        if len(hdr) < 2:
                            continue
                        (length,) = struct.unpack(">H", hdr)
                        buf = b""
                        while len(buf) < length:
                            chunk = s.recv(length - len(buf))
                            if not chunk:
                                break
                            buf += chunk
                        if len(buf) == length:
                            return buf
                else:
                    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                        s.settimeout(UPSTREAM_TIMEOUT_S)
                        # connect() so the kernel drops datagrams from any
                        # other source; the txn-id check below rejects
                        # same-source forgeries (dns_cache feeds a kernel
                        # enforcement map -- poisoning it is an egress hole)
                        s.connect((resolver, 53))
                        s.send(data)
                        deadline = time.monotonic() + UPSTREAM_TIMEOUT_S
                        while time.monotonic() < deadline:
                            reply = s.recv(4096)
                            if len(reply) >= 2 and reply[:2] == data[:2]:
                                return reply
                        continue
            except OSError:
                continue
        return None
