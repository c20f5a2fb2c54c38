"""A virtual internet for socket-level firewall parity runs.

Wires every enforcement surface the production stack uses -- FakeMaps
with kernel semantics, the policy oracle as the kernel twin, the REAL
DnsGate serving a REAL UDP socket, and the generated Envoy bootstrap
*executed* by EnvoySim -- around a set of real localhost origin servers
(benign upstreams, the attacker capture server, the host proxy).  A
scenario's curl/dig analogues cross actual sockets end to end; the only
fakes are the kernel hook (the policy oracle, differentially tested
against the C in tests/test_fw_kernel.py) and world DNS/IP space.

Topology (mirrors the clawker-net static-IP layout, SURVEY.md 2.8):
  DNS gate   10.99.0.1:53   (real listener on 127.0.0.1:<ephemeral>)
  Envoy      10.99.0.2      (EnvoySim listeners, port_map translated)
  host proxy 10.99.0.1:18374 (real HostProxy)
  origins    198.51.100.0/24 (TEST-NET-2: benign upstream servers)
  attacker   203.0.113.0/24  (TEST-NET-3: capture server endpoints)

The port's copy of ``clawker_tpu/parity/world.py``, whole.
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import urllib.parse
from dataclasses import dataclass
from pathlib import Path

from ..config.schema import EgressRule
from ..firewall import pki, policy as policy_mod
from ..firewall.dnsgate import DnsGate, ZonePolicy, parse_a_records, parse_query
from ..firewall.envoy import generate_envoy_config
from ..firewall.maps import FakeMaps
from ..firewall.model import (
    FLAG_ENFORCE,
    FLAG_HOSTPROXY,
    PROTO_TCP,
    PROTO_UDP,
    Action,
    ContainerPolicy,
    Reason,
)
from .attacker import AttackerServer, CaptureStore
from .envoysim import EnvoySim, read_http_request

CG_AGENT = 0xA6E27  # the sandboxed agent's cgroup id in the world
DNS_IP = "10.99.0.1"
ENVOY_IP = "10.99.0.2"
HOSTPROXY_IP = "10.99.0.1"
HOSTPROXY_PORT = 18374


class EgressBlocked(Exception):
    """The kernel twin denied the flow before any bytes left."""

    def __init__(self, reason: Reason):
        super().__init__(f"egress denied: {reason.name}")
        self.reason = reason


@dataclass
class CurlResult:
    code: int = 0            # HTTP status; 0 on transport failure
    body: bytes = b""
    err: str = ""            # curl-style failure class, "" on success

    @property
    def ok(self) -> bool:
        return self.err == "" and 200 <= self.code < 400


class OriginServer:
    """One benign upstream host: plain HTTP + TLS on ephemerals, plus an
    optional raw-TCP banner port (the ssh-keyscan scenario)."""

    def __init__(self, domains: list[str], ca: pki.CA, tmp: Path, *,
                 banner: bytes = b""):
        self.domains = domains
        self.requests: list[tuple[str, str]] = []  # (host, path)
        self._lock = threading.Lock()
        pair = pki._issue(ca, domains[0], dns_names=domains, server=True)
        self.cert_file = tmp / f"{domains[0].replace('*', 'w')}.crt"
        self.key_file = tmp / f"{domains[0].replace('*', 'w')}.key"
        self.cert_file.write_bytes(pair.cert_pem)
        self.key_file.write_bytes(pair.key_pem)
        self.banner = banner
        self.http_port = 0
        self.tls_port = 0
        self.banner_port = 0
        self._servers: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    def start(self) -> None:
        self.http_port = self._listen(self._serve_http, tls=False)
        self.tls_port = self._listen(self._serve_http, tls=True)
        if self.banner:
            self.banner_port = self._listen(self._serve_banner, tls=False)

    def _listen(self, handler, *, tls: bool) -> int:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(16)
        # finite accept timeout so stop() joins promptly (close() alone
        # does not wake a thread blocked in accept())
        srv.settimeout(0.2)
        self._servers.append(srv)

        def loop():
            ctx = None
            if tls:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(str(self.cert_file), str(self.key_file))
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                threading.Thread(target=self._wrap, args=(conn, handler, ctx),
                                 daemon=True).start()

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)
        return srv.getsockname()[1]

    def _wrap(self, conn: socket.socket, handler, ctx) -> None:
        try:
            conn.settimeout(5.0)
            if ctx is not None:
                conn = ctx.wrap_socket(conn, server_side=True)
            handler(conn)
        except (OSError, ssl.SSLError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_http(self, conn) -> None:
        rfile = conn.makefile("rb")
        req = read_http_request(rfile)
        if req is None:
            return
        with self._lock:
            self.requests.append((req.host, req.target))
        body = b"origin ok: " + req.target.encode()
        conn.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n"
                     b"connection: close\r\n\r\n%s" % (len(body), body))

    def _serve_banner(self, conn) -> None:
        conn.sendall(self.banner)
        with self._lock:
            self.requests.append(("<banner>", ""))

    def stop(self) -> None:
        self._stop.set()
        for srv in self._servers:
            try:
                srv.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(1.0)


class World:
    """The assembled virtual internet + sandbox enforcement stack."""

    def __init__(self, rules: list[EgressRule], tmp: Path, *,
                 enforce: bool = True, hostproxy: bool = True,
                 enrolled: bool = True,
                 intra_net: tuple[str, int] | None = None,
                 captures: CaptureStore | None = None):
        tmp.mkdir(parents=True, exist_ok=True)
        self.tmp = tmp
        self.rules = rules
        self.maps = FakeMaps()
        self.dns_table: dict[str, str] = {}          # domain -> virtual IP
        self.endpoints: dict[tuple[str, int], tuple[str, int]] = {}
        self.attacker_zones: set[str] = set()
        self.upstream_queries: list[str] = []        # what internet DNS saw
        self.origins: dict[str, OriginServer] = {}
        self._next_origin_ip = 10
        self._next_attacker_ip = 10

        # two trust roots: the firewall CA (MITM) and the "internet" CA
        self.fw_ca = pki.ensure_ca(tmp / "fw-pki")
        self.net_ca = pki.generate_ca("parity world internet CA")
        self.ca_bundle = tmp / "ca-bundle.pem"
        self.ca_bundle.write_bytes(self.fw_ca.cert_pem + self.net_ca.cert_pem)

        # attacker infrastructure (TLS cert from its own junk CA)
        atk_ca = pki.generate_ca("attacker CA")
        atk_pair = pki._issue(atk_ca, "attacker.test",
                              dns_names=["attacker.test", "*.attacker.test"],
                              server=True)
        (tmp / "atk.crt").write_bytes(atk_pair.cert_pem)
        (tmp / "atk.key").write_bytes(atk_pair.key_pem)
        self.attacker = AttackerServer(
            captures or CaptureStore(),
            tls_cert=str(tmp / "atk.crt"), tls_key=str(tmp / "atk.key"))
        self.attacker.start()
        self.add_attacker_host("attacker.test")

        # enforcement surfaces.  enrolled=False models `firewall.enable:
        # false` -- the cgroup is never enrolled, every verdict is
        # UNMANAGED ALLOW (reference e2e FirewallDisabled).
        if enrolled:
            flags = (FLAG_ENFORCE if enforce else 0) | (FLAG_HOSTPROXY if hostproxy else 0)
            net_ip, net_prefix = intra_net or ("0.0.0.0", 0)
            self.maps.enroll(CG_AGENT, ContainerPolicy(
                envoy_ip=ENVOY_IP, dns_ip=DNS_IP,
                hostproxy_ip=HOSTPROXY_IP, hostproxy_port=HOSTPROXY_PORT,
                flags=flags, net_ip=net_ip, net_prefix=net_prefix))
        self.bundle = generate_envoy_config(rules, cert_dir=str(tmp / "mitm"))
        (tmp / "mitm").mkdir(exist_ok=True)
        self._write_mitm_certs()
        self.maps.sync_routes(policy_mod.build_routes(
            rules, envoy_ip=ENVOY_IP, tls_port=10000,
            tcp_ports=self.bundle.tcp_ports))

        self.gate = DnsGate(ZonePolicy.from_rules(rules), self.maps,
                            host="127.0.0.1", port=0,
                            internal_lookup=self._internal_lookup)
        self.gate._forward = self._world_dns_forward  # upstream = this world
        self.gate.start()

        self.envoy = EnvoySim(self.bundle.config_yaml, self._resolve,
                              upstream_ca=str(self.ca_bundle))
        self.envoy.start()

        self.hostproxy = None
        if hostproxy:
            from ..hostproxy.server import HostProxy

            class _ProxyCfg:  # the proxy only reads egress_rules()
                def __init__(self, r):
                    self._r = r

                def egress_rules(self):
                    return self._r

            self.hostproxy = HostProxy(
                _ProxyCfg(rules), host="127.0.0.1", port=0,
                open_browser=lambda url: True,
                git_fill=lambda req: "")
            self.hostproxy.start()

        self._cookie_lock = threading.Lock()
        self._cookie = 0
        self.internal_hosts: dict[str, str] = {}     # docker.internal names

    # ---------------------------------------------------------- inventory

    def add_origin(self, domains: list[str], *, banner: bytes = b"",
                   extra_ports: dict[int, str] = {}) -> OriginServer:
        """Create a benign origin for ``domains``; all map to one virtual
        IP with HTTP:80 / TLS:443 (+ banner port, e.g. 22)."""
        origin = OriginServer(domains, self.net_ca, self.tmp, banner=banner)
        origin.start()
        vip = f"198.51.100.{self._next_origin_ip}"
        self._next_origin_ip += 1
        for d in domains:
            self.dns_table[d.lower()] = vip
            self.origins[d.lower()] = origin
        self.endpoints[(vip, 80)] = ("127.0.0.1", origin.http_port)
        self.endpoints[(vip, 443)] = ("127.0.0.1", origin.tls_port)
        if banner:
            for port in (extra_ports or {22: "banner"}):
                self.endpoints[(vip, port)] = ("127.0.0.1", origin.banner_port)
        return origin

    def add_attacker_host(self, domain: str) -> str:
        """Register an attacker-controlled name; returns its virtual IP."""
        vip = f"203.0.113.{self._next_attacker_ip}"
        self._next_attacker_ip += 1
        self.dns_table[domain.lower()] = vip
        self.attacker_zones.add(domain.lower())
        self.endpoints[(vip, 443)] = ("127.0.0.1", self.attacker.tls_port)
        self.endpoints[(vip, 80)] = ("127.0.0.1", self.attacker.http_port)
        for port in (4444, 8443, 9001, 53):
            self.endpoints[(vip, port)] = ("127.0.0.1", self.attacker.tcp_port)
        self.attacker_udp = ("127.0.0.1", self.attacker.udp_port)
        return vip

    def add_internal_host(self, name: str, vip: str,
                          real: tuple[str, int] | None = None,
                          port: int = 80) -> None:
        """docker.internal-zone name answered from the engine inventory."""
        self.internal_hosts[name.lower().rstrip(".")] = vip
        if real is not None:
            self.endpoints[(vip, port)] = real

    def _internal_lookup(self, qname: str) -> str | None:
        return self.internal_hosts.get(qname.lower().rstrip("."))

    def _write_mitm_certs(self) -> None:
        for apex in self.bundle.mitm_domains:
            pair = pki.generate_domain_cert(self.fw_ca, f"*.{apex}")
            (self.tmp / "mitm" / f"{apex}.crt").write_bytes(pair.cert_pem)
            (self.tmp / "mitm" / f"{apex}.key").write_bytes(pair.key_pem)

    # ------------------------------------------------------------- wiring

    def _resolve(self, host: str, port: int) -> tuple[str, int] | None:
        """LOGICAL_DNS / DFP resolution as the proxy sees the world."""
        vip = self.dns_table.get(host.lower().rstrip("."))
        if vip is None:
            return None
        return self.endpoints.get((vip, port))

    def _record_upstream(self, qname: str) -> str:
        """A query escaped to 'internet DNS': log it, and report attacker
        zones to the capture DB (DNS-label exfil is observable traffic)."""
        qname = qname.lower().rstrip(".")
        self.upstream_queries.append(qname)
        for zone in self.attacker_zones:
            if qname == zone or qname.endswith("." + zone):
                self.attacker.record_dns(qname)
                break
        return qname

    def _world_dns_forward(self, data: bytes, resolvers, *, tcp: bool):
        """Upstream resolver stand-in: answers from the world DNS table,
        records every query the gate let out."""
        try:
            q = parse_query(data)
        except Exception:
            return None
        self._record_upstream(q.qname)
        ip = self.dns_table.get(q.qname)
        if ip is None:
            # upstream: NXDOMAIN-shaped reply
            flags = 0x8180 | 3
            return struct.pack(">HHHHHH", q.qid, flags, 1, 0, 0, 0) + q.raw_question
        flags = 0x8180
        hdr = struct.pack(">HHHHHH", q.qid, flags, 1, 1, 0, 0)
        answer = (struct.pack(">HHHIH", 0xC00C, 1, 1, 120, 4)
                  + socket.inet_aton(ip))
        return hdr + q.raw_question + answer

    # ------------------------------------------------------- kernel twin

    def cookie(self) -> int:
        with self._cookie_lock:
            self._cookie += 1
            return self._cookie

    def open_tcp(self, ip: str, port: int, *,
                 technique: str = "") -> socket.socket:
        """connect() through the kernel twin; returns a REAL socket to
        wherever the verdict steers the flow."""
        if technique:
            self.attacker.set_technique(technique)
        v = policy_mod.connect4(self.maps, CG_AGENT, ip, port, PROTO_TCP,
                                sock_cookie=self.cookie())
        if v.action is Action.DENY:
            raise EgressBlocked(v.reason)
        if v.action in (Action.REDIRECT, Action.REDIRECT_DNS):
            if v.action is Action.REDIRECT_DNS:
                target = ("127.0.0.1", self.gate.bound_port)
            else:
                bound = self.envoy.port_map.get(v.redirect_port)
                if bound is None:
                    raise ConnectionRefusedError(
                        f"no proxy listener at {v.redirect_port}")
                target = ("127.0.0.1", bound)
            return socket.create_connection(target, timeout=5.0)
        # ALLOW: direct to the destination the world knows
        if ip.startswith("127."):
            return socket.create_connection((ip, port), timeout=5.0)
        if ip == ENVOY_IP and port in self.envoy.port_map:
            # dialing the proxy chokepoint directly: the kernel allows it
            # (Envoy's SNI default-deny is the enforcement surface there)
            return socket.create_connection(
                ("127.0.0.1", self.envoy.port_map[port]), timeout=5.0)
        if ip == HOSTPROXY_IP and port == HOSTPROXY_PORT and self.hostproxy:
            return socket.create_connection(
                ("127.0.0.1", self.hostproxy.bound_port), timeout=5.0)
        real = self.endpoints.get((ip, port))
        if real is None:
            raise ConnectionRefusedError(f"unreachable {ip}:{port}")
        return socket.create_connection(real, timeout=5.0)

    def send_udp(self, ip: str, port: int, payload: bytes, *,
                 technique: str = "") -> None:
        if technique:
            self.attacker.set_technique(technique)
        cookie = self.cookie()
        v = policy_mod.sendmsg4(self.maps, CG_AGENT, cookie, ip, port)
        if v.action is Action.DENY:
            raise EgressBlocked(v.reason)
        if v.action is Action.REDIRECT_DNS:
            target = ("127.0.0.1", self.gate.bound_port)
        elif v.action is Action.REDIRECT:
            target = ("127.0.0.1",
                      self.envoy.port_map.get(v.redirect_port, 1))
        elif (ip, port) == (DNS_IP, 53):
            # explicitly resolver-directed traffic lands on the real gate
            target = ("127.0.0.1", self.gate.bound_port)
        elif ip in {self.dns_table.get(z) for z in self.attacker_zones}:
            # ANY port on attacker infrastructure captures: an allowed
            # datagram that reaches the attacker's address is an escape
            # regardless of which port the C2 listens on.
            target = self.attacker_udp
        elif port == 53:
            # allowed direct :53 to a non-gate resolver = the query
            # reached "internet DNS" unfiltered; the upstream resolver
            # stand-in sees (and, for attacker zones, captures) it.
            self._world_dns_forward(payload, (), tcp=False)
            return
        else:
            target = self.endpoints.get((ip, port))
            if target is None:
                return  # datagram into the void
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(payload, target)

    def raw_socket_verdict(self):
        return policy_mod.sock_create(self.maps, CG_AGENT, 2,
                                      policy_mod.SOCK_RAW)

    # --------------------------------------------------------- resolvers

    def dig(self, name: str, qtype: int = 1) -> tuple[int, list[str]]:
        """dig through the kernel twin + the REAL gate socket.

        An ALLOW verdict (bypass / unenrolled cgroup) means the kernel
        did NOT rewrite the resolver address: the query reaches upstream
        "internet DNS" (the world table) directly, exactly as a bypassed
        container's queries flow to its configured resolver."""
        v = policy_mod.sendmsg4(self.maps, CG_AGENT, self.cookie(),
                                "8.8.8.8", 53)
        if v.action is Action.DENY:
            return -1, []
        if v.action is Action.ALLOW:
            # un-gated resolution: the query reaches upstream internet DNS
            # directly (and attacker zones observe it)
            qname = self._record_upstream(name)
            ip = self.dns_table.get(qname)
            return (0, [ip]) if ip else (3, [])
        from ..firewall.dnsgate import _encode_name
        hdr = struct.pack(">HHHHHH", 0x2222, 0x0100, 1, 0, 0, 0)
        query = hdr + _encode_name(name) + struct.pack(">HH", qtype, 1)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(5.0)
            s.sendto(query, ("127.0.0.1", self.gate.bound_port))
            try:
                reply = s.recv(4096)
            except socket.timeout:
                return -1, []
        rcode = struct.unpack(">H", reply[2:4])[0] & 0xF
        return rcode, [ip for ip, _ in parse_a_records(reply)]

    # -------------------------------------------------------------- curl

    def curl(self, url: str, *, method: str = "GET",
             headers: dict[str, str] | None = None, body: bytes = b"",
             follow: bool = True, max_redirects: int = 5,
             technique: str = "", insecure: bool = False) -> CurlResult:
        """curl analogue: resolve via the gate, connect via the kernel
        twin, TLS against the world trust bundle, follow redirects."""
        for _ in range(max_redirects + 1):
            u = urllib.parse.urlsplit(url)
            host = u.hostname or ""
            port = u.port or (443 if u.scheme == "https" else 80)
            path = (u.path or "/") + (f"?{u.query}" if u.query else "")
            try:  # IP-literal target: no resolver step (curl semantics)
                socket.inet_aton(host)
                ips = [host]
            except OSError:
                rcode, ips = self.dig(host)
                if rcode != 0 or not ips:
                    return CurlResult(err=f"could not resolve host: {host}")
            try:
                sock = self.open_tcp(ips[0], port, technique=technique)
            except EgressBlocked as e:
                return CurlResult(err=f"connection blocked: {e.reason.name}")
            except OSError as e:
                return CurlResult(err=f"connect failed: {e}")
            try:
                if u.scheme == "https":
                    ctx = ssl.create_default_context(
                        cafile=str(self.ca_bundle))
                    if insecure:
                        ctx.check_hostname = False
                        ctx.verify_mode = ssl.CERT_NONE
                    try:
                        sock = ctx.wrap_socket(sock, server_hostname=host)
                    except (ssl.SSLError, OSError) as e:
                        return CurlResult(err=f"tls failed: {e.__class__.__name__}")
                head = f"{method} {path} HTTP/1.1\r\nhost: {host}\r\n"
                for k, v in (headers or {}).items():
                    head += f"{k}: {v}\r\n"
                if body:
                    head += f"content-length: {len(body)}\r\n"
                head += "connection: close\r\n\r\n"
                try:
                    sock.sendall(head.encode("latin-1") + body)
                    raw = b""
                    while len(raw) < 1 << 22:
                        chunk = sock.recv(65536)
                        if not chunk:
                            break
                        raw += chunk
                except OSError as e:
                    return CurlResult(err=f"recv failed: {e}")
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            if not raw:
                return CurlResult(err="empty reply from server")
            try:
                head_raw, _, resp_body = raw.partition(b"\r\n\r\n")
                status = int(head_raw.split(b"\r\n")[0].split(b" ")[1])
            except (ValueError, IndexError):
                return CurlResult(err="malformed response")
            if follow and status in (301, 302, 307, 308):
                loc = ""
                for line in head_raw.split(b"\r\n")[1:]:
                    if line.lower().startswith(b"location:"):
                        loc = line.split(b":", 1)[1].strip().decode()
                if loc.startswith("/"):
                    url = f"{u.scheme}://{host}:{port}{loc}" \
                        if u.port else f"{u.scheme}://{host}{loc}"
                    continue
                elif loc:
                    url = loc
                    continue
            return CurlResult(code=status, body=resp_body)
        return CurlResult(err="too many redirects")

    # ---------------------------------------------------------- lifecycle

    def reload_rules(self, rules: list[EgressRule]) -> None:
        """firewall add/remove analogue: regenerate Envoy + routes + zones
        the way Handler.regenerate does, swap atomically."""
        self.rules = rules
        self.bundle = generate_envoy_config(rules, cert_dir=str(self.tmp / "mitm"))
        self._write_mitm_certs()
        self.maps.sync_routes(policy_mod.build_routes(
            rules, envoy_ip=ENVOY_IP, tls_port=10000,
            tcp_ports=self.bundle.tcp_ports))
        self.gate.set_policy(ZonePolicy.from_rules(rules))
        self.envoy.stop()
        self.envoy = EnvoySim(self.bundle.config_yaml, self._resolve,
                              upstream_ca=str(self.ca_bundle))
        self.envoy.start()

    def close(self) -> None:
        self.envoy.stop()
        self.gate.stop()
        self.attacker.stop()
        if self.hostproxy is not None:
            self.hostproxy.stop()
        for origin in set(self.origins.values()):
            origin.stop()
