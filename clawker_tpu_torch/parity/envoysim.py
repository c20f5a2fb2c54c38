"""Executable interpreter for the generated Envoy bootstrap.

``generate_envoy_config`` emits a bootstrap YAML that, in production, a
real Envoy process loads.  This module LOADS THAT SAME YAML and serves
real localhost sockets with the semantics the config declares: the TLS
listener sniffs SNI off the actual ClientHello and dispatches to the
matching filter chain (MITM chains terminate TLS with the configured
cert files and apply HTTP route verdicts; passthrough chains splice the
raw bytes to the cluster upstream), the plain-HTTP listener routes on
the Host header, and sequential tcp_proxy listeners splice to their
pinned clusters.  Parity verdicts produced through this interpreter are
backed by config that was *executed*, not merely rendered: no verdict
rests on YAML that nothing ever loaded.

Semantics sources (re-derived, not copied):
- filter-chain SNI match + default refuse: reference envoy_config.go
  GenerateEnvoyConfig TLS listener (SURVEY.md 2.8).
- HCM hardening (normalize_path, merge_slashes,
  path_with_escaped_slashes_action=UNESCAPE_AND_REDIRECT): reference
  envoy_http.go:411; exercised by e2e firewall_test.go:1131.  The
  percent-decode here iterates to a fixpoint, which is *stricter* than
  Envoy's single pass -- a security boundary may tighten, never loosen.
- direct_response deny routes: envoy_http.go httpDenyRoute.

Listener ports from the config are virtual (10000, 10001...); the sim
binds 127.0.0.1 ephemerals and exposes ``port_map`` so the kernel-twin
dialer can translate REDIRECT verdicts the same way the TPU-VM kernel
would rewrite to the real Envoy.

The port's copy of ``clawker_tpu/parity/envoysim.py``, whole.
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import urllib.parse
from dataclasses import dataclass, field
from typing import Callable

import yaml

# resolve(host, port) -> (real_host, real_port) | None.  Models what
# LOGICAL_DNS / dynamic_forward_proxy resolution sees from inside the
# proxy: the world's virtual internet.
Resolve = Callable[[str, int], "tuple[str, int] | None"]

_MAX_HEAD = 64 * 1024


class TlsParseError(Exception):
    pass


def parse_client_hello_sni(data: bytes) -> str | None:
    """Extract SNI from a raw TLS ClientHello record (RFC 6066)."""
    if len(data) < 5 or data[0] != 0x16:
        raise TlsParseError("not a TLS handshake record")
    rec_len = struct.unpack(">H", data[3:5])[0]
    if len(data) < 5 + rec_len:
        raise TlsParseError("short record")
    body = data[5:5 + rec_len]
    if not body or body[0] != 0x01:
        raise TlsParseError("not a ClientHello")
    off = 4 + 2 + 32  # msg hdr + client_version + random
    if off >= len(body):
        raise TlsParseError("truncated hello")
    sid_len = body[off]
    off += 1 + sid_len
    if off + 2 > len(body):
        raise TlsParseError("truncated ciphers")
    cs_len = struct.unpack(">H", body[off:off + 2])[0]
    off += 2 + cs_len
    if off >= len(body):
        raise TlsParseError("truncated compression")
    comp_len = body[off]
    off += 1 + comp_len
    if off + 2 > len(body):
        return None  # no extensions
    ext_total = struct.unpack(">H", body[off:off + 2])[0]
    off += 2
    end = min(len(body), off + ext_total)
    while off + 4 <= end:
        etype, elen = struct.unpack(">HH", body[off:off + 4])
        off += 4
        if etype == 0 and off + elen <= end:  # server_name
            # list_len(2) type(1) name_len(2) name
            if elen >= 5:
                name_len = struct.unpack(">H", body[off + 3:off + 5])[0]
                return body[off + 5:off + 5 + name_len].decode("ascii", "replace")
        off += elen
    return None


def normalize_path(raw: str) -> tuple[str, bool]:
    """(normalized_path, had_escaped_slash).

    merge_slashes + percent-decode-to-fixpoint + dot-segment resolution.
    had_escaped_slash=True means the raw path hid a slash behind %2F/%5C
    -- the UNESCAPE_AND_REDIRECT case (client is 307'd to the clean
    path, reference envoy_http.go:419)."""
    qpos = raw.find("?")
    path, query = (raw[:qpos], raw[qpos:]) if qpos >= 0 else (raw, "")
    had_escaped_slash = any(
        t in path.lower() for t in ("%2f", "%5c"))
    # decode to fixpoint (capped): defeats double-encoding smuggling
    for _ in range(4):
        decoded = urllib.parse.unquote(path)
        if decoded == path:
            break
        path = decoded
    path = path.replace("\\", "/")
    # merge slashes + resolve dot segments
    out: list[str] = []
    for seg in path.split("/"):
        if seg in ("", "."):
            continue
        if seg == "..":
            if out:
                out.pop()
            continue
        out.append(seg)
    norm = "/" + "/".join(out)
    if path.endswith("/") and norm != "/":
        norm += "/"
    return norm + query, had_escaped_slash


def _host_matches(pattern: str, host: str) -> bool:
    """Envoy virtual-host domain match (exact, *.suffix, host:*).

    Faithful to Envoy: ``*.example.com`` matches subdomains ONLY, never
    the bare apex -- configs that want the apex list it explicitly.  (An
    apex-matching wildcard here once masked a Host-smuggling bypass the
    generator had already fixed.)"""
    pattern, host = pattern.lower(), host.lower()
    if pattern.endswith(":*"):
        return _host_matches(pattern[:-2], host.rsplit(":", 1)[0])
    host = host.rsplit(":", 1)[0] if ":" in host else host
    if pattern.startswith("*."):
        return host.endswith(pattern[1:])
    if pattern == "*":
        return True
    return host == pattern


def _sni_matches(server_names: list[str], sni: str | None) -> bool:
    """filter_chain_match server_names, Envoy-faithful: a ``*.`` entry
    matches subdomains only (the generator lists the apex explicitly
    when a wildcard rule admits it)."""
    if sni is None:
        return False
    sni = sni.lower().rstrip(".")
    for name in server_names:
        name = name.lower()
        if name.startswith("*."):
            if sni.endswith(name[1:]):
                return True
        elif sni == name:
            return True
    return False


@dataclass
class HttpRequest:
    method: str
    target: str
    version: str
    headers: dict[str, str]
    body: bytes
    raw_head: bytes

    @property
    def host(self) -> str:
        return self.headers.get("host", "")


def read_http_request(rfile) -> HttpRequest | None:
    head = b""
    while b"\r\n\r\n" not in head:
        chunk = rfile.read(1)
        if not chunk:
            return None
        head += chunk
        if len(head) > _MAX_HEAD:
            return None
    lines = head.split(b"\r\n")
    try:
        method, target, version = lines[0].decode("latin-1").split(" ", 2)
    except ValueError:
        return None
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if b":" in line:
            k, v = line.split(b":", 1)
            headers[k.decode("latin-1").strip().lower()] = v.decode("latin-1").strip()
    body = b""
    clen = int(headers.get("content-length", "0") or "0")
    while len(body) < clen:
        chunk = rfile.read(clen - len(body))
        if not chunk:
            break
        body += chunk
    return HttpRequest(method, target, version, headers, body, head)


def _send_simple(wfile, status: int, body: bytes, *,
                 extra_headers: dict[str, str] | None = None) -> None:
    reason = {200: "OK", 307: "Temporary Redirect", 403: "Forbidden",
              404: "Not Found", 502: "Bad Gateway"}.get(status, "OK")
    head = f"HTTP/1.1 {status} {reason}\r\n"
    for k, v in (extra_headers or {}).items():
        head += f"{k}: {v}\r\n"
    head += f"content-length: {len(body)}\r\nconnection: close\r\n\r\n"
    wfile.write(head.encode("latin-1") + body)
    wfile.flush()


def _pump(a: socket.socket, b: socket.socket) -> None:
    """Bidirectional byte splice until either side closes."""
    def one(src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    t = threading.Thread(target=one, args=(b, a), daemon=True)
    t.start()
    one(a, b)
    t.join(5.0)


class EnvoySim:
    """Serve the bootstrap's listeners on real localhost sockets."""

    def __init__(self, config_yaml: str, resolve: Resolve, *,
                 upstream_ca: str | None = None):
        self.cfg = yaml.safe_load(config_yaml)
        self.resolve = resolve
        self.upstream_ca = upstream_ca
        self.clusters = {c["name"]: c for c in
                         self.cfg["static_resources"]["clusters"]}
        self.port_map: dict[int, int] = {}   # configured -> bound
        self.access_log: list[dict] = []
        self._log_lock = threading.Lock()
        self._servers: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        for listener in self.cfg["static_resources"]["listeners"]:
            cport = listener["address"]["socket_address"]["port_value"]
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", 0))
            srv.listen(32)
            # finite accept timeout: close() alone does not wake a thread
            # blocked in accept(), and stop() would eat the full join
            srv.settimeout(0.2)
            self.port_map[cport] = srv.getsockname()[1]
            self._servers.append(srv)
            t = threading.Thread(target=self._accept_loop,
                                 args=(srv, listener),
                                 name=f"envoysim-{cport}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for srv in self._servers:
            try:
                srv.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(2.0)
        self._servers.clear()
        self._threads.clear()

    def _log(self, **rec) -> None:
        with self._log_lock:
            self.access_log.append(rec)

    # ------------------------------------------------------------ dispatch

    def _accept_loop(self, srv: socket.socket, listener: dict) -> None:
        has_tls_inspector = any(
            f.get("name") == "envoy.filters.listener.tls_inspector"
            for f in listener.get("listener_filters", []))
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(10.0)
            t = threading.Thread(
                target=self._handle, args=(conn, listener, has_tls_inspector),
                daemon=True)
            t.start()

    def _handle(self, conn: socket.socket, listener: dict,
                tls_inspector: bool) -> None:
        try:
            if tls_inspector:
                self._handle_tls_listener(conn, listener)
            else:
                self._handle_plain_listener(conn, listener)
        except (OSError, ssl.SSLError, TlsParseError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------- TLS listener

    def _peek_record(self, conn: socket.socket) -> bytes:
        """Peek the first full TLS record without consuming it."""
        want = 5
        data = b""
        for _ in range(64):
            data = conn.recv(want, socket.MSG_PEEK)
            if len(data) >= 5:
                rec_len = struct.unpack(">H", data[3:5])[0]
                want = 5 + rec_len
                if len(data) >= want:
                    return data[:want]
            elif not data:
                return b""
        return data

    def _handle_tls_listener(self, conn: socket.socket, listener: dict) -> None:
        record = self._peek_record(conn)
        if not record:
            return
        sni = parse_client_hello_sni(record)
        # Envoy picks the most-specific filter_chain_match: an exact
        # server_name beats a wildcard, regardless of declaration order
        # (exercised by e2e WildcardAndExactCoexist).
        chain = None
        chains = listener.get("filter_chains", [])
        for exact_pass in (True, False):
            for c in chains:
                names = c.get("filter_chain_match", {}).get("server_names", [])
                wanted = [n for n in names
                          if n.startswith("*.") != exact_pass]
                if _sni_matches(wanted, sni):
                    chain = c
                    break
            if chain is not None:
                break
        if chain is None:
            # default deny: no chain for this SNI -> refuse
            self._log(listener="tls", sni=sni, action="refused")
            conn.shutdown(socket.SHUT_RDWR)
            return
        if "transport_socket" in chain:
            self._serve_mitm(conn, chain, sni)
        else:
            self._serve_passthrough(conn, chain, sni)

    def _serve_passthrough(self, conn: socket.socket, chain: dict,
                           sni: str | None) -> None:
        filters = {f["name"]: f for f in chain["filters"]}
        dfp = filters.get("envoy.filters.network.sni_dynamic_forward_proxy")
        tcp_proxy = filters["envoy.filters.network.tcp_proxy"]
        if dfp is not None:
            port = dfp["typed_config"]["port_value"]
            upstream = self.resolve(sni or "", port)
        else:
            upstream = self._cluster_endpoint(
                tcp_proxy["typed_config"]["cluster"], authority=sni)
        if upstream is None:
            self._log(listener="tls", sni=sni, action="no_upstream")
            conn.shutdown(socket.SHUT_RDWR)
            return
        self._log(listener="tls", sni=sni, action="passthrough",
                  upstream=f"{upstream[0]}:{upstream[1]}")
        with socket.create_connection(upstream, timeout=10.0) as up:
            _pump(conn, up)

    def _serve_mitm(self, conn: socket.socket, chain: dict,
                    sni: str | None) -> None:
        certs = (chain["transport_socket"]["typed_config"]
                 ["common_tls_context"]["tls_certificates"][0])
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certs["certificate_chain"]["filename"],
                            certs["private_key"]["filename"])
        with ctx.wrap_socket(conn, server_side=True) as tls:
            hcm = next(
                f for f in chain["filters"]
                if f["name"] == "envoy.filters.network.http_connection_manager"
            )["typed_config"]
            self._serve_hcm(tls, hcm, tls_upstream=True, sni=sni)

    # ------------------------------------------------------ plain listener

    def _handle_plain_listener(self, conn: socket.socket, listener: dict) -> None:
        chain = listener["filter_chains"][0]
        names = {f["name"]: f for f in chain["filters"]}
        hcm = names.get("envoy.filters.network.http_connection_manager")
        if hcm is not None:
            self._serve_hcm(conn, hcm["typed_config"], tls_upstream=False)
            return
        tcp_proxy = names["envoy.filters.network.tcp_proxy"]
        upstream = self._cluster_endpoint(
            tcp_proxy["typed_config"]["cluster"], authority=None)
        if upstream is None:
            self._log(listener="tcp", action="no_upstream")
            conn.shutdown(socket.SHUT_RDWR)
            return
        self._log(listener="tcp", action="splice",
                  upstream=f"{upstream[0]}:{upstream[1]}")
        with socket.create_connection(upstream, timeout=10.0) as up:
            _pump(conn, up)

    # ------------------------------------------------------------- HCM

    def _serve_hcm(self, sock, hcm: dict, *, tls_upstream: bool,
                   sni: str | None = None) -> None:
        rfile = sock.makefile("rb")
        wfile = sock.makefile("wb")
        req = read_http_request(rfile)
        if req is None:
            return
        path, had_escaped = normalize_path(req.target)
        if had_escaped:
            # UNESCAPE_AND_REDIRECT: bounce the client to the clean path
            self._log(hcm=hcm.get("stat_prefix"), authority=req.host,
                      path=req.target, action="redirect_normalized")
            _send_simple(wfile, 307, b"", extra_headers={"location": path})
            return
        vhost = self._match_vhost(hcm, req.host)
        if vhost is None:
            self._log(hcm=hcm.get("stat_prefix"), authority=req.host,
                      path=path, action="no_vhost", code=404)
            _send_simple(wfile, 404, b"")
            return
        route = self._match_route(vhost, path, req.method)
        if route is None:
            self._log(hcm=hcm.get("stat_prefix"), authority=req.host,
                      path=path, action="no_route", code=404)
            _send_simple(wfile, 404, b"")
            return
        action = (route.get("metadata", {}).get("filter_metadata", {})
                  .get("fw", {}).get("action", ""))
        if "direct_response" in route:
            dr = route["direct_response"]
            body = dr.get("body", {}).get("inline_string", "").encode()
            self._log(hcm=hcm.get("stat_prefix"), authority=req.host,
                      path=path, method=req.method, action=action or "denied",
                      code=dr["status"])
            _send_simple(wfile, dr["status"], body)
            return
        cluster = route["route"]["cluster"]
        upstream = self._cluster_endpoint(cluster, authority=req.host or sni)
        if upstream is None:
            self._log(hcm=hcm.get("stat_prefix"), authority=req.host,
                      path=path, action="no_upstream", code=502)
            _send_simple(wfile, 502, b"upstream resolution failed\n")
            return
        self._log(hcm=hcm.get("stat_prefix"), authority=req.host, path=path,
                  method=req.method, action=action or "allowed",
                  upstream=f"{upstream[0]}:{upstream[1]}")
        self._forward_request(wfile, req, path, upstream,
                              tls=self._cluster_tls(cluster),
                              server_hostname=(req.host or sni or "").split(":")[0])

    def _match_vhost(self, hcm: dict, host: str) -> dict | None:
        # exact domains win over wildcards (Envoy vhost domain search
        # order: exact, then suffix wildcards), declaration order second
        for exact_pass in (True, False):
            for vh in hcm["route_config"]["virtual_hosts"]:
                domains = [d for d in vh["domains"]
                           if d.startswith("*") != exact_pass]
                if any(_host_matches(d, host) for d in domains):
                    return vh
        return None

    @staticmethod
    def _match_route(vhost: dict, path: str, method: str) -> dict | None:
        bare = path.split("?")[0]
        for route in vhost["routes"]:
            match = route["match"]
            prefix = match.get("prefix")
            if prefix is None or not bare.startswith(prefix):
                continue
            hdrs = match.get("headers", [])
            ok = True
            for h in hdrs:
                if h.get("name") == ":method":
                    sm = h.get("string_match", {})
                    if "exact" in sm and method != sm["exact"]:
                        ok = False
                    elif "safe_regex" in sm:
                        import re
                        if re.fullmatch(sm["safe_regex"]["regex"], method) is None:
                            ok = False
            if ok:
                return route
        return None

    # --------------------------------------------------------- upstreams

    def _cluster_endpoint(self, name: str, *,
                          authority: str | None) -> tuple[str, int] | None:
        c = self.clusters.get(name)
        if c is None:
            return None
        if "cluster_type" in c:  # dynamic_forward_proxy: host from authority
            if not authority:
                return None
            host, _, port_s = authority.partition(":")
            return self.resolve(host, int(port_s) if port_s else
                                (443 if self._cluster_tls(name) else 80))
        ep = (c["load_assignment"]["endpoints"][0]["lb_endpoints"][0]
              ["endpoint"]["address"]["socket_address"])
        return self.resolve(ep["address"], ep["port_value"])

    def _cluster_tls(self, name: str) -> bool:
        return "transport_socket" in self.clusters.get(name, {})

    def _forward_request(self, wfile, req: HttpRequest, path: str,
                         upstream: tuple[str, int], *, tls: bool,
                         server_hostname: str) -> None:
        try:
            raw = socket.create_connection(upstream, timeout=10.0)
        except OSError:
            _send_simple(wfile, 502, b"upstream connect failed\n")
            return
        try:
            up = raw
            if tls:
                ctx = ssl.create_default_context(cafile=self.upstream_ca)
                if self.upstream_ca is None:
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl.CERT_NONE
                up = ctx.wrap_socket(raw, server_hostname=server_hostname)
            head = f"{req.method} {path} HTTP/1.1\r\n"
            head += f"host: {req.host}\r\nconnection: close\r\n"
            for k, v in req.headers.items():
                if k in ("host", "connection", "content-length"):
                    continue
                head += f"{k}: {v}\r\n"
            if req.body:
                head += f"content-length: {len(req.body)}\r\n"
            up.sendall(head.encode("latin-1") + b"\r\n" + req.body)
            while True:
                data = up.recv(65536)
                if not data:
                    break
                wfile.write(data)
            wfile.flush()
        except (OSError, ssl.SSLError):
            pass
        finally:
            try:
                up.close()
            except OSError:
                pass
