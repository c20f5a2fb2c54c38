"""Socket-level attacker capture server for the adversarial suite.

Re-derivation of the reference C2 test server
(clawker's test/adversarial/attacker-server/main.go): every byte
that reaches an attacker-controlled endpoint is recorded in a sqlite
capture DB the operator grades from.  Listeners:

- raw TCP  : any connection, any bytes (beaconing, custom protocols)
- TLS      : self-signed "attacker CA" cert -- captures decrypted
  payloads when a client is willing to trust it or skip verification
- HTTP     : per-technique capture endpoints (/c/<id>), plus any path
- UDP      : datagram capture (DNS-tunnel / QUIC-shaped exfil)
- DNS view : the world resolver reports queries for attacker zones via
  ``record_dns`` -- label-encoded exfil that never even opens a data
  socket still shows up here

Grading contract: the suite PASSES only when the captures table is
empty for every technique -- an attacker observing anything at all is
an escape, which is strictly stronger than the verdict-taxonomy check
the semantic harness applies.

The port's copy of ``clawker_tpu/parity/attacker.py``, whole.
"""

from __future__ import annotations

import socket
import socketserver
import sqlite3
import threading
import time
from pathlib import Path


class CaptureStore:
    """Sqlite captures table (reference main.go initDB)."""

    def __init__(self, path: str | Path = ":memory:"):
        self.conn = sqlite3.connect(str(path), check_same_thread=False)
        self._lock = threading.Lock()
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS captures ("
            " id INTEGER PRIMARY KEY AUTOINCREMENT,"
            " ts REAL, technique TEXT, proto TEXT, transport TEXT,"
            " raw BLOB, bytes INTEGER)"
        )

    def insert(self, technique: str, proto: str, transport: str,
               raw: bytes) -> None:
        with self._lock:
            self.conn.execute(
                "INSERT INTO captures (ts, technique, proto, transport, raw,"
                " bytes) VALUES (?, ?, ?, ?, ?, ?)",
                (time.time(), technique, proto, transport, raw, len(raw)))
            self.conn.commit()

    def count(self, technique: str | None = None) -> int:
        q = "SELECT COUNT(*) FROM captures"
        args: tuple = ()
        if technique is not None:
            q += " WHERE technique = ?"
            args = (technique,)
        with self._lock:
            return self.conn.execute(q, args).fetchone()[0]

    def all(self) -> list[tuple]:
        with self._lock:
            return list(self.conn.execute(
                "SELECT technique, proto, transport, bytes FROM captures"))

    def close(self) -> None:
        self.conn.close()


class AttackerServer:
    """All attacker listeners on 127.0.0.1 ephemerals + the capture DB."""

    def __init__(self, store: CaptureStore | None = None, *,
                 tls_cert: str | None = None, tls_key: str | None = None):
        self.store = store or CaptureStore()
        self.tls_cert, self.tls_key = tls_cert, tls_key
        self.tcp_port = 0
        self.tls_port = 0
        self.http_port = 0
        self.udp_port = 0
        self._servers: list = []
        self._threads: list[threading.Thread] = []
        # Captures are inserted from socketserver handler threads, never
        # the dialer thread, so the technique tag must be a cross-thread
        # plain attribute (scenarios run sequentially), not a
        # threading.local that would read unset as "?" in handlers.
        self._technique_lock = threading.Lock()
        self._technique_name = "?"

    # The dialer tags which technique is currently attacking so captures
    # attribute to it (the reference uses per-test capture paths).
    def set_technique(self, name: str) -> None:
        with self._technique_lock:
            self._technique_name = name

    def _current(self) -> str:
        with self._technique_lock:
            return self._technique_name

    # ------------------------------------------------------------ servers

    def start(self) -> None:
        att = self

        class _Tcp(socketserver.BaseRequestHandler):
            def handle(self):
                data = b""
                try:
                    self.request.settimeout(2.0)
                    while len(data) < 1 << 20:
                        chunk = self.request.recv(65536)
                        if not chunk:
                            break
                        data += chunk
                except OSError:
                    pass
                att.store.insert(att._current(), "tcp", "raw", data or b"<connect>")

        class _Tls(socketserver.BaseRequestHandler):
            def handle(self):
                import ssl
                try:
                    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                    ctx.load_cert_chain(att.tls_cert, att.tls_key)
                    with ctx.wrap_socket(self.request, server_side=True) as tls:
                        tls.settimeout(2.0)
                        data = b""
                        try:
                            while len(data) < 1 << 20:
                                chunk = tls.recv(65536)
                                if not chunk:
                                    break
                                data += chunk
                        except OSError:
                            pass
                        att.store.insert(att._current(), "tls", "tls",
                                         data or b"<handshake>")
                except (OSError, ssl.SSLError):
                    # handshake never completed: nothing decrypted, but the
                    # TCP reach itself is still attacker-visible
                    att.store.insert(att._current(), "tls", "tcp-reach",
                                     b"<pre-handshake connect>")

        class _Http(socketserver.StreamRequestHandler):
            def handle(self):
                from .envoysim import read_http_request
                try:
                    self.request.settimeout(2.0)
                    req = read_http_request(self.rfile)
                except OSError:
                    req = None
                if req is None:
                    att.store.insert(att._current(), "http", "raw", b"<connect>")
                    return
                att.store.insert(att._current(), "http", "http",
                                 req.raw_head + req.body)
                body = b'{"ok": true}'
                self.wfile.write(
                    b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n"
                    b"connection: close\r\n\r\n%s" % (len(body), body))

        class _Udp(socketserver.BaseRequestHandler):
            def handle(self):
                data, _sock = self.request
                att.store.insert(att._current(), "udp", "udp", data)

        socketserver.ThreadingTCPServer.allow_reuse_address = True
        socketserver.ThreadingUDPServer.allow_reuse_address = True
        tcp = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Tcp)
        http = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Http)
        udp = socketserver.ThreadingUDPServer(("127.0.0.1", 0), _Udp)
        self.tcp_port = tcp.server_address[1]
        self.http_port = http.server_address[1]
        self.udp_port = udp.server_address[1]
        self._servers = [tcp, http, udp]
        if self.tls_cert and self.tls_key:
            tls = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Tls)
            self.tls_port = tls.server_address[1]
            self._servers.append(tls)
        for srv in self._servers:
            # tight poll so stop() returns promptly (default 0.5s/server)
            t = threading.Thread(
                target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        for srv in self._servers:
            srv.shutdown()
            srv.server_close()
        for t in self._threads:
            t.join(2.0)
        self._servers.clear()
        self._threads.clear()

    # ------------------------------------------------------------ DNS view

    def record_dns(self, qname: str) -> None:
        """Called by the world resolver when a query for an attacker zone
        escapes to upstream DNS (label-encoded exfiltration)."""
        self.store.insert(self._current(), "dns", "query", qname.encode())
