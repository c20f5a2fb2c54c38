"""Host-proxy: the audited side channel between agents and the host.

Agents live behind default-deny egress, but three interactions
legitimately need the host (reference: internal/hostproxy server.go:38):

- ``POST /open/url``      -- open a URL in the HOST browser (login
  pages, docs); http/https only, never executed in the container.
- ``POST /oauth/listen`` + ``GET /oauth/poll`` -- OAuth device flows:
  the provider redirects the host browser to 127.0.0.1:<port>; a
  one-shot listener captures that callback and the container-side
  forwarder polls it back into the agent's flow (reference: dynamic
  per-port listeners server.go:507-644 + callback-forwarder binary).
- ``POST /git/credential`` -- fill git credentials from the HOST
  credential store (reference: git_credential.go), gated by the egress
  rule set: a host is only fillable if the firewall would let the
  container reach it (reference: egress_check.go).  Secrets flow
  container-ward only, one host at a time, and every fill is logged.

Binds 127.0.0.1 (host side) -- containers reach it via the
host-gateway extra_host mapping the runtime injects; the kernel
firewall's FLAG_HOSTPROXY allows exactly this ip:port and nothing else.

The port's copy of ``clawker_tpu/hostproxy/server.py``, whole.
"""

from __future__ import annotations

import json
import secrets
import subprocess
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .. import logsetup
from ..config import Config
from ..config.schema import EgressRule

log = logsetup.get("hostproxy.server")

OAUTH_SESSION_TTL_S = 600
OAUTH_SUCCESS_PAGE = (b"<html><body><h3>Authentication complete.</h3>"
                      b"You can return to your agent terminal.</body></html>")


def default_open_browser(url: str) -> bool:
    import webbrowser

    try:
        return webbrowser.open(url)
    except Exception:
        return False


def default_git_fill(request: str, timeout: float = 10.0) -> str:
    """Run the host's `git credential fill` (keychain/helpers apply)."""
    res = subprocess.run(["git", "credential", "fill"], input=request.encode(),
                         capture_output=True, timeout=timeout)
    if res.returncode != 0:
        return ""
    return res.stdout.decode(errors="replace")


@dataclass
class OAuthSession:
    id: str
    port: int
    created: float = field(default_factory=time.time)
    captured: dict | None = None
    server: ThreadingHTTPServer | None = None


def _host_allowed(host: str, rules: list[EgressRule]) -> bool:
    """Would the firewall let a container reach this host?  Same zone
    semantics as the DNS gate (wildcard admits apex + subdomains)."""
    h = host.strip().lower().rstrip(".")
    for r in rules:
        dst = r.dst.strip().lower()
        if dst.startswith("*."):
            apex = dst[2:]
            if h == apex or h.endswith("." + apex):
                return True
        elif h == dst:
            return True
    return False


class HostProxy:
    def __init__(
        self,
        cfg: Config,
        *,
        host: str = "127.0.0.1",
        port: int | None = None,
        open_browser=default_open_browser,
        git_fill=default_git_fill,
    ):
        self.cfg = cfg
        self.host = host
        self.port = cfg.settings.host_proxy.port if port is None else port
        self.open_browser = open_browser
        self.git_fill = git_fill
        self.bound_port = 0
        self.opened_urls: list[str] = []
        self._sessions: dict[str, OAuthSession] = {}
        self._lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        proxy = self

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("hostproxy http: " + fmt, *args)

            def do_GET(self):  # noqa: N802
                proxy._route(self, "GET")

            def do_POST(self):  # noqa: N802
                proxy._route(self, "POST")

        self._httpd = ThreadingHTTPServer((self.host, self.port), _H)
        self.bound_port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hostproxy", daemon=True)
        self._thread.start()
        log.info("host proxy listening on %s:%d", self.host, self.bound_port)

    def stop(self) -> None:
        with self._lock:
            for s in self._sessions.values():
                self._close_session(s)
            self._sessions.clear()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(3.0)

    # ------------------------------------------------------------ routing

    def _route(self, req: BaseHTTPRequestHandler, method: str) -> None:
        try:
            path = urlparse(req.path).path
            if method == "GET" and path == "/healthz":
                self._reply(req, 200, {"ok": True, "sessions": len(self._sessions)})
            elif method == "POST" and path == "/open/url":
                self._handle_open(req)
            elif method == "POST" and path == "/oauth/listen":
                self._handle_oauth_listen(req)
            elif method == "GET" and path == "/oauth/poll":
                self._handle_oauth_poll(req)
            elif method == "POST" and path == "/git/credential":
                self._handle_git_credential(req)
            else:
                self._reply(req, 404, {"error": "not found"})
        except Exception as e:  # serve-path resilience
            log.error("hostproxy handler failure: %s", e)
            try:
                self._reply(req, 500, {"error": "internal error"})
            except Exception:
                pass

    @staticmethod
    def _body(req: BaseHTTPRequestHandler) -> bytes:
        length = int(req.headers.get("Content-Length") or 0)
        return req.rfile.read(length) if length else b""

    @staticmethod
    def _reply(req, code: int, payload: dict | bytes,
               content_type: str = "application/json") -> None:
        data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        req.send_response(code)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    # ----------------------------------------------------------- handlers

    def _handle_open(self, req) -> None:
        try:
            body = json.loads(self._body(req) or b"{}")
        except json.JSONDecodeError:
            self._reply(req, 400, {"error": "invalid JSON"})
            return
        url = str(body.get("url") or "")
        scheme = urlparse(url).scheme.lower()
        if scheme not in ("http", "https"):
            self._reply(req, 400, {"error": f"refusing to open scheme {scheme!r}"})
            return
        self.opened_urls.append(url)
        ok = self.open_browser(url)
        log.info("open-url %s: %s", url, "ok" if ok else "no browser")
        self._reply(req, 200, {"opened": bool(ok)})

    def _handle_oauth_listen(self, req) -> None:
        try:
            body = json.loads(self._body(req) or b"{}")
        except json.JSONDecodeError:
            self._reply(req, 400, {"error": "invalid JSON"})
            return
        port = int(body.get("port") or 0)
        session = OAuthSession(id=secrets.token_urlsafe(16), port=port)
        proxy = self

        class _CB(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                parsed = urlparse(self.path)
                with proxy._lock:
                    # first capture wins: a trailing favicon/asset fetch on
                    # the same listener must not clobber the real callback
                    if session.captured is None:
                        session.captured = {
                            "path": parsed.path,
                            "query": {k: v[0] for k, v in parse_qs(parsed.query).items()},
                        }
                proxy._reply(self, 200, OAUTH_SUCCESS_PAGE, "text/html")

        try:
            srv = ThreadingHTTPServer(("127.0.0.1", port), _CB)
        except OSError as e:
            self._reply(req, 409, {"error": f"port {port}: {e}"})
            return
        session.server = srv
        session.port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever,
                         name=f"oauth-{session.port}", daemon=True).start()
        with self._lock:
            self._gc_sessions()
            self._sessions[session.id] = session
        log.info("oauth session %s listening on 127.0.0.1:%d",
                 session.id[:8], session.port)
        self._reply(req, 200, {"session": session.id, "port": session.port})

    def _handle_oauth_poll(self, req) -> None:
        q = parse_qs(urlparse(req.path).query)
        sid = (q.get("session") or [""])[0]
        with self._lock:
            session = self._sessions.get(sid)
            if session is None:
                self._reply(req, 404, {"error": "unknown session"})
                return
            if session.captured is None:
                # bodyless 204: a body would desync keep-alive clients
                req.send_response(204)
                req.end_headers()
                return
            captured = session.captured
            self._close_session(session)
            del self._sessions[sid]
        self._reply(req, 200, captured)

    def _close_session(self, session: OAuthSession) -> None:
        if session.server is not None:
            srv = session.server
            session.server = None

            def _shutdown():
                srv.shutdown()
                srv.server_close()  # release the listening port too

            threading.Thread(target=_shutdown, daemon=True).start()

    def _gc_sessions(self) -> None:
        now = time.time()
        for sid in [s for s, v in self._sessions.items()
                    if now - v.created > OAUTH_SESSION_TTL_S]:
            self._close_session(self._sessions[sid])
            del self._sessions[sid]

    def _handle_git_credential(self, req) -> None:
        raw = self._body(req).decode(errors="replace")
        fields = dict(
            line.split("=", 1) for line in raw.splitlines() if "=" in line
        )
        host = fields.get("host", "")
        proto = fields.get("protocol", "")
        if proto not in ("https", "http") or not host:
            self._reply(req, 400, {"error": "protocol+host required"})
            return
        if not _host_allowed(host, self.cfg.egress_rules()):
            log.warning("git-credential DENIED for %s (not in egress rules)", host)
            self._reply(req, 403, {"error": f"host {host} not in egress rules"})
            return
        request = f"protocol={proto}\nhost={host}\n\n"
        filled = self.git_fill(request)
        log.info("git-credential fill for %s: %s", host,
                 "hit" if filled else "miss")
        self._reply(req, 200, filled.encode(), "text/plain")
