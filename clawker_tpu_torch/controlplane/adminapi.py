"""AdminService: mTLS + bearer-token JSON API of the control plane.

Parity reference: api/admin/v1/admin.proto:27 -- 15 RPCs (13 firewall
verbs :33-:91, ListAgents :96, GetSystemTime :116) with a method->scope
map (``AdminMethodScopes``) enforced by an auth interceptor
(controlplane/server AuthInterceptor: fail-closed).  The reference fronts
gRPC with Ory Hydra introspection; this build keeps the same wire contract
shape as ``POST /v1/<Method>`` JSON over mTLS with a self-issued ES256
bearer (SURVEY.md section 7 step 5: the Ory triple is the designated
replaceable part).  Transport auth (client cert signed by the CA) and
request auth (bearer scope) are both required -- fail-closed on either.

The port's copy of ``clawker_tpu/controlplane/adminapi.py``, whole.
"""

from __future__ import annotations

import json
import socket
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable
from urllib import error as urlerror
from urllib import request as urlrequest

from cryptography import x509

from .. import consts, logsetup
from ..errors import ClawkerError
from . import identity

log = logsetup.get("cp.admin")

Handler = Callable[[dict], dict]

# Parity: AdminMethodScopes (admin.proto) -- uniform `admin` scope for every
# management verb; `self.register` never reaches this surface (AgentService).
ADMIN_METHODS = (
    "FirewallInit", "FirewallEnable", "FirewallDisable", "FirewallBypass",
    "FirewallAddRules", "FirewallRemoveRule", "FirewallListRules",
    "FirewallReload", "FirewallStatus", "FirewallRotateCA",
    "FirewallSyncRoutes", "FirewallResolveHostname", "FirewallRemove",
    "ListAgents", "GetSystemTime", "Status",
)
ADMIN_METHOD_SCOPES = {m: "admin" for m in ADMIN_METHODS}
TOKEN_TTL_S = 3600


class AdminError(ClawkerError):
    pass


def mint_admin_token(ca, *, ttl_s: int = TOKEN_TTL_S) -> str:
    """Client-credentials stand-in: an ES256 bearer signed by the CA key."""
    now = int(time.time())
    return identity.sign_jwt_es256(
        ca.key,
        {"iss": consts.PRODUCT, "sub": "admin-cli", "scope": "admin",
         "iat": now, "exp": now + ttl_s},
    )


class AdminServer:
    """Threaded HTTPS server dispatching POST /v1/<Method> to handlers."""

    def __init__(
        self,
        *,
        cert_file: Path,
        key_file: Path,
        ca_file: Path,
        host: str = "0.0.0.0",
        port: int = 0,
    ):
        self._handlers: dict[str, Handler] = {}
        self._ca_pub = x509.load_pem_x509_certificate(
            Path(ca_file).read_bytes()
        ).public_key()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(cert_file, key_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(ca_file)
        self._ssl = ctx
        self.host = host
        self.port = port
        self.bound_port = 0
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.register("GetSystemTime", lambda req: {"unix": time.time()})

    def register(self, method: str, handler: Handler) -> None:
        if method not in ADMIN_METHOD_SCOPES:
            raise AdminError(f"unknown admin method {method!r}")
        self._handlers[method] = handler

    def registered(self) -> list[str]:
        return sorted(self._handlers)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        outer = self

        class _Requests(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through our logger
                log.debug("admin http: " + fmt, *args)

            def do_POST(self):  # noqa: N802 (http.server convention)
                outer._dispatch(self)

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Requests)
        self._httpd.socket = self._ssl.wrap_socket(self._httpd.socket, server_side=True)
        self.bound_port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="adminapi", daemon=True
        )
        self._thread.start()
        log.info("admin api listening on :%d", self.bound_port)

    def stop(self, timeout: float = 5.0) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, req: BaseHTTPRequestHandler) -> None:
        try:
            self._dispatch_inner(req)
        except Exception as e:
            # serve-path resilience: a handler bug answers 500, never kills
            # the CP (reference: no panic on serve path, root CLAUDE.md)
            log.error("admin dispatch failure: %s", e)
            try:
                self._reply(req, 500, {"error": "internal error"})
            except Exception:
                pass

    def _dispatch_inner(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path
        if not path.startswith("/v1/"):
            self._reply(req, 404, {"error": "not found"})
            return
        method = path[len("/v1/"):]
        scope = ADMIN_METHOD_SCOPES.get(method)
        if scope is None:
            self._reply(req, 404, {"error": f"unknown method {method!r}"})
            return
        auth = req.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            self._reply(req, 401, {"error": "missing bearer token"})
            return
        try:
            claims = identity.verify_jwt_es256(self._ca_pub, auth[len("Bearer "):])
        except identity.IdentityError as e:
            self._reply(req, 401, {"error": str(e)})
            return
        granted = set(str(claims.get("scope", "")).split())
        if scope not in granted:
            self._reply(req, 403, {"error": f"scope {scope!r} required"})
            return
        handler = self._handlers.get(method)
        if handler is None:
            self._reply(req, 501, {"error": f"{method} not available"})
            return
        length = int(req.headers.get("Content-Length") or 0)
        body = req.rfile.read(length) if length else b"{}"
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError:
            self._reply(req, 400, {"error": "invalid JSON body"})
            return
        try:
            result = handler(payload if isinstance(payload, dict) else {})
        except ClawkerError as e:
            self._reply(req, 422, {"error": str(e)})
            return
        self._reply(req, 200, result if isinstance(result, dict) else {"result": result})

    @staticmethod
    def _reply(req: BaseHTTPRequestHandler, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        req.send_response(code)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)


class AdminClient:
    """CLI-side client: mTLS client cert + bearer, JSON in/out.

    Parity reference: controlplane/adminclient Dial -- mTLS with an
    auto-refreshing bearer; here the token is minted locally from the CA
    key the CLI already owns (same trust root the CP verifies against).
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        cert_file: Path,
        key_file: Path,
        ca_file: Path,
        token: str,
        timeout: float = 15.0,
    ):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(cert_file, key_file)
        ctx.load_verify_locations(ca_file)
        ctx.check_hostname = False      # dialed by IP; CA grounds trust
        ctx.verify_mode = ssl.CERT_REQUIRED
        self._ctx = ctx
        self.base = f"https://{host}:{port}"
        self.token = token
        self.timeout = timeout

    def call(self, method: str, payload: dict | None = None) -> dict:
        req = urlrequest.Request(
            f"{self.base}/v1/{method}",
            data=json.dumps(payload or {}).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.token}",
            },
            method="POST",
        )
        try:
            with urlrequest.urlopen(req, timeout=self.timeout, context=self._ctx) as resp:
                return json.loads(resp.read() or b"{}")
        except urlerror.HTTPError as e:
            try:
                detail = json.loads(e.read() or b"{}").get("error", "")
            except json.JSONDecodeError:
                detail = ""
            raise AdminError(f"{method}: HTTP {e.code} {detail}".strip()) from None
        except (urlerror.URLError, socket.timeout, OSError) as e:
            raise AdminError(f"{method}: control plane unreachable ({e})") from None
