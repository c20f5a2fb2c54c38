"""AgentService: the CP's inbound Register listener for agentd.

Parity reference: api/agent/v1/agent.proto:32 Register (:43, scope
``self.register``) + controlplane/agent/register_handler.go -- agentd's one
outbound call binds its connection identity to the registry row.  The
reference grounds identity in peer IP (IdentityInterceptor); this build
grounds it in the *client certificate thumbprint*: the row is only marked
registered when the presented leaf's SHA-256 matches the thumbprint bound
at mint time, which survives IP churn across workers (stronger than the
peer-IP check and required once agents live on remote TPU-VM daemons).

The port's copy of ``clawker_tpu/controlplane/agentservice.py``, whole.
"""

from __future__ import annotations

import socket
import ssl
import threading
from pathlib import Path

from cryptography import x509
from cryptography.hazmat.primitives import hashes

from .. import logsetup
from ..agentd.protocol import ConnectionClosed, ProtocolError, read_msg, write_msg
from . import identity
from .registry import Registry

log = logsetup.get("cp.agentservice")


class AgentService:
    """mTLS listener accepting one framed register exchange per connection."""

    def __init__(
        self,
        registry: Registry,
        *,
        cert_file: Path,
        key_file: Path,
        ca_file: Path,
        host: str = "0.0.0.0",
        port: int = 0,
    ):
        self.registry = registry
        self.host = host
        self.port = port
        self.bound_port = 0
        self._ca_pub = x509.load_pem_x509_certificate(
            Path(ca_file).read_bytes()
        ).public_key()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(cert_file, key_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(ca_file)
        self._ssl = ctx
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(16)
        self.bound_port = ls.getsockname()[1]
        self._listener = ls
        self._thread = threading.Thread(target=self._serve, name="agentservice", daemon=True)
        self._thread.start()
        log.info("agent service listening on :%d", self.bound_port)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout)

    def _serve(self) -> None:
        assert self._listener is not None
        while not self._stop.is_set():
            try:
                raw, addr = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._handle_recovered, args=(raw, addr), daemon=True
            )
            t.start()

    def _handle_recovered(self, raw: socket.socket, addr) -> None:
        try:
            self._handle(raw, addr)
        except Exception as e:
            log.warning("register conn %s failed: %s", addr, e)
        finally:
            try:
                raw.close()
            except OSError:
                pass

    # ------------------------------------------------------------- handling

    def _handle(self, raw: socket.socket, addr) -> None:
        raw.settimeout(10.0)
        try:
            tls = self._ssl.wrap_socket(raw, server_side=True)
        except ssl.SSLError as e:
            log.info("register tls rejected from %s: %s", addr, e)
            return
        with tls:
            try:
                msg = read_msg(tls)
            except (ProtocolError, ConnectionClosed, OSError):
                return
            if msg.get("type") != "register":
                write_msg(tls, {"type": "register_ack", "ok": False, "error": "expected register"})
                return
            reply = self._register(tls, msg)
            try:
                write_msg(tls, reply)
            except (OSError, ssl.SSLError):
                pass

    def _register(self, tls: ssl.SSLSocket, msg: dict) -> dict:
        def reject(err: str) -> dict:
            log.warning("register rejected: %s", err)
            return {"type": "register_ack", "ok": False, "error": err}

        try:
            claims = identity.verify_jwt_es256(self._ca_pub, str(msg.get("assertion", "")))
        except identity.IdentityError as e:
            return reject(str(e))
        if claims.get("scope") != "self.register":
            return reject(f"wrong scope {claims.get('scope')!r}")
        full = str(claims.get("sub") or "")
        record = self.registry.get(full)
        if record is None:
            return reject(f"unknown agent {full!r}")
        der = tls.getpeercert(binary_form=True)
        if not der:
            return reject("no client certificate")
        digest = hashes.Hash(hashes.SHA256())
        digest.update(der)
        thumb = digest.finalize().hex()
        if not self.registry.mark_registered(full, thumb):
            return reject(f"thumbprint mismatch for {full}")
        log.info("agent %s registered (cert %s)", full, thumb[:16])
        return {"type": "register_ack", "ok": True, "agent": full}
