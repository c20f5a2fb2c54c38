"""agentd's one outbound call: Register with the control plane.

Parity reference: clawkerd register.go -- on RegisterRequired the daemon
obtains a token (reference: Hydra client_credentials; this build: the
pre-minted assertion JWT from bootstrap material) and calls
AgentService.Register over mTLS so the CP binds the connection identity to
the agent row.  The CP answers over the same framed-JSON protocol the
session uses.

The port's copy of ``clawker_tpu/agentd/register.py``, whole.
"""

from __future__ import annotations

import socket
import ssl
from pathlib import Path

from .. import consts
from ..errors import ClawkerError
from .protocol import read_msg, write_msg


class RegisterError(ClawkerError):
    pass


def _client_context(bootstrap_dir: Path) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.load_cert_chain(bootstrap_dir / "agent.crt", bootstrap_dir / "agent.key")
    ctx.load_verify_locations(bootstrap_dir / "ca.crt")
    # CA-signed identity matters, hostname does not (containers dial by IP)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def register_with_cp(
    bootstrap_dir: Path,
    *,
    host: str,
    port: int = consts.CP_AGENT_PORT,
    timeout: float = 10.0,
) -> dict:
    """Present the assertion JWT; returns the CP's ack payload."""
    if not host:
        raise RegisterError("register: no control-plane host")
    jwt = (bootstrap_dir / "assertion.jwt").read_text().strip()
    ctx = _client_context(bootstrap_dir)
    with socket.create_connection((host, port), timeout=timeout) as raw:
        with ctx.wrap_socket(raw, server_hostname=host) as tls:
            write_msg(tls, {"type": "register", "assertion": jwt})
            reply = read_msg(tls)
    if reply.get("type") != "register_ack" or not reply.get("ok"):
        raise RegisterError(f"register rejected: {reply.get('error', reply)}")
    return reply
