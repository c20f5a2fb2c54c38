"""Per-agent identity: bootstrap material minting, assertion JWTs, delivery.

The port's copy of ``clawker_tpu/controlplane/identity.py``, whole,
over the port's ``firewall/pki.py``.  It imports ``cryptography`` at
the top as the reference does; the CLI's factory imports this module
only when a create runs, so ``ps`` and ``stop`` never load it.

Parity reference: internal/cmd/container/shared/agent_bootstrap.go:153
InstallAgentBootstrapMaterial -- between create and start the CLI mints a
per-agent mTLS leaf plus an assertion JWT and tars them into the container
at /run/clawker/bootstrap; agentd's boot reads exactly these files.  The
reference gets its assertion from Ory Hydra; this build self-issues an
ES256 JWT signed by the firewall CA key (the CP verifies with the CA public
key), which keeps the AdminService/Register contract without the Ory triple
(SURVEY.md section 7 step 5 explicitly defers it).
"""

from __future__ import annotations

import base64
import io
import json
import secrets
import tarfile
import threading
import time
from dataclasses import dataclass

from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import (
    decode_dss_signature,
    encode_dss_signature,
)

from .. import consts
from ..errors import ClawkerError
from ..firewall import pki
from ..util import phases

ASSERTION_TTL_S = 24 * 3600

# --- CA session cache: per-agent leaf certs keyed by (CA cert, agent
# full name).  Leaf minting (EC keygen + cert sign) dominated the
# identity_bootstrap cold-start stage (BENCH_r05: 7.0ms of an 8.95ms
# framework cold start); the leaf's CN/SAN is project.agent -- no
# container id -- so a warm placement (loop restart, migration,
# re-create, resume) can reuse it while the assertion JWT and session
# key stay per-container.  Keying by the CA cert PEM makes rotation
# self-invalidating: rotate_ca yields a new PEM, so every cached leaf
# of the retired root simply stops being found.
_LEAF_CACHE: dict[tuple[bytes, str], "pki.CertPair"] = {}
_LEAF_CACHE_MAX = 1024          # ~1KB/entry; a 64-agent pod uses 64
_leaf_lock = threading.Lock()


def _leaf_for(ca: pki.CA, fname: str, *, reuse: bool = True) -> pki.CertPair:
    if not reuse:
        return pki.generate_agent_cert(ca, fname)
    key = (ca.cert_pem, fname)
    with _leaf_lock:
        leaf = _LEAF_CACHE.get(key)
    phases.incr("identity.leaf_cache_hit" if leaf is not None
                else "identity.leaf_cache_miss")
    if leaf is None:
        leaf = pki.generate_agent_cert(ca, fname)
        with _leaf_lock:
            if len(_LEAF_CACHE) >= _LEAF_CACHE_MAX:
                _LEAF_CACHE.clear()
            _LEAF_CACHE[key] = leaf
    return leaf


def prewarm_identities(ca: pki.CA, project: str, agents) -> int:
    """Pre-mint leaf certs into the session cache for the given agent
    names (fleet fan-outs call this once up front so every placement's
    identity_bootstrap is a cache hit).  Returns how many were minted
    (already-warm agents cost nothing)."""
    minted = 0
    for agent in agents:
        fname = full_name(project, agent)
        key = (ca.cert_pem, fname)
        with _leaf_lock:
            warm = key in _LEAF_CACHE
        if not warm:
            _leaf_for(ca, fname)
            minted += 1
    return minted


def clear_identity_cache() -> None:
    """Drop every cached leaf (tests; explicit revocation sweeps)."""
    with _leaf_lock:
        _LEAF_CACHE.clear()


class IdentityError(ClawkerError):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def sign_jwt_es256(key: ec.EllipticCurvePrivateKey, claims: dict) -> str:
    """Compact ES256 JWT (raw r||s signature per RFC 7518 3.4)."""
    header = _b64url(json.dumps({"alg": "ES256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    der = key.sign(signing_input, ec.ECDSA(hashes.SHA256()))
    r, s = decode_dss_signature(der)
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return f"{header}.{payload}.{_b64url(sig)}"


def verify_jwt_es256(pub: ec.EllipticCurvePublicKey, token: str, *, now: float | None = None) -> dict:
    """Verify signature + exp/iat; returns claims or raises IdentityError."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_dec(header_b64))
        if header.get("alg") != "ES256":
            raise IdentityError(f"unexpected JWT alg {header.get('alg')!r}")
        raw = _b64url_dec(sig_b64)
        if len(raw) != 64:
            raise IdentityError("malformed ES256 signature")
        der = encode_dss_signature(int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big"))
        pub.verify(der, f"{header_b64}.{payload_b64}".encode(), ec.ECDSA(hashes.SHA256()))
        claims = json.loads(_b64url_dec(payload_b64))
    except IdentityError:
        raise
    except Exception as e:
        raise IdentityError(f"invalid assertion JWT: {e}") from None
    t = time.time() if now is None else now
    if claims.get("exp") is not None and t > float(claims["exp"]):
        raise IdentityError("assertion JWT expired")
    if claims.get("iat") is not None and t < float(claims["iat"]) - 300:
        raise IdentityError("assertion JWT issued in the future")
    return claims


@dataclass
class BootstrapMaterial:
    """The five files agentd boot reads from /run/clawker/bootstrap."""

    agent_cert: bytes       # agent.crt -- mTLS leaf (server+client EKU)
    agent_key: bytes        # agent.key
    ca_cert: bytes          # ca.crt -- trust anchor for the CP dialer
    assertion_jwt: str      # assertion.jwt -- identity proof for Register
    session_key: str        # session.key -- per-agent shared secret (audit HMAC)

    def files(self) -> dict[str, bytes]:
        return {
            "agent.crt": self.agent_cert,
            "agent.key": self.agent_key,
            "ca.crt": self.ca_cert,
            "assertion.jwt": self.assertion_jwt.encode(),
            "session.key": self.session_key.encode(),
        }

    def tar_bytes(self, prefix: str = "") -> bytes:
        """Tar of the bundle.  With ``prefix`` (e.g. ``bootstrap``) the tar
        carries a leading directory entry and prefixed members, so it can be
        extracted at an *existing* parent dir -- real daemons 404 when the
        extraction path itself is missing (reference solves this the same
        way: WriteAgentBootstrapToContainer tars ``bootstrap/`` into
        /run/clawker, agent_bootstrap.go:209)."""
        buf = io.BytesIO()
        now = int(time.time())
        with tarfile.open(fileobj=buf, mode="w") as tf:
            if prefix:
                d = tarfile.TarInfo(prefix)
                d.type = tarfile.DIRTYPE
                d.mode = 0o700
                d.mtime = now
                tf.addfile(d)
            for name, data in self.files().items():
                info = tarfile.TarInfo(f"{prefix}/{name}" if prefix else name)
                info.size = len(data)
                info.mode = 0o600 if name.endswith((".key", ".jwt")) else 0o644
                info.mtime = now
                tf.addfile(info, io.BytesIO(data))
        return buf.getvalue()


def full_name(project: str, agent: str) -> str:
    return f"{project}.{agent}"


def mint_bootstrap_material(
    ca: pki.CA, project: str, agent: str, *, container_id: str = "",
    reuse_leaf: bool = True
) -> BootstrapMaterial:
    """Mint the per-agent identity bundle (leaf + assertion + session key).

    The mTLS leaf rides the CA session cache (warm placements reuse it;
    ``reuse_leaf=False`` forces a fresh keypair); the assertion JWT and
    session key are ALWAYS fresh -- they bind the container id and the
    per-container audit secret."""
    fname = full_name(project, agent)
    with phases.phase("identity_mint_leaf"):
        leaf = _leaf_for(ca, fname, reuse=reuse_leaf)
    now = int(time.time())
    claims = {
        "iss": consts.PRODUCT,
        "sub": fname,
        "project": project,
        "agent": agent,
        "container_id": container_id,
        "iat": now,
        "exp": now + ASSERTION_TTL_S,
        "jti": secrets.token_hex(8),
        "scope": "self.register",
    }
    return BootstrapMaterial(
        agent_cert=leaf.cert_pem,
        agent_key=leaf.key_pem,
        ca_cert=ca.cert_pem,
        assertion_jwt=sign_jwt_es256(ca.key, claims),
        session_key=secrets.token_hex(32),
    )


def install_bootstrap_material(engine, container_ref: str, material: BootstrapMaterial) -> None:
    """Tar the bundle into the created (not yet started) container
    (reference: WriteAgentBootstrapToContainer agent_bootstrap.go:209).
    Extracts at the parent dir with a ``bootstrap/`` directory entry so the
    target need not pre-exist in the image."""
    parent, _, leaf = consts.BOOTSTRAP_DIR.rpartition("/")
    engine.put_archive(container_ref, parent or "/", material.tar_bytes(prefix=leaf))


def make_bootstrapper(cfg, engine, registry=None):
    """The create-path hook: mint + install material, bind the registry row.

    Wired by the CLI factory as ``AgentRuntime.bootstrap`` so every created
    agent container carries identity material before it first starts.
    """

    def hook(container_id: str, project: str, agent: str) -> None:
        ca = pki.ensure_ca(cfg.pki_dir)
        material = mint_bootstrap_material(ca, project, agent, container_id=container_id)
        with phases.phase("identity_install"):
            install_bootstrap_material(engine, container_id, material)
        if registry is not None:
            registry.bind(
                full_name(project, agent),
                project,
                agent,
                container_id=container_id,
                cert_sha256=cert_fingerprint(material.agent_cert),
            )

    return hook


def cert_fingerprint(cert_pem: bytes) -> str:
    """SHA-256 thumbprint of the DER cert, hex -- the registry binding key."""
    from cryptography import x509

    cert = x509.load_pem_x509_certificate(cert_pem)
    return cert.fingerprint(hashes.SHA256()).hex()
