"""PKI: ECDSA P-256 CA, per-domain MITM leaf certs, per-agent client certs.

Parity reference: controlplane/firewall/certs.go (EnsureCA,
GenerateDomainCert, CA rotation) and the per-agent mTLS leaf minting in
internal/cmd/container/shared/agent_bootstrap.go:153.  One CA signs both
the MITM server certs Envoy presents and the client/server certs the
control-plane <-> agentd mTLS mesh uses; rotation rewrites the CA and
invalidates every leaf (callers rebuild images / re-enroll).

The port's copy of ``clawker_tpu/firewall/pki.py``, whole.  It imports
``cryptography`` at the top as the reference does; the OTLP lanes
(``controlplane/otel.py``) load it only for an ``https://`` collector.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

CA_CERT = "ca.crt"
CA_KEY = "ca.key"
CA_DAYS = 3650
LEAF_DAYS = 825


@dataclass
class CertPair:
    cert_pem: bytes
    key_pem: bytes


@dataclass
class CA:
    cert_pem: bytes
    key_pem: bytes

    # parsed forms are cached per CA object: the identity mint path
    # touches .key/.cert on every agent create, and PEM parsing was a
    # measurable share of cold-start (bench stage: bootstrap)
    @cached_property
    def cert(self) -> x509.Certificate:
        return x509.load_pem_x509_certificate(self.cert_pem)

    @cached_property
    def key(self) -> ec.EllipticCurvePrivateKey:
        k = serialization.load_pem_private_key(self.key_pem, password=None)
        assert isinstance(k, ec.EllipticCurvePrivateKey)
        return k


def _key_pem(key: ec.EllipticCurvePrivateKey) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def generate_ca(common_name: str = "clawker-tpu firewall CA") -> CA:
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - datetime.timedelta(minutes=5))
        .not_valid_after(_now() + datetime.timedelta(days=CA_DAYS))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.SubjectKeyIdentifier.from_public_key(key.public_key()), critical=False
        )
        .add_extension(
            x509.KeyUsage(
                digital_signature=True,
                key_cert_sign=True,
                crl_sign=True,
                content_commitment=False,
                key_encipherment=False,
                data_encipherment=False,
                key_agreement=False,
                encipher_only=False,
                decipher_only=False,
            ),
            critical=True,
        )
        .sign(key, hashes.SHA256())
    )
    return CA(cert_pem=cert.public_bytes(serialization.Encoding.PEM), key_pem=_key_pem(key))


_CA_CACHE: dict[tuple, CA] = {}


def ensure_ca(pki_dir: Path) -> CA:
    """Load the CA from ``pki_dir``, generating it on first use.

    Process-cached by (path, mtimes): repeated creates in one process
    (loop fan-out, bench) reuse the same CA object -- and its parsed
    key/cert -- while rotate_ca's unlink+rewrite changes the mtime
    signature and naturally invalidates."""
    cert_p, key_p = pki_dir / CA_CERT, pki_dir / CA_KEY
    try:
        sig = (str(pki_dir), cert_p.stat().st_mtime_ns, key_p.stat().st_mtime_ns)
    except OSError:
        sig = None
    if sig is not None:
        hit = _CA_CACHE.get(sig)
        if hit is not None:
            return hit
    if cert_p.is_file() and key_p.is_file():
        ca = CA(cert_pem=cert_p.read_bytes(), key_pem=key_p.read_bytes())
    else:
        pki_dir.mkdir(parents=True, exist_ok=True)
        ca = generate_ca()
        cert_p.write_bytes(ca.cert_pem)
        key_p.write_bytes(ca.key_pem)
        key_p.chmod(0o600)
        sig = (str(pki_dir), cert_p.stat().st_mtime_ns, key_p.stat().st_mtime_ns)
    if sig is not None:
        if len(_CA_CACHE) > 64:
            _CA_CACHE.clear()
        _CA_CACHE[sig] = ca
    return ca


def rotate_ca(pki_dir: Path) -> CA:
    """Replace the CA (reference: Handler.RotateCA firewall/handler.go:981)."""
    for f in (pki_dir / CA_CERT, pki_dir / CA_KEY):
        if f.exists():
            f.unlink()
    # never trust mtime granularity across a rotation: a same-tick
    # rewrite must not let ensure_ca return the retired root
    _CA_CACHE.clear()
    return ensure_ca(pki_dir)


def _issue(
    ca: CA,
    common_name: str,
    *,
    dns_names: list[str] | None = None,
    server: bool = False,
    client: bool = False,
) -> CertPair:
    key = ec.generate_private_key(ec.SECP256R1())
    ekus = []
    if server:
        ekus.append(ExtendedKeyUsageOID.SERVER_AUTH)
    if client:
        ekus.append(ExtendedKeyUsageOID.CLIENT_AUTH)
    builder = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)]))
        .issuer_name(ca.cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - datetime.timedelta(minutes=5))
        .not_valid_after(_now() + datetime.timedelta(days=LEAF_DAYS))
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .add_extension(x509.ExtendedKeyUsage(ekus), critical=False)
        .add_extension(
            x509.SubjectKeyIdentifier.from_public_key(key.public_key()), critical=False
        )
        .add_extension(
            x509.AuthorityKeyIdentifier.from_issuer_public_key(ca.key.public_key()),
            critical=False,
        )
    )
    if dns_names:
        builder = builder.add_extension(
            x509.SubjectAlternativeName([x509.DNSName(d) for d in dns_names]),
            critical=False,
        )
    cert = builder.sign(ca.key, hashes.SHA256())
    return CertPair(cert_pem=cert.public_bytes(serialization.Encoding.PEM), key_pem=_key_pem(key))


def generate_domain_cert(ca: CA, domain: str) -> CertPair:
    """MITM server cert for one allowed domain (Envoy presents it)."""
    names = [domain] if not domain.startswith("*.") else [domain, domain[2:]]
    return _issue(ca, names[0], dns_names=names, server=True)


def generate_client_cert(ca: CA, common_name: str) -> CertPair:
    """Client-auth-only leaf (infra subsystems dialing mTLS collectors)."""
    return _issue(ca, common_name, dns_names=[common_name], client=True)


def generate_agent_cert(ca: CA, agent_full_name: str) -> CertPair:
    """Per-agent leaf for the agentd mTLS listener (CN = project.agent)."""
    return _issue(ca, agent_full_name, dns_names=[agent_full_name], server=True, client=True)


def generate_cp_cert(ca: CA, *, dns_names: list[str] | None = None) -> CertPair:
    """Control-plane identity (dials agentd as client, serves admin/agent)."""
    return _issue(
        ca,
        "clawker-controlplane",
        dns_names=dns_names or ["clawker-controlplane", "localhost"],
        server=True,
        client=True,
    )
