"""Per-subsystem OTLP log lanes, optionally over mTLS.

Each control-plane subsystem (cp, netlogger, firewall, dnsgate, ...)
gets its OWN OTLP/HTTP lane with ``service.name`` identifying it --
that is what routes its records into the right OpenSearch index
(monitor/stack.py routing connector).  When the collector terminates
TLS, the lane authenticates with a per-subsystem infra client cert
minted from the deployment's identity CA: a compromised agent container
cannot impersonate a CP subsystem's telemetry without the CA.

Parity reference: controlplane/otel (NewOtelLoggerProvider per
subsystem) + controlplane/otelcerts + controlplane/infracerts (client
certs for OTLP-over-mTLS lanes, SURVEY.md 2.7) -- re-derived over
urllib + ssl.

The port's copy of ``clawker_tpu/controlplane/otel.py``, whole but for
one departure: :mod:`..firewall.pki` (and with it ``cryptography``) is
imported inside :func:`mint_infra_cert`, so a plain ``http://`` lane
never loads it, and an ``https://`` lane on a host without
``cryptography`` raises a :class:`ConfigError` that names the package
instead of falling back to plain HTTP.
"""

from __future__ import annotations

import json
import logging
import ssl
import threading
import time
import urllib.request as urlrequest
from pathlib import Path

from .. import logsetup
from ..errors import ConfigError

log = logsetup.get("cp.otel")


def otlp_logs_payload(service: str, records: list[dict], *,
                      severity_of=None) -> bytes:
    """The OTLP/HTTP JSON logs envelope for one subsystem's batch."""
    severity_of = severity_of or (lambda rec: "INFO")
    return json.dumps({
        "resourceLogs": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": service},
            }]},
            "scopeLogs": [{
                "logRecords": [{
                    "timeUnixNano": str(time.time_ns()),
                    "severityText": severity_of(rec),
                    "body": {"stringValue": json.dumps(rec)},
                } for rec in records]
            }],
        }]
    }).encode()


def mint_infra_cert(pki_dir: Path, subsystem: str) -> tuple[Path, Path, Path]:
    """Per-subsystem client cert from the deployment CA.  Returns
    (cert, key, ca) file paths, minting on first use (reference
    infracerts.EnsureClientCert)."""
    try:
        from ..firewall import pki
    except ImportError as e:
        raise ConfigError(
            f"OTLP lane {subsystem}: an https:// collector needs client "
            f"certs, which need the 'cryptography' package ({e})") from e
    ca = pki.ensure_ca(Path(pki_dir))
    certs = Path(pki_dir) / "infra"
    certs.mkdir(parents=True, exist_ok=True)
    cert_p = certs / f"{subsystem}.crt"
    key_p = certs / f"{subsystem}.key"
    ca_p = Path(pki_dir) / "ca.crt"
    if not (cert_p.exists() and key_p.exists()):
        pair = pki.generate_client_cert(ca, f"clawker-otel-{subsystem}")
        cert_p.write_bytes(pair.cert_pem)
        key_p.write_bytes(pair.key_pem)
    if not ca_p.exists():
        ca_p.write_bytes(ca.cert_pem)
    return cert_p, key_p, ca_p


class OtlpLane:
    """One subsystem's lane to the collector.

    Plain HTTP for loopback/tunneled collectors; https endpoints verify
    the server against ``ca`` and authenticate with the client pair.
    Shipping is best-effort and never raises into the caller -- a downed
    collector degrades telemetry, not the subsystem."""

    def __init__(self, endpoint: str, service: str, *,
                 client_cert: Path | None = None,
                 client_key: Path | None = None,
                 ca: Path | None = None,
                 timeout: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.service = service
        self.timeout = timeout
        self._ctx: ssl.SSLContext | None = None
        if self.endpoint.startswith("https://"):
            self._ctx = ssl.create_default_context(
                cafile=str(ca) if ca else None)
            if client_cert and client_key:
                self._ctx.load_cert_chain(str(client_cert), str(client_key))

    def ship(self, records: list[dict], *, severity_of=None) -> bool:
        if not records or not self.endpoint:
            return False
        body = otlp_logs_payload(self.service, records,
                                 severity_of=severity_of)
        req = urlrequest.Request(
            f"{self.endpoint}/v1/logs", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            urlrequest.urlopen(req, timeout=self.timeout,
                               context=self._ctx).close()
            return True
        except Exception as e:  # noqa: BLE001 - contract: telemetry never
            # raises into the caller (urlopen surfaces ValueError/
            # InvalidURL/HTTPException beyond OSError)
            log.debug("otlp lane %s: ship failed: %s", self.service, e)
            return False

    # ------------------------------------------------------ logging lane

    def handler(self, *, level: int = logging.INFO,
                batch: int = 32, flush_s: float = 2.0) -> logging.Handler:
        """A logging.Handler that batches records onto this lane."""
        return _LaneHandler(self, level=level, batch=batch, flush_s=flush_s)


class _LaneHandler(logging.Handler):
    """Batching handler with a background shipper.

    ``emit`` only appends under the lock -- network I/O never happens on
    the logging caller's thread (Handler.handle holds the handler lock
    around emit; synchronous shipping there would stall every thread
    logging to the same logger for up to the lane timeout).  A daemon
    thread ships when the batch fills or flush_s elapses, so a quiet
    daemon's sub-batch records still reach the collector."""

    def __init__(self, lane: OtlpLane, *, level: int, batch: int,
                 flush_s: float):
        super().__init__(level=level)
        self.lane = lane
        self.batch = batch
        self.flush_s = flush_s
        self._buf: list[dict] = []
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._pump,
                                        name=f"otel-{lane.service}",
                                        daemon=True)
        self._thread.start()

    def emit(self, record: logging.LogRecord) -> None:
        rec = {"logger": record.name, "level": record.levelname,
               "message": record.getMessage()}
        with self._cond:
            self._buf.append(rec)
            if len(self._buf) >= self.batch:
                self._cond.notify()

    def _drain(self) -> list[dict]:
        out, self._buf = self._buf, []
        return out

    def _pump(self) -> None:
        while True:
            with self._cond:
                self._cond.wait(self.flush_s)
                if self._closed and not self._buf:
                    return
                out = self._drain()
            if out:
                self.lane.ship(out,
                               severity_of=lambda r: r.get("level", "INFO"))

    def flush(self) -> None:
        with self._cond:
            out = self._drain()
        if out:
            self.lane.ship(out, severity_of=lambda r: r.get("level", "INFO"))

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()
        self.flush()
        super().close()


def build_lanes(cfg, subsystems: tuple[str, ...] = (
        "clawkercp", "ebpf-egress", "clawker-dnsgate")) -> dict[str, OtlpLane]:
    """The CP's lane set.  Endpoint from CLAWKER_TPU_OTLP (worker tunnel)
    or local collector when monitoring is enabled; https endpoints get
    per-subsystem infra certs from the deployment PKI."""
    import os

    from .. import consts

    endpoint = os.environ.get("CLAWKER_TPU_OTLP", "") or (
        f"http://127.0.0.1:{consts.OTLP_HTTP_PORT}"
        if cfg.settings.monitoring.enable else "")
    if not endpoint:
        return {}
    lanes: dict[str, OtlpLane] = {}
    pki_dir = cfg.data_dir / "pki"
    for sub in subsystems:
        cert = key = ca = None
        if endpoint.startswith("https://"):
            cert, key, ca = mint_infra_cert(pki_dir, sub)
        lanes[sub] = OtlpLane(endpoint, sub, client_cert=cert,
                              client_key=key, ca=ca)
    return lanes
