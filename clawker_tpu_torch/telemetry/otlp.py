"""Ship registry snapshots over the control plane's OTLP lanes.

The reference clawker's monitoring stack ingests everything through an
OTel Collector; our CP subsystems already hold per-subsystem OTLP/HTTP
lanes (controlplane/otel.py, mTLS-capable).  Fleet metrics ride the
same transport: a shipper thread snapshots the registry every
``interval_s`` and POSTs the samples as one batch on a
``clawker-telemetry`` lane, so the collector-side routing that indexes
CP logs needs zero new endpoints to pick up fleet metrics.

Shipping is best-effort by the lane's contract -- a downed collector
degrades telemetry, never the loop run.

The port's copy of ``clawker_tpu/telemetry/otlp.py``, whole.
"""

from __future__ import annotations

import threading

from .. import logsetup
from .registry import REGISTRY, MetricsRegistry

log = logsetup.get("telemetry.otlp")

TELEMETRY_SUBSYSTEM = "clawker-telemetry"
DEFAULT_INTERVAL_S = 10.0


def telemetry_lane(cfg):
    """The fleet-telemetry OTLP lane for this deployment, or None when
    no collector endpoint is configured (CLAWKER_TPU_OTLP env / local
    monitoring stack) -- same resolution as the CP's own lanes."""
    from ..controlplane.otel import build_lanes

    return build_lanes(cfg, (TELEMETRY_SUBSYSTEM,)).get(TELEMETRY_SUBSYSTEM)


class MetricsOtlpShipper:
    """Periodic registry -> OTLP batches on a daemon thread.

    ``lane`` is any object with ``ship(records) -> bool``
    (controlplane.otel.OtlpLane in production, a list-appender in
    tests).  ``stop()`` ships one final snapshot so a short run's
    metrics are never lost to the interval."""

    def __init__(self, lane, *, registry: MetricsRegistry | None = None,
                 interval_s: float = DEFAULT_INTERVAL_S):
        self.lane = lane
        self.registry = registry if registry is not None else REGISTRY
        self.interval_s = interval_s
        self.shipped_batches = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def ship_once(self) -> bool:
        records = self.registry.snapshot()
        if not records:
            return False
        try:
            ok = bool(self.lane.ship(records))
        except Exception as e:   # noqa: BLE001 -- lane contract: never raise
            log.debug("telemetry otlp ship failed: %s", e)
            return False
        if ok:
            self.shipped_batches += 1
        return ok

    def start(self) -> "MetricsOtlpShipper":
        if self._thread is not None:
            return self
        self._stop.clear()

        def pump() -> None:
            while not self._stop.wait(self.interval_s):
                self.ship_once()

        self._thread = threading.Thread(target=pump, name="telemetry-otlp",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.ship_once()    # final flush: short runs still land a batch
