"""Unified fleet telemetry: metrics registry, trace spans, exporters.

- :mod:`.registry` -- process-wide counters/gauges/histograms behind a
  lock-striped :class:`MetricsRegistry`; ``REGISTRY`` is the process
  default.
- :mod:`.httpserv` -- opt-in local Prometheus scrape endpoint
  (``loop --metrics-port``, loopd's metrics port).
- :mod:`.otlp` -- registry snapshots batched over the control plane's
  OTLP lanes (controlplane/otel.py).
- :mod:`.spans` -- per-iteration span records + tree reconstruction for
  the flight recorder and ``trace``.

The port's copy of ``clawker_tpu/telemetry``, whole.
"""

from .httpserv import MetricsServer
from .otlp import MetricsOtlpShipper, telemetry_lane
from .registry import (
    LATENCY_BUCKETS,
    REGISTRY,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)
from .spans import (
    SPAN_CREATE,
    SPAN_EXIT,
    SPAN_ITERATION,
    SPAN_MIGRATE,
    SPAN_ORPHAN,
    SPAN_SENTINEL_TICK,
    SPAN_START,
    SPAN_WAIT,
    SpanNode,
    SpanRecord,
    Tracer,
    build_trees,
    load_spans,
    tree_to_dict,
)

__all__ = [
    "LATENCY_BUCKETS", "REGISTRY", "MetricsRegistry", "MetricsServer",
    "MetricsOtlpShipper", "telemetry_lane", "counter", "gauge",
    "histogram", "SPAN_CREATE", "SPAN_EXIT", "SPAN_ITERATION",
    "SPAN_MIGRATE", "SPAN_ORPHAN", "SPAN_SENTINEL_TICK", "SPAN_START",
    "SPAN_WAIT", "SpanNode", "SpanRecord", "Tracer", "build_trees",
    "load_spans", "tree_to_dict",
]
