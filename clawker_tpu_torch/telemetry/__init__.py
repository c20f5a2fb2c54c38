"""Fleet telemetry: the metrics registry and trace spans.

The port's copy of ``clawker_tpu/telemetry``'s registry and spans
modules.  The Prometheus endpoint (``httpserv``) and the OTLP shipper
(``otlp``) are not ported yet.
"""

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
    "LATENCY_BUCKETS", "REGISTRY", "MetricsRegistry", "counter", "gauge",
    "histogram", "SPAN_CREATE", "SPAN_EXIT", "SPAN_ITERATION",
    "SPAN_MIGRATE", "SPAN_ORPHAN", "SPAN_SENTINEL_TICK", "SPAN_START",
    "SPAN_WAIT", "SpanNode", "SpanRecord", "Tracer", "build_trees",
    "load_spans", "tree_to_dict",
]
