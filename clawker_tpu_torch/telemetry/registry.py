"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``clawker_tpu/telemetry/registry.py``.  The port's ``REGISTRY``
is its own: a process that imports both packages holds two registries.

The fleet's telemetry used to live in three disconnected fragments: the
``util/phases`` stopwatch (bench-only, enable/disable around a run),
ad-hoc counters inside ``engine/pool.py``'s stats dict, and per-worker
count dicts in ``health/monitor.py``.  None of them could answer "what
is the engine's request latency per verb right now" without a re-run.
This registry subsumes them: every subsystem registers named metrics
once at import time and records into them on the hot path; consumers
(the Prometheus endpoint, the OTLP shipper, ``clawker fleet health``)
read consistent snapshots.

Design constraints, in order:

- **Hot-path cost.**  A record is one enabled-flag read, one dict hit
  on the child cache (only on first use per label set), and one
  striped-lock increment.  ``set_enabled(False)`` turns every record
  into a single attribute check -- bench.py's ``telemetry_overhead_ns``
  gates both paths so instrumentation can never silently regress the
  cold-start budget.
- **Lock striping.**  One global lock would couple every lane, waiter,
  prober, and the scrape handler; per-child locks would allocate one
  lock per label set.  Children hash onto a fixed stripe array instead:
  concurrent writers to DIFFERENT metrics almost never contend, and a
  scrape takes the stripes one at a time, never stopping the world.
- **Fixed buckets.**  Histograms pre-declare their bucket bounds, so
  ``observe`` is a linear scan over a small tuple (latency histograms
  here have <= 14 bounds) and exposition needs no merging.

Not a tracing system -- spans live in :mod:`.spans`.
``util/phases`` stays for bench cold-start attribution (its
enable/around-a-run contract is different); new instrumentation should
land here.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

N_STRIPES = 16

# Default latency buckets (seconds): spans dial-on-unix (~100us) through
# a wedged-SSH probe deadline (multi-second).
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_KIND_COUNTER = "counter"
_KIND_GAUGE = "gauge"
_KIND_HISTOGRAM = "histogram"


def _format_value(v: float) -> str:
    """Prometheus sample formatting: integers without the trailing .0."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _label_str(labelnames: tuple[str, ...], labelvalues: tuple[str, ...],
               extra: str = "") -> str:
    pairs = [f'{k}="{_escape(v)}"' for k, v in zip(labelnames, labelvalues)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Child:
    """One (metric, label-values) time series.  All mutation rides the
    stripe lock the registry assigned at creation."""

    __slots__ = ("_metric", "labelvalues", "_lock", "value",
                 "bucket_counts", "sum")

    def __init__(self, metric: "Metric", labelvalues: tuple[str, ...],
                 lock: threading.Lock):
        self._metric = metric
        self.labelvalues = labelvalues
        self._lock = lock
        self.value = 0.0
        if metric.kind == _KIND_HISTOGRAM:
            self.bucket_counts = [0] * (len(metric.buckets) + 1)  # +Inf last
            self.sum = 0.0

    # ------------------------------------------------------------ counter

    def inc(self, n: float = 1.0) -> None:
        if not self._metric.registry.enabled:
            return
        with self._lock:
            self.value += n

    # -------------------------------------------------------------- gauge

    def set(self, v: float) -> None:
        if not self._metric.registry.enabled:
            return
        with self._lock:
            self.value = v

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    # ---------------------------------------------------------- histogram

    def observe(self, v: float) -> None:
        if not self._metric.registry.enabled:
            return
        idx = bisect_left(self._metric.buckets, v)
        with self._lock:
            self.bucket_counts[idx] += 1
            self.value += 1          # observation count
            self.sum += v

    # ----------------------------------------------------------- snapshot

    def peek(self) -> float:
        with self._lock:
            return self.value


class Metric:
    """A named metric family; label sets materialize children on demand."""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 kind: str, labelnames: tuple[str, ...],
                 buckets: tuple[float, ...] = ()):
        self.registry = registry
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = labelnames
        self.buckets = tuple(sorted(buckets)) if kind == _KIND_HISTOGRAM else ()
        self._children: dict[tuple[str, ...], _Child] = {}
        self._children_lock = threading.Lock()
        if not labelnames:
            self._default = self._child(())

    def _child(self, labelvalues: tuple[str, ...]) -> _Child:
        child = self._children.get(labelvalues)
        if child is not None:
            return child
        with self._children_lock:
            child = self._children.get(labelvalues)
            if child is None:
                child = _Child(self, labelvalues,
                               self.registry._stripe(self.name, labelvalues))
                self._children[labelvalues] = child
            return child

    def labels(self, *labelvalues: str, **labelkw: str) -> _Child:
        if labelkw:
            labelvalues = tuple(str(labelkw[k]) for k in self.labelnames)
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name}: got {len(labelvalues)} label values "
                f"for labels {self.labelnames}")
        return self._child(labelvalues)

    # unlabeled convenience: metric.inc() / .set() / .observe()
    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    def set(self, v: float) -> None:
        self._default.set(v)

    def observe(self, v: float) -> None:
        self._default.observe(v)

    def children(self) -> list[_Child]:
        with self._children_lock:
            return list(self._children.values())


class MetricsRegistry:
    """Named-metric store with striped locks and consistent-enough reads.

    Registration is idempotent: a second ``counter(name, ...)`` returns
    the existing family (so modules can declare their metrics at import
    time without ordering constraints), but re-registering a name as a
    different kind is a programming error and raises.
    """

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()
        self._stripes = [threading.Lock() for _ in range(N_STRIPES)]

    # --------------------------------------------------------- registration

    def _register(self, name: str, help: str, kind: str,
                  labelnames: tuple[str, ...],
                  buckets: tuple[float, ...] = ()) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}")
                return m
            m = Metric(self, name, help, kind, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Metric:
        return self._register(name, help, _KIND_COUNTER, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Metric:
        return self._register(name, help, _KIND_GAUGE, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS) -> Metric:
        return self._register(name, help, _KIND_HISTOGRAM, tuple(labels),
                              buckets)

    def _stripe(self, name: str, labelvalues: tuple[str, ...]) -> threading.Lock:
        return self._stripes[hash((name, labelvalues)) % N_STRIPES]

    # -------------------------------------------------------------- control

    def set_enabled(self, enabled: bool) -> None:
        """Global record gate.  Metric handles stay valid either way;
        disabled records cost one attribute read."""
        self.enabled = enabled

    def reset(self) -> None:
        """Zero every series in place (tests, bench).  Handles cached at
        module import keep working -- values reset, identity doesn't."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for c in m.children():
                with c._lock:
                    c.value = 0.0
                    if m.kind == _KIND_HISTOGRAM:
                        c.bucket_counts = [0] * (len(m.buckets) + 1)
                        c.sum = 0.0

    # ------------------------------------------------------------ consumers

    def snapshot(self) -> list[dict]:
        """Point-in-time sample list (OTLP shipper, fleet health).
        Consistent per series; the set of series is whatever existed when
        the snapshot started."""
        out: list[dict] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            for c in sorted(m.children(), key=lambda c: c.labelvalues):
                labels = dict(zip(m.labelnames, c.labelvalues))
                with c._lock:
                    row = {"metric": m.name, "kind": m.kind, "labels": labels,
                           "value": c.value}
                    if m.kind == _KIND_HISTOGRAM:
                        row["sum"] = c.sum
                        row["buckets"] = dict(zip(
                            [*map(str, m.buckets), "+Inf"],
                            list(c.bucket_counts)))
                out.append(row)
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every series."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            children = sorted(m.children(), key=lambda c: c.labelvalues)
            if not children:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for c in children:
                if m.kind == _KIND_HISTOGRAM:
                    with c._lock:
                        counts = list(c.bucket_counts)
                        total, s = c.value, c.sum
                    acc = 0
                    for bound, n in zip(m.buckets, counts):
                        acc += n
                        le = 'le="' + _format_value(bound) + '"'
                        labels = _label_str(m.labelnames, c.labelvalues, le)
                        lines.append(f"{m.name}_bucket{labels} {acc}")
                    labels = _label_str(m.labelnames, c.labelvalues,
                                        'le="+Inf"')
                    lines.append(f"{m.name}_bucket{labels} {int(total)}")
                    lines.append(
                        f"{m.name}_sum{_label_str(m.labelnames, c.labelvalues)}"
                        f" {repr(s)}")
                    lines.append(
                        f"{m.name}_count{_label_str(m.labelnames, c.labelvalues)}"
                        f" {int(total)}")
                else:
                    lines.append(
                        f"{m.name}{_label_str(m.labelnames, c.labelvalues)}"
                        f" {_format_value(c.peek())}")
        return "\n".join(lines) + ("\n" if lines else "")


# The process-wide default registry.  Subsystems register against this
# at import time; `telemetry.REGISTRY` is the single scrape/ship source.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: tuple[str, ...] = ()) -> Metric:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: tuple[str, ...] = ()) -> Metric:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: tuple[str, ...] = (),
              buckets: tuple[float, ...] = LATENCY_BUCKETS) -> Metric:
    return REGISTRY.histogram(name, help, labels, buckets)
