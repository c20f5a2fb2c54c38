"""Telemetry-derived capacity signals: rate estimation + registry deltas.

The port's copy of ``clawker_tpu/capacity/signals.py``, whole.

The controller never instruments the hot path itself -- the scheduler,
warm pool, and admission controller already record into the process
:data:`~clawker_tpu_torch.telemetry.REGISTRY` (warm_pool_{hits,misses}_total,
placement_admission_wait_seconds, ...).  :class:`RegistrySampler`
diff-samples those cumulative series per controller tick, and
:class:`EwmaRate` turns the per-tick deltas into a smoothed arrival
rate.

The rate EWMA is deliberately asymmetric: a burst must grow capacity
within a tick or two (``alpha_up``), while the decay back to the quiet
baseline is slow (``alpha_down``) so a bursty trace's SECOND burst
finds the pools already sized -- shrinking eagerly would re-pay every
burst's cold misses forever, which is exactly the p99 the elastic bench
gates (bench.py ``elastic_vs_static_p99``).
"""

from __future__ import annotations

from .. import telemetry

DEFAULT_ALPHA_UP = 0.5
DEFAULT_ALPHA_DOWN = 0.08


class EwmaRate:
    """Asymmetric exponentially-weighted rate (events/second).

    ``observe(count, dt)`` folds one tick's event count over ``dt``
    seconds into the estimate: increases blend at ``alpha_up``,
    decreases at ``alpha_down``.  With a constant input rate the
    estimate converges to it from either side (tests/test_capacity.py
    proves convergence and the asymmetry).
    """

    def __init__(self, alpha_up: float = DEFAULT_ALPHA_UP,
                 alpha_down: float = DEFAULT_ALPHA_DOWN):
        self.alpha_up = min(1.0, max(0.0, float(alpha_up)))
        self.alpha_down = min(1.0, max(0.0, float(alpha_down)))
        self.value = 0.0
        self._seen = False

    def observe(self, count: float, dt: float) -> float:
        if dt <= 0:
            return self.value
        rate = max(0.0, float(count)) / dt
        if not self._seen:
            # first sample seeds the estimate: blending against the 0.0
            # prior would under-size the pool for the whole ramp-up
            self._seen = True
            self.value = rate
            return self.value
        alpha = self.alpha_up if rate > self.value else self.alpha_down
        self.value += alpha * (rate - self.value)
        return self.value


class RegistrySampler:
    """Per-tick deltas of cumulative registry series, keyed by label.

    ``delta(metric, label_index)`` returns ``{label_value: increase}``
    since the previous call for that metric -- the first call primes
    the baseline and returns zeros (a controller attached mid-run must
    not read the whole history as one giant burst).  Histogram series
    yield ``(count_delta, sum_delta)`` via :meth:`hist_delta`.
    """

    def __init__(self, registry=None):
        self._registry = registry if registry is not None else telemetry.REGISTRY
        self._last: dict[tuple[str, str], float] = {}
        self._last_hist: dict[tuple[str, str], tuple[float, float]] = {}
        self._primed: set[str] = set()  # metrics sampled at least once:
        #                                 a series BORN after that point
        #                                 is entirely new traffic, not
        #                                 history to be skipped

    def _rows(self, metric: str) -> list[dict]:
        return [r for r in self._registry.snapshot() if r["metric"] == metric]

    def delta(self, metric: str, label: str) -> dict[str, float]:
        out: dict[str, float] = {}
        primed = metric in self._primed
        for row in self._rows(metric):
            key_val = str(row["labels"].get(label, ""))
            key = (metric, key_val)
            prev = self._last.get(key)
            cur = float(row["value"])
            self._last[key] = cur
            if prev is not None:
                # max(0, ...): a registry reset (tests/bench) must read
                # as "no events", never as a negative arrival count
                out[key_val] = max(0.0, cur - prev)
            else:
                out[key_val] = cur if primed else 0.0
        self._primed.add(metric)
        return out

    def hist_delta(self, metric: str, label: str
                   ) -> dict[str, tuple[float, float]]:
        """{label: (observations delta, sum delta)} for a histogram."""
        out: dict[str, tuple[float, float]] = {}
        hkey = f"{metric}#hist"
        primed = hkey in self._primed
        for row in self._rows(metric):
            if row.get("kind") != "histogram":
                continue
            key_val = str(row["labels"].get(label, ""))
            key = (metric, key_val)
            prev = self._last_hist.get(key)
            cur = (float(row["value"]), float(row.get("sum", 0.0)))
            self._last_hist[key] = cur
            if prev is not None:
                out[key_val] = (max(0.0, cur[0] - prev[0]),
                                max(0.0, cur[1] - prev[1]))
            else:
                out[key_val] = cur if primed else (0.0, 0.0)
        self._primed.add(hkey)
        return out
