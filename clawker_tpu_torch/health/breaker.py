"""Per-worker circuit breaker: closed -> open -> half-open -> closed.

The port's copy of ``clawker_tpu/health/breaker.py``, whole.

One breaker per pod worker, driven by the health prober (probe
successes/failures) and by scheduler signals (a wedged lane trips it
directly).  The state machine is the classic one:

- **closed** -- worker is serving.  K consecutive failures open it.
- **open** -- worker is quarantined; no probes until the backoff
  deadline.  Backoff grows exponentially per consecutive open (with
  jitter, so a pod of breakers re-probing a recovering daemon doesn't
  stampede it) and is capped.
- **half-open** -- backoff expired; trial probes run.  M consecutive
  successes close the breaker (the worker rejoins the placement set);
  any failure re-opens it with a deeper backoff.

Thread-safety: state mutations ride one lock; transition callbacks fire
OUTSIDE it (the monitor's callback publishes events and re-enters
scheduler code -- holding the breaker lock across that would couple
every prober to event-sink latency).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


@dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3      # K consecutive failures -> open
    backoff_base_s: float = 1.0     # first open's re-probe delay
    backoff_max_s: float = 30.0     # cap for repeated opens
    backoff_jitter: float = 0.2     # +/- fraction of the delay
    half_open_successes: int = 2    # M trial successes -> closed


class CircuitBreaker:
    """One worker's serve/quarantine state machine."""

    def __init__(self, name: str, config: BreakerConfig | None = None, *,
                 on_transition=None, clock=time.monotonic,
                 rng: random.Random | None = None):
        self.name = name
        self.config = config or BreakerConfig()
        self.on_transition = on_transition   # (name, old, new, reason)
        self._clock = clock
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._failures = 0          # consecutive, while closed
        self._half_open_ok = 0      # consecutive trial successes
        self._open_streak = 0       # consecutive opens since last close
        self._open_until = 0.0
        self.last_error = ""

    # ------------------------------------------------------------- queries

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "failures": self._failures,
                "open_streak": self._open_streak,
                "retry_in_s": (max(0.0, self._open_until - self._clock())
                               if self._state == BREAKER_OPEN else 0.0),
                "last_error": self.last_error,
            }

    def probe_due(self) -> bool:
        """Should a probe run now?  Open breakers sit out their backoff;
        the first call past the deadline transitions to half-open (the
        probe that follows is the trial)."""
        fire = None
        with self._lock:
            if self._state != BREAKER_OPEN:
                return True
            if self._clock() < self._open_until:
                return False
            self._state = BREAKER_HALF_OPEN
            self._half_open_ok = 0
            fire = (BREAKER_OPEN, BREAKER_HALF_OPEN, "backoff expired")
        self._fire(*fire)
        return True

    # ----------------------------------------------------------- verdicts

    def record_success(self) -> None:
        fire = None
        with self._lock:
            if self._state == BREAKER_CLOSED:
                self._failures = 0
                self.last_error = ""    # a below-threshold blip is over;
                #                         don't show it as current state
            elif self._state == BREAKER_HALF_OPEN:
                self._half_open_ok += 1
                if self._half_open_ok >= self.config.half_open_successes:
                    self._state = BREAKER_CLOSED
                    self._failures = 0
                    self._open_streak = 0
                    self.last_error = ""
                    fire = (BREAKER_HALF_OPEN, BREAKER_CLOSED,
                            f"{self._half_open_ok} trial probes ok")
            # success while OPEN: stale signal from before the trip; ignore
        if fire:
            self._fire(*fire)

    def record_failure(self, reason: str = "") -> None:
        fire = None
        with self._lock:
            self.last_error = reason
            if self._state == BREAKER_CLOSED:
                self._failures += 1
                if self._failures >= self.config.failure_threshold:
                    fire = self._open_locked(
                        reason or f"{self._failures} consecutive failures")
            elif self._state == BREAKER_HALF_OPEN:
                # one failed trial re-quarantines with a deeper backoff
                fire = self._open_locked(reason or "half-open trial failed")
        if fire:
            self._fire(*fire)

    def trip(self, reason: str = "") -> None:
        """Immediate open from any state (a wedged lane is conclusive --
        no need to wait out K probe failures)."""
        fire = None
        with self._lock:
            if self._state != BREAKER_OPEN:
                self.last_error = reason
                fire = self._open_locked(reason or "tripped")
        if fire:
            self._fire(*fire)

    # ------------------------------------------------------------ internals

    def _open_locked(self, reason: str) -> tuple[str, str, str]:
        old = self._state
        self._state = BREAKER_OPEN
        self._open_streak += 1
        cfg = self.config
        delay = min(cfg.backoff_base_s * (2 ** (self._open_streak - 1)),
                    cfg.backoff_max_s)
        delay *= 1.0 + cfg.backoff_jitter * (2.0 * self._rng.random() - 1.0)
        self._open_until = self._clock() + delay
        self._failures = 0
        return (old, BREAKER_OPEN, reason)

    def _fire(self, old: str, new: str, reason: str) -> None:
        if self.on_transition is not None:
            self.on_transition(self.name, old, new, reason)
