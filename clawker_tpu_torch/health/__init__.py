"""Fleet health & failover: per-worker probes, circuit breakers, verdicts.

The port's copy of ``clawker_tpu/health/__init__.py``, whole.

The pod-scale counterpart of the per-worker lanes (ISSUE 1) and the
connection pool (ISSUE 2): those isolate and cheapen a wedged or dead
worker engine, this subsystem *detects* it, reports it, and lets the
loop scheduler move the stranded agent loops.  Production cluster
managers treat machine failure as the common case (Borg, EuroSys 2015)
and recover by restarting from clean state instead of diagnosing in
place (crash-only software, HotOS 2003) -- the breaker + migration
model here follows that shape.
"""

from .breaker import BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN, BreakerConfig, CircuitBreaker
from .monitor import HealthConfig, HealthMonitor, ProbeResult

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "BreakerConfig",
    "CircuitBreaker",
    "HealthConfig",
    "HealthMonitor",
    "ProbeResult",
]
