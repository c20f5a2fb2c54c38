"""Online fleet sentinel on PyTorch and CUDA: live anomaly scoring.

The port of ``clawker_tpu/sentinel``: the live collector that fuses
every worker's egress stream (``collector``), the fused 40-dim feature
ABI (``features``), the per-tick ``ScoringEngine`` (one K3 and one K1
launch per scored tick on the GPU), and ``FleetSentinel``, which ticks
them, publishes typed ``anomaly.flag`` bus events, registry metrics and
``sentinel.tick`` spans, and persists its baselines per run.  Strictly
observe-only: flags never feed breakers or placement.

Surfaces: ``python -m clawker_tpu_torch fleet anomaly`` (one-shot /
--watch / --format json) and ``python -m clawker_tpu_torch loop
--sentinel`` (``LoopScheduler.attach_sentinel``).  The daemons'
sentinels are not ported yet.
"""

from .collector import StreamCollector, wire_fleet
from .engine import DEFAULT_THRESHOLD, ScoringEngine, TickReport
from .features import BEHAVIOR_FEATURES, EXT_FEATURES, BehaviorTracker, featurize_fused
from .sentinel import STATE_DIR, FleetSentinel, state_path

__all__ = [
    "BEHAVIOR_FEATURES",
    "BehaviorTracker",
    "DEFAULT_THRESHOLD",
    "EXT_FEATURES",
    "FleetSentinel",
    "STATE_DIR",
    "ScoringEngine",
    "StreamCollector",
    "TickReport",
    "featurize_fused",
    "state_path",
    "wire_fleet",
]
