"""Fleet sentinel scoring on PyTorch and CUDA.

The port of the scoring half of ``clawker_tpu/sentinel``: the fused
40-dim feature ABI (``features``) and the per-tick ``ScoringEngine``.
The live collector and the sentinel loop are not ported yet.
"""

from .engine import DEFAULT_THRESHOLD, ScoringEngine, TickReport
from .features import BEHAVIOR_FEATURES, EXT_FEATURES, BehaviorTracker, featurize_fused

__all__ = [
    "BEHAVIOR_FEATURES",
    "BehaviorTracker",
    "DEFAULT_THRESHOLD",
    "EXT_FEATURES",
    "ScoringEngine",
    "TickReport",
    "featurize_fused",
]
