"""Elastic capacity: telemetry-driven warm-pool sizing, SLO-aware

The port's copy of ``clawker_tpu/capacity``, but for ``TPUVMScaler``,
which waits for the ``gpu_host`` driver (ROADMAP §1 item 12b).
admission, and fleet autoscaling (docs/elastic-capacity.md).

Every capacity knob used to be a static setting tuned for one traffic
shape: warm-pool depth, per-worker admission tokens, the fleet size
itself.  This package closes the loop from the metrics registry --
observed arrival rate and hit/miss history size each worker's pool,
measured launch latency scales each worker's token bucket against a
per-tenant latency SLO (reject-with-``retry_after_s`` instead of
unbounded queueing when the SLO is provably unattainable), and
sustained queue depth or idle capacity provisions/drains workers
through the concurrent fleet provisioner.

Layering: rank 2, like :mod:`clawker_tpu_torch.placement` -- the controller
never imports the scheduler or the CLI.  The scheduler (and loopd) wire
it through :class:`CapacityHooks`, a bag of callables over their own
surfaces (pool targets, admission caps, journal, event bus), so every
decision is journaled as ``REC_CAPACITY_*`` records in the run journal
and emitted as typed ``capacity.decision`` bus events -- ``--resume``
restores controller state, the console replays it.
"""

from .controller import (
    REC_CAPACITY_POOL,
    REC_CAPACITY_QUEUE,
    REC_CAPACITY_SCALE,
    REC_CAPACITY_TOKENS,
    CapacityController,
    CapacityHooks,
    tokens_for,
)
from .scaler import (
    FakeFleetScaler,
    FleetScaler,
    NullScaler,
    make_scaler,
)
from .signals import EwmaRate, RegistrySampler

__all__ = [
    "REC_CAPACITY_POOL", "REC_CAPACITY_QUEUE", "REC_CAPACITY_SCALE",
    "REC_CAPACITY_TOKENS", "CapacityController", "CapacityHooks",
    "EwmaRate", "FakeFleetScaler", "FleetScaler", "NullScaler",
    "RegistrySampler", "make_scaler", "tokens_for",
]
