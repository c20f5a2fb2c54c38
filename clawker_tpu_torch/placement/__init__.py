"""Pod-scale placement & admission: where loops land and how fast they launch.

The port's copy of ``clawker_tpu/placement/__init__.py``, whole.

The fleet control plane's placement brain, split out of the loop
scheduler (docs/loop-placement.md):

- :mod:`.policy` -- pluggable :class:`PlacementPolicy` engine
  (``spread`` / ``pack`` / ``topology``).  Policies see one
  :class:`PlacementContext`: the live worker set, each worker's circuit
  breaker state (open/half-open workers NEVER receive placements),
  recent probe latency (slow-but-alive workers get fewer slots), the
  current per-worker load, and -- for ``topology`` -- the pod's ICI
  layout from :mod:`clawker_tpu.fleet.inventory`.
- :mod:`.admission` -- per-worker :class:`AdmissionController`: a token
  bucket bounding concurrent in-flight create/start work per worker
  plus a bounded pending queue, so a 64-loop burst drains at each
  daemon's sustainable rate instead of wedging its lane.  Pending
  launches are dequeued by weighted fair queueing across tenants with
  per-tenant max-in-flight caps: two runs sharing a pod cannot starve
  each other.

These two interfaces are the seam the planned agentd-resident
supervision split needs: a worker-resident supervisor implements the
same submit/release and plan/pick contracts, and the CLI becomes a thin
client of them.
"""

from .admission import (
    ADMISSION_DISPATCHED,
    ADMISSION_QUEUED,
    ADMISSION_REJECTED,
    AdmissionController,
    AdmissionOutcome,
    AdmissionTicket,
)
from .policy import (
    PLACEMENT_POLICIES,
    PlacementContext,
    PlacementPolicy,
    PodPolicy,
    get_policy,
    note_decision,
)

__all__ = [
    "ADMISSION_DISPATCHED", "ADMISSION_QUEUED", "ADMISSION_REJECTED",
    "AdmissionController", "AdmissionOutcome", "AdmissionTicket",
    "PLACEMENT_POLICIES", "PlacementContext", "PlacementPolicy",
    "PodPolicy", "get_policy", "note_decision",
]
