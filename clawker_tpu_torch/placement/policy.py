"""Placement policies: which worker each loop slot lands on.

The port's copy of ``clawker_tpu/placement/policy.py``, whole.

The old ``place()`` in ``loop/scheduler.py`` was a ~10-line round-robin
with no notion of health or topology.  Policies here all see one
:class:`PlacementContext` and share three invariants:

- **Breaker-aware.**  A worker whose circuit breaker is OPEN or
  HALF-OPEN never receives a placement -- open means the daemon is
  quarantined, half-open means it is mid-trial and one flap would
  bounce the loop right back (the same stance as
  ``HealthMonitor.pick_target``).
- **Latency-weighted.**  Slot shares rebalance by recent probe latency:
  a slow-but-alive worker (overloaded daemon, congested SSH path) gets
  proportionally fewer slots than a fast one.  Unknown latency reads as
  the fleet median, so a fresh fleet degrades to equal shares.
- **Graceful degradation.**  ``topology`` with no known topology (fake
  pods, single hosts, unparseable accelerator) falls back to ``spread``
  semantics rather than failing the run.

Policies:

- ``spread`` (default): weighted round-robin across eligible workers in
  TPU worker order -- the PR-1 shape, now health/latency-aware.
- ``pack``: fill the first eligible worker (single-worker debugging).
- ``topology``: prefer pod-local ICI groups -- place the run's loops
  onto as few ICI-adjacent worker groups as possible (ICI carries the
  collective traffic; co-scheduled loops that share a group share the
  fast interconnect) while still respecting each worker's fair-share
  cap; migration targets prefer the ICI-closest healthy worker.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .. import logsetup, telemetry
from ..engine.drivers import Worker
from ..errors import ClawkerError
from ..fleet.inventory import WorkerTopology
from ..health import BREAKER_CLOSED

log = logsetup.get("placement.policy")

# docs/loop-placement.md: one increment per placement decision that
# landed (initial slot, migration target, resume re-placement)
_DECISIONS = telemetry.counter(
    "placement_decisions_total", "Placement decisions by policy and worker",
    labels=("policy", "worker"))


def note_decision(policy: str, worker_id: str, n: int = 1) -> None:
    _DECISIONS.labels(policy, worker_id).inc(n)


@dataclass
class PlacementContext:
    """Everything a policy may consult.  Built fresh per decision by the
    scheduler so breaker states and latencies are live, never snapshots.

    ``breaker_state`` / ``latency_s`` default to closed / 0.0 so a
    context built before any health monitor exists still places.
    """

    workers: list[Worker] = field(default_factory=list)
    breaker_state: Callable[[str], str] = lambda wid: BREAKER_CLOSED
    latency_s: Callable[[str], float] = lambda wid: 0.0
    load: dict[str, int] = field(default_factory=dict)
    topology: WorkerTopology | None = None

    def eligible(self, exclude: set[str] | None = None) -> list[Worker]:
        """Workers that may receive placements: breaker CLOSED (open and
        half-open both excluded), engine connected, not excluded."""
        exclude = exclude or set()
        return [w for w in self.workers
                if w.id not in exclude
                and w.engine is not None
                and self.breaker_state(w.id) == BREAKER_CLOSED]

    def plan_pool(self) -> list[Worker]:
        """Workers ``plan`` may use: the eligible set, falling back to
        EVERY connected worker when no breaker reads closed -- a fully
        dead or not-yet-probed fleet still places, the loops strand into
        the breaker/failover machinery, and --orphan-grace bounds the
        run (the pre-placement stance failover has always assumed).
        ``pick`` deliberately has no such fallback: re-placements onto
        known-dead workers would just churn strand->rescue cycles."""
        elig = self.eligible()
        if elig:
            return elig
        return [w for w in self.workers if w.engine is not None] or list(
            self.workers)

    def weight(self, worker_id: str) -> float:
        """Relative slot share for one worker: inverse recent probe
        latency, normalized so unknown latency (0.0) reads as 1.0.
        Sub-millisecond probes are measurement noise (in-process fakes,
        loopback daemons), not a load signal -- they all read 1.0."""
        lat = self.latency_s(worker_id)
        if lat <= 0.001:
            return 1.0
        sampled = [self.latency_s(w.id) for w in self.workers]
        sampled = [s for s in sampled if s > 0.001]
        ref = sorted(sampled)[len(sampled) // 2] if sampled else lat
        if ref <= 0.0:
            return 1.0
        # a worker at the median gets weight 1; 2x the median latency
        # halves its share; floor keeps a slow worker reachable, ceiling
        # keeps one fast worker from absorbing the whole plan (spread
        # must stay spread under latency skew)
        return max(0.1, min(10.0, ref / lat))


def _weighted_order(ctx: PlacementContext, workers: list[Worker],
                    n: int, cap: int | None = None) -> list[Worker]:
    """n slots over ``workers`` by smooth weighted round-robin
    (nginx-style): deterministic, interleaved, and proportional to
    ctx.weight.  Equal weights degrade to plain round-robin in worker
    order -- the exact PR-1 ``spread`` behavior.  With ``cap``, no
    worker receives more than cap slots: weighting biases ORDER and
    share, but a hard per-worker ceiling stays a ceiling (a fast worker
    among slow row-mates must not absorb their whole group)."""
    if not workers:
        return []
    current = {w.id: 0.0 for w in workers}
    weights = {w.id: ctx.weight(w.id) for w in workers}
    counts = {w.id: 0 for w in workers}
    active = list(workers)
    out: list[Worker] = []
    while len(out) < n and active:
        total = sum(weights[w.id] for w in active)
        for w in active:
            current[w.id] += weights[w.id]
        # ties break on pod worker order (max over a list ordered by
        # index returns the first maximal element)
        best = max(active, key=lambda w: current[w.id])
        current[best.id] -= total
        out.append(best)
        counts[best.id] += 1
        if cap is not None and counts[best.id] >= cap:
            active.remove(best)
    return out


class PlacementPolicy:
    """One placement strategy.  ``plan`` maps N loop slots onto workers
    at run start; ``pick`` chooses a single target for a re-placement
    (migration, resume onto a changed fleet)."""

    name = "abstract"

    def plan(self, ctx: PlacementContext, n: int) -> list[Worker]:
        raise NotImplementedError

    def pick(self, ctx: PlacementContext, *, exclude: set[str] | None = None,
             near: Worker | None = None) -> Worker | None:
        """Least-loaded eligible worker, latency-weighted; ``near`` is
        the previous placement (policies that understand locality prefer
        its neighborhood).  None when no eligible worker exists."""
        candidates = ctx.eligible(exclude)
        if not candidates:
            return None
        return min(candidates, key=lambda w: (
            ctx.load.get(w.id, 0) / ctx.weight(w.id), w.index))


class SpreadPolicy(PlacementPolicy):
    name = "spread"

    def plan(self, ctx: PlacementContext, n: int) -> list[Worker]:
        workers = ctx.plan_pool()
        if not workers:
            raise ClawkerError("placement: no workers available")
        return _weighted_order(ctx, workers, n)


class PackPolicy(PlacementPolicy):
    name = "pack"

    def plan(self, ctx: PlacementContext, n: int) -> list[Worker]:
        workers = ctx.plan_pool()
        if not workers:
            raise ClawkerError("placement: no workers available")
        return [workers[0]] * n

    def pick(self, ctx: PlacementContext, *, exclude: set[str] | None = None,
             near: Worker | None = None) -> Worker | None:
        candidates = ctx.eligible(exclude)
        return candidates[0] if candidates else None


class TopologyPolicy(PlacementPolicy):
    """Prefer pod-local ICI groups; spread within the chosen groups.

    The pod's ICI mesh is fastest between co-located workers (same
    board/host group).  ``plan`` packs the run into as FEW groups as
    possible -- groups chosen healthiest-first (most eligible members),
    slots spread latency-weighted within each group -- while capping any
    worker at its fair share ``ceil(n / eligible)``, so group locality
    never turns into worker 0 melting.  Unknown topology falls back to
    ``spread`` semantics (graceful: fake pods and plain hosts have no
    coordinates).
    """

    name = "topology"

    def plan(self, ctx: PlacementContext, n: int) -> list[Worker]:
        workers = ctx.plan_pool()
        if not workers:
            raise ClawkerError("placement: no workers available")
        topo = ctx.topology
        if topo is None or not topo.known:
            log.info("topology unknown: falling back to spread placement")
            return _weighted_order(ctx, workers, n)
        cap = -(-n // len(workers))     # ceil: per-worker fair share
        by_group: dict[int, list[Worker]] = {}
        for w in workers:
            by_group.setdefault(topo.group_of(w.index), []).append(w)
        # healthiest-first: the largest eligible group is the biggest
        # intact ICI domain; ties break on group id (pod order)
        groups = sorted(by_group.items(), key=lambda kv: (-len(kv[1]), kv[0]))
        out: list[Worker] = []
        for _gid, members in groups:
            if len(out) >= n:
                break
            take = min(n - len(out), cap * len(members))
            out.extend(_weighted_order(ctx, members, take, cap=cap))
        # more slots than cap * workers can hold (cap rounding on tiny
        # fleets): wrap around rather than under-place
        while len(out) < n:
            out.extend(_weighted_order(ctx, workers, n - len(out)))
        return out[:n]

    def pick(self, ctx: PlacementContext, *, exclude: set[str] | None = None,
             near: Worker | None = None) -> Worker | None:
        candidates = ctx.eligible(exclude)
        if not candidates:
            return None
        topo = ctx.topology
        if topo is None or not topo.known or near is None:
            return super().pick(ctx, exclude=exclude, near=near)
        return min(candidates, key=lambda w: (
            topo.distance(near.index, w.index),
            ctx.load.get(w.id, 0) / ctx.weight(w.id),
            w.index))


class PodPolicy(TopologyPolicy):
    """The POD tier of two-level placement (docs/federation.md).

    The federation router builds a :class:`PlacementContext` whose
    "workers" are pod stand-ins (one Worker per pod: id = pod name,
    index = pod index, load = live run slots, latency = measured status
    RTT, breaker = pod health from its status RPC) and whose topology
    is :func:`~clawker_tpu.fleet.inventory.federation_topology` -- so
    the exact locality machinery that packs loops onto ICI-adjacent
    workers packs runs onto DCN-adjacent pods, one level up.  Intra-pod
    placement stays with each pod's own policy, untouched.

    Deliberately NOT in :data:`PLACEMENT_POLICIES`: loop specs name
    intra-pod policies only; the pod tier is the router's, not a spec
    field.
    """

    name = "pod"


PLACEMENT_POLICIES: dict[str, type[PlacementPolicy]] = {
    "spread": SpreadPolicy,
    "pack": PackPolicy,
    "topology": TopologyPolicy,
}


def get_policy(name: str) -> PlacementPolicy:
    cls = PLACEMENT_POLICIES.get(name)
    if cls is None:
        raise ClawkerError(
            f"placement: unknown policy {name!r} "
            f"({'|'.join(sorted(PLACEMENT_POLICIES))})")
    return cls()
