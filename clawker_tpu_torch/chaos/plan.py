"""Seeded, serializable fault plans: every soak failure is a repro.

The port's copy of ``clawker_tpu/chaos/plan.py``, whole: the same
(seed, scenario) draws the same plan in both packages, rider for rider.

A :class:`FaultPlan` is the complete description of one chaos scenario:
the fleet shape (workers/loops/iterations/warm-pool/failover) plus a
time-ordered schedule of :class:`FaultEvent` injections.  Plans are
generated deterministically from ``(seed, scenario)`` --
``generate_plan(seed, i)`` always yields the same plan on every
machine -- and serialize to/from JSON, so a failure found during a
1000-scenario soak replays from either its ``--seed``/``--scenario``
pair or its saved plan file (``clawker chaos replay``).

Event kinds and where they inject:

======================  ====================================================
kind                    injection point
======================  ====================================================
``worker_kill``         _FaultGate ``refuse``: every call dials ECONNREFUSED
``worker_wedge``        _FaultGate ``wedge``: every call hangs until revive
``worker_flap``         _FaultGate ``flap``: every other call refused
``worker_slow``         _FaultGate ``slow``: slow-loris, +``arg`` s per call
``engine_burst``        _FaultGate ``burst``: next ``arg`` calls fail like a
                        daemon 5xx / mid-response ECONNRESET, then self-heal
``probe_drop``          _FaultGate ``probe_drop``: ``ping`` fails (dropped
                        SSH-mux probe), data-path calls still succeed
``worker_revive``       clear the worker's fault
``cli_sigkill``         arm crash seam ``arg`` (chaos/seams.py): the
                        scheduler dies there mid-flight, optionally with
                        ``torn_tail`` bytes truncated off the journal, and
                        the runner resumes the run (`--resume` semantics)
``egress_silent``       sentinel scenarios: the worker's egress stream
                        stops mid-run (netlogger death / firewall gap)
``egress_flood``        sentinel scenarios: the worker's stream bursts
                        ``arg`` records at once (log storm)
``sentinel_kill``       SIGKILL the sentinel's collector mid-run: scoring
                        degrades to the stale buffer; the fleet must not
                        notice (observe-only invariant)
``workerd_partition``   drop the worker's workerd intent channel mid-run
                        (the daemon lives): pending intents survive, the
                        executor redials + resyncs, buffered events
                        replay -- no duplicate creates, no lost exits
``workerd_kill``        SIGKILL the worker's workerd: pending intents hit
                        the deadline and strand their loops WITHOUT a
                        breaker penalty; the fleet degrades that worker
                        to the direct WAN path and still drains
``index_down``          shipper scenarios: the monitor stack's bulk index
                        goes down (``arg: "stall"`` wedges it inside the
                        sink deadline instead) mid-run -- the telemetry
                        shipper must degrade observe-only: bounded buffer,
                        oldest batches dropped and counted, the bus and
                        every scheduler lane untouched
``traffic_burst``       capacity scenarios: ``arg`` open-loop synthetic
                        arrivals spike the worker's admission queue (the
                        bursty production shape the elastic controller
                        exists for); real launches must still drain and
                        every standard invariant hold
``scale_down``          capacity scenarios: ask the elastic controller to
                        drain the worker -- the drain must stay gated on
                        journal replay proving zero live placements
                        (``stranded-by-drain`` invariant), deferring for
                        as long as the run keeps the worker busy
``seed_cache_evict``    workerd scenarios: drop the worker's resident
                        workspace-seed store mid-run (restart-equivalent
                        cold cache) -- later creates referencing the
                        digest must degrade to the per-create fallback
                        walk, never fail or cross-seed another agent
``pod_down``            federation scenarios: EVERY worker's daemon dials
                        ECONNREFUSED at once (the whole pod's control
                        plane dies -- VM group preempted, loopd host
                        gone); the federation router must migrate the
                        pod's runs onto survivors exactly-once
``pod_partition``       federation scenarios: every worker's probe
                        channel drops while data paths stay up (DCN
                        partition between front tier and pod): health
                        must not condemn the whole pod without
                        corroboration, lease renews lapse and recover
``gitguard_down``       gitguard scenarios: kill the run's git firewall
                        proxy mid-run -- every later push attempt must
                        fail CLOSED (connection refused, journaled
                        ``down_refused``), never fall through to an
                        unguarded path (``ref-isolation-at-proxy``)
``disk_full``           storage scenarios: the run journal's fd starts
                        returning ENOSPC for ``arg`` writes
                        (testenv.FaultFS) -- durable appends must fail
                        LOUDLY (storage.fault event, degraded
                        durability, strand-without-penalty on
                        placement WAL), never silently succeed
``io_error``            storage scenarios: like ``disk_full`` but EIO
                        -- the generic dying-disk write error
``fsync_fail``          storage scenarios: the next ``arg`` fsyncs on
                        the journal fd raise EIO; the writer must
                        reopen + re-append the unsynced ring, NEVER
                        retry fsync on the poisoned fd
``torn_record``         storage scenarios: flip one bit mid-journal
                        (``arg: "flip"``) or truncate at the last
                        synced offset (power cut) -- ``journal
                        verify`` must flag it and a resume must fold
                        only the verified prefix
======================  ====================================================

Plans with ``sentinel: true`` run with the fleet sentinel attached to
the scheduler (and per-worker synthetic egress feeders for the
``egress_*`` events); the standard invariant audit then proves the
robustness stack holds WITH the sentinel riding along, and the
dedicated observe-only check (runner.run_observe_only_check) proves
sentinel presence changes no scheduling outcome.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from pathlib import Path

from ..errors import ClawkerError
from .seams import SEAM_NAMES

EVENT_KINDS = (
    "worker_kill", "worker_wedge", "worker_flap", "worker_slow",
    "engine_burst", "probe_drop", "worker_revive", "cli_sigkill",
    "egress_silent", "egress_flood", "sentinel_kill",
    "workerd_partition", "workerd_kill", "index_down",
    "traffic_burst", "scale_down", "seed_cache_evict",
    "pod_down", "pod_partition", "gitguard_down",
    "disk_full", "io_error", "fsync_fail", "torn_record",
)

# event kinds that target no worker (worker index is ignored)
_WORKERLESS_KINDS = ("cli_sigkill", "sentinel_kill", "index_down",
                     "pod_down", "pod_partition", "gitguard_down",
                     "disk_full", "io_error", "fsync_fail", "torn_record")

# fault gate modes the worker_* / engine_* / probe_* kinds map onto
GATE_MODE = {
    "worker_kill": "refuse",
    "worker_wedge": "wedge",
    "worker_flap": "flap",
    "worker_slow": "slow",
    "engine_burst": "burst",
    "probe_drop": "probe_drop",
}

# fault gate modes the pod-scope kinds map onto, applied to EVERY
# worker's gate at once (docs/federation.md#chaos): a dead pod refuses
# all dials; a partitioned pod drops probes while data paths serve
POD_GATE_MODE = {
    "pod_down": "refuse",
    "pod_partition": "probe_drop",
}


@dataclass
class FaultEvent:
    """One injection: ``at_s`` seconds into the scenario, ``kind``
    against worker index ``worker`` (ignored for ``cli_sigkill``).
    ``arg`` is kind-specific: burst length for ``engine_burst``,
    per-call delay for ``worker_slow``, seam name for ``cli_sigkill``.
    ``torn_tail`` (cli_sigkill only) truncates that many bytes off the
    journal tail after the kill -- the host-crash torn-write case."""

    at_s: float
    kind: str
    worker: int = 0
    arg: object = None
    torn_tail: int = 0

    def to_doc(self) -> dict:
        doc = {"at_s": round(self.at_s, 3), "kind": self.kind,
               "worker": self.worker}
        if self.arg is not None:
            doc["arg"] = self.arg
        if self.torn_tail:
            doc["torn_tail"] = self.torn_tail
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "FaultEvent":
        kind = str(doc.get("kind", ""))
        if kind not in EVENT_KINDS:
            raise ClawkerError(
                f"chaos plan: unknown event kind {kind!r} "
                f"(expected {'|'.join(EVENT_KINDS)})")
        return cls(at_s=float(doc.get("at_s", 0.0)), kind=kind,
                   worker=int(doc.get("worker", 0)),
                   arg=doc.get("arg"),
                   torn_tail=int(doc.get("torn_tail", 0)))


@dataclass
class FaultPlan:
    """One scenario: fleet shape + injection schedule."""

    seed: int
    scenario: int = 0
    n_workers: int = 4
    n_loops: int = 6
    iterations: int = 2
    failover: str = "migrate"
    warm_pool_depth: int = 0
    max_inflight_per_worker: int = 2
    sentinel: bool = False          # run with the fleet sentinel attached
    workerd: bool = False           # run with per-worker workerd executors
    shipper: bool = False           # run with the telemetry shipper attached
    capacity: bool = False          # run with the elastic-capacity
    #                                 controller attached
    gitguard: bool = False          # run with a git firewall proxy + a
    #                                 deterministic push probe schedule
    #                                 (docs/git-policy.md)
    events: list[FaultEvent] = field(default_factory=list)

    @property
    def name(self) -> str:
        return f"chaos-s{self.seed}-{self.scenario}"

    def to_doc(self) -> dict:
        return {
            "seed": self.seed, "scenario": self.scenario,
            "n_workers": self.n_workers, "n_loops": self.n_loops,
            "iterations": self.iterations, "failover": self.failover,
            "warm_pool_depth": self.warm_pool_depth,
            "max_inflight_per_worker": self.max_inflight_per_worker,
            "sentinel": self.sentinel,
            "workerd": self.workerd,
            "shipper": self.shipper,
            "capacity": self.capacity,
            "gitguard": self.gitguard,
            "events": [e.to_doc() for e in sorted(self.events,
                                                  key=lambda e: e.at_s)],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2) + "\n"

    @classmethod
    def from_doc(cls, doc: dict) -> "FaultPlan":
        plan = cls(
            seed=int(doc.get("seed", 0)),
            scenario=int(doc.get("scenario", 0)),
            n_workers=max(1, int(doc.get("n_workers", 4))),
            n_loops=max(1, int(doc.get("n_loops", 6))),
            iterations=max(1, int(doc.get("iterations", 2))),
            failover=str(doc.get("failover", "migrate")),
            warm_pool_depth=int(doc.get("warm_pool_depth", 0)),
            max_inflight_per_worker=int(
                doc.get("max_inflight_per_worker", 2)),
            sentinel=bool(doc.get("sentinel", False)),
            workerd=bool(doc.get("workerd", False)),
            shipper=bool(doc.get("shipper", False)),
            capacity=bool(doc.get("capacity", False)),
            gitguard=bool(doc.get("gitguard", False)),
            events=[FaultEvent.from_doc(e) for e in doc.get("events") or []],
        )
        _validate(plan)
        return plan

    @classmethod
    def load(cls, path: Path | str) -> "FaultPlan":
        try:
            doc = json.loads(Path(path).read_text(encoding="utf-8"))
        except (OSError, ValueError) as e:
            raise ClawkerError(f"chaos plan {path}: {e}") from e
        if not isinstance(doc, dict):
            raise ClawkerError(f"chaos plan {path}: expected a JSON object")
        return cls.from_doc(doc)

    def save(self, path: Path | str) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json(), encoding="utf-8")
        return path


# the sigkill seams worth crashing at, weighted toward the WAL-to-engine
# gaps that historically hid bugs (ISSUE 8); resume.* seams only make
# sense once a generation is already a resume, so the generator uses
# them for the SECOND kill of a scenario
_KILL_SEAMS_GEN1 = ("run.post_placement", "launch.pre_create",
                    "launch.post_create", "launch.pre_start",
                    "launch.post_start", "iteration.post_exit",
                    "pool.post_fill")
_KILL_SEAMS_GEN2 = ("resume.pre_reconcile", "resume.post_adopt",
                    "launch.post_start", "iteration.post_exit")


def generate_plan(seed: int, scenario: int = 0, *, n_workers: int = 4,
                  n_loops: int = 6, iterations: int = 2,
                  horizon_s: float = 0.9) -> FaultPlan:
    """Deterministic plan for ``(seed, scenario)``.

    Every scenario gets 1-4 fault events inside ``horizon_s``; kills and
    wedges are always paired with a revive so the fleet can finish, and
    roughly half the scenarios include a CLI SIGKILL at a named crash
    seam (with a resume leg), a third of those with a torn journal
    tail.  ``random.Random`` is seeded from the (seed, scenario) pair
    alone -- no global state, no time, no machine dependence.
    """
    rng = random.Random((int(seed) & 0xFFFFFFFF) * 100_003 + int(scenario))
    plan = FaultPlan(
        seed=int(seed), scenario=int(scenario), n_workers=n_workers,
        n_loops=n_loops, iterations=iterations,
        failover=rng.choice(("migrate", "migrate", "wait")),
        warm_pool_depth=rng.choice((0, 0, 1)),
        max_inflight_per_worker=rng.choice((2, 2, 3)),
    )
    events: list[FaultEvent] = []
    n_worker_faults = rng.randint(1, 2)
    victims = rng.sample(range(n_workers), k=min(n_worker_faults, n_workers))
    for victim in victims:
        kind = rng.choice(("worker_kill", "worker_kill", "worker_wedge",
                           "worker_flap", "worker_slow", "engine_burst",
                           "probe_drop"))
        at = rng.uniform(0.05, horizon_s * 0.6)
        arg = None
        if kind == "worker_slow":
            arg = round(rng.uniform(0.05, 0.2), 3)
        elif kind == "engine_burst":
            arg = rng.randint(2, 6)
        events.append(FaultEvent(at_s=at, kind=kind, worker=victim, arg=arg))
        if kind in ("worker_kill", "worker_wedge", "worker_flap",
                    "worker_slow", "probe_drop"):
            # bounded outage: the scenario must be able to drain
            events.append(FaultEvent(
                at_s=at + rng.uniform(0.2, horizon_s * 0.5),
                kind="worker_revive", worker=victim))
    if rng.random() < 0.6:
        # early arms catch the run while launches are still in flight;
        # seams that never fire (the run drained first) are benign
        seam = rng.choice(_KILL_SEAMS_GEN1)
        torn = rng.choice((0, 0, rng.randint(1, 40)))
        events.append(FaultEvent(
            at_s=rng.uniform(0.02, horizon_s * 0.5), kind="cli_sigkill",
            worker=-1, arg=seam, torn_tail=torn))
        if rng.random() < 0.4:
            seam2 = rng.choice(_KILL_SEAMS_GEN2)
            events.append(FaultEvent(
                at_s=rng.uniform(0.05, horizon_s * 0.6), kind="cli_sigkill",
                worker=-1, arg=seam2))
    # sentinel rider (drawn strictly AFTER every pre-existing draw, so
    # the worker-fault/sigkill schedule of a (seed, scenario) pair is
    # byte-identical to what it was before the sentinel existed): about
    # a third of scenarios run with the fleet sentinel attached, plus
    # stream chaos against it -- silence, floods, a collector SIGKILL
    if rng.random() < 0.35:
        plan.sentinel = True
        victim = rng.randrange(n_workers)
        kind = rng.choice(("egress_silent", "egress_flood", "egress_flood"))
        events.append(FaultEvent(
            at_s=rng.uniform(0.05, horizon_s * 0.6), kind=kind,
            worker=victim,
            arg=rng.randint(50, 200) if kind == "egress_flood" else None))
        if rng.random() < 0.4:
            events.append(FaultEvent(
                at_s=rng.uniform(0.1, horizon_s * 0.7),
                kind="sentinel_kill", worker=-1))
    # workerd rider (again drawn strictly AFTER every pre-existing draw,
    # sentinel's included -- the worker-fault/sigkill/sentinel schedule
    # of a (seed, scenario) pair is byte-identical to the pre-workerd
    # generator): about a third of scenarios run with per-worker
    # workerd executors attached, most of those with data-plane chaos
    # against one channel -- a partition (heals via redial + resync) or
    # a daemon SIGKILL (degrades that worker to the direct WAN path).
    # The generated cli_sigkill seams above stay drawn from the
    # pre-workerd pools for the same reason; the workerd.* seams are
    # reachable via hand-written plans and the optional draw below.
    if rng.random() < 0.35:
        plan.workerd = True
        if rng.random() < 0.75:
            victim = rng.randrange(n_workers)
            kind = rng.choice(("workerd_partition", "workerd_partition",
                               "workerd_kill"))
            events.append(FaultEvent(
                at_s=rng.uniform(0.05, horizon_s * 0.6), kind=kind,
                worker=victim))
        if rng.random() < 0.25:
            events.append(FaultEvent(
                at_s=rng.uniform(0.02, horizon_s * 0.4),
                kind="cli_sigkill", worker=-1,
                arg="workerd.pre_dispatch"))
    # shipper rider (drawn strictly AFTER every pre-existing draw, so
    # the worker-fault/sigkill/sentinel/workerd schedule of a (seed,
    # scenario) pair is byte-identical to the pre-shipper generator):
    # about a quarter of scenarios run with the telemetry shipper
    # attached to a fake bulk index, most of those with the index going
    # down (or wedging) mid-run -- the observe-only degradation the
    # fleet-console ingestion contract promises
    if rng.random() < 0.25:
        plan.shipper = True
        if rng.random() < 0.8:
            events.append(FaultEvent(
                at_s=rng.uniform(0.05, horizon_s * 0.6),
                kind="index_down", worker=-1,
                arg="stall" if rng.random() < 0.3 else None))
    # capacity rider (drawn strictly AFTER every pre-existing draw, so
    # the worker-fault/sigkill/sentinel/workerd/shipper schedule of a
    # (seed, scenario) pair is byte-identical to the pre-capacity
    # generator): about a third of scenarios run with the elastic
    # controller attached -- most with an open-loop traffic burst
    # spiking one worker's admission queue, and roughly half asking
    # for a scale-down whose drain must stay gated on journal replay
    # (the stranded-by-drain invariant audits every drain that fires)
    if rng.random() < 0.35:
        plan.capacity = True
        if rng.random() < 0.8:
            events.append(FaultEvent(
                at_s=rng.uniform(0.05, horizon_s * 0.5),
                kind="traffic_burst", worker=rng.randrange(n_workers),
                arg=rng.randint(6, 18)))
        if rng.random() < 0.5:
            events.append(FaultEvent(
                at_s=rng.uniform(0.1, horizon_s * 0.7),
                kind="scale_down", worker=rng.randrange(n_workers)))
    # seed-cache rider (drawn strictly AFTER every pre-existing draw, so
    # the worker-fault/sigkill/sentinel/workerd/shipper/capacity
    # schedule of a (seed, scenario) pair is byte-identical to the
    # pre-seed-cache generator): scenarios already running workerd get
    # their resident workspace-seed store dropped mid-run about a third
    # of the time -- later digest-referencing creates must degrade to
    # the per-create fallback walk, and no agent may ever see another
    # agent's workspace content (the cross-agent-write invariant)
    if plan.workerd and rng.random() < 0.35:
        events.append(FaultEvent(
            at_s=rng.uniform(0.05, horizon_s * 0.6),
            kind="seed_cache_evict", worker=rng.randrange(n_workers)))
    # pod rider (drawn strictly AFTER every pre-existing draw, so the
    # worker-fault/sigkill/sentinel/workerd/shipper/capacity/seed-cache
    # schedule of a (seed, scenario) pair is byte-identical to the
    # pre-federation generator): about a fifth of scenarios lose the
    # WHOLE pod at once -- every daemon refusing dials (pod_down) or
    # every probe channel dropping while data paths serve
    # (pod_partition).  Both revive at half-horizon + the usual bounded
    # outage via the runner's end-of-schedule heal, and the standard
    # invariant audit (exactly-once accounting included) must hold
    if rng.random() < 0.20:
        kind = "pod_down" if rng.random() < 0.5 else "pod_partition"
        events.append(FaultEvent(
            at_s=rng.uniform(0.1, horizon_s * 0.5), kind=kind, worker=-1))
    # gitguard rider (drawn strictly AFTER every pre-existing draw, so
    # the worker-fault/sigkill/sentinel/workerd/shipper/capacity/
    # seed-cache/pod schedule of a (seed, scenario) pair is
    # byte-identical to the pre-gitguard generator): about a third of
    # scenarios run a git firewall proxy with a deterministic push-probe
    # schedule riding the run (own-namespace allow, sibling deny,
    # integration-branch deny, an occasional merge-queue landing), and
    # roughly 40% of those kill the proxy mid-run -- every later probe
    # must fail CLOSED, never land an out-of-namespace update
    # (docs/git-policy.md; the ref-isolation-at-proxy invariant)
    if rng.random() < 0.35:
        plan.gitguard = True
        if rng.random() < 0.4:
            events.append(FaultEvent(
                at_s=rng.uniform(0.1, horizon_s * 0.6),
                kind="gitguard_down", worker=-1))
    # storage rider (drawn strictly AFTER every pre-existing draw, so
    # the worker-fault/sigkill/sentinel/workerd/shipper/capacity/
    # seed-cache/pod/gitguard schedule of a (seed, scenario) pair is
    # byte-identical to the pre-storage generator): about a third of
    # scenarios hit the run journal's own disk -- write errors
    # (ENOSPC/EIO), an fsync-fail burst (the reopen-not-retry proof),
    # or a torn record (bit-flip/power-cut, audited by the
    # replay-integrity invariant).  Every fault must surface as a
    # storage.fault event + metric (the no-silent-drop invariant)
    if rng.random() < 0.35:
        kind = rng.choice(("disk_full", "io_error", "fsync_fail",
                           "fsync_fail", "torn_record"))
        arg = None
        if kind in ("disk_full", "io_error", "fsync_fail"):
            arg = rng.randint(1, 4)
        elif kind == "torn_record":
            arg = "flip" if rng.random() < 0.5 else "cut"
        events.append(FaultEvent(
            at_s=rng.uniform(0.05, horizon_s * 0.6), kind=kind,
            worker=-1, arg=arg))
    plan.events = sorted(events, key=lambda e: e.at_s)
    _validate(plan)
    return plan


def _validate(plan: FaultPlan) -> None:
    from ..loop.scheduler import FAILOVER_POLICIES

    if plan.failover not in FAILOVER_POLICIES:
        raise ClawkerError(
            f"chaos plan: unknown failover policy {plan.failover!r} "
            f"(expected {'|'.join(FAILOVER_POLICIES)})")
    for e in plan.events:
        if e.kind == "cli_sigkill" and e.arg not in SEAM_NAMES:
            raise ClawkerError(
                f"chaos plan: cli_sigkill at unknown seam {e.arg!r}")
        if e.kind not in _WORKERLESS_KINDS and not (
                -1 < e.worker < plan.n_workers):
            raise ClawkerError(
                f"chaos plan: event {e.kind} targets worker {e.worker} "
                f"outside the {plan.n_workers}-worker fleet")
