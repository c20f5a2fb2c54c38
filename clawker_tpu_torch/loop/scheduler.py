"""The loop scheduler: place, run, restart, and account N agent loops.

An *agent loop* is one autonomous harness container run repeatedly:
each iteration starts the container, waits for exit, records the
result, and re-starts until the iteration budget, a stop request, or
the failure ceiling.  ``--parallel N`` runs N loops at once, placed
across the runtime driver's workers:

- ``spread`` (default): round-robin across pod workers in TPU worker
  order -- one loop per worker VM on a v5e-8 with ``--parallel 8``,
  the BASELINE benchmark shape.
- ``pack``: fill worker 0 first (single-worker debugging).

Placement is the ONLY thing pod topology feeds (SURVEY.md 2.13: ICI
carries no control traffic); everything else is per-worker local.

Concurrency model (the fan-out used to be strictly serial, O(N * RTT)
on SSH-backed engines):

- **Per-worker lanes.**  Every worker gets one serial lane thread; all
  engine mutations for that worker (create, start, stop, remove, the
  batched poll) run on its lane.  Two agents on one worker can never
  race that worker's engine, while distinct workers proceed fully in
  parallel -- and a hung worker engine wedges only its own lane.
- **Batched polling.**  Instead of one ``inspect_container`` round-trip
  per agent per tick, each tick issues ONE ``list_containers`` filtered
  by the loop-run label per engine, then inspects only containers that
  actually stopped (to fetch their exit code).
- **Event-driven restarts.**  Each running iteration gets a blocking
  ``wait_container`` thread that wakes the run loop the moment the
  container exits, so the next iteration starts immediately instead of
  waiting out the poll interval; ``poll_s`` only bounds the fallback
  re-check cadence and stop() latency.
- **Ordered events.**  ``on_event`` callbacks now fire from lane,
  waiter, and anomaly-watch threads; a :class:`monitor.events.EventBus`
  serializes them so per-agent ordering still holds.

Per-iteration context rides a small state file written into the
container between restarts (env is immutable after create), so the
harness can see iteration number + loop id.  Consecutive-failure
ceiling stops a crash-looping agent from burning a worker forever.

Failover (the health subsystem, ``--failover``): a
:class:`~clawker_tpu.health.HealthMonitor` probes every pod worker while
run() drives the loops; when a worker's circuit breaker opens (K probe
failures, an unreachable poll, or a wedged lane), the loops placed
there are marked ``orphaned``, their containers best-effort halted on a
side thread (stop rides a dedicated never-pooled socket -- the pool of
a dead worker is exactly what not to wait on), and the policy decides
what happens next:

- ``migrate`` (default): re-place each orphan onto the least-loaded
  worker whose breaker is CLOSED (half-open workers are mid-trial and
  never receive migrations), preserving iteration count and the
  consecutive-failure ceiling across the move.
- ``wait``: orphans stay put until their worker's breaker closes again,
  then resume on it.
- ``fail``: orphans fail immediately (crash-only accounting).

A recovered worker (open -> half-open -> closed) rejoins the placement
set automatically.

Durability (``loop/journal.py``, docs/loop-resume.md): every state
transition -- placement chosen, container created, started, exited,
orphaned, migrated, budget reached -- is appended to a write-ahead
fsync-batched JSONL journal under ``logs/runs/<run>.journal`` BEFORE
the engine call it describes, with deterministic per-(run, slot)
container names and a placement-epoch label.  ``clawker loop --resume``
replays the journal and reconciles it against one label-scoped
``list_containers`` per worker: still-running containers are ADOPTED in
place (waiter threads re-attach, nothing restarts), exits the dead
scheduler never saw are accounted exactly once, created-but-never-
started launches finish, journaled-but-never-created placements
re-launch, unclaimed leftovers are swept as ghosts, and workers that
died while the CLI was down flow into the breaker/failover machinery
above.  The scheduler process is thereby no longer a single point of
failure: kill -9 mid-run costs at most the batched journal tail, which
reconcile re-derives from engine state.

**The port.**  This is the port's copy of ``clawker_tpu/loop/scheduler.py``
for one configuration of ``loop``: the in-process run with engine calls
on the per-worker lanes or, through the workerd seam (``executors=``,
an :class:`~clawker_tpu_torch.workerd.executor.ExecutorSet`), as
batched intents to each worker's resident workerd whose event stream
drives the same journal records, spans and transitions -- over the
ported drivers (the fake one), with the placement policies and admission,
failover, the write-ahead journal, the flight recorder, the
disk-pressure ladder and the two anomaly riders
(:meth:`LoopScheduler.attach_anomaly_watch` /
:meth:`LoopScheduler.attach_sentinel`), and what loopd hands a hosted
run: the admission controller and lane registry shared between
co-tenant runs (``admission=``, ``lanes=``), the cross-process trace
context (``LoopSpec.trace_parent`` / ``clock_offset_s``, journaled in the
run record and carried by each iteration root as ``ctx_parent`` /
``skew_s``; ``_engine_ctx`` around the engine calls), and the daemon's
crash seam :meth:`LoopScheduler.kill`.  The warm pool is here
(``warm_pool_depth`` > 0:
:class:`~clawker_tpu_torch.loop.warmpool.WarmPool`, the refill tick, the checkout on the direct path and on workerd's
launch intents, the fills as workerd ``create`` intents, the drain at
cleanup), and so is the resume path (:meth:`LoopScheduler.resume`,
:meth:`LoopScheduler.reconcile` with its pool-restore branch, and the
adopt intent that hands workerd a reconciled container).  What waits
for its slice (ROADMAP §1) is refused with a named :class:`ConfigError`
and has no code path here: worktrees with their gitguard and merge
queue (item 6; a journal that holds their records is refused at
resume), the scheduler's chaos seams (item 8: ``seams`` is the
never-armed ``NULL_SEAMS`` that the pool, the reconcile and the workerd
executors fire into) and the elastic capacity controller
(:meth:`LoopScheduler.attach_capacity`, item 9; with none attached,
the capacity-state restore of a resume is a no-op, as in the
reference).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import queue
import tarfile
import threading
import time
from concurrent.futures import Future
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field
from pathlib import Path

from .. import consts, logsetup, telemetry
from ..agentd.protocol import b64
from ..chaos.seams import NULL_SEAMS
from ..config import Config
from ..engine.drivers import RuntimeDriver, Worker
from ..errors import ClawkerError, ConfigError, DriverError, NotFoundError
from ..fleet.inventory import pod_topology
from ..health import BREAKER_CLOSED, BREAKER_OPEN, HealthConfig, HealthMonitor
from ..monitor.events import (
    PLACEMENT_DECISION,
    STORAGE_FAULT,
    TRACE_SPAN,
    EventBus,
    PlacementEvent,
    StorageFaultEvent,
)
from ..monitor.pressure import DiskPressureMonitor, note_shed
from ..placement import (
    ADMISSION_REJECTED,
    AdmissionController,
    PlacementContext,
    get_policy,
    note_decision,
)
from ..monitor.ledger import FlightRecorder, flight_path
from ..runtime.names import container_name
from ..runtime.orchestrate import (
    AgentRuntime,
    CreateOptions,
    workspace_seed_tar,
)
from ..telemetry.spans import (
    SPAN_CREATE,
    SPAN_EXIT,
    SPAN_MIGRATE,
    SPAN_ORPHAN,
    SPAN_RESUME,
    SPAN_START,
    SPAN_WAIT,
    Tracer,
)
from ..tracing.context import TraceContext, use
from ..util import ids
from .journal import (
    REC_ADMIT_QUEUED,
    REC_ADOPTED,
    REC_CREATED,
    REC_EXITED,
    REC_GHOST,
    REC_LOOP_END,
    REC_MIGRATED,
    REC_ORPHANED,
    REC_PLACEMENT,
    REC_POOL_REMOVE,
    REC_RESUME,
    REC_RUN,
    REC_SEED_SHIP,
    REC_SEED_TAR,
    REC_SHUTDOWN,
    REC_STARTED,
    REC_STORAGE_FAULT,
    AppendReceipt,
    JournalFault,
    NO_JOURNAL_RECEIPT,
    RunImage,
    RunJournal,
    journal_path,
    retention_gc,
)
from .warmpool import WarmPool

log = logsetup.get("loop.scheduler")

# Lane telemetry (docs/telemetry.md): queue-wait vs execute time per
# worker -- the direct form of the signal wedge detection used to infer
# from future states (a healthy lane has near-zero queue wait; a wedged
# one shows queue time exploding while execute time flatlines).
_LANE_QUEUE_SECONDS = telemetry.histogram(
    "loop_lane_queue_seconds",
    "Time a lane task waited queued behind earlier tasks",
    labels=("worker",))
_LANE_EXECUTE_SECONDS = telemetry.histogram(
    "loop_lane_execute_seconds", "Time a lane task spent executing",
    labels=("worker",))
_ITERATIONS = telemetry.counter(
    "loop_iterations_total", "Completed loop iterations",
    labels=("status",))           # status: ok | failed
# resume telemetry (docs/loop-resume.md): how a journal replay landed --
# adoption is the cheap path (container kept running, zero engine
# mutations), everything else re-pays part of a cold start
_RESUMES = telemetry.counter(
    "loop_resumes_total", "Journal-replay resumes of loop runs")
_ADOPTIONS = telemetry.counter(
    "loop_adoptions_total",
    "Still-running containers adopted in place by --resume",
    labels=("worker",))
_GHOSTS = telemetry.counter(
    "loop_ghosts_swept_total",
    "Unjournaled leftover containers swept at resume reconcile",
    labels=("worker",))
FAILURE_CEILING = 3          # consecutive nonzero exits -> loop failed
LOOP_STATE_DIR = "/run/clawker"
HALT_DEADLINE_S = 10.0       # bounded halt/cleanup: a hung worker's lane
#                              must never wedge CLI shutdown
FAILOVER_POLICIES = ("migrate", "wait", "fail")
LANE_WEDGE_FLOOR_S = 2.0     # a poll future EXECUTING past max(4*poll_s,
#                              this) trips the worker's breaker
LAUNCH_WEDGE_S = 300.0       # a create/start/restart task EXECUTING this
#                              long trips the breaker too: catches a lane
#                              wedged inside a dedicated read-unbounded
#                              engine call (put_archive, start) on a
#                              daemon that still answers probes.  Must
#                              stay generous -- a first create legitimately
#                              includes an image pull.
ORPHAN_GRACE_S = 600.0       # an orphan with no placement for this long
#                              fails: total fleet death must terminate a
#                              non-interactive run, not hang it forever
STRAND_CEILING = 8           # consecutive stranded create/starts (across
#                              re-placements) before the loop fails: a
#                              DETERMINISTIC daemon 5xx (bad image cmd,
#                              disk full) must not churn strand->rescue->
#                              re-place forever -- probes keep succeeding
#                              so the breaker never opens for it

# container-list summary states meaning "iteration still in flight"
_ACTIVE_STATES = {"created", "running", "restarting", "paused"}


class _EngineUnreachable(ClawkerError):
    """A lane poll could not reach the worker's daemon at all.  Routed to
    the health breaker instead of failing loops: whether the loops die,
    wait, or migrate is the failover policy's call, not the poll's."""


@dataclass
class LoopSpec:
    parallel: int = 1
    iterations: int = 0              # per-agent budget; 0 = until stop()
    placement: str = "spread"        # spread | pack | topology
    tenant: str = "default"          # fairness class this run bills under
    tenant_weight: float = 1.0       # weighted-fair-queue share vs co-tenants
    tenant_max_inflight: int = 0     # per-tenant in-flight launch cap; 0 = none
    max_inflight_per_worker: int = 0  # admission token bucket; 0 = settings
    #                                  loop.placement.max_inflight_per_worker
    image: str = "@"
    prompt: str = ""                 # handed to the harness via env
    worktrees: bool = False          # one git worktree per agent loop
    gitguard: bool | None = None     # git-protocol firewall for worktree
    #                                  runs (docs/git-policy.md): None =
    #                                  settings gitguard.enable; only
    #                                  meaningful with worktrees
    workspace_mode: str = ""         # default: snapshot (isolation per
    #                                  loop); with --worktrees the default
    #                                  comes from settings
    #                                  loop.worktrees.workspace_mode (bind)
    agent_prefix: str = "loop"
    env: dict[str, str] = field(default_factory=dict)
    failover: str = "migrate"        # migrate | wait | fail
    journal: bool = True             # write-ahead run journal under
    #                                  logs/runs/<run>.journal: what
    #                                  `loop --resume` replays after a
    #                                  scheduler death (docs/loop-resume.md)
    telemetry: bool = True           # iteration spans + flight recorder
    #                                  (metrics registration is import-time
    #                                  and stays on either way)
    orphan_grace_s: float | None = None    # None = ORPHAN_GRACE_S; bounds
    #                                  how long an orphan may sit with no
    #                                  healthy placement before failing
    #                                  (0 = fail at the first rescue tick)
    warm_pool_depth: int = 0         # per-worker warm pool of pre-created
    #                                  containers placements adopt; 0 =
    #                                  disabled (docs/loop-warmpool.md).
    #                                  Ignored with bind-mode --worktrees
    #                                  (a pool member's mounts are staged
    #                                  before the adopting agent's worktree
    #                                  exists); snapshot-mode worktree runs
    #                                  pool normally -- content travels via
    #                                  the workspace seed, not the mount
    #                                  (docs/loop-worktrees.md#degrade-matrix)
    trace_parent: str = ""           # upstream traceparent (loopd's submit
    #                                  span): iteration roots carry its
    #                                  span id as attr ctx_parent so the
    #                                  cross-process merge can join the
    #                                  segments (docs/tracing.md)
    clock_offset_s: float = 0.0      # this scheduler's cumulative clock
    #                                  offset to the ROOT clock (the
    #                                  router's), estimated hop by hop;
    #                                  0 when this process is the root


@dataclass
class AgentLoop:
    agent: str
    worker: Worker
    container_id: str = ""
    iteration: int = 0
    consecutive_failures: int = 0
    exit_codes: list[int] = field(default_factory=list)
    status: str = "pending"          # pending|running|orphaned|done|failed|stopped
    fresh_container: bool = True     # next start needs the full bootstrap
    migrations: int = 0
    retry_at: float = 0.0            # rejected-with-backoff: the rescue
    #                                  pass honors the admission queue's
    #                                  retry_after_s instead of re-placing
    #                                  at the very next tick
    strands: int = 0                 # consecutive stranded create/starts
    #                                  (reset once an iteration starts)
    epoch: int = 0                   # bumped at orphan time: stale lane
    #                                  tasks for an earlier placement no-op
    abandoned: list[tuple[Worker, str]] = field(default_factory=list)
    #                                  containers left on dead workers

    def summary(self) -> dict:
        return {
            "agent": self.agent, "worker": self.worker.id,
            "status": self.status, "iteration": self.iteration,
            "exit_codes": list(self.exit_codes),
            "migrations": self.migrations,
        }


def refuse_unported(spec: LoopSpec) -> None:
    """Raise a named :class:`ConfigError` for a spec that asks for a part
    of the scheduler the port does not carry yet (ROADMAP §1 item 6)."""
    if spec.worktrees:
        raise ConfigError(
            "loop: worktrees (--worktrees, with gitguard and the merge "
            "queue) are not yet ported to clawker_tpu_torch")
    if spec.gitguard:
        raise ConfigError(
            "loop: gitguard (--gitguard) is not yet ported to "
            "clawker_tpu_torch")


def place(workers: list[Worker], n: int, policy: str) -> list[Worker]:
    """n loop slots -> workers (legacy helper: a bare context with no
    health/latency/topology signal).  The scheduler itself plans through
    the placement subsystem with the live context -- see
    clawker_tpu/placement/policy.py and docs/loop-placement.md."""
    if not workers:
        raise ClawkerError("loop: no workers available")
    return get_policy(policy).plan(PlacementContext(workers=workers), n)


class _WorkerLane:
    """Serial executor for ONE worker's engine calls.

    Two agents placed on the same worker must never race that worker's
    engine, so each worker gets exactly one lane thread; distinct
    workers proceed in parallel.  A ``ThreadPoolExecutor(max_workers=1)``
    would do, except its threads are joined at interpreter exit -- one
    hung SSH engine would wedge the whole CLI shutdown.  A daemon thread
    plus explicit futures keeps a hung worker's damage confined to that
    worker.
    """

    def __init__(self, name: str):
        self.name = name
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name=f"loop-lane-{name}")
        self._thread.start()

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, args, time.monotonic()))
        return fut

    def close(self) -> None:
        self._q.put(None)

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args, t_submit = item
            if not fut.set_running_or_notify_cancel():
                continue
            t_run = time.monotonic()
            _LANE_QUEUE_SECONDS.labels(self.name).observe(t_run - t_submit)
            try:
                fut.set_result(fn(*args))
            except BaseException as e:   # the lane must survive any task
                fut.set_exception(e)
            finally:
                _LANE_EXECUTE_SECONDS.labels(self.name).observe(
                    time.monotonic() - t_run)


class LaneRegistry:
    """Get-or-create registry of per-worker serial lanes, owned and
    closed by one run (sharing one registry between loopd's co-tenant
    runs waits with loopd).  ``retire`` keeps the quarantine semantics:
    the wedged thread is abandoned, and the next ``lane()`` call builds
    a fresh thread.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.lanes: dict[str, _WorkerLane] = {}

    def lane(self, worker_id: str) -> _WorkerLane:
        # get-or-create must not race two lanes into existence for one
        # worker (admission dispatch runs on whichever thread released
        # a token)
        with self._lock:
            lane = self.lanes.get(worker_id)
            if lane is None:
                lane = _WorkerLane(worker_id)
                self.lanes[worker_id] = lane
            return lane

    def retire(self, worker_id: str) -> None:
        """Abandon the worker's (possibly wedged) lane thread; the next
        ``lane()`` call starts a fresh one.  Queued tasks on the old
        lane are epoch-guarded by their submitters and no-op when (if)
        the thread unblocks."""
        with self._lock:
            lane = self.lanes.pop(worker_id, None)
        if lane is not None:
            lane.close()

    def close_all(self) -> None:
        with self._lock:
            lanes, self.lanes = list(self.lanes.values()), {}
        for lane in lanes:
            lane.close()


class LoopScheduler:
    def __init__(self, cfg: Config, driver: RuntimeDriver, spec: LoopSpec,
                 *, on_event=None, health_config: HealthConfig | None = None,
                 run_id: str | None = None,
                 admission: AdmissionController | None = None,
                 lanes: LaneRegistry | None = None, executors=None):
        if spec.failover not in FAILOVER_POLICIES:
            raise ClawkerError(
                f"loop: unknown failover policy {spec.failover!r} "
                f"({'|'.join(FAILOVER_POLICIES)})")
        refuse_unported(spec)
        self.cfg = cfg
        self.driver = driver
        self.spec = spec
        # --- placement & admission (docs/loop-placement.md): the policy
        # plans/picks workers, the admission controller rates launches.
        # A SHARED controller (the `admission` param) is how two runs
        # co-tenant one pod in-process: both bill the same token buckets
        # and the weighted fair queue arbitrates between their tenants.
        ps = cfg.settings.loop.placement
        self.policy = get_policy(spec.placement)     # raises on unknown
        self.admission = admission if admission is not None else (
            AdmissionController(
                max_inflight_per_worker=(spec.max_inflight_per_worker
                                         or ps.max_inflight_per_worker),
                max_pending_per_worker=ps.max_pending_per_worker))
        self.admission.register_tenant(
            spec.tenant, weight=spec.tenant_weight,
            max_inflight=spec.tenant_max_inflight or ps.tenant_max_inflight)
        self._topology = None       # resolved lazily (driver worker count)
        # an explicit run_id is a RESUME: the journal, flight record, and
        # container names of the dead scheduler's run are all keyed by it
        self.loop_id = run_id or ids.short_id()
        self.loops: list[AgentLoop] = []
        # every event (lane threads, waiter threads, anomaly watch) rides
        # the bus so consumers see per-agent order despite the fan-out
        self.events = EventBus(on_event)
        self.on_event = self.events.emit
        self.anomaly_watch = None
        self.health: HealthMonitor | None = None   # live while run() runs
        self._health_config = health_config
        self._stop = threading.Event()
        self._wake = threading.Event()        # set by waiters on any exit
        # placement state (epoch / container_id / status transitions) is
        # mutated by lane threads (_create tail, _strand) AND the run
        # thread (_orphan_worker, _rescue_orphans): every check-then-act
        # on it rides this lock, or an orphan landing mid-create could
        # leak a container into neither container_id nor abandoned
        self._placement_lock = threading.Lock()
        # a SHARED registry (the `lanes` param) is how loopd serializes
        # several runs' engine calls per worker on one lane; a private
        # registry (the default) is owned -- and closed -- by this run
        self.lanes = lanes if lanes is not None else LaneRegistry()
        self._owns_lanes = lanes is None
        self._inflight: dict[str, Future] = {}   # agent -> launch HANDLE: the
        #                                          admission-to-completion
        #                                          future busy-tracking reads
        self._lane_task: dict[str, Future] = {}  # agent -> the dispatched
        #                                          lane future (wedge scan
        #                                          needs running(), which a
        #                                          queued handle can't know)
        self._waited: set[tuple[str, int]] = set()
        self._exit_hints: set[str] = set()    # workers with a fresh exit
        self._verdicts: queue.SimpleQueue = queue.SimpleQueue()
        self.launch_wedge_s = LAUNCH_WEDGE_S  # tests tighten these
        self.orphan_grace_s = (ORPHAN_GRACE_S if spec.orphan_grace_s is None
                               else spec.orphan_grace_s)
        self._orphan_since: dict[str, float] = {}   # agent -> first unplaceable
        self._halted: set[tuple[str, str]] = set()  # (wid, cid) stops that
        #                                             landed: recovery re-halts
        #                                             must not repeat them
        self._unreach: dict[str, int] = {}    # consecutive unreachable polls;
        #                                       reset on success, orphan, and
        #                                       recovery (a stale count must
        #                                       not condemn a healed worker)
        # --- telemetry: every iteration is a span tree (iteration ->
        # create/start/wait/exit|orphan|migrate), flushed to the per-run
        # flight recorder AND the bus as typed trace.span records.  On by
        # default: the recorder exists for the runs nobody planned to
        # debug.  See docs/telemetry.md.
        self.flight: FlightRecorder | None = None
        if spec.telemetry:
            try:
                fr_max = int(cfg.settings.telemetry.flight_recorder.max_bytes)
            except AttributeError:      # bare test cfgs without settings
                fr_max = 0
            self.flight = FlightRecorder(
                flight_path(cfg.logs_dir, self.loop_id), max_bytes=fr_max)
        self.tracer = Tracer(
            self.loop_id,
            on_span=self._record_span if spec.telemetry else None)
        # cumulative clock offset to the root clock (docs/tracing.md):
        # loopd stamps it on the spec for federated runs.  0 = this
        # process IS the root clock.
        self._trace_offset_s = float(spec.clock_offset_s or 0.0)
        self._queue_wait: dict[str, float] = {}   # agent -> launch queue s
        self._iter_started: dict[tuple[str, int], float] = {}  # wait-span t0
        # --- durability: the write-ahead run journal (docs/loop-resume.md).
        # Every placement/create/start/exit/orphan/migrate transition is
        # appended BEFORE the engine call it describes; `--resume`
        # replays it and reconciles against live container state.  A
        # resume APPENDS to the dead run's journal (run_id keys the path).
        self.journal: RunJournal | None = None
        # storage-fault state (docs/durability.md): "ok" until a durable
        # append cannot be made durable, then "degraded" (or the run
        # fail-stops, per loop.journal.on_fault) -- surfaced in
        # status()/loop --json/loopd status/fleet health
        self.durability = "ok"
        self.storage_faults = 0
        self._journal_on_fault = "degrade"
        self._in_storage_fault = False  # reentrancy: the fault handler
        #                                 journals, which can fault again
        if spec.journal:
            js = cfg.settings.loop.journal
            self._journal_on_fault = str(
                getattr(js, "on_fault", "degrade")) or "degrade"
            if js.enable:
                self.journal = RunJournal(
                    journal_path(cfg.logs_dir, self.loop_id),
                    fsync_batch_n=js.fsync_batch_n,
                    fsync_interval_s=js.fsync_interval_s,
                    on_fault=self._on_journal_fault)
        # disk-pressure ladder (docs/durability.md#ladder): ticked on
        # the run thread; flight spans and shipper tees consult the
        # shed set, the hard watermark runs the retention GC
        self.pressure: DiskPressureMonitor | None = None
        try:
            sps = cfg.settings.loop.storage_pressure
        except AttributeError:          # bare test cfgs without settings
            sps = None
        if sps is not None and sps.enable:
            keep = int(sps.retention_runs)
            self.pressure = DiskPressureMonitor(
                cfg.logs_dir, soft_free_pct=sps.soft_free_pct,
                hard_free_pct=sps.hard_free_pct,
                check_interval_s=sps.check_interval_s,
                gc=lambda: retention_gc(cfg.logs_dir, keep=keep),
                on_event=self._on_pressure_event)
        # --- warm pool (docs/loop-warmpool.md): pre-created containers
        # this run's placements adopt instead of paying a full create.
        # Refills bill a dedicated low-weight admission tenant so the
        # WFQ hands real placements the worker's tokens first.  (The
        # reference keeps bind-mode worktree runs cold here; the port
        # refuses worktrees, so every pooled spec builds its pool.)
        self.warmpool: WarmPool | None = None
        if spec.warm_pool_depth > 0:
            wps = cfg.settings.loop.warm_pool
            self.warmpool = WarmPool(
                self.loop_id, depth=spec.warm_pool_depth,
                max_age_s=wps.max_age_s, journal=self._journal)
            self.admission.register_tenant(
                self.warmpool.tenant, weight=wps.tenant_weight)
        # the named crash seams (docs/chaos.md): never armed until the
        # chaos runner is ported; the pool (pool.*), the reconcile
        # (resume.*) and the workerd executors fire into them
        self.seams = NULL_SEAMS
        # --- workerd (docs/workerd.md): the WorkerExecutor seam.  An
        # ExecutorSet maps workers to live channels into their
        # worker-resident launch daemons: dispatch sends batched intents
        # there instead of running engine calls on the local lane, and
        # the event stream drives the SAME journal records, spans, and
        # status transitions.  None (the default) or a worker with no
        # live channel = the direct in-process path, unchanged.  The set
        # is caller-owned (CLI, loopd, chip_smoke) -- the scheduler
        # never closes it.
        self.executors = executors
        if executors is not None:
            executors.bind(self)
        self._remote_exits: queue.SimpleQueue = queue.SimpleQueue()
        self._placed_workers: set[str] = set()  # every worker a launch or
        #                           refill was EVER submitted to: the
        #                           cleanup sweep set
        self._shutdown_journaled = False
        self._aborted = False       # kill(): crash seam, skip all shutdown
        self._image: RunImage | None = None   # journal image being resumed
        self._extra_workers: list[Worker] = []  # journaled workers missing
        #                           from the current fleet: engine-less
        #                           stand-ins whose pre-opened breakers
        #                           route their loops into failover
        # --- workspace-seed fan-out (docs/loop-worktrees.md): the tree
        # walk is paid once per fan-out (content-addressed TTL cache in
        # runtime/orchestrate) and journaled write-ahead per DIGEST.
        self._seed_lock = threading.Lock()
        self._seeds_journaled: set[str] = set()     # REC_SEED_TAR dedup

    def _effective_mode(self) -> str:
        """The workspace mode this run's creates resolve to: the
        explicit spec value, else snapshot."""
        return self.spec.workspace_mode or "snapshot"

    def _record_span(self, rec) -> None:
        if self.flight is not None:
            if (self.pressure is not None
                    and self.pressure.is_shedding("flight")):
                # soft-watermark shed (docs/durability.md#ladder): the
                # span is post-mortem evidence, the journal is
                # correctness evidence -- under pressure the span goes
                self.flight.dropped += 1
                note_shed("flight")
            else:
                self.flight.append(rec.to_json())
        self.events.emit(rec.agent, TRACE_SPAN, rec.detail())

    def _journal(self, kind: str, *, durable: bool = False,
                 **fields) -> AppendReceipt:
        """Append one journal record and return its receipt.  A
        disabled journal answers with the no-journal receipt: there is
        no WAL, so there is no durability contract to break.  Storage
        faults surface
        through the journal's ``on_fault`` -> :meth:`_on_journal_fault`,
        so even receipt-ignoring bookkeeping appends degrade loudly.
        After kill() nothing lands: a SIGKILLed process writes no
        records."""
        if self.journal is None or self._aborted:
            return NO_JOURNAL_RECEIPT
        return self.journal.append(kind, durable=durable, **fields)

    def _durable_ok(self, receipt: AppendReceipt, what: str) -> bool:
        """Consume a durable append's receipt: True when the record is
        on disk.  On a broken write-ahead promise the degrade/fail-stop
        policy has already run via ``on_fault``; this just tells the
        call site whether to proceed (most sites log and continue
        degraded; placement sites strand the launch instead)."""
        if receipt.synced:
            return True
        log.warning("loop %s: durable journal append (%s) not durable: %s",
                    self.loop_id, what, receipt.error or "unsynced")
        return False

    def _on_journal_fault(self, fault: JournalFault) -> None:
        """The journal's storage-fault callback (docs/durability.md):
        every fault -- recovered or not -- lands on the event bus as a
        typed ``storage.fault``; an UNRECOVERED fault flips the run to
        degraded-durability (journaled best-effort) or fail-stops it,
        per ``loop.journal.on_fault``.  Defensive about construction
        order: the journal can fault inside its own __init__."""
        if getattr(self, "_in_storage_fault", True):
            return              # a fault while handling a fault: counted
        self._in_storage_fault = True
        try:
            self.storage_faults += 1
            action = "recovered" if fault.recovered else (
                "fail_stop" if self._journal_on_fault == "fail"
                else "degraded")
            try:
                self.on_event("scheduler", STORAGE_FAULT, StorageFaultEvent(
                    fault.op, action, fault.dropped, fault.error).detail())
            except Exception:   # noqa: BLE001 -- surfacing must never
                pass            # compound the fault
            if fault.recovered:
                return
            if self.durability == "ok":
                self.durability = "degraded"
                # journaled degraded-durability state: best-effort (the
                # journal may still be unhealthy; the record lands on a
                # later recovery's re-ring or not at all -- the event +
                # metric above are the guaranteed signals)
                self._journal(REC_STORAGE_FAULT, op=fault.op,
                              dropped=fault.dropped, error=fault.error)
            if self._journal_on_fault == "fail":
                self.durability = "failed"
                log.error("loop %s: fail-stop on storage fault (%s: %s)",
                          self.loop_id, fault.op, fault.error)
                stop = getattr(self, "_stop", None)
                if stop is not None:
                    self.stop()
        finally:
            self._in_storage_fault = False

    def _on_pressure_event(self, ev: StorageFaultEvent) -> None:
        try:
            self.on_event("scheduler", STORAGE_FAULT, ev.detail())
        except Exception:       # noqa: BLE001
            pass

    def storage_summary(self) -> dict:
        """Durability + disk-pressure state for status surfaces
        (``loop --json``, loopd status, ``fleet health`` STORAGE)."""
        j = self.journal
        doc: dict = {
            "durability": self.durability,
            "faults": self.storage_faults,
            "journal": (None if j is None else {
                "healthy": j.healthy, "dropped": j.dropped,
                "recoveries": j.recoveries, "poisoned": j.poisoned,
                "last_error": j.last_error}),
        }
        if self.pressure is not None:
            doc["pressure"] = self.pressure.summary()
        return doc

    def attach_anomaly_watch(self, watch) -> None:
        """Surface fleet anomaly scores (analytics.runtime.AnomalyWatch)
        in status() and as scheduler events when an agent crosses the
        threshold.  Optional: the loop runs identically without it."""
        self.anomaly_watch = watch

        def emit(container: str, z: float) -> None:
            # score rows are keyed by CONTAINER name (netlogger field);
            # events must carry the loop agent name like every other
            # scheduler event, so map back via dot segments
            segments = container.split(".")
            agent = next((l.agent for l in self.loops if l.agent in segments),
                         container)
            self.on_event(agent, "anomaly", f"egress z-score {z:.1f}")

        watch.on_anomaly = emit
        # a broken scorer must not fail silently behind stale scores
        watch.on_error = lambda msg: self.on_event(
            "scheduler", "anomaly_watch_error", msg)

    def attach_sentinel(self, sentinel) -> None:
        """Attach the online fleet sentinel (clawker_tpu/sentinel,
        docs/analytics-online.md): status rows and the dashboard reuse
        the AnomalyWatch surface; the bus tap feeds its behavioral
        features; typed ``anomaly.flag`` events ride this run's bus and
        its ticks land in this run's flight recorder.  Strictly
        observe-only -- the sentinel holds no engine/placement/
        admission reference, and nothing in the scheduler reads its
        verdicts back into a decision."""
        self.attach_anomaly_watch(sentinel)
        sentinel.bind_run(run_id=self.loop_id, events=self.events,
                          flight=self.flight)

    def attach_capacity(self, controller) -> None:
        """The elastic-capacity controller is not ported yet (ROADMAP
        §1): refused, never attached half-way."""
        raise ConfigError(
            "loop: the elastic capacity controller (attach_capacity, "
            "settings capacity.enable) is not yet ported to "
            "clawker_tpu_torch")

    # -------------------------------------------------------------- set up

    def _ensure_health(self) -> HealthMonitor:
        """Construct the fleet HealthMonitor on first use (probe threads
        start in run()).  Built this early so PLACEMENT sees live
        breaker state: engine-less workers pre-open their breakers at
        construction, and tests/resumes can trip breakers before
        start() -- a quarantined worker must receive zero placements,
        including the initial ones."""
        if self.health is not None:
            return self.health
        fleet = list(self.driver.workers())
        known = {w.id for w in fleet}
        # a resume may carry loops journaled onto workers the current
        # fleet no longer has: engine-less stand-ins join the monitored
        # set so their pre-opened breakers orphan those loops into the
        # normal failover machinery on the first verdict drain
        fleet.extend(w for w in self._extra_workers if w.id not in known)
        self.health = HealthMonitor(
            self.driver, fleet,
            config=self._health_config, events=self.events,
            on_verdict=lambda wid, old, new, reason: (
                self._verdicts.put((wid, old, new, reason)),
                self._wake.set()))
        return self.health

    def _placement_ctx(self, workers: list[Worker] | None = None
                       ) -> PlacementContext:
        """The LIVE context every placement decision reads: current
        fleet, breaker states, recent probe latency, load, topology."""
        ws = list(workers if workers is not None else self.driver.workers())
        known = {w.id for w in ws}
        ws.extend(w for w in self._extra_workers if w.id not in known)
        if self._topology is None:
            # shape from the REAL pod only: resume stand-ins (journaled
            # workers absent from the fleet) have no coordinates, and
            # counting them would mis-infer the grid (or invalidate an
            # explicit topology) for the whole cached run
            self._topology = pod_topology(
                self.cfg.settings.runtime.tpu, len(self.driver.workers()))
        health = self.health
        return PlacementContext(
            workers=ws,
            breaker_state=(health.state if health is not None
                           else (lambda wid: BREAKER_CLOSED)),
            latency_s=(health.latency_p50_s if health is not None
                       else (lambda wid: 0.0)),
            load=self._load_by_worker(),
            topology=self._topology)

    @property
    def _lanes(self) -> dict[str, _WorkerLane]:
        """The live lane table (tests / introspection)."""
        return self.lanes.lanes

    def _lane(self, worker: Worker) -> _WorkerLane:
        return self.lanes.lane(worker.id)

    def _submit_launch(self, loop: AgentLoop, worker: Worker, epoch: int,
                       fn) -> None:
        """Route a create/start/restart through admission onto the
        worker's lane (docs/loop-placement.md).

        The loop's in-flight HANDLE future settles when the launch
        completes (or its ticket is cancelled); while the launch waits
        in the admission queue there is no lane task yet, so busy
        tracking reads the handle and wedge detection reads
        ``_lane_task`` (set at dispatch).  The per-worker token is
        released in the lane future's done-callback -- covering create
        AND first start, the whole burst a daemon actually feels.

        A REJECTED submission (pending queue full) strands the loop
        WITHOUT penalizing the worker's breaker: a full queue is
        backpressure, not sickness -- the rescue pass re-places it
        through the policy at tick cadence.
        """
        agent = loop.agent
        self._placed_workers.add(worker.id)
        handle: Future = Future()
        handle.add_done_callback(lambda _f: self._wake.set())
        self._inflight[agent] = handle
        # drop any stale lane task now: a re-placed loop must not have
        # its OLD placement's (possibly wedged) task attributed to the
        # new worker by the launch-wedge scan while the new launch is
        # still queued in admission
        self._lane_task.pop(agent, None)
        t_submit = time.monotonic()

        def cancelled() -> bool:
            return self._stop.is_set() or loop.epoch != epoch

        def on_cancel() -> None:
            if not handle.done():
                handle.set_result(None)

        def dispatch(release) -> None:
            # the WorkerExecutor seam (docs/workerd.md): with a live
            # channel to this worker's workerd, the launch becomes a
            # batched intent executed against the worker's LOCAL engine
            # socket -- zero blocking WAN round trips on this side.  A
            # mid-dispatch degrade (channel just died, restart with no
            # container yet) falls through to the direct lane.
            fut: Future | None = None
            if fn in (self._launch, self._guarded_start):
                ex = self._workerd_for(worker)
                if ex is not None:
                    self._queue_wait[agent] = time.monotonic() - t_submit
                    # NOTE: == not `is` -- bound-method attribute access
                    # builds a fresh object per read, so identity never
                    # matches; equality compares (__self__, __func__)
                    fut = self._workerd_dispatch(
                        ex, loop, epoch, worker,
                        restart=fn == self._guarded_start)
            if fut is None:
                def task():
                    # stamp the full pre-create wait (admission queue +
                    # lane queue) where the iteration span can pick it
                    # up: the root opens inside fn, on this lane thread
                    self._queue_wait[agent] = time.monotonic() - t_submit
                    return fn(loop, epoch, worker)

                fut = self._lane(worker).submit(task)
                self._lane_task[agent] = fut
            lane_fut = self._lane_task.get(agent)

            def done(f: Future) -> None:
                release()
                if self._lane_task.get(agent) is lane_fut is f:
                    self._lane_task.pop(agent, None)
                if handle.done():
                    return
                exc = f.exception()
                if exc is not None:
                    handle.set_exception(exc)
                else:
                    handle.set_result(None)

            fut.add_done_callback(done)

        # write-ahead: the queue entry is journaled before the ticket
        # exists, so a resume can rebuild the pending queue in order
        self._journal(REC_ADMIT_QUEUED, agent=agent, worker=worker.id,
                      tenant=self.spec.tenant, epoch=epoch)
        st = self.admission.submit(worker.id, self.spec.tenant, dispatch,
                                   cancelled=cancelled, on_cancel=on_cancel)
        if st == ADMISSION_REJECTED:
            # the rejection carries its backoff hint (satellite of
            # docs/elastic-capacity.md): surface it in the typed event
            # and pin the rescue pass behind it -- an immediate re-place
            # would bounce straight off the same full (or shed) queue
            retry_after = getattr(st, "retry_after_s", 0.0)
            why = getattr(st, "reason", "") or "admission queue full"
            self.on_event(agent, PLACEMENT_DECISION, PlacementEvent(
                agent, worker.id, self.policy.name, self.spec.tenant,
                "rejected", why, retry_after_s=retry_after).detail())
            loop.retry_at = time.monotonic() + max(0.0, retry_after)
            self._strand(loop, epoch,
                         f"{why} on {worker.id}"
                         + (f" (retry in {retry_after:.2f}s)"
                            if retry_after > 0 else ""),
                         penalize=False)
            if not handle.done():
                handle.set_result(None)
            return
        # ADMITTED (dispatched or queued): the loop made real progress,
        # so its orphan-grace clock resets.  A REJECTED re-submission
        # keeps the clock running -- rejection strands skip the strand
        # ceiling (penalize=False is flow control, not sickness), so
        # --orphan-grace is the only bound on a queue that never drains
        self._orphan_since.pop(agent, None)

    # ------------------------------------------------------------- workerd

    def _workerd_for(self, worker: Worker):
        """The worker's live executor, or None (= direct path).  While
        there is one, exits stream over its channel, so run() skips WAN
        polls and waiters for the worker.  (The reference keeps
        bind-mode worktree runs direct here; the port refuses
        worktrees, so every run may dispatch.)"""
        if self.executors is None:
            return None
        return self.executors.for_worker(worker.id)

    def _ship_seed(self, ex, worker: Worker, root: Path) -> str:
        """Stage the workspace seed in ``worker``'s workerd seed store
        (once per (digest, worker): the executor tracks what it sent).
        The WAL lands BEFORE the send -- a resume reads REC_SEED_SHIP to
        know which workers may hold the digest; re-shipping after a
        crash is harmless (a content-addressed put is idempotent).  A
        transfer lost to a dying link only degrades that worker's
        creates to the per-create fallback walk -- never correctness."""
        digest, tar = self._workspace_seed(root)
        if not digest or tar is None or ex is None or ex.seeded(digest):
            return digest
        # degraded WAL: still ship -- a resume that lost this record
        # re-ships, and a content-addressed put is idempotent
        self._durable_ok(self._journal(REC_SEED_SHIP, durable=True,
                                       digest=digest, worker=worker.id),
                         "seed_ship")
        ex.submit_seed(digest, tar)
        return digest

    def _launch_env(self, loop: AgentLoop) -> dict[str, str]:
        return {
            "CLAWKER_LOOP_ID": self.loop_id,
            "CLAWKER_LOOP_AGENT": loop.agent,
            **({"CLAWKER_LOOP_PROMPT": self.spec.prompt}
               if self.spec.prompt else {}),
            **self.spec.env,
        }

    def _launch_opts_doc(self, loop: AgentLoop, worker: Worker,
                         epoch: int) -> dict:
        """The CreateOptions a launch intent carries -- the same fields
        _create builds in-process (workerd constructs the CreateOptions
        from this doc and runs the full create path locally).  A
        snapshot create references its workspace seed BY DIGEST: the
        worker-local seed store resolves it without a WAN transfer or a
        tree walk (a store miss degrades to the local fallback walk)."""
        doc = {
            "agent": loop.agent, "image": self.spec.image,
            "env": self._launch_env(loop), "tty": False,
            "workspace_mode": self._effective_mode(),
            "worker": worker.id, "loop_id": self.loop_id,
            "extra_labels": {consts.LABEL_LOOP_EPOCH: str(epoch)},
            "replace": True,
        }
        if doc["workspace_mode"] == "snapshot":
            digest, _tar = self._workspace_seed(self._seed_root())
            if digest:
                doc["seed_digest"] = digest
        return doc

    def _state_doc(self, loop: AgentLoop) -> dict:
        """The per-iteration context file, shipped in the intent so
        workerd writes it locally (the direct path's
        _write_iteration)."""
        return {"dir": LOOP_STATE_DIR,
                "tar": b64(self._iteration_state_tar(loop))}

    def _workerd_dispatch(self, ex, loop: AgentLoop, epoch: int,
                          worker: Worker, *, restart: bool) -> Future | None:
        """Send one launch/restart intent over the worker's channel.
        Returns the handle future the admission release rides, or None
        to fall back to the direct lane (restart with no container --
        the epoch moved under us)."""
        if restart:
            with self._placement_lock:
                if loop.epoch != epoch or self._stop.is_set():
                    done: Future = Future()
                    done.set_result(None)
                    return done
                cid = loop.container_id
                fresh = loop.fresh_container
            if not cid:
                return None         # nothing to restart: direct path owns it
            return ex.submit_start(loop, epoch, worker, cid=cid,
                                   fresh=fresh, state=self._state_doc(loop))
        # launch: create + first start.  Warm-pool checkout stays
        # scheduler-side (bookkeeping); the engine-side adoption runs
        # worker-resident, falling back to a cold create there.
        if self._effective_mode() == "snapshot":
            # one transfer per (digest, worker); every create on the
            # worker then fans out from its local store
            self._ship_seed(ex, worker, self._seed_root())
        pool_cid = ""
        pool_entry = None
        if self.warmpool is not None and worker.engine is not None:
            pool_entry = self.warmpool.checkout(worker.id, by=loop.agent,
                                                epoch=epoch)
            if pool_entry is not None:
                pool_cid = pool_entry.cid
        opts = self._launch_opts_doc(loop, worker, epoch)
        if pool_entry is not None:
            opts["extra_labels"][consts.LABEL_WARMPOOL] = pool_entry.agent
        return ex.submit_launch(loop, epoch, worker, opts_doc=opts,
                                state=self._state_doc(loop),
                                pool_cid=pool_cid, pool_entry=pool_entry)

    # --- event-stream accounting: these run on the executor's reader
    # thread and write the SAME journal records, spans, and transitions
    # the lane-thread path writes, on the same locks, in the same order.

    def _workerd_created(self, loop: AgentLoop, epoch: int, worker: Worker,
                         cid: str, pool_hit: bool, pool_error: str,
                         pool_entry, ms: float, *,
                         wan_ms: float = 0.0) -> None:
        if pool_entry is not None and not pool_hit:
            # remote adoption failed and workerd cold-created instead:
            # account the recycled member and discard its container
            if self.warmpool is not None:
                self.warmpool.adoption_failed(
                    pool_entry, pool_error or "remote adoption failed")
            threading.Thread(
                target=self._remove_cid, args=(worker, pool_entry.cid),
                daemon=True, name=f"workerd-recycle-{pool_entry.cid[:12]}",
            ).start()
        # durable before anything acts on the cid -- same contract as
        # _create: a crash here re-finds the container by (deterministic
        # name, journaled cid).  The container already exists, so a
        # broken promise here cannot be unwound -- degrade loudly
        self._durable_ok(self._journal(
            REC_CREATED, durable=True, agent=loop.agent,
            worker=worker.id, epoch=epoch, cid=cid,
            pool=pool_hit), "created")
        with self._placement_lock:
            if loop.epoch != epoch or self._stop.is_set():
                # orphaned while the create was remote: leftover for
                # the cleanup/ghost machinery, exactly like _create
                loop.abandoned.append((worker, cid))
                return
            loop.container_id = cid
            loop.fresh_container = True
            self._begin_iter_span(loop, worker, epoch)
        now = self.tracer.now()
        self.tracer.child(loop.agent, loop.iteration, SPAN_CREATE,
                          now - ms / 1000.0, now, worker=worker.id,
                          pool=pool_hit, workerd=True,
                          wan_ms=round(wan_ms, 3))
        self.on_event(loop.agent, "created", worker.id)

    def _workerd_started(self, loop: AgentLoop, epoch: int, worker: Worker,
                         ms: float, *, wan_ms: float = 0.0) -> None:
        with self._placement_lock:
            if loop.epoch != epoch or self._stop.is_set():
                return
            if loop.status not in ("pending", "running"):
                # a late started for a loop that already reached a
                # terminal state must never resurrect it to "running"
                return
            self._begin_iter_span(loop, worker, epoch)   # idempotent
            loop.fresh_container = False
            loop.status = "running"
            loop.strands = 0        # the placement genuinely works
        self._journal(REC_STARTED, agent=loop.agent, worker=worker.id,
                      epoch=epoch, iteration=loop.iteration)
        now = self.tracer.now()
        self.tracer.child(loop.agent, loop.iteration, SPAN_START,
                          now - ms / 1000.0, now, worker=worker.id,
                          workerd=True, wan_ms=round(wan_ms, 3))
        self._iter_started[(loop.agent, loop.iteration)] = now
        self.on_event(loop.agent, "iteration_start", str(loop.iteration))

    def _workerd_failed(self, loop: AgentLoop, epoch: int, worker: Worker,
                        phase: str, error: str, *, driverish: bool,
                        penalize: bool = True, pool_entry=None) -> None:
        if pool_entry is not None:
            # the checked-out pool member never got adopted (intent
            # failed or expired): account the recycle and discard its
            # container, exactly like the direct path's adoption-failed
            # branch -- silent drops would drift pool depth accounting
            if self.warmpool is not None:
                self.warmpool.adoption_failed(
                    pool_entry, f"workerd {phase}: {error}")
            threading.Thread(
                target=self._remove_cid, args=(worker, pool_entry.cid),
                daemon=True,
                name=f"workerd-recycle-{pool_entry.cid[:12]}").start()
        if self._stop.is_set() or loop.epoch != epoch:
            return
        if driverish:
            # the worker-side engine refused (daemon down there), or the
            # channel itself died (penalize=False: workerd death is not
            # engine sickness) -- either way the rescue pass re-places
            self._strand(loop, epoch, f"workerd {phase}: {error}",
                         penalize=penalize)
            return
        loop.status = "failed"
        self._journal(REC_LOOP_END, agent=loop.agent, status="failed",
                      reason=f"{phase}: {error}")
        self.tracer.end_iteration(loop.agent, loop.iteration,
                                  status="failed",
                                  reason=f"{phase}: {error}")
        self.on_event(loop.agent, f"{phase}_failed", error)
        log.error("loop %s: workerd %s failed: %s", loop.agent, phase, error)

    def _workerd_exited(self, agent: str, epoch: int, iteration: int,
                        code, detail: str) -> None:
        """Unsolicited exit from the worker-resident waiter: queued for
        the run thread, which accounts it through the same
        _finish_iteration path as a poll result."""
        self._remote_exits.put((agent, epoch, iteration, code, detail))
        self._wake.set()

    def _workerd_running_view(self, worker_id: str) -> list[dict]:
        """The iterations the scheduler has actually OBSERVED start on
        ``worker_id`` -- what a post-partition resync asks workerd to
        re-watch.  Gated on the open wait span (_iter_started), not
        just status: a loop between iterations still reads "running"
        while its restart is queued, and a view entry for it would make
        workerd inspect the PREVIOUS iteration's exited container and
        report a phantom exit for an iteration that never ran."""
        view = []
        for loop in list(self.loops):
            if (loop.status == "running" and loop.container_id
                    and loop.worker.id == worker_id
                    and (loop.agent, loop.iteration) in self._iter_started):
                view.append({"agent": loop.agent, "epoch": loop.epoch,
                             "iteration": loop.iteration,
                             "cid": loop.container_id})
        return view

    def _drain_remote_exits(self) -> list[tuple[AgentLoop, int | None, str]]:
        """Remote exit events -> (loop, code, detail) rows, dropping
        stale ones (superseded epoch, already-accounted iteration, or
        an iteration the scheduler never observed START -- the dedup
        that makes a post-partition resync's replayed exits idempotent
        and phantom-proof)."""
        out: list[tuple[AgentLoop, int | None, str]] = []
        by_agent = {l.agent: l for l in self.loops}
        while True:
            try:
                agent, epoch, iteration, code, detail = \
                    self._remote_exits.get_nowait()
            except queue.Empty:
                return out
            loop = by_agent.get(agent)
            if (loop is None or loop.epoch != epoch
                    or loop.status != "running"
                    or loop.iteration != iteration
                    or (agent, iteration) not in self._iter_started):
                continue
            if code is None and not detail:
                detail = "exit unreadable"
            out.append((loop, int(code) if code is not None else None,
                        detail))

    # ------------------------------------------------------------ warm pool

    def _pool_tick(self) -> None:
        """Keep every healthy worker's warm pool at target depth
        (docs/loop-warmpool.md).  Runs on the run thread each tick:
        expired members are recycled, and refills are submitted through
        admission under the pool's low-weight tenant -- the WFQ hands
        real placements the tokens first, so a refill burst can never
        starve live launches."""
        wp = self.warmpool
        if wp is None or self._stop.is_set() or wp.draining:
            return
        for entry in wp.take_expired():
            self._lane(entry.worker).submit(
                self._remove_cid, entry.worker, entry.cid)
        for worker in self.driver.workers():
            if worker.engine is None:
                continue
            if (self.health is not None
                    and self.health.state(worker.id) != BREAKER_CLOSED):
                continue
            while wp.want(worker.id) > 0:
                pool_agent = wp.begin_refill(worker)
                if pool_agent is None:
                    break
                if not self._submit_refill(worker, pool_agent):
                    # admission pending queue saturated: the released
                    # reservation would make want() > 0 again, so retry
                    # next tick instead of spinning durable journal
                    # records on the run thread
                    break

    def prefill_pool(self, timeout: float = 0.0) -> int:
        """Kick one refill round now and (optionally) wait until every
        worker's pool reads target depth or ``timeout`` elapses.
        Returns the number of adoptable members.  Callers that want the
        FIRST placements to hit the pool (benches, tests, a CLI warm
        start) call this before :meth:`start`; during a run the tick
        does the same thing continuously."""
        if self.warmpool is None:
            return 0
        self._pool_tick()
        deadline = time.monotonic() + max(0.0, timeout)
        workers = [w for w in self.driver.workers() if w.engine is not None]

        def ready() -> int:
            return sum(self.warmpool.depth_of(w.id) for w in workers)

        target = self.warmpool.depth * len(workers)
        while timeout and ready() < target and time.monotonic() < deadline:
            time.sleep(0.005)
        return ready()

    def _submit_refill(self, worker: Worker, pool_agent: str) -> bool:
        """Route one pool fill through admission onto the worker's lane.
        A REJECTED or failed fill just releases the reservation --
        refills are opportunistic, never a loop failure and never a
        breaker report (probes judge the worker).  Returns False on a
        synchronous admission rejection so the tick stops refilling
        this worker (the queue is saturated; retrying now would spin)."""
        wp = self.warmpool

        def cancelled() -> bool:
            return self._stop.is_set() or wp.draining

        def on_cancel() -> None:
            wp.fill_done(worker, pool_agent, None, "cancelled")

        def dispatch(release) -> None:
            # workerd seam: refill creates execute worker-resident too
            # (the `create` intent), so a pool fill costs one batched
            # WAN crossing instead of the whole create call chain
            remote_fill = (self._workerd_for(worker)
                           if not (self._stop.is_set() or wp.draining)
                           else None)
            if remote_fill is not None:
                # pre-stage the workspace seed (docs/loop-worktrees.md):
                # the fill's create resolves it from the worker-local
                # store, so warm_pool_hit_p50 keeps its split even on
                # WAN-remote workers
                if self._effective_mode() == "snapshot":
                    self._ship_seed(remote_fill, worker, self._seed_root())
                fut = remote_fill.submit_pool_fill(
                    pool_agent, self._pool_opts_doc(worker, pool_agent))
            else:
                fut = self._lane(worker).submit(
                    self._pool_fill, worker, pool_agent)

            def done(f: Future) -> None:
                release()
                exc = f.exception()
                if exc is not None:
                    wp.fill_done(worker, pool_agent, None, f"{exc}")
                    log.info("pool refill on %s failed: %s", worker.id, exc)
                    return
                cid = f.result()
                if remote_fill is not None and cid:
                    self.seams.fire("pool.post_fill")
                if cid is None:
                    wp.fill_done(worker, pool_agent, None, "skipped")
                elif not wp.fill_done(worker, pool_agent, cid):
                    # the pool started draining while the fill was on
                    # the lane: discard on this same lane (ordered
                    # after us), so drain can never leak it
                    self._lane(worker).submit(
                        self._remove_cid, worker, cid)

            fut.add_done_callback(done)

        self._placed_workers.add(worker.id)
        st = self.admission.submit(worker.id, wp.tenant, dispatch,
                                   cancelled=cancelled, on_cancel=on_cancel)
        if st == ADMISSION_REJECTED:
            wp.fill_done(worker, pool_agent, None, "admission rejected")
            return False
        return True

    def _pool_opts_doc(self, worker: Worker, pool_agent: str) -> dict:
        """The create doc a remote pool-fill intent carries (mirrors
        _pool_fill's CreateOptions)."""
        env = {
            "CLAWKER_LOOP_ID": self.loop_id,
            **({"CLAWKER_LOOP_PROMPT": self.spec.prompt}
               if self.spec.prompt else {}),
            **self.spec.env,
        }
        doc = {
            "agent": pool_agent, "image": self.spec.image, "env": env,
            "tty": False,
            "workspace_mode": self._effective_mode(),
            "worker": worker.id, "loop_id": self.loop_id,
            "extra_labels": {consts.LABEL_LOOP_EPOCH: consts.POOL_EPOCH,
                             consts.LABEL_WARMPOOL: pool_agent},
            "replace": True,
        }
        if doc["workspace_mode"] == "snapshot":
            # pool members seed from the project root: an adopting
            # agent's worktree has not diverged at adoption time, so
            # the digests are identical (docs/loop-worktrees.md)
            digest, _tar = self._workspace_seed(self._seed_root())
            if digest:
                doc["seed_digest"] = digest
        return doc

    def _pool_fill(self, worker: Worker, pool_agent: str) -> str | None:
        """Create one pool member (the expensive create-time stages) on
        the owning worker's lane.  Runs under the pool placeholder
        agent name; adoption finalizes the real agent's surface."""
        wp = self.warmpool
        if wp is None or self._stop.is_set() or wp.draining:
            return None
        rt = self._runtime(worker)
        # the fill's own harness seed populates the (harness, root,
        # credentials) staging-tar cache, so every subsequent create on
        # this worker -- warm or cold -- reuses the staged tar
        env = {
            "CLAWKER_LOOP_ID": self.loop_id,
            **({"CLAWKER_LOOP_PROMPT": self.spec.prompt}
               if self.spec.prompt else {}),
            **self.spec.env,
        }
        mode = self._effective_mode()
        seed_digest = ""
        if mode == "snapshot":
            # pre-stage the workspace seed (docs/loop-worktrees.md):
            # warms the content-addressed tar cache AND journals the
            # digest, so this fill and every adoption-era create reuse
            # one tree walk
            seed_digest, _tar = self._workspace_seed(self._seed_root())
        # analyze: allow(wal-before-mutation): REC_POOL_ADD is journaled
        # durable in warmpool.begin_refill BEFORE this fill is submitted
        # to the lane -- the WAL lives one hop up the flow
        cid = rt.create(CreateOptions(
            agent=pool_agent,
            image=self.spec.image,
            env=env,
            tty=False,
            workspace_mode=mode,
            seed_digest=seed_digest,
            worker=worker.id,
            loop_id=self.loop_id,
            extra_labels={consts.LABEL_LOOP_EPOCH: consts.POOL_EPOCH,
                          consts.LABEL_WARMPOOL: pool_agent},
            replace=True,
        ))
        self.seams.fire("pool.post_fill")
        return cid

    def _drain_pool_worker(self, worker: Worker) -> None:
        """Remove every pool member on ``worker`` (runs on its lane,
        AFTER any queued fills -- nothing can be added behind it)."""
        wp = self.warmpool
        if wp is None:
            return
        for entry in wp.drain_worker(worker.id):
            self._remove_cid(worker, entry.cid)

    # ------------------------------------------------------------ launches

    def _seed_root(self) -> Path:
        """The directory a snapshot create seeds from: the project
        root."""
        return self.cfg.project_root or Path.cwd()

    def _workspace_seed(self, root: Path) -> tuple[str, bytes | None]:
        """(digest, tar) of the workspace seed for ``root`` via the
        content-addressed cache; journals REC_SEED_TAR (durable) the
        first time this run sees a digest, so a resume knows which
        seeds were in flight without re-walking anything."""
        root = Path(root)
        if not root.exists():
            return "", None
        digest, tar = workspace_seed_tar(root)
        if digest:
            with self._seed_lock:
                if digest not in self._seeds_journaled:
                    self._seeds_journaled.add(digest)
                    # degraded WAL: proceed anyway -- a resume that lost
                    # this record re-builds the seed (idempotent, slow)
                    self._durable_ok(self._journal(
                        REC_SEED_TAR, durable=True, digest=digest,
                        bytes=len(tar)), "seed_tar")
        return digest, tar

    def _runtime(self, worker: Worker) -> AgentRuntime:
        from ..controlplane.bootstrap import post_start_services, pre_start_services
        from ..fleet.channels import open_side_channels

        channels = None
        try:
            # every loop agent gets the side channel the reference
            # guarantees every agent (hostproxy + monitor stream), tunneled
            # for remote workers (VERDICT r1 weak #6)
            channels = open_side_channels(worker.require_engine(), self.cfg)
        except Exception as e:
            self.on_event("scheduler", "side_channels_unavailable",
                          f"{worker.id}: {e}")
        return AgentRuntime(
            worker.require_engine(), self.cfg,
            pre_start=lambda ref: pre_start_services(self.cfg, self.driver, ref),
            post_start=lambda ref: post_start_services(self.cfg, self.driver, ref),
            channels=channels,
        )

    def start(self) -> None:
        """Place loops and fan create+first-start across worker lanes.

        Returns once every launch is SUBMITTED to admission: the old
        serial create loop stacked O(N * RTT) on SSH engines, and one
        wedged worker blocked the whole pod's fan-out.  Each worker's
        admission token bucket then drains its launches at the daemon's
        sustainable rate; run() drives them to completion (and accounts
        their failures).

        Placement rides the policy engine with the LIVE context: a
        worker whose breaker is already open (known-dead dial, a test
        pre-trip) receives zero slots.
        """
        self._ensure_health()
        workers = self.driver.workers()
        slots = self.policy.plan(self._placement_ctx(workers),
                                 self.spec.parallel)
        for i, worker in enumerate(slots):
            # loop id in the agent name: two concurrent runs in one project
            # must never collide (replace=True would kill the other run);
            # the name is DETERMINISTIC per (run, slot) so a resume can
            # re-derive it from the journal alone
            agent = self._agent_name(i)
            loop = AgentLoop(agent=agent, worker=worker)
            self.loops.append(loop)
        # write-ahead: the run header and every placement hit the journal
        # (one group-commit fsync) BEFORE any launch is submitted -- a
        # crash past this point leaves enough to reconcile from
        self._journal(REC_RUN, run=self.loop_id,
                      project=self.cfg.project_name(),
                      spec=self._spec_doc(), workers=[w.id for w in workers])
        for loop in self.loops:
            self._journal(REC_PLACEMENT, agent=loop.agent,
                          worker=loop.worker.id, epoch=loop.epoch,
                          tenant=self.spec.tenant)
        if self.journal is not None:
            self.journal.sync()
        for loop in self.loops:
            note_decision(self.policy.name, loop.worker.id)
            self.on_event(loop.agent, PLACEMENT_DECISION, PlacementEvent(
                loop.agent, loop.worker.id, self.policy.name,
                self.spec.tenant, "placed").detail())
            self._submit_launch(loop, loop.worker, loop.epoch, self._launch)

    def _agent_name(self, slot: int) -> str:
        return f"{self.spec.agent_prefix}-{self.loop_id[:6]}-{slot}"

    def _spec_doc(self) -> dict:
        """The journaled run shape: everything a resume needs to rebuild
        an equivalent LoopSpec without the original command line."""
        s = self.spec
        return {
            "parallel": s.parallel, "iterations": s.iterations,
            "placement": s.placement, "image": s.image, "prompt": s.prompt,
            "worktrees": s.worktrees, "gitguard": s.gitguard,
            "workspace_mode": s.workspace_mode,
            "agent_prefix": s.agent_prefix, "env": dict(s.env),
            "failover": s.failover,
            "tenant": s.tenant, "tenant_weight": s.tenant_weight,
            "tenant_max_inflight": s.tenant_max_inflight,
            "max_inflight_per_worker": s.max_inflight_per_worker,
            "warm_pool_depth": s.warm_pool_depth,
            "trace_parent": s.trace_parent,
            "clock_offset_s": s.clock_offset_s,
        }

    def wait_launched(self, timeout: float | None = None) -> bool:
        """Block until every submitted launch (create + first start) has
        completed; True when all landed within ``timeout``.  For callers
        that need the old synchronous start() semantics -- run() does NOT
        need this (it harvests launches as they finish), so a hung worker
        only stalls callers that explicitly opt into waiting."""
        done, not_done = futures_wait(list(self._inflight.values()),
                                      timeout=timeout)
        return not not_done

    # -------------------------------------------------------------- resume

    @classmethod
    def resume(cls, cfg: Config, driver: RuntimeDriver, image: RunImage, *,
               on_event=None, health_config: HealthConfig | None = None,
               failover: str | None = None, iterations: int | None = None,
               orphan_grace_s: float | None = None,
               telemetry: bool = True,
               admission: AdmissionController | None = None,
               executors=None) -> "LoopScheduler":
        """Rebuild a scheduler from a replayed run journal.

        The journal is the authority for the run's SHAPE (slot count,
        image, prompt, placement policy, per-loop iteration counts and
        exit histories); ``failover`` / ``iterations`` /
        ``orphan_grace_s`` may be overridden for the resumed leg.  The
        caller must run :meth:`reconcile` before :meth:`run` -- that is
        where journaled state meets live container state.

        A journal whose run asked for worktrees or gitguard is refused
        by name: re-attaching a worktree and re-arming the git firewall
        wait for their slice (ROADMAP §1 item 6).
        """
        if not image.run_id:
            raise ClawkerError(
                "loop resume: journal has no run header -- the previous "
                "scheduler died before its first record landed; start a "
                "fresh run instead")
        sd = image.spec
        spec = LoopSpec(
            parallel=int(sd.get("parallel") or len(image.loops) or 1),
            iterations=(iterations if iterations is not None
                        else int(sd.get("iterations") or 0)),
            placement=str(sd.get("placement") or "spread"),
            image=str(sd.get("image") or "@"),
            prompt=str(sd.get("prompt") or ""),
            worktrees=bool(sd.get("worktrees") or False),
            gitguard=sd.get("gitguard"),
            workspace_mode=str(sd.get("workspace_mode") or ""),
            agent_prefix=str(sd.get("agent_prefix") or "loop"),
            env={str(k): str(v) for k, v in (sd.get("env") or {}).items()},
            failover=failover or str(sd.get("failover") or "migrate"),
            orphan_grace_s=orphan_grace_s,
            telemetry=telemetry,
            tenant=str(sd.get("tenant") or "default"),
            tenant_weight=float(sd.get("tenant_weight") or 1.0),
            tenant_max_inflight=int(sd.get("tenant_max_inflight") or 0),
            max_inflight_per_worker=int(
                sd.get("max_inflight_per_worker") or 0),
            warm_pool_depth=int(sd.get("warm_pool_depth") or 0),
            trace_parent=str(sd.get("trace_parent") or ""),
            clock_offset_s=float(sd.get("clock_offset_s") or 0.0),
        )
        if image.worktrees or image.gitguard_rules:
            # the run's spec asked for neither (the constructor refuses
            # those by name), yet its journal holds their records
            raise ConfigError(
                "loop resume: the journal holds worktree or gitguard "
                "records; re-attaching them is not yet ported to "
                "clawker_tpu_torch (ROADMAP §1 item 6)")
        sched = cls(cfg, driver, spec, on_event=on_event,
                    health_config=health_config, run_id=image.run_id,
                    admission=admission, executors=executors)
        sched._image = image
        # seed provisioning replays as DEDUP state, not as work: a
        # journaled digest is never re-journaled (zero duplicate seeds
        # -- the REC_SEED_* records exist exactly for this)
        sched._seeds_journaled.update(image.seeds)
        sched._build_resumed_loops(image)
        sched._durable_ok(sched._journal(
            REC_RESUME, durable=True, generation=image.generation + 1,
            clean=image.clean_shutdown), "resume")
        _RESUMES.inc()
        sched.on_event("scheduler", "resume",
                       f"run {image.run_id} generation {image.generation + 1}")
        return sched

    def _build_resumed_loops(self, image: RunImage) -> None:
        """Journal images -> AgentLoop objects on the CURRENT fleet.

        A journaled worker the fleet no longer has gets an engine-less
        stand-in ``Worker``: the health monitor pre-opens its breaker,
        so its loops flow through the ordinary orphan/failover path on
        the first verdict drain instead of needing a parallel mechanism.
        """
        workers_by_id = {w.id: w for w in self.driver.workers()}
        synthesized: dict[str, Worker] = {}

        def worker_for(wid: str) -> Worker:
            w = workers_by_id.get(wid)
            if w is not None:
                return w
            if wid not in synthesized:
                stand_in = Worker(
                    id=wid, index=len(workers_by_id) + len(synthesized),
                    hostname=wid, engine=None,
                    meta={"dial_error": "worker absent from resumed fleet"})
                synthesized[wid] = stand_in
                self._extra_workers.append(stand_in)
            return synthesized[wid]

        # agent names are deterministic per (run, slot): slots the journal
        # never recorded (crash inside start() before the placement batch
        # synced) get fresh placements on the live fleet
        slots = place(self.driver.workers(), self.spec.parallel,
                      self.spec.placement)
        for i in range(self.spec.parallel):
            agent = self._agent_name(i)
            img = image.loops.get(agent)
            if img is None:
                self._journal(REC_PLACEMENT, agent=agent,
                              worker=slots[i].id, epoch=0)
                self.loops.append(AgentLoop(agent=agent, worker=slots[i]))
                continue
            worker = worker_for(img.worker) if img.worker else slots[i]
            status = img.status
            if status in ("running", "stopped"):
                # "running" is a claim about the DEAD scheduler's world;
                # reconcile re-earns it.  "stopped" is the clean-drain
                # state a resume exists to pick back up.
                status = "pending"
            if (self.spec.iterations
                    and img.iteration >= self.spec.iterations
                    and status in ("pending", "orphaned")):
                # budget reached; the crash beat the terminal record
                status = "done"
            loop = AgentLoop(
                agent=agent, worker=worker, iteration=img.iteration,
                consecutive_failures=img.consecutive_failures,
                exit_codes=list(img.exit_codes), status=status,
                fresh_container=False, migrations=img.migrations,
                epoch=img.epoch)
            loop.abandoned = [(workers_by_id[wid], cid)
                              for wid, cid in img.abandoned
                              if wid in workers_by_id]
            self.loops.append(loop)
        if self.journal is not None:
            self.journal.sync()

    def reconcile(self, *, deadline_s: float = 60.0) -> dict:
        """Reconcile journaled placements against live container state:
        ONE label-scoped ``list_containers`` per worker (on its lane),
        then per loop -- adopt a still-running container in place,
        account an exit the dead scheduler never saw, finish a created-
        but-never-started launch, re-launch a journaled-but-never-created
        placement, and sweep unclaimed leftovers as ghosts.  Workers
        whose listing fails or overruns ``deadline_s`` strand their
        loops into the normal breaker/failover machinery.

        Returns a summary dict (adopted/continued/relaunched/
        exits_accounted/ghosts/orphaned counts).  Must run after
        :meth:`resume` and before :meth:`run`.
        """
        image = self._image
        if image is None:
            raise ClawkerError("loop resume: reconcile() before resume()")
        self.seams.fire("resume.pre_reconcile")
        self._ensure_health()
        summary = {"adopted": 0, "continued": 0, "relaunched": 0,
                   "exits_accounted": 0, "ghosts": 0, "orphaned": 0,
                   "pool_restored": 0}
        lock = threading.Lock()     # summary is mutated from lane threads
        # journaled pool members that may still be adoptable: matched by
        # their deterministic pool name on the owning worker's listing --
        # restored into this generation's pool while still `created`
        # (and under target depth), swept as ghosts otherwise
        pool_by_worker: dict[str, list] = {}
        workers_by_id = {w.id: w for w in self.driver.workers()}
        for member in image.pool.values():
            if (member.state in ("pending", "ready")
                    and member.worker in workers_by_id):
                pool_by_worker.setdefault(member.worker, []).append(member)
        by_worker: dict[str, list[AgentLoop]] = {}
        # journaled pending-queue order first: loops whose launch was
        # queued in admission when the scheduler died re-enter each
        # worker's queue in the order they originally held (satellite
        # guarantee: --resume restores pending-queue order)
        queue_rank = {a: i for i, a in enumerate(image.queued_order)}
        ordered = sorted(
            self.loops,
            key=lambda l: (queue_rank.get(l.agent, len(queue_rank)),
                           self.loops.index(l)))
        for loop in ordered:
            if loop.status != "pending" or loop.worker.engine is None:
                # engine-less stand-ins are handled by the health
                # pre-trip at run(); terminal loops need nothing
                continue
            by_worker.setdefault(loop.worker.id, []).append(loop)
        # workers hosting only journaled pool members (no pending loops)
        # still need a listing: their members must be restored or swept
        for wid in pool_by_worker:
            if wid not in by_worker:
                by_worker[wid] = []
        futs: dict[str, Future] = {}
        for wid, group in by_worker.items():
            worker = group[0].worker if group else workers_by_id[wid]
            futs[wid] = self._lane(worker).submit(
                self._reconcile_worker, worker, list(group),
                image, summary, lock, pool_by_worker.get(wid, []))
        futures_wait(list(futs.values()), timeout=deadline_s)
        for wid, fut in futs.items():
            if not fut.done() or fut.exception() is not None:
                # wedged or crashed reconcile: its un-adopted loops go to
                # failover now; the epoch bump no-ops the late lane task
                for loop in by_worker[wid]:
                    if loop.status == "pending":
                        self._strand(loop, loop.epoch,
                                     "resume reconcile "
                                     + ("timed out" if not fut.done() else
                                        f"crashed: {fut.exception()!r}"))
                        with lock:
                            summary["orphaned"] += 1
        with lock:
            return dict(summary)

    def _reconcile_worker(self, worker: Worker, group: list[AgentLoop],
                          image: RunImage, summary: dict, lock,
                          pool_members: list | None = None) -> None:
        engine = worker.require_engine()
        try:
            rows = engine.list_containers(all=True, filters={
                "label": [f"{consts.LABEL_LOOP}={self.loop_id}"]})
        except ClawkerError as e:
            # the worker died while the CLI was down: strand its loops
            # into the breaker/failover machinery
            for loop in group:
                self._strand(loop, loop.epoch, f"resume: list failed: {e}")
            with lock:
                summary["orphaned"] += len(group)
            return
        project = self.cfg.project_name()
        by_name: dict[str, dict] = {}
        for row in rows:
            names = row.get("Names") or []
            if names:
                by_name[str(names[0]).lstrip("/")] = row
        claimed: set[str] = set()
        for loop in group:
            row = by_name.get(container_name(project, loop.agent))
            if row is not None:
                row_epoch = (row.get("Labels") or {}).get(
                    consts.LABEL_LOOP_EPOCH, "")
                if row_epoch and row_epoch != str(loop.epoch):
                    # engines without in-place relabel leave an adopted
                    # warm-pool member's create-time epoch label
                    # ("pool") behind; there the journal is
                    # authoritative -- the durable REC_CREATED cid
                    # names the exact container this placement owns
                    li = image.loops.get(loop.agent)
                    jcid = li.container_id if li is not None else ""
                    if not jcid or str(row.get("Id", "")) != jcid:
                        row = None  # superseded placement's copy: a ghost
            if row is None:
                # journaled placement, no current container -- the crash
                # landed between the WAL record and the create (or the
                # container was lost with its worker): re-launch
                rcpt = self._journal(REC_PLACEMENT, durable=True,
                                     agent=loop.agent, worker=worker.id,
                                     epoch=loop.epoch,
                                     tenant=self.spec.tenant)
                if not self._durable_ok(rcpt, "placement"):
                    # storage fault, not worker sickness: strand WITHOUT
                    # breaker penalty -- the WAL-before-create contract
                    # is never waived, the rescue pass re-places once
                    # the journal recovers (docs/durability.md)
                    self._strand(loop, loop.epoch,
                                 "storage fault: placement not durable",
                                 penalize=False)
                    with lock:
                        summary["orphaned"] += 1
                    continue
                self._submit_launch(loop, worker, loop.epoch, self._launch)
                with lock:
                    summary["relaunched"] += 1
                continue
            claimed.add(str(row.get("Id", "")))
            try:
                self._reconcile_loop(loop, worker, row,
                                     image.loops.get(loop.agent),
                                     summary, lock)
            except ClawkerError as e:
                self._strand(loop, loop.epoch, f"resume: {e}")
                with lock:
                    summary["orphaned"] += 1
        # journaled pool members on this worker: a member still sitting
        # `created` under its pool name is re-adopted into THIS
        # generation's pool (exactly once -- checkout/adopt journaled
        # it consumed otherwise); anything else -- started, exited,
        # half-adopted, over target depth, pool disabled now -- is left
        # unclaimed for the ghost sweep below, which counts it in
        # loop_ghosts_swept_total like every other stale leftover
        for member in pool_members or []:
            row = by_name.get(container_name(project, member.agent))
            if row is None:
                continue        # never created, or lost with the worker
            cid = str(row.get("Id", ""))
            state = str(row.get("State") or "").lower()
            if (self.warmpool is not None and state == "created"
                    and self.warmpool.restore(worker, member.agent, cid)):
                claimed.add(cid)
                with lock:
                    summary["pool_restored"] += 1
            else:
                self._journal(REC_POOL_REMOVE, agent=member.agent,
                              worker=worker.id, cid=cid,
                              reason="stale at resume")
        # ghost sweep: this run's containers on this worker that no
        # resumed loop claims -- lost-create-response leftovers, stale
        # epochs, copies of loops placed elsewhere, finished loops'
        # remains.  Only a label-scoped list finds these.
        for row in rows:
            cid = str(row.get("Id", ""))
            if cid and cid not in claimed:
                self._remove_cid(worker, cid)
                self._journal(REC_GHOST, agent="", worker=worker.id, cid=cid)
                _GHOSTS.labels(worker.id).inc()
                with lock:
                    summary["ghosts"] += 1

    def _reconcile_loop(self, loop: AgentLoop, worker: Worker, row: dict,
                        hint, summary: dict, lock) -> None:
        """One loop vs its live container.  Runs on the worker's lane."""
        cid = str(row.get("Id", ""))
        state = str(row.get("State") or "").lower()
        epoch = loop.epoch
        if state in _ACTIVE_STATES and state != "created":
            # ADOPT in place: the agent kept working while the scheduler
            # was dead -- no restart, no create; the ordinary waiter/poll
            # machinery attaches to the live container from here
            with self._placement_lock:
                if loop.epoch != epoch or self._stop.is_set():
                    return
                loop.container_id = cid
                loop.fresh_container = False
                loop.status = "running"
            self.tracer.begin_iteration(loop.agent, loop.iteration,
                                        worker.id, epoch=epoch,
                                        resumed=True, adopted=True)
            now = self.tracer.now()
            self.tracer.child(loop.agent, loop.iteration, SPAN_RESUME,
                              now, now, worker=worker.id, adopted=True)
            self._iter_started[(loop.agent, loop.iteration)] = now
            self._journal(REC_ADOPTED, agent=loop.agent, worker=worker.id,
                          cid=cid, iteration=loop.iteration)
            _ADOPTIONS.labels(worker.id).inc()
            done: Future = Future()
            done.set_result(None)
            self._inflight[loop.agent] = done
            ex = self._workerd_for(worker)
            if ex is not None:
                # the adopted iteration's exit streams from a
                # worker-resident waiter; run() will skip WAN polls for
                # this worker while the channel is live
                ex.submit_adopt(loop, epoch)
            self.on_event(loop.agent, "adopted", f"{worker.id}:{cid[:12]}")
            with lock:
                summary["adopted"] += 1
            self.seams.fire("resume.post_adopt")
            return
        if state == "created":
            # created but never started (crash between the create and the
            # first start): finish the launch -- full bootstrap, and
            # crucially NOT a second create
            with self._placement_lock:
                if loop.epoch != epoch or self._stop.is_set():
                    return
                loop.container_id = cid
                loop.fresh_container = True
            self._submit_launch(loop, worker, epoch, self._guarded_start)
            with lock:
                summary["continued"] += 1
            return
        # exited while the scheduler was dead
        if hint is not None and hint.started:
            # the journaled iteration ran to exit unaccounted: account it
            # exactly once, then continue at the next iteration
            with self._placement_lock:
                if loop.epoch != epoch or self._stop.is_set():
                    return
                loop.container_id = cid
                loop.fresh_container = False
                loop.status = "running"
            code, detail = self._read_exit(loop)
            if code is None and not detail:
                # the list row raced the container back to life: it is
                # effectively still running -- adopt instead
                self._reconcile_loop(loop, worker,
                                     {**row, "State": "running"},
                                     hint, summary, lock)
                return
            self.tracer.begin_iteration(loop.agent, loop.iteration,
                                        worker.id, epoch=epoch, resumed=True)
            now = self.tracer.now()
            self.tracer.child(loop.agent, loop.iteration, SPAN_RESUME,
                              now, now, worker=worker.id, adopted=False)
            if code is None:
                loop.status = "failed"
                self._journal(REC_LOOP_END, agent=loop.agent,
                              status="failed", reason=detail)
                self.tracer.end_iteration(loop.agent, loop.iteration,
                                          status="failed", reason=detail)
                self.on_event(loop.agent, "failed", detail)
                with lock:
                    summary["exits_accounted"] += 1
                return
            self._finish_iteration(loop, code)
            with lock:
                summary["exits_accounted"] += 1
            if loop.status == "running":    # budget left: next iteration
                self._submit_launch(loop, worker, epoch, self._guarded_start)
            return
        # exit already journaled (crash landed between iterations):
        # restart the same container into the next iteration
        with self._placement_lock:
            if loop.epoch != epoch or self._stop.is_set():
                return
            loop.container_id = cid
            loop.fresh_container = False
        self._submit_launch(loop, worker, epoch, self._guarded_start)
        with lock:
            summary["continued"] += 1

    def _launch(self, loop: AgentLoop, epoch: int,
                worker: Worker | None = None) -> None:
        """Create + first iteration start, on the owning worker's lane.

        ``epoch`` pins the task to the placement it was submitted for: a
        launch still queued behind a wedged lane when the loop was
        orphaned (and possibly migrated) must no-op once that lane
        drains, exactly like one queued behind a user stop().  ``worker``
        is captured at submit time for the same reason -- the task must
        act on ITS placement's worker even if the loop has since moved.
        """
        worker = worker or loop.worker
        if self._stop.is_set() or loop.epoch != epoch:
            return
        try:
            self._create(loop, epoch, worker)
        except DriverError as e:
            # the worker's daemon is unreachable: that is a HEALTH
            # verdict, not this loop's failure -- strand the loop and
            # let the failover policy place it
            self._strand(loop, epoch, f"create: {e}")
            return
        except ClawkerError as e:
            if loop.epoch != epoch:
                return      # raced an orphan mid-create; rescue owns it
            loop.status = "failed"
            self._journal(REC_LOOP_END, agent=loop.agent, status="failed",
                          reason=f"create: {e}")
            self.tracer.end_iteration(loop.agent, loop.iteration,
                                      status="failed", reason=f"create: {e}")
            self.on_event(loop.agent, "create_failed", str(e))
            log.error("loop %s: create failed: %s", loop.agent, e)
            return
        self._guarded_start(loop, epoch, worker)

    def _begin_iter_span(self, loop: AgentLoop, worker: Worker,
                         epoch: int) -> None:
        """Open (idempotently) this iteration attempt's root span,
        attaching the lane queue wait measured at dequeue time."""
        attrs: dict = {"epoch": epoch}
        qw = self._queue_wait.pop(loop.agent, None)
        if qw is not None:
            attrs["queue_ms"] = round(qw * 1000, 2)
        # federated runs: link this root to loopd's submit span and carry
        # the cumulative clock offset so the cross-process merge can both
        # JOIN the segments and re-base their clocks (docs/tracing.md)
        tp = TraceContext.from_header(self.spec.trace_parent)
        if tp is not None and tp.span_id:
            attrs["ctx_parent"] = tp.span_id
        if self._trace_offset_s:
            attrs["skew_s"] = round(self._trace_offset_s, 6)
        self.tracer.begin_iteration(loop.agent, loop.iteration, worker.id,
                                    **attrs)

    def _trace_tp(self, loop: AgentLoop) -> str:
        """Traceparent for one loop's workerd intents: the run id plus
        the open iteration-root span id when one is open (adopt/start
        after the root exists), else a root-less header the merge joins
        by (agent, iteration) -- the launch path, where the root only
        opens when the created event lands."""
        if self.flight is None:
            return ""       # tracing rides telemetry: off together
        span_id = self.tracer.open_root(loop.agent, loop.iteration)
        return TraceContext(self.loop_id, span_id).to_header()

    def _engine_ctx(self, loop: AgentLoop):
        """Activate this iteration's trace context around direct-path
        engine work: an engine client stamps ``engine.request`` spans
        under the open iteration root, with zero new round-trips (the
        traceparent rides requests the path already makes)."""
        if self.flight is None:
            return contextlib.nullcontext()
        return use(TraceContext(
            self.loop_id,
            self.tracer.open_root(loop.agent, loop.iteration),
            agent=loop.agent, worker=loop.worker.id,
            sink=self._record_span))

    def _create(self, loop: AgentLoop, epoch: int, worker: Worker) -> None:
        rt = self._runtime(worker)
        # isolation default: snapshot copies
        mode = self._effective_mode()
        seed_digest = ""
        if mode == "snapshot":
            # journals REC_SEED_TAR + warms the content-addressed tar
            # cache: the create below seeds from it without re-walking
            seed_digest, _tar = self._workspace_seed(self._seed_root())
        with self._placement_lock:
            # epoch re-checked under the lock before opening the span: a
            # stale create racing its own orphaning must not re-open a
            # root the orphan path just closed
            if loop.epoch != epoch:
                return
            self._begin_iter_span(loop, worker, epoch)
        t_create = self.tracer.now()
        opts = CreateOptions(
            agent=loop.agent,
            image=self.spec.image,
            env=self._launch_env(loop),
            tty=False,
            workspace_mode=mode,
            worker=worker.id,
            loop_id=self.loop_id,
            # the epoch label makes the container self-describing for a
            # resume: a copy from a superseded placement reads as stale
            # and is swept instead of adopted
            extra_labels={consts.LABEL_LOOP_EPOCH: str(epoch)},
            replace=True,
            seed_digest=seed_digest,
        )
        # warm-pool checkout (docs/loop-warmpool.md): an adoptable
        # pre-created container turns this create into a
        # relabel/env-fixup + rename -- the expensive stages were paid
        # at pool fill.  Any adoption failure falls back to the cold
        # create below, transparently.
        cid = ""
        pool_hit = False
        with self._engine_ctx(loop):
            if self.warmpool is not None and worker.engine is not None:
                entry = self.warmpool.checkout(worker.id, by=loop.agent,
                                               epoch=epoch)
                if entry is not None:
                    aopts = dataclasses.replace(
                        opts, extra_labels=dict(opts.extra_labels))
                    # pool-origin marker survives adoption so volume sweeps
                    # can trace the placeholder's volumes back to it
                    aopts.extra_labels[consts.LABEL_WARMPOOL] = entry.agent
                    try:
                        rt.adopt_pooled(entry.cid, aopts)
                        cid = entry.cid
                        pool_hit = True
                    except ClawkerError as e:
                        self.warmpool.adoption_failed(entry, str(e))
                        self._remove_cid(worker, entry.cid)
                        log.info("loop %s: pool adoption on %s failed (%s); "
                                 "cold create", loop.agent, worker.id, e)
            if not pool_hit:
                cid = rt.create(opts)
        # durable before anything acts on the cid: a crash here must find
        # the container again by (deterministic name, journaled cid).
        # The container already exists -- a broken promise here cannot
        # be unwound, so the run degrades loudly instead of stranding
        self._durable_ok(self._journal(
            REC_CREATED, durable=True, agent=loop.agent,
            worker=worker.id, epoch=epoch, cid=cid,
            pool=pool_hit), "created")
        with self._placement_lock:
            if loop.epoch != epoch:
                # orphaned mid-create: the new placement owns the loop
                # now; this container is a leftover to clean up
                loop.abandoned.append((worker, cid))
                return
            loop.container_id = cid
            loop.fresh_container = True
        self.tracer.child(loop.agent, loop.iteration, SPAN_CREATE,
                          t_create, self.tracer.now(), worker=worker.id,
                          pool=pool_hit)
        self.on_event(loop.agent, "created", worker.id)

    # ----------------------------------------------------------- iteration

    def _iteration_state_tar(self, loop: AgentLoop) -> bytes:
        body = (f"loop_id={self.loop_id}\nagent={loop.agent}\n"
                f"iteration={loop.iteration}\n").encode()
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            ti = tarfile.TarInfo("loop-state")
            ti.size = len(body)
            tf.addfile(ti, io.BytesIO(body))
        return buf.getvalue()

    def _write_iteration(self, loop: AgentLoop, engine, cid: str) -> None:
        """Per-iteration context file (env can't change after create)."""
        # analyze: allow(wal-before-mutation): advisory state file into an
        # already-journaled cid (REC_CREATED durable at create); callers
        # tolerate its loss, so there is nothing for a resume to replay
        engine.put_archive(cid, LOOP_STATE_DIR,
                           self._iteration_state_tar(loop))

    def _start_iteration(self, loop: AgentLoop, worker: Worker,
                         epoch: int) -> None:
        engine = worker.require_engine()
        rt = self._runtime(worker)
        # snapshot the placement under the lock: a stale task unblocking
        # after a migration must act on ITS container, never read (or
        # write) the new placement's container_id / fresh_container
        with self._placement_lock:
            if loop.epoch != epoch:
                return
            if loop.status not in ("pending", "running"):
                # stale restart racing a terminal transition (e.g. an
                # exit accounted through another path while this task
                # was queued): a done/failed loop must never start
                # another iteration
                return
            cid = loop.container_id
            fresh = loop.fresh_container
            # span open shares the epoch check: see _create
            self._begin_iter_span(loop, worker, epoch)
        t_start = self.tracer.now()
        try:
            self._write_iteration(loop, engine, cid)
        except ClawkerError:
            pass  # state file is advisory; the loop itself is not
        with self._engine_ctx(loop):
            if fresh:
                # first start of THIS container (iteration 0, or the first
                # iteration after a migration re-created it elsewhere): the
                # full pre/post bootstrap must run
                rt.start(cid)
            else:
                engine.start_container(cid)
                # a restarted container gets a fresh cgroup: enforcement
                # must re-enroll every iteration (the handler's drift
                # guard keys on exactly this)
                if rt.post_start:
                    rt.post_start(cid)
        with self._placement_lock:
            if loop.epoch != epoch:
                # orphaned mid-start: the orphan already moved this
                # container to the abandoned list -- committing
                # "running" would silently un-orphan a loop the rescue
                # pass owns
                return
            loop.fresh_container = False
            loop.status = "running"
            loop.strands = 0        # the placement genuinely works
        # journaled AFTER the engine start returned: a crash in between
        # reads as started=False with a running container, which the
        # reconcile pass adopts at this same iteration anyway
        self._journal(REC_STARTED, agent=loop.agent, worker=worker.id,
                      epoch=epoch, iteration=loop.iteration)
        now = self.tracer.now()
        self.tracer.child(loop.agent, loop.iteration, SPAN_START,
                          t_start, now, worker=worker.id)
        # the wait span opens here and closes when the poll accounts the
        # exit -- the container-executing phase of the iteration
        self._iter_started[(loop.agent, loop.iteration)] = now
        # mixed-path window (docs/workerd.md): this start ran DIRECT
        # (channel was down at submit) but the channel may be live
        # again -- and a live channel suppresses WAN polls/waiters for
        # this worker.  Hand workerd the exit watch so the iteration's
        # end is observed whichever path the launch took; the adopt
        # intent is idempotent server-side.
        ex = self._workerd_for(worker)
        if ex is not None:
            ex.submit_adopt(loop, epoch)
        self.on_event(loop.agent, "iteration_start", str(loop.iteration))

    def _guarded_start(self, loop: AgentLoop, epoch: int,
                       worker: Worker | None = None) -> None:
        """One worker's transient failure must never abort the other
        loops (per-worker isolation) or skip the CLI's cleanup."""
        worker = worker or loop.worker
        if self._stop.is_set() or loop.epoch != epoch:
            return
        try:
            self._start_iteration(loop, worker, epoch)
        except DriverError as e:
            # daemon unreachable mid-run: strand, don't fail -- the
            # failover policy owns the outcome (the container, if any,
            # is abandoned and re-created at the next placement)
            self._strand(loop, epoch, f"start: {e}")
        except ClawkerError as e:
            if loop.epoch != epoch:
                return      # raced an orphan mid-start; rescue owns it
            loop.status = "failed"
            self._journal(REC_LOOP_END, agent=loop.agent, status="failed",
                          reason=f"start: {e}")
            self.tracer.end_iteration(loop.agent, loop.iteration,
                                      status="failed", reason=f"start: {e}")
            self.on_event(loop.agent, "failed", f"start: {e}")
            log.error("loop %s: start failed: %s", loop.agent, e)

    def _strand(self, loop: AgentLoop, epoch: int, reason: str,
                *, penalize: bool = True) -> None:
        """Mark a loop orphaned after its worker's engine refused a
        create/start.  Runs on a lane thread; the run loop's rescue pass
        (_rescue_orphans) re-places it under the failover policy.
        ``penalize=False`` skips the breaker failure report: admission
        backpressure (a full queue) is flow control, not sickness."""
        with self._placement_lock:
            if loop.epoch != epoch or self._stop.is_set():
                return
            loop.epoch += 1
            # captured under the lock: the rescue pass may reassign
            # loop.worker the moment status flips to orphaned, and the
            # accounting below must hit the worker that FAILED, not the
            # healthy migration target
            wid = loop.worker.id
            stranded_cid = loop.container_id
            if loop.container_id:
                loop.abandoned.append((loop.worker, loop.container_id))
                loop.container_id = ""
            # close this attempt's span BEFORE the status flip publishes
            # the orphan: the run thread's rescue pass may re-place the
            # loop the moment it reads "orphaned", and its migrate hop
            # must open a fresh root, never land on this dying one
            now = self.tracer.now()
            self.tracer.child(loop.agent, loop.iteration, SPAN_ORPHAN,
                              now, now, worker=wid, reason=reason)
            self.tracer.end_iteration(loop.agent, loop.iteration,
                                      status="orphaned")
            self._iter_started.pop((loop.agent, loop.iteration), None)
            loop.status = "orphaned"
            if penalize:
                # backpressure rejections do NOT burn the strand
                # ceiling: a busy-but-healthy worker's queue draining is
                # not a deterministic daemon fault
                loop.strands += 1
                loop.retry_at = 0.0     # only rejections carry a backoff
        self._journal(REC_ORPHANED, agent=loop.agent, worker=wid,
                      cid=stranded_cid, reason=reason)
        if self.health is not None:
            if penalize:
                self.health.report_failure(wid, reason)
            self.health.note_orphaned(wid)
        self.on_event(loop.agent, "orphaned", f"{wid}: {reason}")
        log.info("loop %s stranded on %s: %s", loop.agent, wid, reason)
        if penalize:
            self._wake.set()
        # a backpressure strand retries at the fallback tick cadence
        # instead: an immediate wake would spin rescue->reject->rescue
        # at CPU speed until the queue drains

    def _finish_iteration(self, loop: AgentLoop, code: int) -> None:
        finished = loop.iteration
        loop.exit_codes.append(code)
        loop.iteration += 1
        if code == 0:
            loop.consecutive_failures = 0
        else:
            loop.consecutive_failures += 1
        now = self.tracer.now()
        t_wait = self._iter_started.pop((loop.agent, finished), now)
        status = "ok" if code == 0 else "failed"
        self.tracer.child(loop.agent, finished, SPAN_WAIT, t_wait, now,
                          worker=loop.worker.id)
        self.tracer.child(loop.agent, finished, SPAN_EXIT, now, now,
                          worker=loop.worker.id, status=status, code=code)
        self.tracer.end_iteration(loop.agent, finished, status=status,
                                  code=code)
        _ITERATIONS.labels(status).inc()
        self.on_event(loop.agent, "iteration_done", f"{loop.iteration - 1}:{code}")
        # journal records follow the event emits: a batched append may
        # fsync (milliseconds on slow filesystems), and consumers that
        # saw the status flip must not wait that long for the event --
        # replay only needs record ORDER, which is preserved
        self._journal(REC_EXITED, agent=loop.agent, iteration=finished,
                      code=code)
        if loop.consecutive_failures >= FAILURE_CEILING:
            loop.status = "failed"
            self.on_event(loop.agent, "failed",
                          f"{FAILURE_CEILING} consecutive failures")
            self._journal(REC_LOOP_END, agent=loop.agent, status="failed",
                          reason=f"{FAILURE_CEILING} consecutive failures")
        elif self.spec.iterations and loop.iteration >= self.spec.iterations:
            loop.status = "done"
            self.on_event(loop.agent, "done", f"{loop.iteration} iterations")
            self._journal(REC_LOOP_END, agent=loop.agent, status="done")

    # ------------------------------------------------------------- polling

    def _read_exit(self, loop: AgentLoop) -> tuple[int | None, str]:
        """(exit_code, failure_detail) for a stopped container.

        A ``None`` code with a detail means the iteration cannot be
        accounted: the container vanished, or it stopped with no
        ExitCode in its state -- a daemon that lost the exit status must
        read as a FAILED iteration, never as success (the old
        ``int(state.get("ExitCode") or 0)`` mapped exactly that to 0).
        A daemon that cannot be REACHED is neither: that raises
        ``_EngineUnreachable`` for the health breaker to judge.
        """
        engine = loop.worker.require_engine()
        try:
            info = engine.inspect_container(loop.container_id)
        except NotFoundError:
            return None, "container vanished"
        except ClawkerError as e:
            raise _EngineUnreachable(
                f"{loop.worker.id}: inspect failed: {e}") from e
        state = info.get("State") or {}
        if state.get("Running"):
            return None, ""        # raced a restart: not finished after all
        code = state.get("ExitCode")
        if code is None:
            return None, "stopped without exit code"
        try:
            return int(code), ""
        except (TypeError, ValueError):
            return None, f"unreadable exit code {code!r}"

    def _poll_lane(self, engine, loops: list[AgentLoop]
                   ) -> list[tuple[AgentLoop, int | None, str]]:
        """ONE ``list_containers`` round-trip for every loop agent this
        worker hosts (the serial loop paid one inspect per agent per
        tick), then one inspect per *stopped* container for its exit
        code.  Runs on the worker's lane, so a hung engine blocks only
        its own worker's poll.  Raises ``_EngineUnreachable`` when the
        daemon itself is gone: run() routes that to the health breaker
        (the failover policy decides the loops' fate), instead of the
        old behavior of failing every loop on the first dead poll."""
        try:
            rows = engine.list_containers(all=True, filters={
                "label": [f"{consts.LABEL_LOOP}={self.loop_id}"]})
        except ClawkerError as e:
            # transient list hiccup vs daemon-down: one cheap ping
            # decides (real engines return False rather than raising)
            try:
                alive = engine.ping()
            except Exception as pe:     # noqa: BLE001
                raise _EngineUnreachable(
                    f"list+ping failed: {pe}") from e
            if not alive:
                raise _EngineUnreachable(f"list+ping failed: {e}") from e
            rows = None
        out: list[tuple[AgentLoop, int | None, str]] = []
        if rows is None:
            # daemon answers pings but the list failed: fall back to
            # per-container inspects this tick
            for l in loops:
                code, detail = self._read_exit(l)
                if code is not None or detail:
                    out.append((l, code, detail))
            return out
        state_by_id = {r.get("Id", ""): str(r.get("State") or "").lower()
                       for r in rows}
        for l in loops:
            st = state_by_id.get(l.container_id)
            if st is None:
                out.append((l, None, "container vanished"))
            elif st not in _ACTIVE_STATES:
                code, detail = self._read_exit(l)
                if code is not None or detail:
                    out.append((l, code, detail))
        return out

    def _spawn_waiter(self, loop: AgentLoop) -> None:
        """Blocking ``wait_container`` on a side thread: a finished
        iteration wakes run() immediately instead of waiting out the
        poll interval.  Purely a wake-up -- the batched poll stays the
        source of truth for exit accounting."""
        key = (loop.agent, loop.iteration)
        if key in self._waited:
            return
        self._waited.add(key)
        engine = loop.worker.require_engine()
        cid = loop.container_id
        wid = loop.worker.id

        def wait() -> None:
            try:
                engine.wait_container(cid)
            except Exception:
                pass
            # the hint makes the NEXT tick submit this worker's poll
            # immediately instead of waiting out the fallback cadence
            self._exit_hints.add(wid)
            self._wake.set()

        threading.Thread(target=wait, daemon=True,
                         name=f"loop-wait-{loop.agent}-{loop.iteration}").start()

    # ----------------------------------------------------------------- run

    def run(self, *, poll_s: float = 0.5) -> list[AgentLoop]:
        """Drive every loop to completion (or stop()); returns final states.

        Event-driven: waiter threads wake the loop the moment an
        iteration exits, and poll futures wake it the moment they
        complete (done-callbacks on the waker event), so ``poll_s`` only
        bounds the fallback re-check cadence (and stop() latency) -- it
        can stay coarse without slowing restarts down, and one wedged
        worker's never-completing poll future no longer degrades healthy
        workers' restarts to poll-interval latency.

        The fleet :class:`HealthMonitor` runs for the duration: breaker
        verdicts (from probes, unreachable polls, and wedged lanes) are
        drained each tick on THIS thread, so orphaning and migration
        never race the accounting.
        """
        for loop in self.loops:
            # compat: loops registered without start() still launch here
            if loop.agent not in self._inflight:
                if loop.status == "pending":
                    self._submit_launch(loop, loop.worker, loop.epoch,
                                        self._launch)
                else:
                    done: Future = Future()
                    done.set_result(None)
                    self._inflight[loop.agent] = done
        self._ensure_health().start()
        wedge_after = max(4.0 * poll_s, LANE_WEDGE_FLOOR_S)
        polls: dict[str, Future] = {}
        poll_running_since: dict[str, float] = {}    # first tick seen EXECUTING
        launch_running_since: dict[str, float] = {}  # agent -> ditto, inflight
        poll_epochs: dict[str, dict[str, int]] = {}  # wid -> agent epochs
        #                                              at poll submit
        next_poll_at: dict[str, float] = {}   # backoff after unreachable
        poll_errs: dict[str, int] = {}
        unreach = self._unreach
        wedged: set[str] = set()
        try:
            while not self._stop.is_set():
                self._wake.clear()
                self._harvest_inflight()
                self._drain_verdicts()
                self._rescue_orphans()
                # queue hygiene: melt cancelled tickets (orphaned/stopped
                # placements) and dispatch anything their removal unblocks
                self.admission.sweep()
                self._pool_tick()
                if self.pressure is not None:
                    # disk-pressure ladder rides the run thread at its
                    # own statvfs cadence (docs/durability.md#ladder)
                    self.pressure.tick()
                # a loop is busy while running or orphaned (awaiting
                # failover), or while its create/start/restart is still
                # queued on a (possibly wedged) worker lane
                busy = [l for l in self.loops
                        if l.status in ("running", "orphaned")
                        or not self._inflight[l.agent].done()]
                if not busy:
                    break
                pollable = [l for l in self.loops
                            if l.status == "running"
                            and self._inflight[l.agent].done()]
                by_worker: dict[str, list[AgentLoop]] = {}
                for l in pollable:
                    if self._workerd_for(l.worker) is not None:
                        # exits stream over the workerd channel: no WAN
                        # waiter, no WAN poll.  A degraded channel drops
                        # the worker back into this table next tick.
                        continue
                    self._spawn_waiter(l)
                    by_worker.setdefault(l.worker.id, []).append(l)
                now = time.monotonic()
                # a launch/restart EXECUTING far past any legitimate
                # duration means the lane is wedged inside a dedicated
                # read-unbounded engine call on a daemon that may still
                # answer probes -- without this, such a loop would hang
                # forever with no poll ever submitted for it
                for l in self.loops:
                    # wedge detection reads the dispatched LANE task --
                    # a launch still waiting in the admission queue has
                    # no lane task and is by definition not wedging one
                    fut = self._lane_task.get(l.agent)
                    if (l.status not in ("pending", "running")
                            or fut is None or fut.done()
                            or not fut.running()):
                        # an orphaned loop's stale future may stay
                        # running forever on the retired lane: reporting
                        # it again would re-trip every half-open trial
                        # and pin the worker open past recovery
                        launch_running_since.pop(l.agent, None)
                        continue
                    started = launch_running_since.setdefault(l.agent, now)
                    if now - started >= self.launch_wedge_s:
                        self.health.report_wedge(
                            l.worker.id, f"launch/restart executing "
                                         f"{now - started:.1f}s")
                for wid, group in by_worker.items():
                    pending = polls.get(wid)
                    if pending is not None:
                        if self._poll_is_stale(poll_epochs.get(wid, {})):
                            # every loop this poll was submitted for has
                            # moved on (orphaned, then resumed/migrated):
                            # abandon the stale future so a recovered
                            # worker's polls aren't blocked behind it
                            # forever (its results are unusable anyway)
                            polls.pop(wid, None)
                            poll_epochs.pop(wid, None)
                            poll_running_since.pop(wid, None)
                            wedged.discard(wid)
                        else:
                            # wedge detection clocks time EXECUTING on
                            # the lane -- a poll merely queued behind a
                            # slow-but-healthy create/bootstrap must not
                            # trip the breaker
                            if pending.running():
                                started = poll_running_since.setdefault(
                                    wid, now)
                                if (now - started >= wedge_after
                                        and wid not in wedged):
                                    wedged.add(wid)
                                    self.health.report_wedge(
                                        wid, f"poll executing "
                                             f"{now - started:.1f}s")
                            continue
                    # polls are demand-driven: an exit hint (waiter fired
                    # since the last poll) submits one immediately, else
                    # the fallback cadence applies -- submitting on every
                    # tick would spin, since each completion wakes a tick
                    if (wid not in self._exit_hints
                            and now < next_poll_at.get(wid, 0.0)):
                        continue
                    self._exit_hints.discard(wid)
                    engine = group[0].worker.require_engine()
                    fut = self._lane(group[0].worker).submit(
                        self._poll_lane, engine, list(group))
                    # completion wakes the tick immediately: no healthy
                    # worker ever waits out another worker's poll
                    fut.add_done_callback(lambda _f: self._wake.set())
                    polls[wid] = fut
                    poll_epochs[wid] = {l.agent: l.epoch for l in group}
                    next_poll_at[wid] = now + poll_s
                # workerd-streamed exits first: already deduped against
                # stale epochs/iterations, accounted through the same
                # block as poll results below
                finished: list[tuple[AgentLoop, int | None, str]] = \
                    self._drain_remote_exits()
                for wid in list(polls):
                    fut = polls[wid]
                    if not fut.done():
                        continue         # slow worker: re-harvest next tick
                    del polls[wid]
                    poll_running_since.pop(wid, None)
                    epochs = poll_epochs.pop(wid, {})
                    wedged.discard(wid)
                    try:
                        # a result only counts for loops still at the
                        # placement the poll was submitted for: a wedged
                        # poll completing AFTER its loops were orphaned
                        # and migrated must not fail the healthy
                        # re-placements ("container vanished" on the old
                        # worker is about the old placement, not them)
                        finished.extend(
                            (l, c, d) for l, c, d in fut.result()
                            if l.epoch == epochs.get(l.agent, l.epoch))
                        poll_errs.pop(wid, None)
                        unreach.pop(wid, None)
                        self.health.report_success(wid)
                    except _EngineUnreachable as e:
                        unreach[wid] = unreach.get(wid, 0) + 1
                        # a fresh successful probe is direct evidence the
                        # daemon is alive (unlike breaker state, it can't
                        # be perturbed by our own failure reports): a
                        # deterministic inspect/list fault, not death --
                        # feeding the breaker would quarantine a healthy
                        # worker, and never escalating would spin run()
                        # forever behind a breaker that never opens
                        alive = self.health.probe_says_alive(wid)
                        if alive and unreach[wid] >= FAILURE_CEILING:
                            # the freshness window can straddle the
                            # moment of death: confirm with a probe NOW
                            # before condemning the loops
                            group = by_worker.get(wid) or ()
                            confirm = (self.health.probe_worker(
                                group[0].worker) if group else None)
                            if confirm is not None and confirm.ok:
                                unreach[wid] = 0
                                finished.extend(
                                    (l, None, f"poll unreachable: {e}")
                                    for l in group)
                                continue
                            alive = False   # confirmation failed: dying
                        if not alive:
                            # the worker may be dying -- health's call,
                            # not the poll's: the breaker opens after K
                            # of these (or the probes get there first)
                            # and the failover policy takes over
                            self.health.report_failure(wid, str(e))
                    except Exception as e:
                        # a DETERMINISTIC poll crash (engine bug,
                        # malformed state) would otherwise retry at
                        # poll_s cadence forever with the loops stuck
                        # "running"
                        log.error("loop poll on %s failed: %r", wid, e)
                        poll_errs[wid] = poll_errs.get(wid, 0) + 1
                        if poll_errs[wid] >= FAILURE_CEILING:
                            finished.extend(
                                (l, None, f"poll crashed: {e!r}")
                                for l in by_worker.get(wid, ()))
                progressed = False
                for loop, code, detail in finished:
                    if loop.status != "running":
                        continue
                    progressed = True
                    self._waited.discard((loop.agent, loop.iteration))
                    if code is None:
                        loop.status = "failed"
                        self._journal(REC_LOOP_END, agent=loop.agent,
                                      status="failed", reason=detail)
                        self._iter_started.pop(
                            (loop.agent, loop.iteration), None)
                        self.tracer.end_iteration(
                            loop.agent, loop.iteration,
                            status="failed", reason=detail)
                        self.on_event(loop.agent, "failed", detail)
                        continue
                    self._finish_iteration(loop, code)
                    if loop.status == "running":  # budget left: next iteration
                        self._submit_launch(loop, loop.worker, loop.epoch,
                                            self._guarded_start)
                if not progressed:
                    self._wake.wait(poll_s)
        finally:
            self.health.stop()
            # settle tickets a stop/abort left in the admission queue:
            # their cancelled() now reads true, and sweeping completes
            # their handles so wait_launched callers never hang
            self.admission.sweep()
        if self._aborted:
            # kill(): the crash seam -- return exactly what SIGKILL would
            # leave behind (no halts, no span flush, no shutdown records;
            # the journal's batched tail stays wherever it was)
            return self.loops
        if self._stop.is_set():
            self._halt_running()
        # iterations still open (stop(), a failed loop's in-flight span)
        # must land in the flight record before callers read it
        self.tracer.close_open(
            "stopped" if self._stop.is_set() else "failed")
        # callers read final states + their own on_event capture right
        # after run(); make sure every stamped event reached the sink
        self.events.flush()
        if self.journal is not None:
            self.journal.sync()
        return self.loops

    # ----------------------------------------------------------- failover

    def _poll_is_stale(self, snap: dict[str, int]) -> bool:
        """True when EVERY loop a pending poll was submitted for has
        moved on (epoch bumped by orphan/strand, or gone entirely) --
        the future's results are unusable and keeping it would block a
        recovered worker's fresh polls forever.  Checked against ALL
        loops, not the worker's current group: a loop that migrated AWAY
        is exactly the 'moved on' case."""
        if not snap:
            return False
        live = {l.agent: l.epoch for l in self.loops}
        return all(live.get(agent, epoch + 1) != epoch
                   for agent, epoch in snap.items())

    def _drain_verdicts(self) -> None:
        """Apply queued breaker transitions on the run thread.  Only the
        OPEN edge needs action (orphan the worker's loops); recovery is
        picked up by the per-tick rescue pass, which sees the closed
        breaker directly."""
        while True:
            try:
                wid, old, new, reason = self._verdicts.get_nowait()
            except queue.Empty:
                return
            if new == BREAKER_OPEN:
                self._orphan_worker(wid, reason)
            elif new == BREAKER_CLOSED:
                # retire the worker's lane at recovery too (the same
                # mechanism quarantine uses at open): a lane brought up
                # while the breaker cycled may still be wedged inside a
                # dedicated read-unbounded engine call that queued tasks
                # never trip wedge detection for -- launches resumed
                # under `--failover wait` must start on a FRESH thread,
                # never queue behind the stuck call (ROADMAP: PR-3 known
                # limitation).  Queued tasks on the old lane are
                # epoch-guarded and no-op when (if) the thread unblocks.
                self.lanes.retire(wid)
                self._unreach.pop(wid, None)   # a fresh episode starts clean
                # the halt attempted at orphan time ran against a dead
                # daemon and likely failed: a recovered worker may still
                # be running the abandoned copy of a migrated agent --
                # re-halt now that the daemon answers
                for loop in self.loops:
                    for worker, cid in list(loop.abandoned):
                        if worker.id == wid:
                            self._halt_abandoned(worker, cid)

    def _orphan_worker(self, wid: str, reason: str) -> None:
        # retire the worker's lane: its single thread may be parked
        # inside the very call that got the worker quarantined (a
        # dedicated read-unbounded engine op never errors out), and
        # abandoning futures does not free the thread -- work submitted
        # after recovery must get a FRESH lane thread, not queue behind
        # the wedged one.  Tasks already queued on the old lane are
        # epoch-guarded, so they no-op when (if) the thread unblocks.
        self.lanes.retire(wid)
        self._unreach.pop(wid, None)   # the episode ends with the orphaning
        for loop in self.loops:
            halt_cid = ""
            with self._placement_lock:
                if loop.worker.id != wid:
                    continue
                if loop.status not in ("pending", "running"):
                    continue
                loop.epoch += 1        # stale lane tasks for this placement die
                # span close precedes the status flip for the same
                # reason as in _strand (the rescue pass runs on this
                # thread, but lane tasks read the open-span table too)
                now = self.tracer.now()
                self.tracer.child(loop.agent, loop.iteration, SPAN_ORPHAN,
                                  now, now, worker=wid, reason=reason)
                self.tracer.end_iteration(loop.agent, loop.iteration,
                                          status="orphaned")
                self._iter_started.pop((loop.agent, loop.iteration), None)
                loop.status = "orphaned"
                loop.retry_at = 0.0     # a worker death supersedes any
                #                         admission backoff hint
                self._waited.discard((loop.agent, loop.iteration))
                if loop.container_id:
                    loop.abandoned.append((loop.worker, loop.container_id))
                    halt_cid = loop.container_id
                    loop.container_id = ""
            self._journal(REC_ORPHANED, agent=loop.agent, worker=wid,
                          cid=halt_cid, reason=reason)
            if halt_cid:
                # best-effort halt OFF the wedged lane: stop rides a
                # dedicated never-pooled socket (engine/httpapi), so a
                # dead worker's pool is never part of the attempt
                self._halt_abandoned(loop.worker, halt_cid)
            if self.health is not None:
                self.health.note_orphaned(wid)
            self.on_event(loop.agent, "orphaned", f"{wid}: {reason}")
        # zero the worker's admission bucket LAST (epochs above are
        # bumped, so its pending tickets read stale and melt in the
        # reset's pump): launches admitted there strand on the retired
        # lane, and their eventual releases must not free tokens in a
        # recovered worker's fresh bucket
        self.admission.reset_worker(wid)

    def _rescue_orphans(self) -> None:
        """Re-place orphaned loops under the failover policy.  Runs every
        tick: orphans that found no healthy target (or whose worker has
        not recovered yet, under ``wait``) are retried at tick cadence.
        """
        orphans = [l for l in self.loops if l.status == "orphaned"]
        if not orphans or self.health is None:
            return
        policy = self.spec.failover
        now = time.monotonic()
        for loop in orphans:
            # a bounded wait for a placement: when the whole fleet is
            # dead (or the waited-for worker never recovers), the run
            # must eventually fail and return rather than hang a
            # non-interactive invocation forever
            since = self._orphan_since.setdefault(loop.agent, now)
            if now - since >= self.orphan_grace_s:
                self._fail_orphan(loop, f"no healthy placement for "
                                        f"{now - since:.0f}s "
                                        f"(failover={policy})")
                continue
            # a loop that keeps stranding across placements while the
            # breakers read healthy is hitting a DETERMINISTIC daemon
            # failure (bad image, disk full): stop churning, fail it --
            # ADMITTED re-placements reset the grace timer
            # (_submit_launch), so this ceiling bounds that cycle while
            # the grace bounds rejection churn (which never burns it)
            if loop.strands >= STRAND_CEILING:
                self._fail_orphan(loop, f"{loop.strands} consecutive "
                                        "stranded create/starts")
                continue
            # a rejected-with-backoff loop honors the queue's
            # retry_after_s: re-placing before it would bounce straight
            # off the same full (or shed) queue -- the orphan-grace
            # clock keeps running above, so the backoff can never
            # extend a run past --orphan-grace
            if loop.retry_at and now < loop.retry_at:
                continue
            if policy == "fail":
                self._fail_orphan(loop, f"worker {loop.worker.id} "
                                        "unhealthy (failover=fail)")
                continue
            if policy == "wait":
                # resume on the SAME worker once its breaker closes
                if self.health.state(loop.worker.id) != BREAKER_CLOSED:
                    continue
                target = loop.worker
            else:                       # migrate
                # prefer a DIFFERENT worker: the orphan's own worker may
                # still read closed (one stranded create is below the
                # breaker threshold) yet just refused a create -- but
                # fall back to it rather than strand the only worker of
                # a one-worker fleet behind a transient blip.  The
                # policy picks (topology prefers the ICI-closest healthy
                # worker; everyone weighs load by probe latency).
                ctx = self._placement_ctx()
                target = (self.policy.pick(
                    ctx, exclude={loop.worker.id}, near=loop.worker)
                    or self.policy.pick(ctx, near=loop.worker))
                if target is None:
                    continue            # no healthy worker right now
            with self._placement_lock:
                if loop.status != "orphaned":
                    continue            # raced a concurrent transition
                old = loop.worker
                loop.worker = target
                loop.status = "pending"
                loop.fresh_container = True
                loop.retry_at = 0.0
            # NOTE: _orphan_since is NOT cleared here -- only an ADMITTED
            # re-submission clears it (_submit_launch), so a loop cycling
            # orphan -> re-place -> admission-rejected stays on the
            # grace clock and --orphan-grace bounds the churn
            # write-ahead: the new placement is durable before its launch
            # is submitted, so a crash mid-migration resumes at the NEW
            # worker instead of resurrecting the dead placement
            if target.id != old.id:
                self._journal(REC_MIGRATED, agent=loop.agent,
                              src=old.id, dst=target.id)
            rcpt = self._journal(REC_PLACEMENT, durable=True,
                                 agent=loop.agent, worker=target.id,
                                 epoch=loop.epoch,
                                 tenant=self.spec.tenant)
            if not self._durable_ok(rcpt, "placement"):
                # storage fault: the WAL-before-create contract is never
                # waived.  Strand WITHOUT breaker penalty (the worker is
                # fine, the disk is not); the next rescue pass retries
                # once the journal's lazy reopen / the pressure GC has
                # had a chance to recover it
                self._strand(loop, loop.epoch,
                             "storage fault: placement not durable",
                             penalize=False)
                continue
            note_decision(self.policy.name, target.id)
            self.on_event(loop.agent, PLACEMENT_DECISION, PlacementEvent(
                loop.agent, target.id, self.policy.name, self.spec.tenant,
                "replaced", f"from {old.id}").detail())
            # the re-placed attempt gets a FRESH root span (the orphaned
            # attempt's root closed when the worker died); the hop rides
            # it as a zero-width migrate child so `loop trace` can show
            # where the iteration travelled
            self.tracer.begin_iteration(loop.agent, loop.iteration,
                                        target.id, epoch=loop.epoch,
                                        resumed=True)
            # NOT `now`: the tracer clock is epoch time, and clobbering
            # the pass's monotonic `now` here would feed the NEXT
            # orphan's grace/backoff checks a 50-year delta
            t_span = self.tracer.now()
            if target.id != old.id:
                loop.migrations += 1
                self.health.note_migration(old.id, target.id)
                self.tracer.child(loop.agent, loop.iteration, SPAN_MIGRATE,
                                  t_span, t_span, worker=target.id,
                                  src=old.id, dst=target.id,
                                  hop=loop.migrations)
                self.on_event(loop.agent, "migrated",
                              f"{old.id}->{target.id}")
            else:
                self.on_event(loop.agent, "resumed", target.id)
            self._submit_launch(loop, target, loop.epoch, self._launch)

    def _fail_orphan(self, loop: AgentLoop, detail: str) -> None:
        loop.status = "failed"
        # the loop may still be "inflight" behind a wedged lane task
        # that will never complete: replace the future or busy stays
        # truthy and run() never returns
        done: Future = Future()
        done.set_result(None)
        self._inflight[loop.agent] = done
        self._orphan_since.pop(loop.agent, None)
        self._journal(REC_LOOP_END, agent=loop.agent, status="failed",
                      reason=detail)
        self.tracer.end_iteration(loop.agent, loop.iteration,
                                  status="failed", reason=detail)
        self.on_event(loop.agent, "failed", detail)

    def _load_by_worker(self) -> dict[str, int]:
        load: dict[str, int] = {}
        for l in self.loops:
            if l.status in ("pending", "running"):
                load[l.worker.id] = load.get(l.worker.id, 0) + 1
        return load

    def _halt_abandoned(self, worker: Worker, cid: str) -> None:
        if (worker.id, cid) in self._halted:
            return      # a previous halt landed; don't re-stop per recovery

        def halt() -> None:
            try:
                worker.require_engine().stop_container(cid, timeout=2)
                self._halted.add((worker.id, cid))
            except Exception:           # noqa: BLE001 -- best effort by design
                pass

        threading.Thread(target=halt, daemon=True,
                         name=f"loop-halt-{cid[:12]}").start()

    def _harvest_inflight(self) -> None:
        """Unexpected (non-ClawkerError) lane crashes must surface as a
        failed loop, not evaporate inside a future nobody reads."""
        for loop in self.loops:
            fut = self._inflight.get(loop.agent)
            if fut is None or not fut.done():
                continue
            exc = fut.exception()
            if exc is not None and loop.status in ("pending", "running"):
                loop.status = "failed"
                self._journal(REC_LOOP_END, agent=loop.agent, status="failed",
                              reason=f"internal: {exc!r}")
                self.tracer.end_iteration(loop.agent, loop.iteration,
                                          status="failed",
                                          reason=f"internal: {exc!r}")
                self.on_event(loop.agent, "failed", f"internal: {exc!r}")
                log.error("loop %s: lane task crashed: %r", loop.agent, exc)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def kill(self) -> None:
        """Simulate scheduler death (loopd's crash seam): cease all
        activity WITHOUT journaling, halting containers, flushing spans,
        or cleaning up -- exactly the state SIGKILL leaves behind.  Lane
        guards see the stop flag, so queued tasks die the way a killed
        process's threads would."""
        self._aborted = True
        self._stop.set()
        self._wake.set()

    def request_shutdown(self, reason: str = "stop") -> None:
        """Graceful drain with a durable ``shutdown`` journal record --
        the marker that tells a later ``--resume`` this run ended
        cleanly (stopped loops, not a crash).  Idempotent: the CLI's
        first Ctrl-C and its SIGTERM path both land here."""
        if not self._shutdown_journaled:
            self._shutdown_journaled = True
            self._durable_ok(self._journal(REC_SHUTDOWN, durable=True,
                                           reason=reason), "shutdown")
        self.stop()

    def _halt_running(self) -> None:
        futs = []
        for loop in self.loops:
            if loop.status != "running":
                continue
            futs.append(self._lane(loop.worker).submit(self._halt_one, loop))
            loop.status = "stopped"
            self._journal(REC_LOOP_END, agent=loop.agent, status="stopped")
            self.on_event(loop.agent, "stopped")
        if futs:
            futures_wait(futs, timeout=HALT_DEADLINE_S)

    def _halt_one(self, loop: AgentLoop) -> None:
        try:
            loop.worker.require_engine().stop_container(loop.container_id,
                                                        timeout=5)
        except ClawkerError:
            pass

    def status(self) -> list[dict]:
        out = []
        for l in self.loops:
            row = l.summary()
            if self.anomaly_watch is not None:
                sc = self.anomaly_watch.score_for(l.agent)
                if sc is not None:
                    row["anomaly_z"] = round(sc.latest, 2)
            out.append(row)
        return out

    def cleanup(self, *, remove_containers: bool = False) -> None:
        # the warm pool drains unconditionally (even under --keep): its
        # members are framework plumbing, not user containers, and
        # "zero leaked pool containers after drain" is the contract.
        # The per-lane drain task runs AFTER queued fills; fills that
        # complete past the flag discard their own container.
        if self.warmpool is not None:
            self.warmpool.begin_drain()
            pool_futs = [self._lane(w).submit(self._drain_pool_worker, w)
                         for w in self.warmpool.workers()
                         if w.engine is not None]
            if pool_futs:
                futures_wait(pool_futs, timeout=HALT_DEADLINE_S)
        if remove_containers:
            # submit a removal for EVERY loop: it rides the same lane as
            # the loop's launch, so by the time it runs the launch has
            # drained and container_id is authoritative (checking it here
            # on the main thread could snapshot '' mid-create and leak)
            futs = [self._lane(loop.worker).submit(self._remove_one, loop)
                    for loop in self.loops]
            # containers abandoned on dead/recovered workers by failover
            # ride THEIR worker's lane (a dead worker's removal fails
            # fast or eats the bounded wait, never the healthy lanes').
            # The label sweep covers every worker any GENERATION of this
            # run touched -- final placements, failover-abandoned
            # workers, and (for a resumed run) the journaled fleet:
            # after a kill/resume cycle a worker may hold only an
            # earlier generation's leftovers (exited copies,
            # un-restored pool members) that no current loop points at.
            # Not the whole live fleet -- cleanup cost scales with the
            # run, and a worker no generation saw cannot hold this run's
            # label.  Engine-less stand-ins are excluded everywhere: a
            # sweep on one would die at require_engine before its
            # guarded list call.
            journaled = (set(self._image.workers)
                         if self._image is not None else set())
            # every worker a launch/refill was ever SUBMITTED to joins
            # the journaled set: a remote create whose `created` event
            # died with its workerd (after the loop migrated away)
            # leaves a labeled container no final placement or
            # abandoned entry points at
            journaled |= self._placed_workers
            sweep_workers: dict[str, Worker] = {
                w.id: w for w in self.driver.workers()
                if w.engine is not None and w.id in journaled}
            for loop in self.loops:
                if loop.worker.engine is not None:
                    sweep_workers.setdefault(loop.worker.id, loop.worker)
                for worker, cid in loop.abandoned:
                    if worker.engine is not None:
                        sweep_workers.setdefault(worker.id, worker)
                    futs.append(self._lane(worker).submit(
                        self._remove_cid, worker, cid))
            # label-scoped sweep: a create whose response was lost AFTER
            # the daemon executed it (the case the engine client must
            # not blindly re-send) leaves a container in neither
            # container_id nor abandoned -- only listing by this run's
            # loop label catches such ghosts
            futs.extend(self._lane(w).submit(self._sweep_worker, w)
                        for w in sweep_workers.values())
            if futs:
                futures_wait(futs, timeout=HALT_DEADLINE_S)
        if self._owns_lanes:
            # a SHARED registry (loopd) outlives this run: the daemon
            # closes it at its own shutdown, and other runs' queued
            # work must not die with ours
            self.lanes.close_all()
        self.tracer.close_open("stopped")
        if self.flight is not None:
            self.flight.close()
        if self.journal is not None:
            self.journal.close()
        self.events.flush()
        self.events.close()

    def _remove_one(self, loop: AgentLoop) -> None:
        if not loop.container_id:
            return      # create never ran (failed, or aborted by stop())
        self._remove_cid(loop.worker, loop.container_id)

    def _remove_cid(self, worker: Worker, cid: str) -> None:
        try:
            worker.require_engine().remove_container(
                cid, force=True, volumes=True)
        except ClawkerError:
            pass

    def _sweep_worker(self, worker: Worker) -> None:
        """Remove every container carrying THIS run's loop label on the
        worker -- the backstop for ghosts no bookkeeping tracked."""
        engine = worker.require_engine()
        try:
            rows = engine.list_containers(all=True, filters={
                "label": [f"{consts.LABEL_LOOP}={self.loop_id}"]})
        except ClawkerError:
            return
        for row in rows:
            self._remove_cid(worker, row.get("Id", ""))
