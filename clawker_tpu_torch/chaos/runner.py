"""Chaos soak runner: execute fault plans against a fake pod, audit,
shrink failures to minimal repros.

One :class:`ChaosRunner` executes one :class:`~.plan.FaultPlan` end to
end: build the fake pod, start the scheduler, walk the injection
schedule (worker faults through the driver's fault gates; CLI SIGKILLs
through armed crash seams followed by ``--resume`` reconciliation,
kill/resume cycles included), drive the run to completion, clean up,
then run :func:`~.invariants.check_invariants`.  ``run_soak`` iterates
N seeded scenarios and, on the first failure, calls
:func:`shrink_plan` -- greedy delta-debugging over the event list -- so
the report carries the SMALLEST schedule that still breaks an
invariant, plus the exact ``--seed``/``--scenario`` repro.

:class:`ChaosController` is the ``clawker loop --chaos-plan`` dev hook:
it applies a plan's schedule to a LIVE scheduler the CLI already built
(worker faults only where the driver supports injection; ``cli_sigkill``
events deliver a real SIGKILL so ``--resume`` can be crash-tested
against a genuine process death).

The port's copy of ``clawker_tpu/chaos/runner.py``.  The fleet sentinel
the sentinel scenarios and the observe-only twin attach scores on
``device`` (default ``"cuda"``): every scored tick one K3 fit and one K1
score on the card.  The device is resolved before anything runs -- a
plan with ``sentinel: true``, :func:`run_observe_only_check` and
:func:`run_soak` raise the device error without a card unless
``device="cpu"`` -- so the sentinel never silently drops out of a
scenario, and the observe-only verdict is always a verdict (never the
reference's "skipped" when its accelerator runtime is missing).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field

from .. import logsetup, telemetry
from ..analytics import runtime as art
from ..errors import ClawkerError
from .invariants import (
    check_invariants,
    observe_only_violations,
    scheduling_outcome,
)
from .plan import GATE_MODE, POD_GATE_MODE, FaultEvent, FaultPlan, generate_plan
from .seams import SeamAbort, SeamRegistry

log = logsetup.get("chaos.runner")

_INJECTIONS = telemetry.counter(
    "chaos_injections_total", "Fault events injected by the chaos runner",
    labels=("kind",))
_SCENARIOS = telemetry.counter(
    "chaos_scenarios_total", "Chaos scenarios executed",
    labels=("result",))         # result: ok | violated | error
_VIOLATIONS = telemetry.counter(
    "chaos_invariant_violations_total",
    "Invariant violations found by chaos scenarios",
    labels=("invariant",))

def apply_fault(driver, ev: FaultEvent) -> None:
    """Apply one worker-fault event to an injectable driver -- the ONE
    event-kind -> fault-gate mapping shared by the soak runner and the
    live `loop --chaos-plan` controller."""
    if ev.kind == "worker_revive":
        driver.clear_fault(ev.worker)
        return
    if ev.kind in POD_GATE_MODE:
        # pod-scope faults hit EVERY worker's gate at once (the whole
        # pod's control plane dies / partitions; docs/federation.md).
        # The all-workers view keeps fixed-seed schedules meaningful
        # when an earlier scale_down shrank workers()
        all_workers = getattr(driver, "all_workers", None)
        n = len(all_workers() if all_workers is not None
                else driver.workers())
        for i in range(n):
            driver.inject_fault(i, POD_GATE_MODE[ev.kind])
        return
    kw = {}
    if ev.kind == "worker_slow":
        kw["delay_s"] = float(ev.arg or 0.1)
    elif ev.kind == "engine_burst":
        kw["count"] = int(ev.arg or 3)
    driver.inject_fault(ev.worker, GATE_MODE[ev.kind], **kw)


IMAGE = "clawker-chaos:default"
# generous end-to-end ceiling per scenario: a scenario that cannot
# drain within this is itself an invariant violation (stuck-run)
SCENARIO_DEADLINE_S = 60.0
MAX_GENERATIONS = 4             # sigkill/resume cycles per scenario bound

# gitguard scenarios: the run name + agent pool the deterministic
# push-probe schedule draws identities/refs from (docs/git-policy.md)
GITGUARD_RUN = "chaosrun"
GITGUARD_AGENTS = 3
GITGUARD_PROBES = 8


def gitguard_probe_script(seed: int,
                          scenario: int) -> list[tuple[str, str, str, str]]:
    """Deterministic push-probe schedule for a gitguard scenario:
    ``(kind, identity_header, ref, new_sha)`` per probe, drawn from the
    (seed, scenario) pair alone -- same plan, same probes, every
    machine.  Kinds: own-namespace push (must land), sibling-namespace
    and integration-branch pushes (must be refused at the proxy), and
    an occasional merge-queue landing (the ONE identity allowed onto
    the integration branch)."""
    import random

    rng = random.Random(
        (int(seed) & 0xFFFFFFFF) * 7_919 + int(scenario) + 1)
    probes: list[tuple[str, str, str, str]] = []
    for _ in range(GITGUARD_PROBES):
        kind = rng.choice(("own", "own", "own", "sibling", "sibling",
                           "integration", "mergeq"))
        a = rng.randrange(GITGUARD_AGENTS)
        sha = format(rng.getrandbits(160), "040x")
        if kind == "own":
            ident = f"{GITGUARD_RUN}/agent-{a}"
            ref = f"refs/heads/loop/{GITGUARD_RUN}/agent-{a}/work"
        elif kind == "sibling":
            other = (a + 1) % GITGUARD_AGENTS
            ident = f"{GITGUARD_RUN}/agent-{a}"
            ref = f"refs/heads/loop/{GITGUARD_RUN}/agent-{other}/work"
        elif kind == "integration":
            ident = f"{GITGUARD_RUN}/agent-{a}"
            ref = f"refs/heads/loop/{GITGUARD_RUN}/merged"
        else:
            ident = f"{GITGUARD_RUN}/queue/mergeq"
            ref = f"refs/heads/loop/{GITGUARD_RUN}/merged"
        probes.append((kind, ident, ref, sha))
    return probes
SENTINEL_TRAIN_STEPS = 20       # one step count for every chaos sentinel
#                                 fit: the soak and the observe-only twin
#                                 launch K3 at the same [n, 40] x 20


def resolve_device(device: str = art.DEFAULT_DEVICE) -> str:
    """Resolve the sentinel's device before any scenario runs: on a
    CUDA device, open its context and build or load the kernels
    (``runtime.bring_up``), so the first scored tick launches at once;
    without a card the device error is raised here."""
    art.bring_up(device)
    return str(device)


class _EgressFeeder:
    """Synthetic per-worker egress streams for sentinel scenarios.

    Writes benign netlogger-shaped records into each worker's
    ``ebpf-egress-<worker>.jsonl`` under the scenario's logs dir (the
    sentinel collector's fake-pod convention) on a feeder thread.
    ``silence(i)`` stops worker i's stream mid-run; ``flood(i, n)``
    bursts n records at once -- the two stream-level faults the
    ``sentinel`` chaos scenario injects."""

    def __init__(self, cfg, worker_ids: list[str], *, hz: float = 20.0):
        self.cfg = cfg
        self.worker_ids = list(worker_ids)
        self.hz = hz
        self._silent: set[str] = set()
        self._stop = threading.Event()
        self._n = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-egress-feeder")

    def path(self, wid: str):
        return self.cfg.logs_dir / f"ebpf-egress-{wid}.jsonl"

    def _record(self, wid: str) -> dict:
        self._n += 1
        return {
            "@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "service": "ebpf-egress",
            "container": f"clawker.chaosproj.{wid}-agent{self._n % 3}",
            "worker": wid, "dst_ip": "198.51.100.9",
            "dst_port": 443, "proto": 6, "verdict": "ALLOW",
            "reason": "ROUTE", "zone": "example.com",
        }

    def _append(self, wid: str, n: int) -> None:
        try:
            with open(self.path(wid), "a", encoding="utf-8") as f:
                for _ in range(n):
                    f.write(json.dumps(self._record(wid)) + "\n")
        except OSError:
            pass

    def _run(self) -> None:
        while not self._stop.wait(1.0 / self.hz):
            for wid in self.worker_ids:
                if wid not in self._silent:
                    self._append(wid, 1)

    def start(self) -> "_EgressFeeder":
        self._thread.start()
        return self

    def silence(self, index: int) -> None:
        if 0 <= index < len(self.worker_ids):
            self._silent.add(self.worker_ids[index])

    def flood(self, index: int, n: int) -> None:
        if 0 <= index < len(self.worker_ids):
            self._append(self.worker_ids[index], max(1, n))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(1.0)


@dataclass
class ScenarioResult:
    seed: int
    scenario: int
    ok: bool
    violations: list[str] = field(default_factory=list)
    wall_s: float = 0.0
    kills: int = 0
    generations: int = 1
    injected: int = 0
    run_id: str = ""
    plan_doc: dict = field(default_factory=dict)

    def to_doc(self) -> dict:
        return {
            "seed": self.seed, "scenario": self.scenario, "ok": self.ok,
            "violations": list(self.violations),
            "wall_s": round(self.wall_s, 3), "kills": self.kills,
            "generations": self.generations, "injected": self.injected,
            "run_id": self.run_id,
        }


class ChaosRunner:
    """Execute one fault plan against a fresh fake pod."""

    def __init__(self, cfg, plan: FaultPlan, *, on_event=None,
                 behavior=None, poll_s: float = 0.05,
                 device: str = art.DEFAULT_DEVICE):
        from ..engine.drivers import FakeDriver
        from ..engine.fake import exit_behavior
        from ..health import BreakerConfig, HealthConfig

        self.cfg = cfg
        self.plan = plan
        self.on_event = on_event
        self.poll_s = poll_s
        # the sentinel's device, resolved before the pod is built: a
        # sentinel plan without its card fails here, never mid-scenario
        self.device = resolve_device(device) if plan.sentinel else device
        self.driver = FakeDriver(n_workers=plan.n_workers)
        for api in self.driver.apis:
            api.add_image(IMAGE)
            api.set_behavior(IMAGE,
                             behavior or exit_behavior(b"", 0, delay=0.02))
        # fast verdicts: the scenario horizon is under a second, so
        # probes and breaker backoff must be an order faster than that
        self.health_config = HealthConfig(
            probe_interval_s=0.05, probe_deadline_s=0.5,
            breaker=BreakerConfig(failure_threshold=2,
                                  backoff_base_s=0.05, backoff_max_s=0.2))
        self.kills = 0
        self.generations = 0
        self.injected = 0
        self._sched = None
        self._run_done = threading.Event()
        self._run_exc: list[BaseException] = []
        self._armed: list[tuple] = []   # (sched, seam, event) pending arms
        # storage scenarios (disk_full/io_error/fsync_fail/torn_record):
        # faults hit the run journal's OWN fd via testenv.FaultFS, never
        # an engine -- the workers stay unfaulted.  The audit compares
        # the shims' fired counts against the scheduler's fault
        # accounting and storage.fault bus events (no-silent-drop), and
        # the checksum verify verdict against the injections
        # (replay-integrity); both counters accumulate across
        # kill/resume generations
        self._storage_injected: list[str] = []
        self._storage_shims: list = []
        self._torn_injected = False
        self._storage_events = 0        # storage.fault frames, all gens
        self._storage_faults_base = 0   # dead generations' fault counts
        # sentinel scenarios (plan.sentinel): the fleet sentinel rides
        # the run on self.device, fed by synthetic per-worker egress
        # streams; the standard invariants must hold WITH it attached,
        # its audit counters must stay zero, and egress_*/sentinel_kill
        # events fault the streams/collector instead of the workers
        self.sentinel = None
        self.feeder = None
        if plan.sentinel:
            self.feeder = _EgressFeeder(
                cfg, [w.id for w in self.driver.workers()]).start()
            from ..sentinel import FleetSentinel

            self.sentinel = FleetSentinel(
                cfg, self.driver, interval_s=0.15,
                train_steps=SENTINEL_TRAIN_STEPS, threshold=3.5,
                device=self.device).start()
        # workerd scenarios (plan.workerd): per-worker launch daemons on
        # the fake pod's LOCAL engine views + an executor per channel;
        # the scheduler's data plane rides them, and
        # workerd_partition/workerd_kill events fault the channels
        # while every standard invariant must keep holding
        self.workerd_servers: list = []
        self.executors = None
        if plan.workerd:
            from ..workerd.executor import ExecutorSet, WorkerdExecutor
            from ..workerd.server import WorkerdServer

            exs = {}
            for i, w in enumerate(self.driver.workers()):
                sock = cfg.state_dir / "chaos-wd" / f"wd-{i}.sock"
                srv = WorkerdServer(cfg, self.driver.local_engine(i),
                                    worker_id=w.id, sock_path=sock).start()
                self.workerd_servers.append(srv)
                # a killed daemon must strand its pending intents well
                # inside the scenario deadline
                exs[w.id] = WorkerdExecutor(w.id, sock,
                                            intent_deadline_s=2.0)
            self.executors = ExecutorSet(exs)
        # shipper scenarios (plan.shipper): the telemetry shipper rides
        # every generation against an in-memory fake bulk index;
        # index_down events take the index down (or wedge it inside the
        # sink deadline) while the standard invariants must keep
        # holding and the shipper audit proves the bounded-buffer,
        # drop-oldest, never-blocks degradation
        self.index = None
        self.shipper = None
        self._index_downed = False
        if plan.shipper:
            from ..monitor.shipper import TelemetryShipper
            from ..testenv import FakeBulkIndex

            self.index = FakeBulkIndex(stall_timeout_s=0.2)
            self.shipper = TelemetryShipper(
                self.index, interval_s=0.05, batch_docs=16,
                max_batches=4, source="chaos").start()
        # capacity scenarios (plan.capacity): the elastic controller
        # rides each generation (re-attached like the sentinel; its
        # journaled state survives the kill/resume cycle via
        # RunImage.capacity).  traffic_burst events spike admission
        # queues open-loop; scale_down events request drains whose
        # firing stays gated on journal replay -- every standard
        # invariant must keep holding, and stranded-by-drain audits
        # the drains that fired.  Autoscale GROWTH stays off in chaos:
        # drains are event-driven, so the scenario shape stays the
        # plan's.
        self.capacity_ctrl = None
        self.capacity_scaler = None
        self._drain_requests: list[str] = []
        if plan.capacity:
            from ..capacity import FakeFleetScaler
            from ..config.schema import (
                CapacityAutoscaleSettings,
                CapacitySettings,
            )

            self.capacity_scaler = FakeFleetScaler(
                self.driver, max_workers=plan.n_workers)
            self._cap_settings = CapacitySettings(
                enable=True, interval_s=0.05,
                pool_min_depth=0,
                pool_max_depth=max(2, plan.warm_pool_depth),
                autoscale=CapacityAutoscaleSettings(
                    enable=True, min_workers=1,
                    max_workers=plan.n_workers,
                    queue_high=10_000,      # growth off: event-driven only
                    idle_low=0.0,           # idle drains off: ditto
                    sustain_s=3600.0))
        # gitguard scenarios (plan.gitguard): the run's git firewall
        # proxy rides the scenario over an in-memory upstream,
        # exercised by a deterministic protocol-level push-probe
        # schedule (own-namespace allow, sibling deny, integration
        # deny, an occasional merge-queue landing).  gitguard_down
        # kills the proxy mid-run; every later probe must fail CLOSED
        # (connection refused, recorded as such) -- the invariant
        # audits the upstream's acknowledged log as ground truth
        # (docs/git-policy.md; ref-isolation-at-proxy)
        self.gitguard_srv = None
        self.gitguard_upstream = None
        self._gitguard_decisions: list[tuple[float, dict]] = []
        self._gitguard_probes: list[dict] = []
        self._gitguard_script: list[tuple[str, str, str, str]] = []
        self._gitguard_downed_at: float | None = None
        if plan.gitguard:
            from ..gitguard import FakeGitUpstream, GitguardServer, RefPolicy

            self.gitguard_upstream = FakeGitUpstream(
                refs={"refs/heads/main": "a" * 40})
            self.gitguard_srv = GitguardServer(
                self.gitguard_upstream, RefPolicy(run=GITGUARD_RUN),
                tcp_addr=("127.0.0.1", 0),
                on_decision=lambda d: self._gitguard_decisions.append(
                    (time.monotonic(), d.to_doc())))
            self.gitguard_srv.start()
            self._gitguard_script = gitguard_probe_script(
                plan.seed, plan.scenario)

    # ------------------------------------------------------------ lifecycle

    def _spec(self):
        from ..loop import LoopSpec

        p = self.plan
        return LoopSpec(
            parallel=p.n_loops, iterations=p.iterations,
            failover=p.failover, warm_pool_depth=p.warm_pool_depth,
            max_inflight_per_worker=p.max_inflight_per_worker,
            image=IMAGE, agent_prefix="chaos", orphan_grace_s=20.0)

    def _start_generation(self, *, resume_of=None,
                          arm_events: list | None = None):
        """Build + start generation 1, or resume generation N+1 from the
        dead generation's journal (kill/resume cycle).  ``arm_events``
        re-arms surviving sigkill seams on the FRESH registry before the
        generation starts driving -- resume.* seams fire during
        reconcile, so arming after the thread started would race the
        window."""
        from ..loop import LoopScheduler
        from ..loop.journal import RunJournal, journal_path, replay

        self.generations += 1
        if self._sched is not None:
            # the dead generation's storage-fault count survives into
            # the audit (its bus history does not)
            self._storage_faults_base += getattr(
                self._sched, "storage_faults", 0)
        seams = SeamRegistry()
        if resume_of is None:
            sched = LoopScheduler(self.cfg, self.driver, self._spec(),
                                  on_event=self.on_event,
                                  health_config=self.health_config,
                                  seams=seams, executors=self.executors)
        else:
            image = replay(RunJournal.read(
                journal_path(self.cfg.logs_dir, resume_of)))
            if not image.run_id:
                raise ClawkerError(
                    "chaos: resume found no run header -- the kill beat "
                    "the first journal record (seam fired too early?)")
            sched = LoopScheduler.resume(
                self.cfg, self.driver, image, on_event=self.on_event,
                health_config=self.health_config, seams=seams,
                executors=self.executors)
        self._sched = sched
        sched.events.add_tap(self._storage_tap)
        if self.sentinel is not None:
            # re-attached per generation: each generation owns a fresh
            # bus/flight recorder, while the sentinel's baselines and
            # flagged set persist across the kill/resume cycle via its
            # run-keyed state file (the --resume persistence contract)
            sched.attach_sentinel(self.sentinel)
        if self.shipper is not None:
            # one shipper across generations, like loopd hosting it
            # across runs: the bounded buffer and drop accounting span
            # the kill/resume cycle
            sched.attach_shipper(self.shipper)
        if self.plan.capacity:
            # a fresh controller per generation, bound to the fresh
            # scheduler's hooks; journaled targets restore through
            # RunImage.capacity, and un-fired drain requests re-queue
            # so a kill between request and gate cannot lose the drain
            from ..capacity import CapacityController

            self.capacity_ctrl = CapacityController(
                self._cap_settings, scaler=self.capacity_scaler)
            sched.attach_capacity(self.capacity_ctrl)
            drained = set(self.capacity_scaler.drained)
            for wid in self._drain_requests:
                if wid not in drained:
                    self.capacity_ctrl.request_drain(wid)
        # per-GENERATION completion state: the closure binds these
        # locals, not self, so a stale gen-N thread that finally
        # unblocks (e.g. out of a wedge after the 5s kill wait gave up
        # on it) completes only its own dead generation -- it can
        # neither mark the live one done nor pin its crash on it
        done = self._run_done = threading.Event()
        exc = self._run_exc = []
        for ev in arm_events or []:
            self._arm_sigkill(ev, sched)

        def drive() -> None:
            try:
                if resume_of is None:
                    sched.start()
                else:
                    sched.reconcile()
                sched.run(poll_s=self.poll_s)
            except SeamAbort:
                pass            # the armed kill fired on this thread
            except BaseException as e:  # noqa: BLE001 -- surfaced as error
                exc.append(e)
            finally:
                done.set()

        threading.Thread(target=drive, daemon=True,
                         name=f"chaos-run-g{self.generations}").start()
        return sched

    # ------------------------------------------------------------ injection

    def _apply_worker_fault(self, ev: FaultEvent) -> None:
        apply_fault(self.driver, ev)
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _apply_stream_fault(self, ev: FaultEvent) -> None:
        """Sentinel-scenario faults: silence/flood a worker's egress
        stream, or SIGKILL the sentinel's collector.  A plan's stream
        fault without ``sentinel: true`` (a hand-written plan) is a
        counted no-op."""
        if ev.kind == "egress_silent" and self.feeder is not None:
            self.feeder.silence(ev.worker)
        elif ev.kind == "egress_flood" and self.feeder is not None:
            self.feeder.flood(ev.worker, int(ev.arg or 100))
        elif ev.kind == "sentinel_kill" and self.sentinel is not None:
            self.sentinel.kill_collector()
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _apply_index_fault(self, ev: FaultEvent) -> None:
        """Monitor-stack faults: the bulk index refuses (down) or
        wedges inside the sink deadline (``arg: "stall"``).  Hits only
        the shipper's SINK -- workers, bus, and lanes stay untouched,
        so the standard invariants double as the never-stalls proof."""
        self._index_downed = True
        if self.index is not None:
            if ev.arg == "stall":
                self.index.stall()
            else:
                self.index.down = True
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _shipper_audit(self) -> dict | None:
        """Shipper evidence for the invariant checker: intake/flush/
        drop accounting plus what the fake index actually holds.  None
        when the scenario ran without a shipper."""
        if self.shipper is None:
            return None
        audit = self.shipper.stats()
        audit["down_injected"] = self._index_downed
        audit["indexed_docs"] = (
            sum(len(v) for v in self.index.docs.values())
            if self.index is not None else 0)
        return audit

    def _workerd_audit(self) -> list[dict] | None:
        """Per-worker workerd evidence for the invariant checker: the
        channel's end-of-scenario liveness plus the server's
        undelivered-event and intent-dedup counters.  None when the
        scenario ran without workerd."""
        if self.executors is None:
            return None
        out = []
        for srv in self.workerd_servers:
            ex = self.executors.any_for(srv.worker_id)
            out.append({
                "worker": srv.worker_id,
                "alive": not srv._stop.is_set(),
                "channel_live": bool(ex is not None and ex.live()),
                "undelivered": srv.undelivered(),
                "intents": srv.stats["intents"],
                "dedup_hits": srv.stats["dedup_hits"],
            })
        return out

    def _apply_workerd_fault(self, ev: FaultEvent) -> None:
        """Data-plane faults: partition a channel (the daemon lives;
        the executor redials + resyncs) or SIGKILL the daemon itself
        (pending intents strand, the worker degrades to the direct WAN
        path).  Neither touches the worker's ENGINE -- the worker stays
        in the unfaulted set, so spurious-quarantine also proves
        workerd chaos can never open a breaker."""
        if 0 <= ev.worker < len(self.workerd_servers):
            srv = self.workerd_servers[ev.worker]
            if ev.kind == "workerd_partition":
                srv.drop_conns()
            else:
                srv.kill()
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _apply_seed_fault(self, ev: FaultEvent) -> None:
        """Workspace-seed cache faults: drop the worker's resident seed
        store mid-run (restart-equivalent cold cache).  Touches only
        workerd's content-addressed store -- the engine stays unfaulted,
        so spurious-quarantine also proves a cold seed cache can never
        open a breaker; later creates referencing the digest degrade to
        the per-create fallback walk (docs/loop-worktrees.md)."""
        if 0 <= ev.worker < len(self.workerd_servers):
            self.workerd_servers[ev.worker].drop_seeds()
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _apply_capacity_fault(self, ev: FaultEvent) -> None:
        """Capacity-scenario faults: an open-loop traffic burst against
        one worker's admission queue, or a scale-down request.  Neither
        touches a worker's ENGINE -- the worker stays in the unfaulted
        set, so spurious-quarantine also proves capacity chaos can
        never open a breaker."""
        sched = self._sched
        workers = self.driver.all_workers()
        if sched is None or not 0 <= ev.worker < len(workers):
            return
        wid = workers[ev.worker].id
        if ev.kind == "traffic_burst":
            # open-loop synthetic arrivals: each holds a token briefly
            # (like a short launch) so the queue genuinely deepens, but
            # performs no engine call -- pure admission pressure
            def hold(release) -> None:
                t = threading.Timer(0.03, release)
                t.daemon = True
                t.start()

            for _ in range(int(ev.arg or 10)):
                sched.admission.submit(wid, "~burst", hold)
        elif ev.kind == "scale_down":
            self._drain_requests.append(wid)
            if self.capacity_ctrl is not None:
                self.capacity_ctrl.request_drain(wid)
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _storage_tap(self, rec) -> None:
        """Bus tap counting storage.fault frames across generations --
        the no-silent-drop audit's event half."""
        from ..monitor.events import STORAGE_FAULT

        if rec.event == STORAGE_FAULT:
            self._storage_events += 1

    def _apply_storage_fault(self, ev: FaultEvent) -> None:
        """Storage faults hit the run journal's own fd
        (testenv.FaultFS) or its bytes on disk, never an engine: the
        workers stay unfaulted, so spurious-quarantine also proves a
        dying disk cannot open a breaker."""
        import errno

        from ..testenv import FaultFS

        self._storage_injected.append(ev.kind)
        if ev.kind == "torn_record":
            self._inject_torn(ev)
        else:
            journal = getattr(self._sched, "journal", None)
            shim = FaultFS.install(journal) if journal is not None else None
            if shim is None:
                return      # journal disabled/unhealthy: nothing to arm
            self._storage_shims.append(shim)
            n = max(1, int(ev.arg or 1))
            if ev.kind == "disk_full":
                shim.fail_writes(n, errno_=errno.ENOSPC)
            elif ev.kind == "io_error":
                shim.fail_writes(n, errno_=errno.EIO)
            elif ev.kind == "fsync_fail":
                shim.fail_fsyncs(n)
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _inject_torn(self, ev: FaultEvent) -> None:
        """torn_record: corrupt journal bytes in place -- a bit-flip
        (``arg: "flip"``) or a crash-torn cut truncating into the last
        record (``arg: "cut"``).  A sacrificial probe record takes the
        damage: the corruption is real (verify must flag it, the
        durable fold must stop at it) without destroying a record the
        OTHER invariants cross-audit -- the mid-run process stays
        alive, so a damaged placement/exit record would never be
        re-journaled the way a kill/resume cycle heals a torn tail.
        The replay-integrity invariant tolerates the corruption ONLY
        because ``torn_injected`` declares it."""
        from pathlib import Path

        from ..testenv import FaultFS

        journal = getattr(self._sched, "journal", None)
        if journal is None or not journal.healthy:
            return
        rcpt = journal.append("chaos_torn_probe", durable=True,
                              mode=str(ev.arg))
        if not rcpt.synced:
            return      # the disk is already faulted: nothing settled
        jp = Path(journal.path)
        try:
            size = jp.stat().st_size
        except OSError:
            return
        self._torn_injected = True
        if ev.arg == "cut":
            # power cut: the probe's unsynced-looking tail vanishes;
            # terminating the torn fragment keeps later appends on a
            # fresh line, so the fragment reads as one garbled
            # mid-file line the fold must stop before
            try:
                os.truncate(jp, size - 4)
                with open(jp, "a", encoding="utf-8") as fh:
                    fh.write("\n")
            except OSError:
                self._torn_injected = False
        else:
            # flip one bit inside the probe line (clear of its newline):
            # the record still parses but its CRC lies, or stops
            # parsing at all -- either way checksum-verify must flag it
            if not FaultFS.flip_bit_in_file(jp, size - 10):
                self._torn_injected = False

    def _storage_audit(self) -> dict | None:
        """Evidence for the storage invariants (None when the plan
        injected no storage fault): shim fired counts vs scheduler
        fault accounting vs storage.fault events, plus the checksum
        verify verdict and the run id the verified prefix folds to."""
        if not self._storage_injected:
            return None
        from pathlib import Path

        from ..loop.journal import journal_path, replay
        from ..monitor.ledger import read_verified_prefix, verify_jsonl

        sched = self._sched
        journal = getattr(sched, "journal", None)
        fired = sum(s.failed_writes + s.failed_fsyncs
                    for s in self._storage_shims)
        audit = {
            "injected": list(self._storage_injected),
            "torn_injected": self._torn_injected,
            "fired": fired,
            "faults": (self._storage_faults_base
                       + getattr(sched, "storage_faults", 0)),
            "durability": getattr(sched, "durability", "ok"),
            "dropped": getattr(journal, "dropped", 0) or 0,
            "poisoned": getattr(journal, "poisoned", 0) or 0,
            "events": self._storage_events,
            "verify": None,
            "folded_run_id": None,
        }
        jp = Path(journal_path(self.cfg.logs_dir, sched.loop_id))
        if jp.exists():
            audit["verify"] = verify_jsonl(jp).to_doc()
            records, _report = read_verified_prefix(jp)
            audit["folded_run_id"] = replay(records).run_id
        return audit

    def _gitguard_probe(self) -> None:
        """Fire the next scheduled push probe at the gitguard proxy:
        one receive-pack POST carrying one ref update, identity in the
        header (the shape Envoy stamps in production).  A probe against
        a killed proxy must dial ECONNREFUSED -- recorded as
        ``refused`` so the invariant can prove nothing landed after
        the down (fail-closed, docs/git-policy.md)."""
        if self.gitguard_srv is None or not self._gitguard_script:
            return
        import http.client

        from ..gitguard.pktline import FLUSH_PKT, encode_pkt
        from ..gitguard.refpolicy import IDENTITY_HEADER

        kind, ident, ref, sha = self._gitguard_script.pop(0)
        body = encode_pkt(
            f"{'0' * 40} {sha} {ref}".encode() + b"\x00report-status\n"
        ) + FLUSH_PKT
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", self.gitguard_srv.port, timeout=2.0)
            conn.request(
                "POST", "/chaos/git-receive-pack", body=body,
                headers={IDENTITY_HEADER: ident, "Content-Type":
                         "application/x-git-receive-pack-request"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            outcome = f"http_{resp.status}"
        except OSError:
            outcome = "refused"
        self._gitguard_probes.append({
            "kind": kind, "identity": ident, "ref": ref,
            "t": time.monotonic(), "outcome": outcome})

    def _apply_gitguard_fault(self, ev: FaultEvent) -> None:
        """Kill the git firewall proxy mid-run.  The guard is the ONLY
        git path (the co-installed egress rules pin ssh/22 + git/9418
        shut), so a dead guard means pushes fail CLOSED -- later
        probes must dial ECONNREFUSED and the invariant proves nothing
        was acknowledged after this moment.  Never touches a worker's
        engine: spurious-quarantine also proves a dead git proxy
        cannot open a breaker."""
        if self.gitguard_srv is not None:
            self.gitguard_srv.close()
            self._gitguard_downed_at = time.monotonic()
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1

    def _gitguard_audit(self) -> dict | None:
        """Gitguard evidence for the invariant checker: the upstream's
        acknowledged-update log (ground truth), the proxy's decision
        stream, the probe outcomes, and when (if ever) the proxy was
        killed.  None when the scenario ran without gitguard."""
        if self.gitguard_upstream is None:
            return None
        return {
            "run": GITGUARD_RUN,
            "branch_prefix": "loop",
            "downed_at": self._gitguard_downed_at,
            "acknowledged": list(self.gitguard_upstream.acknowledged),
            "decisions": list(self._gitguard_decisions),
            "probes": list(self._gitguard_probes),
        }

    def _arm_sigkill(self, ev: FaultEvent, sched=None) -> None:
        """Arm a crash seam on the current (or given) generation.
        Several seams may be armed at once -- whichever fires first
        kills the generation, and the survivors re-arm on the resumed
        one (that is how resume.* seams become reachable).  Arming is
        NOT counted as an injection -- a sigkill counts when its seam
        fires (_service_kill), so re-arms on resumed generations and
        seams the run never reaches don't inflate the report."""
        sched = sched if sched is not None else self._sched
        seam = str(ev.arg)
        if any(s is sched and sm == seam for s, sm, _e in self._armed):
            return              # same seam twice on one generation: one kill

        def die() -> None:
            sched.kill()
            raise SeamAbort(f"chaos sigkill at {seam}")

        sched.seams.arm(seam, die)
        self._armed.append((sched, seam, ev))

    def _service_kill(self) -> bool:
        """If any armed seam fired, finish its kill/resume cycle (tear
        the journal tail when the plan says so, resume as a fresh
        generation, re-arm surviving seams on it).  Returns True when a
        resume happened."""
        fired_idx = next(
            (i for i, (s, seam, _e) in enumerate(self._armed)
             if seam in s.seams.fired), None)
        if fired_idx is None:
            return False
        sched, _seam, ev = self._armed.pop(fired_idx)
        survivors = [e for s, _sm, e in self._armed if s is sched]
        self._armed = [entry for entry in self._armed
                       if entry[0] is not sched]
        self.kills += 1
        _INJECTIONS.labels(ev.kind).inc()
        self.injected += 1
        sched.kill()            # idempotent; covers seams on the run thread
        self._run_done.wait(5.0)
        # give in-flight lane tasks a beat to hit their epoch guards
        # (daemon threads survive a simulated SIGKILL; a real one's
        # threads would be gone, so we only need them to stop mutating)
        time.sleep(0.05)
        if ev.torn_tail > 0:
            self._tear_journal_tail(sched.loop_id, ev.torn_tail)
        if self.generations < MAX_GENERATIONS:
            self._start_generation(resume_of=sched.loop_id,
                                   arm_events=survivors)
        return True

    def _tear_journal_tail(self, run_id: str, n_bytes: int) -> None:
        from ..loop.journal import journal_path

        path = journal_path(self.cfg.logs_dir, run_id)
        try:
            size = path.stat().st_size
            with open(path, "rb+") as fh:
                fh.truncate(max(0, size - int(n_bytes)))
        except OSError:
            pass                # no journal to tear is not a failure

    # ------------------------------------------------------------- scenario

    def run_scenario(self) -> ScenarioResult:
        t0 = time.monotonic()
        deadline = t0 + SCENARIO_DEADLINE_S
        result = ScenarioResult(seed=self.plan.seed,
                                scenario=self.plan.scenario, ok=False,
                                plan_doc=self.plan.to_doc())
        faulted: set[int] = set()
        runner_error = False
        try:
            # inside the try: a scheduler that refuses the plan's spec
            # must still close the driver (lane/wedge daemon threads)
            # and report through the per-scenario violation path
            sched = self._start_generation()
            result.run_id = sched.loop_id
            for ev in sorted(self.plan.events, key=lambda e: e.at_s):
                # poll toward the event's time, servicing any fired
                # crash seam (kill -> torn tail -> resume) along the way
                while True:
                    self._service_kill()
                    now = time.monotonic()
                    if now >= t0 + ev.at_s:
                        break
                    time.sleep(min(0.01, t0 + ev.at_s - now))
                # gitguard scenarios interleave the deterministic push
                # probes with the schedule: one probe per event slot,
                # the remainder flushed after the heal -- probes before
                # a gitguard_down exercise enforcement, probes after it
                # prove fail-closed
                self._gitguard_probe()
                if ev.kind == "cli_sigkill":
                    self._arm_sigkill(ev)
                elif ev.kind == "gitguard_down":
                    # git-proxy faults hit the guard, never an engine:
                    # the worker stays unfaulted
                    self._apply_gitguard_fault(ev)
                elif ev.kind in ("workerd_partition", "workerd_kill"):
                    # data-plane faults hit the workerd channel/daemon,
                    # never the engine: the worker stays unfaulted
                    self._apply_workerd_fault(ev)
                elif ev.kind == "seed_cache_evict":
                    # seed-store faults hit workerd's resident cache,
                    # never the engine: the worker stays unfaulted
                    self._apply_seed_fault(ev)
                elif ev.kind == "index_down":
                    # monitor-stack faults hit the shipper's sink,
                    # never a worker: the fleet stays unfaulted
                    self._apply_index_fault(ev)
                elif ev.kind in ("traffic_burst", "scale_down"):
                    # capacity faults hit the admission queue / the
                    # elastic controller, never an engine: the worker
                    # stays unfaulted
                    self._apply_capacity_fault(ev)
                elif ev.kind in ("disk_full", "io_error", "fsync_fail",
                                 "torn_record"):
                    # storage faults hit the run journal's fd / bytes,
                    # never an engine: the worker stays unfaulted
                    self._apply_storage_fault(ev)
                elif ev.kind in ("egress_silent", "egress_flood",
                                 "sentinel_kill"):
                    # stream/collector faults: they hit the SENTINEL's
                    # inputs, never the workers -- the workers stay in
                    # the unfaulted set, so spurious-quarantine also
                    # proves stream chaos cannot open a breaker
                    self._apply_stream_fault(ev)
                elif ev.kind in ("pod_down", "pod_partition"):
                    # pod-scope faults gate EVERY worker at once: the
                    # whole fleet is faulted (the unfaulted set empties,
                    # so spurious-quarantine is vacuously satisfied) and
                    # the end-of-schedule heal revives the pod
                    faulted.update(range(self.plan.n_workers))
                    self._apply_worker_fault(ev)
                else:
                    if ev.kind != "worker_revive":
                        faulted.add(ev.worker)
                    self._apply_worker_fault(ev)
            # end of schedule: heal the fleet so the run can drain,
            # servicing seams fired late (and the resumes they trigger)
            for i in range(self.plan.n_workers):
                self.driver.clear_fault(i)
            # flush the rest of the push-probe script (a gitguard_down
            # in the schedule leaves these proving fail-closed); the
            # guard itself is NOT healed -- a dead guard stays dead for
            # the scenario, exactly the degrade the docs promise
            while self._gitguard_script:
                self._gitguard_probe()
            while time.monotonic() < deadline:
                self._service_kill()
                if self._run_done.is_set():
                    # armed seams the drained run never reached (e.g. a
                    # pool seam with the pool disabled) are not
                    # failures: disarm, then re-check for a fire that
                    # raced the disarm
                    for armed_sched, seam, _ev in self._armed:
                        armed_sched.seams.disarm(seam)
                    self._armed = [
                        e for e in self._armed if e[1] in e[0].seams.fired]
                    if not self._armed:
                        break
                time.sleep(0.01)
            else:
                self._sched.stop()
                self._run_done.wait(10.0)
                result.violations.append(
                    "stuck-run: the scenario did not drain within "
                    f"{SCENARIO_DEADLINE_S:.0f}s")
            if self._run_exc:
                result.violations.append(
                    f"scheduler-crash: {self._run_exc[0]!r}")
            final = self._sched
            if self.feeder is not None:
                self.feeder.stop()
            if self.sentinel is not None:
                self.sentinel.stop()
            if self.shipper is not None:
                # stop the pump, then one deterministic snapshot+flush
                # so the audit never races the tick cadence: a downed
                # index records its failed flush, a healthy one lands
                # the final docs, either way before the counters are
                # read.  A pump wedged in the sink (kill() False) must
                # NOT be raced -- the fake sink's stall bound drains it
                # well inside the scenario deadline, so retry once.
                if not self.shipper.kill():
                    if self.index is not None:
                        self.index.unstall()
                    self.shipper.kill()
                self.shipper.snapshot_once()
                self.shipper.flush_once(budget_s=0.5)
            final.cleanup(remove_containers=True)
            unfaulted = {w.id for i, w in enumerate(self.driver.workers())
                         if i not in faulted}
            result.violations.extend(check_invariants(
                self.driver, self.cfg, final.loop_id,
                loops=final.loops, cap=self.plan.max_inflight_per_worker,
                unfaulted=unfaulted, health=final.health,
                kills=self.kills, sentinel=self.sentinel,
                workerd=self._workerd_audit(),
                shipper=self._shipper_audit(),
                gitguard=self._gitguard_audit(),
                storage=self._storage_audit()))
        except ClawkerError as e:
            runner_error = True
            result.violations.append(f"runner-error: {e}")
        finally:
            if self.feeder is not None:
                self.feeder.stop()
            if self.sentinel is not None:
                self.sentinel.stop()
            if self.shipper is not None:
                self.shipper.kill()
            if self.index is not None:
                self.index.unstall()    # release any wedged sink thread
            if self.gitguard_srv is not None:
                self.gitguard_srv.close()
            if self.executors is not None:
                self.executors.close_all()
            for srv in self.workerd_servers:
                srv.stop()
            self.driver.close()
        result.kills = self.kills
        result.generations = self.generations
        result.injected = self.injected
        result.wall_s = time.monotonic() - t0
        result.ok = not result.violations
        for v in result.violations:
            _VIOLATIONS.labels(v.split(":", 1)[0]).inc()
        _SCENARIOS.labels(
            "ok" if result.ok
            else ("error" if runner_error else "violated")).inc()
        return result


# ------------------------------------------------------------------- soak


def _fresh_cfg():
    """An isolated project config per scenario: each scenario gets its
    own logs/journal tree so invariant audits never cross-read.  The
    host proxy is off: the fake pod's agents never dial it, and a proxy
    spawned here would outlive the throwaway state dir that holds its
    pidfile (the reference's spawns one and leaves it running)."""
    from .. import consts
    from ..config import load_config
    from ..testenv import TestEnv

    env = TestEnv()
    env.__enter__()
    env.write_settings("host_proxy:\n  enable: false\n")
    proj = env.base / "proj"
    proj.mkdir()
    (proj / consts.PROJECT_FLAT_FORM).write_text("project: chaosproj\n")
    return env, load_config(proj)


def run_plan(plan: FaultPlan, *, cfg=None, on_event=None,
             device: str = art.DEFAULT_DEVICE) -> ScenarioResult:
    """Execute ONE plan (replay entry point).  With no ``cfg`` a
    throwaway isolated project is created and torn down.  A sentinel
    plan resolves ``device`` before anything runs."""
    if plan.sentinel:
        device = resolve_device(device)
    env = None
    if cfg is None:
        env, cfg = _fresh_cfg()
    try:
        return ChaosRunner(cfg, plan, on_event=on_event,
                           device=device).run_scenario()
    finally:
        if env is not None:
            env.__exit__(None, None, None)


def shrink_plan(plan: FaultPlan, *, rounds: int = 2,
                budget_s: float = 120.0,
                device: str = art.DEFAULT_DEVICE) -> tuple[FaultPlan,
                                                          ScenarioResult]:
    """Greedy delta-debug a FAILING plan down to a minimal repro: try
    dropping one event at a time; keep any reduction that still
    violates an invariant.  Returns (smallest failing plan, its
    result).  Bounded two ways: at most ``rounds`` full passes over the
    event list (each event re-runs one scenario), and at most
    ``budget_s`` of wall clock -- a stuck-run failure burns the full
    scenario deadline PER TRIAL, and a shrink that outlives the caller's
    timeout would discard the very report it exists to produce; on
    budget exhaustion the smallest plan found so far is returned."""
    import dataclasses

    t0 = time.monotonic()
    best = plan
    best_result = run_plan(plan, device=device)
    if best_result.ok:
        return plan, best_result    # not failing (flaky?); nothing to shrink
    for _ in range(rounds):
        reduced_any = False
        i = 0
        while i < len(best.events):
            if time.monotonic() - t0 > budget_s:
                return best, best_result
            trial = dataclasses.replace(
                best, events=best.events[:i] + best.events[i + 1:])
            res = run_plan(trial, device=device)
            if not res.ok:
                best, best_result = trial, res
                reduced_any = True      # same index now names the next event
            else:
                i += 1
        if not reduced_any:
            break
    return best, best_result


def run_observe_only_check(seed: int = 20260803, *, n_workers: int = 4,
                           n_loops: int = 6, iterations: int = 1,
                           device: str = art.DEFAULT_DEVICE) -> list[str]:
    """The observe-only TWIN check: run the same fixed-seed benign fleet
    twice -- once bare, once with the sentinel attached AND its streams
    chaosed (silence + flood mid-run) -- and require byte-identical
    scheduling outcomes (journaled placements, daemon-side create
    counts, terminal statuses; invariants.scheduling_outcome).  No
    worker faults: with a healthy fleet the scheduler is deterministic,
    so ANY divergence is the sentinel leaking into scheduling.
    Returns violations ([] = the observe-only contract holds).  The
    sentinel scores on ``device``, resolved before either run: without
    its card the device error is raised, never a skipped verdict.  Runs
    in the fixed-seed soak (run_soak).
    """
    device = resolve_device(device)
    from ..engine.fake import exit_behavior
    from ..loop import LoopScheduler, LoopSpec

    def one(with_sentinel: bool) -> dict:
        from ..engine.drivers import FakeDriver

        env, cfg = _fresh_cfg()
        driver = FakeDriver(n_workers=n_workers)
        sentinel = feeder = None
        try:
            for api in driver.apis:
                api.add_image(IMAGE)
                api.set_behavior(IMAGE, exit_behavior(b"", 0, delay=0.02))
            spec = LoopSpec(parallel=n_loops, iterations=iterations,
                            image=IMAGE, agent_prefix="twin",
                            orphan_grace_s=20.0)
            sched = LoopScheduler(cfg, driver, spec)
            if with_sentinel:
                from ..sentinel import FleetSentinel

                feeder = _EgressFeeder(
                    cfg, [w.id for w in driver.workers()]).start()
                sentinel = FleetSentinel(
                    cfg, driver, interval_s=0.1,
                    train_steps=SENTINEL_TRAIN_STEPS, device=device).start()
                sched.attach_sentinel(sentinel)
            sched.start()
            if feeder is not None:
                # stream chaos mid-run: silence one worker, flood another
                feeder.silence(0)
                feeder.flood(min(1, n_workers - 1), 120)
            loops = sched.run(poll_s=0.05)
            if sentinel is not None:
                sentinel.refresh_once()     # at least one scored tick
                sentinel.stop()
            if feeder is not None:
                feeder.stop()
            sched.cleanup(remove_containers=True)
            return scheduling_outcome(driver, cfg, sched.loop_id, loops)
        finally:
            if sentinel is not None:
                sentinel.stop()
            if feeder is not None:
                feeder.stop()
            driver.close()
            env.__exit__(None, None, None)

    del seed  # the twin fleet is deterministic; kept for repro symmetry
    baseline = one(False)
    with_sentinel = one(True)
    return observe_only_violations(baseline, with_sentinel)


def run_soak(scenarios: int, seed: int, *, n_workers: int = 4,
             n_loops: int = 6, iterations: int = 2, on_event=None,
             shrink: bool = True, keep_going: bool = False,
             on_progress=None, cfg=None,
             device: str = art.DEFAULT_DEVICE) -> dict:
    """Run ``scenarios`` seeded scenarios; stop at (and shrink) the
    first failure unless ``keep_going``.  Returns the soak report doc
    ``{ok, scenarios, passed, failures: [...]}``.  With ``cfg`` the
    scenarios journal under that project's logs dir (run ids keep them
    apart); otherwise each gets a throwaway isolated environment.
    ``device`` (the sentinel's) is resolved before the first scenario:
    the observe-only twin rides every soak."""
    device = resolve_device(device)
    report: dict = {"seed": seed, "scenarios": scenarios, "passed": 0,
                    "failures": [], "wall_s": 0.0, "kills": 0,
                    "injected": 0}
    t0 = time.monotonic()
    for i in range(scenarios):
        plan = generate_plan(seed, i, n_workers=n_workers, n_loops=n_loops,
                             iterations=iterations)
        env = None
        scen_cfg = cfg
        if scen_cfg is None:
            env, scen_cfg = _fresh_cfg()
        try:
            result = ChaosRunner(scen_cfg, plan, on_event=on_event,
                                 device=device).run_scenario()
        finally:
            if env is not None:
                env.__exit__(None, None, None)
        report["kills"] += result.kills
        report["injected"] += result.injected
        if on_progress is not None:
            on_progress(result)
        if result.ok:
            report["passed"] += 1
            continue
        failure = result.to_doc()
        # the repro must pin the FLEET SHAPE too: generate_plan draws
        # victims from range(n_workers), so replaying a non-default
        # soak's (seed, i) under default shape yields a different
        # schedule entirely
        failure["repro"] = (
            f"python -m clawker_tpu_torch chaos replay --seed {seed} "
            f"--scenario {i} "
            f"--workers {n_workers} --parallel {n_loops} "
            f"--iterations {iterations}")
        if shrink:
            minimal, min_result = shrink_plan(plan, device=device)
            failure["minimal_plan"] = minimal.to_doc()
            failure["minimal_violations"] = list(min_result.violations)
        report["failures"].append(failure)
        if not keep_going:
            break
    # the observe-only twin rides every soak (fixed-seed sentinel
    # scenarios prove invariants hold WITH the sentinel; the twin proves
    # the sentinel changed nothing) -- skipped only when a failure
    # already stopped the soak early
    if not report["failures"] or keep_going:
        violations = run_observe_only_check(seed, n_workers=n_workers,
                                            device=device)
        report["observe_only"] = {"ok": not violations,
                                  "violations": violations}
        if violations:
            report["failures"].append({
                "scenario": "observe-only-twin",
                "violations": violations,
                "repro": "python -c 'from clawker_tpu_torch.chaos.runner import "
                         "run_observe_only_check; "
                         f"print(run_observe_only_check(device={device!r}))'",
            })
    report["wall_s"] = round(time.monotonic() - t0, 2)
    report["ok"] = (not report["failures"]
                    and report["passed"] == scenarios)
    return report


# ---------------------------------------------------- live-run controller


class ChaosController:
    """Apply a fault plan to a LIVE scheduler (``loop --chaos-plan``).

    Worker fault events need an injectable driver (the fake pod); on
    real drivers they are skipped with a scheduler event.  A
    ``cli_sigkill`` event arms its crash seam with a REAL
    ``os.kill(getpid(), SIGKILL)`` -- the dev workflow for crash-testing
    ``--resume`` against a genuine process death."""

    def __init__(self, sched, driver, plan: FaultPlan):
        self.sched = sched
        self.driver = driver
        self.plan = plan
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        if not isinstance(sched.seams, SeamRegistry):
            sched.seams = SeamRegistry()

    def start(self) -> "ChaosController":
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="chaos-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _drive(self) -> None:
        injectable = hasattr(self.driver, "inject_fault")
        t0 = time.monotonic()
        for ev in sorted(self.plan.events, key=lambda e: e.at_s):
            if self._stop.wait(max(0.0, t0 + ev.at_s - time.monotonic())):
                return
            if ev.kind == "cli_sigkill":
                seam = str(ev.arg)

                def die(seam: str = seam) -> None:
                    log.warning("chaos: SIGKILL at seam %s", seam)
                    os.kill(os.getpid(), signal.SIGKILL)

                self.sched.seams.arm(seam, die)
                _INJECTIONS.labels(ev.kind).inc()
                continue
            if ev.kind in ("traffic_burst", "scale_down"):
                # capacity events act on the live scheduler's admission
                # queue / attached controller, not the driver.  Index
                # into the ALL-workers view where the driver has one: a
                # scale_down earlier in this same plan may have shrunk
                # workers(), and the fixed-seed schedule's indices must
                # keep naming the workers the generator chose
                all_workers = getattr(self.driver, "all_workers", None)
                workers = (all_workers() if all_workers is not None
                           else self.driver.workers())
                if not 0 <= ev.worker < len(workers):
                    self.sched.on_event(
                        "chaos", "skipped",
                        f"{ev.kind} worker={ev.worker}: outside the "
                        f"{len(workers)}-worker fleet")
                    continue
                wid = workers[ev.worker].id
                if ev.kind == "traffic_burst":
                    # each synthetic arrival holds its token briefly
                    # (like a short launch) so the queue genuinely
                    # deepens -- an instant release would exert zero
                    # admission pressure
                    def hold(release) -> None:
                        t = threading.Timer(0.03, release)
                        t.daemon = True
                        t.start()

                    for _ in range(int(ev.arg or 10)):
                        self.sched.admission.submit(wid, "~burst", hold)
                    _INJECTIONS.labels(ev.kind).inc()
                elif self.sched.capacity is not None:
                    self.sched.capacity.request_drain(wid)
                    _INJECTIONS.labels(ev.kind).inc()
                else:
                    self.sched.on_event(
                        "chaos", "skipped",
                        f"{ev.kind}: no capacity controller attached")
                continue
            if ev.kind == "seed_cache_evict":
                # the seed store lives inside the worker's workerd
                # daemon; a live CLI run does not own those processes
                self.sched.on_event(
                    "chaos", "skipped",
                    f"{ev.kind}: seed stores are workerd-resident "
                    "(use the soak runner / `chaos run`)")
                continue
            if ev.kind in ("disk_full", "io_error", "fsync_fail"):
                # storage faults arm the LIVE run's journal fd (the
                # fail-loud contract under test end-to-end); the
                # journal recovers on a fresh fd and the run degrades
                # per settings loop.journal.on_fault
                import errno

                from ..testenv import FaultFS

                journal = getattr(self.sched, "journal", None)
                shim = (FaultFS.install(journal)
                        if journal is not None else None)
                if shim is None:
                    self.sched.on_event(
                        "chaos", "skipped",
                        f"{ev.kind}: no healthy journal on this run")
                    continue
                n = max(1, int(ev.arg or 1))
                if ev.kind == "fsync_fail":
                    shim.fail_fsyncs(n)
                else:
                    shim.fail_writes(n, errno_=(
                        errno.ENOSPC if ev.kind == "disk_full"
                        else errno.EIO))
                _INJECTIONS.labels(ev.kind).inc()
                self.sched.on_event("chaos", "injected",
                                    f"{ev.kind} n={n}")
                continue
            if ev.kind == "torn_record":
                # corrupting a LIVE user journal in place would destroy
                # real crash evidence: soak-runner only
                self.sched.on_event(
                    "chaos", "skipped",
                    f"{ev.kind}: destructive to a live journal (use "
                    "the soak runner / `chaos run`)")
                continue
            if ev.kind == "gitguard_down":
                # kill the live run's git firewall proxy: every later
                # agent push must fail CLOSED (the egress lane pins
                # leave no other git path; docs/git-policy.md)
                guard = getattr(self.sched, "gitguard", None)
                if guard is not None:
                    guard.close()
                    _INJECTIONS.labels(ev.kind).inc()
                    self.sched.on_event("chaos", "injected",
                                        "gitguard_down (fail-closed)")
                else:
                    self.sched.on_event(
                        "chaos", "skipped",
                        f"{ev.kind}: no gitguard attached to this run")
                continue
            if ev.kind in POD_GATE_MODE:
                # pod-scope faults target every worker, no index check
                if not injectable:
                    self.sched.on_event(
                        "chaos", "skipped",
                        f"{ev.kind}: driver "
                        f"{getattr(self.driver, 'name', '?')} is not "
                        "fault-injectable")
                    continue
                apply_fault(self.driver, ev)
                _INJECTIONS.labels(ev.kind).inc()
                self.sched.on_event("chaos", "injected",
                                    f"{ev.kind} (whole pod)")
                continue
            if not injectable:
                self.sched.on_event(
                    "chaos", "skipped",
                    f"{ev.kind} on worker {ev.worker}: driver "
                    f"{getattr(self.driver, 'name', '?')} is not "
                    "fault-injectable")
                continue
            if not 0 <= ev.worker < len(self.driver.workers()):
                # a plan generated for a different fleet shape: skip
                # visibly instead of letting an IndexError kill this
                # thread and silently drop the rest of the schedule
                self.sched.on_event(
                    "chaos", "skipped",
                    f"{ev.kind} worker={ev.worker}: outside the "
                    f"{len(self.driver.workers())}-worker fleet")
                continue
            apply_fault(self.driver, ev)
            _INJECTIONS.labels(ev.kind).inc()
            self.sched.on_event("chaos", "injected",
                                f"{ev.kind} worker={ev.worker}")
