"""``loop``: the port's copy of ``clawker_tpu/cli/cmd_loop.py`` (:87-930).
It submits to this project's loopd when one answers (``--detach``,
``loop attach``), shards over every federated pod's loopd through the
front-tier router with ``--pods`` (one pod answering: the daemon path;
none: an error, never an in-process run), else runs the port's own
:class:`~clawker_tpu_torch.loop.LoopScheduler` in process over the
driver that ``CLAWKER_TPU_DRIVER`` / settings ``runtime.driver`` names,
with the anomaly riders scoring on the GPU, the warm pool
(``--warm-pool``) and the launch data plane on any workerd that answers
(``--workerd/--no-workerd``); ``loop --resume RUN`` replays a run's
journal in process and reconciles it (never under a daemon), and
``loop trace RUN`` rebuilds a run's span trees from its flight record
(:809-930).  It takes
``--chaos-plan`` (in process only), ``--ship-telemetry`` and settings
``capacity.enable`` as the reference's does.  On a terminal, and without
``--json``, an in-process ``loop`` paints the reference's
``LoopDashboard`` (its ANOM-Z column holds the riders' scores);
``--metrics-port`` (settings ``telemetry.metrics_port``) serves the
metrics registry and settings ``telemetry.otlp`` ships it to a
collector.
"""

from __future__ import annotations

import json
import os
import signal
from pathlib import Path

import click

from .factory import Factory, _bring_up, _device, _factory


_hard_exit = os._exit       # seam: tests stub the second-stage exit


class _TwoStageInterrupt:
    """First Ctrl-C drains gracefully -- journal a clean ``shutdown``
    record and print the ``--resume`` hint; a second Ctrl-C hard-exits."""

    def __init__(self, sched):
        self.sched = sched
        self.hits = 0

    def __call__(self, signum=None, frame=None) -> None:
        self.hits += 1
        if self.hits == 1:
            click.echo(
                f"\ninterrupt: draining loops (resume later with "
                f"`loop --resume {self.sched.loop_id}`; Ctrl-C again to "
                "hard-exit)", err=True)
            self.sched.request_shutdown("sigint")
        else:
            click.echo("\nsecond interrupt: hard exit", err=True)
            _hard_exit(130)


class _ClientInterrupt:
    """Daemon-owned runs invert the Ctrl-C contract: the run belongs to
    loopd, this CLI is only a viewer -- so the first Ctrl-C DETACHES
    (the run keeps executing; ``loop attach <run>`` re-streams) instead
    of journaling a shutdown.  A second Ctrl-C hard-exits the viewer;
    the run is still untouched."""

    def __init__(self, client, run_id: str):
        self.client = client
        self.run_id = run_id
        self.hits = 0
        self.detached = False

    def __call__(self, signum=None, frame=None) -> None:
        self.hits += 1
        if self.hits == 1:
            self.detached = True
            click.echo(
                f"\ninterrupt: detached -- the run keeps executing under "
                f"loopd (re-attach with `loop attach {self.run_id}`; stop "
                "it with `loopd stop`)", err=True)
            # shuts the socket down too, so a reader blocked in
            # events() wakes immediately
            self.client.detach()
        else:
            click.echo("\nsecond interrupt: hard exit (run unaffected)",
                       err=True)
            _hard_exit(130)


@click.group("loop", invoke_without_command=True)
@click.option("--parallel", "-p", type=int, default=0,
              help="Number of agent loops (default: settings loop.parallel).")
@click.option("--iterations", "-n", type=int, default=-1,
              help="Iterations per agent (0 = until interrupted; "
                   "default: settings loop.max_iterations).")
@click.option("--placement",
              type=click.Choice(["spread", "pack", "topology"]), default=None,
              help="spread = latency-weighted round-robin over workers "
                   "(default); pack = all on the first healthy worker; "
                   "topology = prefer grid-local worker groups (falls back "
                   "to spread when the topology is unknown).")
@click.option("--tenant", default=None,
              help="Fairness class this run bills launches under "
                   "(default: settings loop.placement.tenant).")
@click.option("--tenant-weight", type=float, default=None,
              help="Weighted-fair-queue share vs co-tenants "
                   "(default: settings loop.placement.tenant_weight).")
@click.option("--max-inflight-per-worker", type=int, default=None,
              help="Admission token bucket: concurrent in-flight "
                   "create/start launches allowed per worker (default: "
                   "settings loop.placement.max_inflight_per_worker).")
@click.option("--warm-pool", "warm_pool", type=int, default=None,
              help="Per-worker warm pool depth: keep N pre-created agent "
                   "containers per worker that placements adopt (relabel/"
                   "env-fixup + start) instead of paying a full create "
                   "(default: settings loop.warm_pool; 0 = off; ignored "
                   "with bind-mode --worktrees).")
@click.option("--image", default="@", help="Agent image ('@' = project default).")
@click.option("--prompt", default="", help="Prompt handed to each harness loop.")
@click.option("--worktrees/--no-worktrees", default=False,
              help="One git worktree + branch per agent loop, branched "
                   "from one base (never N clones); agent branches land "
                   "serially through the merge queue at iteration end "
                   "(settings loop.worktrees.*; docs/loop-worktrees.md).")
@click.option("--gitguard/--no-gitguard", "gitguard", default=None,
              help="Worktree runs only: route agent git traffic through "
                   "the run's gitguard proxy -- advertisements hide "
                   "out-of-namespace refs, pushes outside the agent's "
                   "branch namespace are refused with a git-readable "
                   "error, and run-scoped egress rules pin ssh/22 + "
                   "git/9418 shut so guarded smart-HTTP is the only git "
                   "path (default: settings gitguard.enable; "
                   "docs/git-policy.md).")
@click.option("--env", "env_kv", multiple=True, help="KEY=VAL extra agent env.")
@click.option("--failover", type=click.Choice(["migrate", "wait", "fail"]),
              default=None,
              help="When a worker's health breaker opens: migrate its loops "
                   "to the healthiest worker (default), wait for recovery, "
                   "or fail them.")
@click.option("--orphan-grace", type=float, default=None,
              help="Seconds an orphaned loop may wait for a healthy "
                   "placement before failing (default 600, 0 = fail "
                   "immediately).")
@click.option("--resume", "resume_run", default=None, metavar="RUN",
              help="Resume a run from its write-ahead journal (a run id, "
                   "an unambiguous prefix, or a journal path) after a "
                   "scheduler death: adopt still-running containers, "
                   "account missed exits, re-launch the rest.")
@click.option("--metrics-port", type=int, default=None,
              help="Serve Prometheus metrics on 127.0.0.1:PORT during the "
                   "run (default: settings telemetry.metrics_port; 0 = off).")
@click.option("--sentinel/--no-sentinel", "sentinel_flag", default=None,
              help="Attach the online fleet sentinel in place of the "
                   "egress AnomalyWatch: fused egress + behavior windows "
                   "scored on the GPU each tick, flags as typed "
                   "anomaly.flag events (default: settings "
                   "sentinel.enable).")
@click.option("--ship-telemetry/--no-ship-telemetry", "ship_telemetry",
              default=None,
              help="Bulk-ship this run's registry snapshots, typed bus "
                   "events, and flight spans into the monitor stack's "
                   "OpenSearch index (default: settings "
                   "monitoring.shipper.enable).  Bounded backpressure: "
                   "a slow or down index drops oldest batches, never "
                   "stalls the run (docs/fleet-console.md#ingestion).")
@click.option("--chaos-plan", "chaos_plan", type=click.Path(exists=True),
              default=None,
              help="DEV: apply a chaos fault plan (`chaos plan --out`) to "
                   "this live run -- worker faults where the driver is "
                   "injectable (fake), cli_sigkill events as a REAL "
                   "SIGKILL at the named crash seam (crash-test "
                   "--resume).  In process only.")
@click.option("--json", "as_json", is_flag=True, help="Final status as JSON.")
@click.option("--keep", is_flag=True, help="Keep containers after the run.")
@click.option("--daemon/--no-daemon", "use_daemon", default=None,
              help="Submit the run to this project's loopd (default when "
                   "one answers); --daemon requires one, --no-daemon "
                   "always runs in process.")
@click.option("--workerd/--no-workerd", "use_workerd", default=None,
              help="Route the launch data plane through worker-resident "
                   "workerd daemons: batched intents + events over one "
                   "channel per worker instead of a WAN round trip per "
                   "engine call.  Default: use any workerd that answers "
                   "(settings workerd.enable); workers without one keep "
                   "the direct path.")
@click.option("--detach", is_flag=True,
              help="Daemon mode only: return once loopd acknowledges the "
                   "run; re-attach with `loop attach <run>`.")
@click.option("--pods", "use_pods", is_flag=True,
              help="Shard the run across every federated pod: the "
                   "front-tier router splits --parallel N over the pods "
                   "the pod policy picks (locality, load, health), "
                   "acquires capacity leases, and submits one per-pod run "
                   "per shard.  Shards run detached; re-attach each with "
                   "`loop attach`.")
@click.pass_context
def loop_group(ctx, parallel, iterations, placement, tenant, tenant_weight,
               max_inflight_per_worker, warm_pool, image, prompt, worktrees,
               gitguard, env_kv, failover, orphan_grace, resume_run,
               metrics_port, sentinel_flag, ship_telemetry, chaos_plan,
               as_json, keep, use_daemon, use_workerd, detach, use_pods):
    """Fan autonomous agent loops across the runtime's workers, with
    fleet anomaly scoring on the GPU: under this project's loopd when
    one answers (the run is daemon-owned), else in process."""
    if ctx.invoked_subcommand is not None:
        return
    f = ctx.obj if isinstance(ctx.obj, Factory) else Factory()
    _run_loops(f, parallel=parallel, iterations=iterations,
               placement=placement, tenant=tenant,
               tenant_weight=tenant_weight,
               max_inflight_per_worker=max_inflight_per_worker,
               warm_pool=warm_pool, image=image, prompt=prompt,
               worktrees=worktrees, gitguard=gitguard, env_kv=env_kv,
               failover=failover, orphan_grace=orphan_grace,
               resume_run=resume_run, metrics_port=metrics_port,
               sentinel_flag=sentinel_flag, ship_telemetry=ship_telemetry,
               chaos_plan=chaos_plan, as_json=as_json, keep=keep,
               use_daemon=use_daemon, use_workerd=use_workerd,
               detach=detach, use_pods=use_pods)


def _run_loops(f: Factory, *, parallel, iterations, placement, tenant,
               tenant_weight, max_inflight_per_worker, warm_pool, image,
               prompt, worktrees, gitguard, env_kv, failover, orphan_grace,
               resume_run, metrics_port, sentinel_flag, ship_telemetry,
               chaos_plan, as_json, keep, use_daemon, use_workerd, detach,
               use_pods):
    from ..errors import ClawkerError
    from ..loop import LoopScheduler, LoopSpec

    if use_pods and (resume_run or chaos_plan):
        raise click.ClickException(
            "--pods cannot combine with "
            + ("--resume" if resume_run else "--chaos-plan")
            + ": these stay in-process by design (docs/federation.md "
            "degrade matrix)")
    if use_daemon and (resume_run or chaos_plan):
        # an explicit --daemon must never silently degrade to a
        # CLI-owned run -- the exact ownership the user opted out of
        raise click.ClickException(
            "--daemon cannot combine with "
            + ("--resume" if resume_run else "--chaos-plan")
            + ": these stay in-process by design (docs/loopd.md "
            "degrade matrix)")
    env = {}
    for kv in env_kv:
        if "=" not in kv:
            raise click.BadParameter(f"--env {kv!r}: expected KEY=VAL")
        k, _, v = kv.partition("=")
        env[k] = v
    try:
        cfg = f.config
    except ClawkerError as e:
        raise click.ClickException(str(e))
    settings = cfg.settings
    tele = settings.telemetry
    defaults = settings.loop
    live = f.streams.is_stdout_tty() and not as_json
    dashboard = None
    run_image = None
    if resume_run:
        # --resume stays in process: it reconciles against a DEAD
        # scheduler's journal, so it never submits to a daemon
        if (parallel or placement or prompt or env_kv or image != "@"
                or tenant or tenant_weight is not None
                or max_inflight_per_worker):
            click.echo("note: --resume takes the run shape from the "
                       "journal; shape flags are ignored", err=True)
        run_image = _resume_image(f, resume_run)
        spec = None
    else:
        pdef = defaults.placement
        wps = defaults.warm_pool
        spec = LoopSpec(
            parallel=parallel or defaults.parallel,
            iterations=(iterations if iterations >= 0
                        else defaults.max_iterations),
            placement=placement or pdef.policy,
            tenant=tenant or pdef.tenant,
            tenant_weight=(tenant_weight if tenant_weight is not None
                           else pdef.tenant_weight),
            max_inflight_per_worker=max_inflight_per_worker or 0,
            warm_pool_depth=(warm_pool if warm_pool is not None
                             else (wps.depth if wps.enable else 0)),
            image=image,
            prompt=prompt,
            worktrees=worktrees,
            gitguard=gitguard,
            env=env,
            failover=failover or defaults.failover,
            orphan_grace_s=orphan_grace,
            telemetry=tele.flight_recorder.enable,
        )
        # --- federated mode (docs/federation.md): the front-tier router
        # shards the run across every federated pod's loopd.  Shards are
        # detached per-pod runs; a single-pod federation degrades to
        # exactly the daemon path below
        if use_pods:
            if _run_loops_federated(f, spec, as_json=as_json, keep=keep):
                return
            click.echo("--pods: one pod answering; submitting as a "
                       "single daemon run", err=True)
    # --- daemon mode (docs/loopd.md): when a loopd answers on this
    # project's socket the CLI becomes a thin control client -- the run
    # executes inside the daemon (shared admission caps + fairness
    # across every concurrent CLI, the daemon's sentinel) and survives
    # this process exiting.  No daemon = the in-process path below.
    # --resume and --chaos-plan stay in process: resume reconciles
    # against a DEAD scheduler's journal, and the chaos controller needs
    # the scheduler in process to kill it
    if use_daemon is not False and run_image is None and chaos_plan is None:
        from .cmd_loopd import ensure_daemon

        client = ensure_daemon(f)
        if client is not None:
            for flag, note in (
                    (use_workerd, "loopd-hosted runs keep the in-process "
                     "launch path -- --workerd is ignored under the daemon"),
                    (max_inflight_per_worker, "the admission bucket is "
                     "daemon-scoped -- --max-inflight-per-worker is ignored "
                     "under loopd (tune settings loop.placement.* and "
                     "restart the daemon)"),
                    (metrics_port, "metrics are daemon-scoped under loopd "
                     "-- --metrics-port is ignored"),
                    (sentinel_flag, "the sentinel is daemon-scoped under "
                     "loopd -- --sentinel is ignored; set settings "
                     "sentinel.enable and restart the daemon"),
                    (ship_telemetry, "telemetry shipping is daemon-scoped "
                     "under loopd -- --ship-telemetry is ignored")):
                if flag:
                    click.echo(f"note: {note}", err=True)
            _run_loops_client(f, client, spec, detach=detach,
                              as_json=as_json, keep=keep)
            return
        if use_daemon:
            raise click.ClickException(
                "--daemon: no loopd answering on this project's socket "
                "(start one with `loopd start`)")
    if use_pods:
        # the port's departure: a --pods run never degrades to a
        # CLI-owned run when no pod's daemon takes it
        raise click.ClickException(
            "--pods: no pod's loopd answering (start one with "
            "`loopd start`)")
    if detach and run_image is None:
        raise click.ClickException(
            "--detach needs a loopd daemon to own the run (start one "
            "with `loopd start`)")
    try:
        driver = f.driver
    except ClawkerError as e:
        raise click.ClickException(str(e))
    want_ship = (ship_telemetry if ship_telemetry is not None
                 else settings.monitoring.shipper.enable)
    # the riders score on the GPU: without one (and without
    # CLAWKER_TORCH_DEVICE=cpu) the run never starts -- a resume never
    # reconciles
    device = _device("loop")
    _bring_up("loop", device)

    def on_event(agent, event, detail=""):
        if event == "trace.span":
            return      # spans go to the flight recorder; the stderr
            #             lines / dashboard ticker stay the lifecycle
            #             stream
        if dashboard is not None:
            dashboard.record_event(agent, event, detail)
            return
        click.echo(f"[{agent}] {event}" + (f" {detail}" if detail else ""),
                   err=True)

    if run_image is not None:
        executors = _discover_workerd(
            cfg, driver, use_workerd, bool(run_image.spec.get("worktrees")),
            str(run_image.spec.get("workspace_mode") or ""))
    else:
        executors = _discover_workerd(cfg, driver, use_workerd, worktrees)
    try:
        if run_image is not None:
            sched = LoopScheduler.resume(
                cfg, driver, run_image, on_event=on_event,
                failover=failover,
                iterations=iterations if iterations >= 0 else None,
                orphan_grace_s=orphan_grace,
                telemetry=tele.flight_recorder.enable,
                executors=executors)
            spec = sched.spec
        else:
            sched = LoopScheduler(cfg, driver, spec, on_event=on_event,
                                  executors=executors)
    except ClawkerError as e:
        if executors is not None:
            executors.close_all()
        raise click.ClickException(str(e))
    # --- elastic capacity (docs/elastic-capacity.md): for in-process
    # runs the controller ticks on the scheduler's run thread -- the
    # same three loops loopd runs daemon-wide.  Settings-driven: a
    # loopd-hosted run gets the daemon's controller instead.
    cs = settings.capacity
    if cs.enable:
        from ..capacity import CapacityController, make_scaler

        try:
            scaler = (make_scaler(driver, cfg,
                                  max_workers=cs.autoscale.max_workers)
                      if cs.autoscale.enable else None)
        except ClawkerError as e:
            if executors is not None:
                executors.close_all()
            raise click.ClickException(str(e))
        sched.attach_capacity(CapacityController(cs, scaler=scaler))
        click.echo("capacity: elastic controller attached (pool "
                   f"[{cs.pool_min_depth},{cs.pool_max_depth}], "
                   f"slo={cs.slo.default_s or 'off'}, "
                   f"autoscale={'on' if cs.autoscale.enable else 'off'})",
                   err=True)
    chaos = None
    if chaos_plan:
        from ..chaos.plan import FaultPlan
        from ..chaos.runner import ChaosController

        try:
            plan = FaultPlan.load(chaos_plan)
        except ClawkerError as e:
            if executors is not None:
                executors.close_all()
            raise click.ClickException(str(e))
        chaos = ChaosController(sched, driver, plan)
        click.echo(f"chaos: applying {len(plan.events)} event(s) from "
                   f"{chaos_plan} (seed {plan.seed})", err=True)
    from .. import telemetry

    feed = None
    metrics_server = None
    shipper = None
    port = metrics_port if metrics_port is not None else tele.metrics_port
    if port:
        metrics_server = telemetry.MetricsServer(port).start()
        click.echo(f"metrics: http://127.0.0.1:{metrics_server.port}/metrics",
                   err=True)
    if tele.otlp:
        try:
            lane = telemetry.telemetry_lane(cfg)
        except ClawkerError as e:
            if metrics_server is not None:
                metrics_server.stop()
            if executors is not None:
                executors.close_all()
            raise click.ClickException(str(e))
        if lane is not None:
            shipper = telemetry.MetricsOtlpShipper(lane).start()
    # --- bulk ingestion into the monitor stack (docs/fleet-console.md):
    # registry snapshots + typed bus events + flight spans into the
    # OpenSearch bulk API under bounded batching -- a down index drops
    # oldest batches, never the run
    bulk_shipper = None
    if want_ship:
        from ..monitor.shipper import TelemetryShipper

        bulk_shipper = TelemetryShipper.from_config(
            cfg, source=f"loop:{sched.loop_id}").start()
        sched.attach_shipper(bulk_shipper)
        click.echo("telemetry: shipping into the monitor stack "
                   "(bounded; see monitor_ingest_* metrics)", err=True)
    # fleet anomaly scoring rides along: scores land in the status JSON
    # and as scheduler events past the threshold.  With --sentinel (or
    # settings sentinel.enable) the single-file AnomalyWatch is replaced
    # by the online fleet sentinel.  Strictly observe-only either way.
    ss = settings.sentinel
    want_sentinel = (sentinel_flag if sentinel_flag is not None
                     else ss.enable)
    if want_sentinel:
        from ..sentinel import FleetSentinel

        watch = FleetSentinel(
            cfg, driver, run_id=sched.loop_id, interval_s=ss.interval_s,
            window_s=ss.window_s, train_steps=ss.train_steps,
            threshold=ss.threshold, baseline_window=ss.baseline_window,
            device=device)
        sched.attach_sentinel(watch)
    else:
        from ..analytics.runtime import AnomalyWatch

        watch = AnomalyWatch(cfg.logs_dir / "ebpf-egress.jsonl",
                             device=device)
        sched.attach_anomaly_watch(watch)
    watch.start()
    if live:
        # the shared monitor TUI over the fan-out, with every worker's
        # egress stream merged into the ticker
        from ..fleet.egress_tail import EgressFeed
        from ..ui.dashboard import LoopDashboard

        feed = EgressFeed()
        local_log = cfg.logs_dir / "ebpf-egress.jsonl"
        for w in driver.workers():
            feed.add_worker(w, local_path=local_log)
        dashboard = LoopDashboard(f.streams, sched, egress_path=local_log,
                                  egress_feed=feed)
    signal.signal(signal.SIGINT, _TwoStageInterrupt(sched))
    signal.signal(signal.SIGTERM,
                  lambda *_: sched.request_shutdown("sigterm"))
    click.echo(
        f"loop {sched.loop_id}: {spec.parallel} agent(s), "
        f"{spec.iterations or 'unbounded'} iteration(s), {spec.placement} "
        f"placement, {spec.failover} failover"
        + (f", tenant {spec.tenant}" if spec.tenant != "default" else "")
        + (f", warm-pool {spec.warm_pool_depth}"
           if spec.warm_pool_depth else "")
        + (" (resumed)" if run_image is not None else ""),
        err=True)
    # chaos starts BEFORE start()/reconcile(): run.post_placement fires
    # inside start() and the resume.* seams inside reconcile(), so a
    # controller started after them could never land those kills
    if chaos is not None:
        chaos.start()
    try:
        if run_image is not None:
            summary = sched.reconcile()
            click.echo(
                "resume: {adopted} adopted, {continued} continued, "
                "{relaunched} relaunched, {exits_accounted} exit(s) "
                "accounted, {ghosts} ghost(s) swept, {orphaned} orphaned, "
                "{pool_restored} pool member(s) restored".format(**summary),
                err=True)
        else:
            sched.start()
        if dashboard is not None:
            with dashboard:
                loops = sched.run()
        else:
            loops = sched.run()
    finally:
        # the dashboard's last frame is painted by now: the feed, the
        # rider and the exporters stop after it, in the reference's order
        if chaos is not None:
            chaos.stop()
        if feed is not None:
            feed.stop()
        watch.stop()
        if shipper is not None:
            shipper.stop()
        if bulk_shipper is not None:
            bulk_shipper.stop()
        if metrics_server is not None:
            metrics_server.stop()
        if executors is not None:
            executors.close_all()
    if not keep:
        sched.cleanup(remove_containers=True)
    stor = sched.storage_summary()
    if as_json:
        click.echo(json.dumps({"loop_id": sched.loop_id,
                               "agents": sched.status(),
                               "storage": stor}, indent=2))
    else:
        if stor.get("durability") != "ok":
            click.echo(f"storage: durability {stor.get('durability')} "
                       f"({stor.get('faults', 0)} fault(s)) -- inspect "
                       f"with `journal verify {sched.loop_id}`", err=True)
        for l in loops:
            codes = ",".join(map(str, l.exit_codes)) or "-"
            click.echo(f"{l.agent}\t{l.worker.id}\t{l.status}\t"
                       f"iters={l.iteration}\texits={codes}")
        if sched.flight is not None:
            click.echo(f"trace: {sched.flight.path}", err=True)
        if sched.journal is not None and any(
                l.status == "stopped" for l in loops):
            click.echo(f"resume: loop --resume {sched.loop_id}", err=True)
    # orphaned loops never completed their budget (worker died, no
    # failover outcome before stop): that is not a success either
    if any(l.status in ("failed", "orphaned") for l in loops):
        raise SystemExit(1)


def _resolve_journal(f: Factory, run: str) -> Path:
    """RUN (an id, an unambiguous prefix, or a journal file path) -> the
    run journal to resume from or verify."""
    from ..loop.journal import RUNS_DIR, journal_path

    runs_dir = f.config.logs_dir / RUNS_DIR
    as_path = Path(run)
    if as_path.exists() and as_path.is_file():
        return as_path
    exact = journal_path(f.config.logs_dir, run)
    if exact.exists():
        return exact
    matches = sorted(runs_dir.glob(f"{run}*.journal"))
    if len(matches) == 1:
        return matches[0]
    if matches:
        names = ", ".join(m.stem for m in matches)
        raise click.ClickException(f"run {run!r} is ambiguous: {names}")
    raise click.ClickException(
        f"no run journal for {run!r} under {runs_dir} (runs journal one "
        "by default; check settings loop.journal.enable)")


def _resume_image(f: Factory, run: str):
    """The replayed image of RUN's journal, folded only as far as its
    verified prefix: a bit-flipped or torn journal can never seed the
    resume with garbage state (docs/durability.md#verify)."""
    from ..loop.journal import RunJournal, replay

    jpath = _resolve_journal(f, run)
    records, integrity = RunJournal.read_verified(jpath)
    if integrity.corrupt:
        click.echo(
            f"warning: {jpath.name}: {integrity.corrupt} corrupt "
            f"record(s) from line {integrity.first_corrupt_line}; "
            f"resuming from the last verified prefix "
            f"({integrity.verified} records) -- inspect with "
            f"`journal verify {run}`", err=True)
    elif integrity.torn_tail:
        click.echo(f"note: {jpath.name}: torn final record "
                   "(crash mid-append) dropped", err=True)
    image = replay(records)
    if not image.run_id:
        raise click.ClickException(
            f"{jpath}: no usable run header -- the journal is too "
            "damaged to resume; start a fresh run")
    return image


def _discover_workerd(cfg, driver, use_workerd, worktree_run: bool,
                      workspace_mode: str = ""):
    """ExecutorSet for the in-process scheduler, or None (direct).
    BIND-mode worktree runs stay direct (the worktree mount is
    host-local); snapshot-mode worktree runs dispatch -- content travels
    as a content-addressed workspace seed the worker-local store
    resolves (docs/loop-worktrees.md)."""
    if use_workerd is False:
        return None
    if worktree_run:
        mode = (workspace_mode
                or cfg.settings.loop.worktrees.workspace_mode or "bind")
        if mode == "bind":
            return None
    from ..workerd.executor import discover_executors

    execset = discover_executors(cfg, driver)
    if not execset:
        if use_workerd:
            raise click.ClickException(
                "--workerd: no workerd answering on any worker (start one "
                "per worker with `workerd start`)")
        return None
    click.echo(f"workerd: launch data plane on {len(execset)} worker(s) "
               "(batched intents over one channel each)", err=True)
    return execset


# ------------------------------------------------------------ daemon mode


def _client_spec_doc(spec) -> dict:
    """LoopSpec -> the submit_run spec doc (the journal's run-header
    vocabulary; loopd.server.spec_from_doc is the inverse)."""
    return {
        "parallel": spec.parallel, "iterations": spec.iterations,
        "placement": spec.placement, "image": spec.image,
        "prompt": spec.prompt, "worktrees": spec.worktrees,
        "gitguard": spec.gitguard,
        "workspace_mode": spec.workspace_mode,
        "agent_prefix": spec.agent_prefix, "env": dict(spec.env),
        "failover": spec.failover, "tenant": spec.tenant,
        "tenant_weight": spec.tenant_weight,
        "tenant_max_inflight": spec.tenant_max_inflight,
        "max_inflight_per_worker": spec.max_inflight_per_worker,
        "warm_pool_depth": spec.warm_pool_depth,
        "orphan_grace_s": spec.orphan_grace_s,
        "telemetry": spec.telemetry,
    }


def _run_loops_federated(f: Factory, spec, *, as_json: bool,
                         keep: bool) -> bool:
    """Shard the run across federated pods via the front-tier router
    (docs/federation.md).  Returns False when fewer than two pods
    answer -- the caller degrades to the single-daemon path."""
    from ..errors import ClawkerError
    from ..federation.router import FederationRouter
    from ..loopd.client import discover_all

    project = None
    try:
        project = f.config.project_name()
    except LookupError:
        pass
    clients = discover_all(f.config, require_project=project)
    if len(clients) < 2:
        for c in clients:
            c.close()
        if not clients and not f.config.settings.federation.pods:
            raise click.ClickException(
                "--pods: no federation configured and no loopd "
                "answering (register pods under settings "
                "federation.pods; docs/federation.md)")
        return False
    router = FederationRouter(f.config, clients)
    try:
        shards = router.submit_sharded(_client_spec_doc(spec), keep=keep)
    except ClawkerError as e:
        router.close()
        raise click.ClickException(f"federated submit failed: {e}")
    router.close()
    for pod, size, ack in shards:
        click.echo(f"loop {ack.get('run')}: {size} agent(s) on pod {pod} "
                   f"(tenant {ack.get('tenant')})", err=True)
    click.echo(f"detached: {len(shards)} shard(s) across "
               f"{len({p for p, _, _ in shards})} pod(s); re-attach "
               "each with `loop attach <run>`", err=True)
    if as_json:
        click.echo(json.dumps({"shards": [
            {"pod": pod, "parallel": size, "loop_id": str(ack.get("run"))}
            for pod, size, ack in shards], "detached": True}))
    return True


def _run_loops_client(f: Factory, client, spec, *, detach: bool,
                      as_json: bool, keep: bool) -> None:
    """Submit the run to loopd and (unless ``--detach``) stream it."""
    from ..errors import ClawkerError

    try:
        ack = client.submit_run(_client_spec_doc(spec), keep=keep,
                                stream=not detach)
    except ClawkerError as e:
        client.close()
        raise click.ClickException(f"loopd submit failed: {e}")
    run_id = str(ack.get("run", ""))
    click.echo(
        f"loop {run_id}: {spec.parallel} agent(s), "
        f"{spec.iterations or 'unbounded'} iteration(s), {spec.placement} "
        f"placement -- daemon-owned (loopd tenant {ack.get('tenant')})",
        err=True)
    if detach:
        client.close()
        click.echo(f"detached: the run executes under loopd; re-attach "
                   f"with `loop attach {run_id}`", err=True)
        if as_json:
            click.echo(json.dumps({"loop_id": run_id, "detached": True}))
        return
    _stream_daemon_run(client, run_id, as_json)


def _stream_daemon_run(client, run_id: str, as_json: bool) -> None:
    """Render a daemon-owned run's event stream; exit semantics match
    the in-process path (non-zero on failed/orphaned loops).  Ctrl-C
    DETACHES -- killing the viewer must never kill the run."""
    from ..agentd.protocol import ProtocolError
    from ..errors import ClawkerError

    handler = _ClientInterrupt(client, run_id)
    signal.signal(signal.SIGINT, handler)
    final = None
    try:
        for frame in client.events():
            kind = frame.get("type")
            if kind == "event":
                detail = frame.get("detail", "")
                click.echo(f"[{frame.get('agent')}] {frame.get('event')}"
                           + (f" {detail}" if detail else ""), err=True)
            elif kind == "run_done":
                final = frame
                break
    except (ProtocolError, ClawkerError, OSError):
        pass        # daemon gone, or our own detach shut the socket
    finally:
        client.close()
    if final is None:
        if handler.detached:
            return      # clean viewer exit; the run lives on
        raise click.ClickException(
            f"loopd stream ended unexpectedly (daemon died?) -- run "
            f"{run_id}'s journal survives")
    agents = final.get("agents", [])
    dropped = int(final.get("events_dropped", 0))
    if dropped:
        # the live view was lossy (slow subscriber queues); the journal
        # and flight record were not -- say so instead of looking whole
        click.echo(f"note: {dropped} event frame(s) dropped on slow "
                   f"subscriber queues during this run "
                   f"(loopd_events_dropped_total); the journal and "
                   f"flight record are complete", err=True)
    if as_json:
        click.echo(json.dumps({"loop_id": run_id, "agents": agents,
                               "events_dropped": dropped}, indent=2))
    else:
        for a in agents:
            codes = ",".join(map(str, a.get("exit_codes", []))) or "-"
            click.echo(f"{a.get('agent')}\t{a.get('worker')}\t"
                       f"{a.get('status')}\titers={a.get('iteration')}\t"
                       f"exits={codes}")
    if not final.get("ok", False):
        raise SystemExit(1)


@loop_group.command("attach")
@click.argument("run")
@click.option("--json", "as_json", is_flag=True, help="Final status as JSON.")
@click.pass_context
def loop_attach(ctx, run, as_json):
    """Re-attach to a daemon-owned run and stream it.

    RUN is the loop id printed at submit time (or an unambiguous
    prefix).  The stream replays the run's recent events, then follows
    it live; Ctrl-C detaches again without touching the run.
    """
    from ..errors import ClawkerError
    from ..loopd.client import discover

    client = discover(_factory(ctx).config)
    if client is None:
        raise click.ClickException(
            "no loopd daemon answering (check `loopd status`)")
    try:
        ack = client.attach(run)
    except ClawkerError as e:
        client.close()
        raise click.ClickException(str(e))
    run_id = str(ack.get("run", run))
    click.echo(f"attached to run {run_id} ({ack.get('state')})", err=True)
    _stream_daemon_run(client, run_id, as_json)


# ------------------------------------------------------------------- trace


def _resolve_flight(f, run: str | None) -> Path:
    from ..monitor.ledger import FLIGHT_DIR, flight_path

    flight_dir = f.config.logs_dir / FLIGHT_DIR
    if run:
        as_path = Path(run)
        if as_path.exists() and as_path.is_file():
            return as_path
        exact = flight_path(f.config.logs_dir, run)
        if exact.exists():
            return exact
        # id prefixes are fine as long as they are unambiguous
        matches = sorted(flight_dir.glob(f"loop-{run}*.jsonl"))
        if len(matches) == 1:
            return matches[0]
        if matches:
            names = ", ".join(m.stem.removeprefix("loop-") for m in matches)
            raise click.ClickException(
                f"run {run!r} is ambiguous: {names}")
        raise click.ClickException(
            f"no flight record for run {run!r} under {flight_dir}")
    latest = max(flight_dir.glob("loop-*.jsonl"), default=None,
                 key=lambda p: p.stat().st_mtime)
    if latest is None:
        raise click.ClickException(
            f"no flight records under {flight_dir} (runs record one by "
            "default; check settings telemetry.flight_recorder)")
    return latest


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1000:.1f}ms"


def _render_node(node, depth: int, out: list[str]) -> None:
    rec = node.record
    pad = "  " * depth
    if depth == 0:
        from ..telemetry.spans import STANDALONE_SPANS

        attrs = rec.attrs
        extra = "".join(
            f" {k}={attrs[k]}" for k in ("queue_ms", "resumed", "adopted")
            if k in attrs)
        # a non-iteration root is a phase span whose iteration root never
        # flushed (crashed run): show it, flagged, rather than hide it.
        # Standalone run-level spans (sentinel ticks) are their own kind.
        name = (f"iteration {attrs.get('iteration', '?')}"
                if rec.name == "iteration"
                else rec.name if rec.name in STANDALONE_SPANS
                else f"{rec.name} (no iteration root)")
        out.append(f"{rec.agent}  {name} "
                   f"[{rec.status}] {_fmt_ms(rec.wall_s)} "
                   f"worker={rec.worker}{extra}")
    else:
        keys = [k for k in sorted(rec.attrs) if k != "iteration"]
        extra = "".join(f" {k}={rec.attrs[k]}" for k in keys)
        out.append(f"{pad}{rec.name} {_fmt_ms(rec.wall_s)}{extra}")
    for child in node.children:
        _render_node(child, depth + 1, out)


@loop_group.command("trace")
@click.argument("run", required=False)
@click.option("--json", "as_json", is_flag=True,
              help="Reconstructed span trees as JSON.")
@click.pass_context
def loop_trace(ctx, run, as_json):
    """Reconstruct a loop run's iteration span trees.

    RUN is a loop id (as printed by `clawker loop`), an unambiguous id
    prefix, or a path to a flight-recorder JSONL file; the newest run is
    traced when omitted.  Shows per-span wall time, lane queue time, and
    migration hops -- the post-mortem view of what every iteration paid
    and where it travelled (docs/telemetry.md).
    """
    from ..monitor.ledger import read_rotated_lines
    from ..telemetry import build_trees, load_spans, tree_to_dict

    path = _resolve_flight(_factory(ctx), run)
    # read across the rotation boundary: a size-capped recorder keeps the
    # previous generation at <path>.1 (docs/telemetry.md)
    spans = load_spans(read_rotated_lines(path))
    if not spans:
        raise click.ClickException(f"{path}: no span records")
    trees = build_trees(spans)
    run_id = spans[0].trace_id or path.stem.removeprefix("loop-")
    if as_json:
        click.echo(json.dumps({
            "run": run_id,
            "path": str(path),
            "iterations": [tree_to_dict(t) for t in trees],
        }, indent=2))
        return
    from ..telemetry.spans import STANDALONE_SPANS

    agents = sorted({s.agent for s in spans})
    migrations = [s for s in spans if s.name == "migrate"]
    # a phase span promoted to a root means its iteration root never
    # flushed -- the writer died before end_iteration/close_open ran.
    # Run-level standalone roots (sentinel ticks) are by-design roots.
    promoted = [t for t in trees if t.record.name != "iteration"
                and t.record.name not in STANDALONE_SPANS]
    n_iters = sum(1 for t in trees if t.record.name == "iteration")
    click.echo(f"run {run_id}: {n_iters} iteration span(s) across "
               f"{len(agents)} agent(s)  ({path})")
    out: list[str] = []
    for tree in trees:
        _render_node(tree, 0, out)
    for line in out:
        click.echo(line)
    if migrations:
        click.echo("migration hops:")
        for m in sorted(migrations, key=lambda s: s.t_start):
            click.echo(f"  {m.agent} iteration {m.attrs.get('iteration')}: "
                       f"{m.attrs.get('src')} -> {m.attrs.get('dst')}")
    if promoted:
        click.echo(f"warning: {len(promoted)} span(s) without a recorded "
                   "iteration root (crashed run?)", err=True)


def register(root: click.Group) -> None:
    root.add_command(loop_group)
