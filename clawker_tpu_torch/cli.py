"""Command line of the port: ``python -m clawker_tpu_torch <group> <verb>``.

``monitor anomalies`` has the options, table/JSON output and exit codes
of the reference's ``clawker monitor anomalies``
(``clawker_tpu/cli/cmd_monitor.py:115-185``): 0 scored, 1 no scorable
windows (or no accelerator), 2 when an agent's latest z crosses
``--threshold``.  ``fleet anomaly`` those of ``clawker fleet anomaly``
(``clawker_tpu/cli/cmd_fleet.py:761-900``): 0 scored, 1 no scorable
windows (or no accelerator), 2 when an agent's window flags.  ``loop``
is the in-process part of ``clawker loop``
(``clawker_tpu/cli/cmd_loop.py:87-628``): the port's own
:class:`~clawker_tpu_torch.loop.LoopScheduler` over the driver that
``CLAWKER_TPU_DRIVER`` / settings ``runtime.driver`` names, with the
anomaly riders scoring on the GPU.  The device comes from
``CLAWKER_TORCH_DEVICE`` (default ``cuda``); ``cpu`` runs the plain
PyTorch versions.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import time
from pathlib import Path
from types import SimpleNamespace

import click

DEVICE_ENV = "CLAWKER_TORCH_DEVICE"


@click.group()
def cli():
    """clawker fleet analytics on PyTorch/CUDA."""


@cli.group("monitor")
def monitor_group():
    """Fleet monitoring verbs."""


@monitor_group.command("anomalies")
@click.option("--input", "input_path", type=click.Path(),
              default=None, help="Egress jsonl (default: logs dir stream).")
@click.option("--window", type=click.IntRange(min=1), default=60,
              help="Window seconds.")
@click.option("--train-steps", type=click.IntRange(min=1), default=120,
              help="Autoencoder fit steps before scoring.")
@click.option("--top", type=int, default=0, help="Only the N hottest agents.")
@click.option("--threshold", type=float, default=None,
              help="Exit 2 when any agent's latest z-score crosses this.")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
def monitor_anomalies(input_path, window, train_steps, top, threshold, fmt):
    """Score per-agent egress behavior on the GPU.

    Folds the netlogger stream into per-agent windows (32-feature
    vectors), fits the fleet autoencoder on them, and reports
    reconstruction-error z-scores: the fleet's own behavior is the
    normal profile, agents that deviate surface first.
    """
    from .analytics import runtime as art
    from .util.xdg import logs_dir

    device = _device("anomalies")
    path = (Path(input_path) if input_path
            else logs_dir() / "ebpf-egress.jsonl")
    rep = art.score_file(path, window_s=window, train_steps=train_steps,
                         device=device)
    if rep is None:
        click.echo(f"anomalies: no scorable egress windows in {path}",
                   err=True)
        raise SystemExit(1)

    thr = threshold if threshold is not None else art.ANOMALY_Z
    agents = sorted(rep.agents, key=lambda a: -a.latest)
    if top:
        agents = agents[:top]
    hot = [a for a in rep.agents if a.latest >= thr]
    if fmt == "json":
        click.echo(json.dumps({
            "windows": len(rep.keys), "device": rep.device,
            "train_ms": round(rep.train_ms, 2),
            "score_ms": round(rep.score_ms, 2),
            "train_steps": rep.train_steps,
            "threshold": thr,
            "agents": [{
                "agent": a.agent, "windows": a.windows,
                "latest_z": round(a.latest, 3), "peak_z": round(a.peak, 3),
                "latest_window": a.latest_start,
                "anomalous": a.latest >= thr,
            } for a in agents],
        }))
    else:
        click.echo(f"{'AGENT':<28} {'WINDOWS':>7} {'LATEST-Z':>9} "
                   f"{'PEAK-Z':>8}  FLAG")
        for a in agents:
            flag = "ANOMALOUS" if a.latest >= thr else ""
            click.echo(f"{a.agent:<28.28} {a.windows:>7} {a.latest:>9.2f} "
                       f"{a.peak:>8.2f}  {flag}")
        click.echo(f"\n{len(rep.keys)} windows scored on {rep.device} "
                   f"(fit {rep.train_steps} steps {rep.train_ms:.0f} ms, "
                   f"score {rep.score_ms:.1f} ms)")
    if threshold is not None and hot:
        raise SystemExit(2)


def _device(verb: str) -> str:
    """The device ``CLAWKER_TORCH_DEVICE`` names; exits 1 when it is a
    CUDA device and there is no GPU."""
    from .analytics import runtime as art

    device = os.environ.get(DEVICE_ENV) or art.DEFAULT_DEVICE
    try:
        art.resolve_device(device)
    except RuntimeError as e:
        click.echo(f"{verb}: {e} (set {DEVICE_ENV}=cpu to score on "
                   "the CPU)", err=True)
        raise SystemExit(1)
    return device


def _bring_up(verb: str, device: str) -> None:
    """Open the CUDA context and load the kernels before a long-running
    verb starts its rider: the rider's first tick then scores at once
    instead of paying seconds of set-up mid-run, and a card or a build
    that fails stops the verb before it starts anything (exit 1)."""
    import torch

    from .analytics import runtime as art
    from .kernels import build

    dev = art.resolve_device(device)
    if dev.type != "cuda":
        return
    try:
        torch.zeros(1, device=dev)
        build.build_all()
    except RuntimeError as e:      # CUDA errors and KernelCompileError
        click.echo(f"{verb}: cannot bring up {dev}: {e}", err=True)
        raise SystemExit(1)


@cli.group("fleet")
def fleet_group():
    """Fleet-wide verbs."""


# The host's one worker when no fleet is configured, named as the
# reference names it (clawker_tpu/engine/drivers/local.py:42).
LOCAL_WORKER = "local-0"

_ANOMALY_COLUMNS = ("AGENT", "WORKER", "WINDOWS", "LATEST-Z", "PEAK-Z",
                    "RECORDS", "FLAG")


class _LocalFleet:
    """The host's one worker, for ``wire_fleet``: its stream is a host
    file under the logs dir, never a remote tail."""

    def workers(self):
        return [SimpleNamespace(id=LOCAL_WORKER, engine=None)]


@fleet_group.command("anomaly")
@click.option("--watch", is_flag=True,
              help="Keep scoring and re-print the table every interval.")
@click.option("--interval", type=float, default=None,
              help="Scoring tick seconds with --watch (default 5).")
@click.option("--ticks", type=int, default=0,
              help="With --watch: stop after N ticks (0 = until Ctrl-C).")
@click.option("--window", type=int, default=None,
              help="Window seconds (default 60).")
@click.option("--train-steps", type=int, default=None,
              help="Denoising fit steps per tick (default 40).")
@click.option("--threshold", type=float, default=None,
              help="Worker-relative robust z past which an agent flags "
                   "(default 3.5).")
@click.option("--stream", "streams", multiple=True, metavar="WORKER=PATH",
              help="Extra local stream source(s): tail PATH as WORKER's "
                   "egress jsonl (besides the fleet's own streams).")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
@click.option("--no-daemon", is_flag=True,
              help="Score locally.  The port has no loopd daemon yet, so "
                   "it always scores locally, with or without this flag.")
def fleet_anomaly(watch, interval, ticks, window, train_steps, threshold,
                  streams, fmt, no_daemon):
    """Live fleet-wide anomaly scores: every agent's fused egress +
    behavior windows fitted and scored on the GPU in one fit and one
    score per tick.

    One-shot by default: collect the host worker's streams
    (``ebpf-egress-local-0.jsonl`` and ``ebpf-egress.jsonl`` under the
    logs dir) and every ``--stream``, score once, and exit 2 when any
    agent's window flags past the threshold.  ``--watch`` keeps ticking
    and re-prints live scores.
    """
    from .sentinel import FleetSentinel
    from .util.xdg import logs_dir

    device = _device("fleet anomaly")
    settings = {"interval_s": interval, "window_s": window or None,
                "train_steps": train_steps or None, "threshold": threshold}
    sentinel = FleetSentinel(
        SimpleNamespace(logs_dir=logs_dir()), _LocalFleet(), device=device,
        **{k: v for k, v in settings.items() if v is not None})
    for kv in streams:
        wid, _, path = kv.partition("=")
        if not wid or not path:
            raise click.BadParameter(f"--stream {kv!r}: expected WORKER=PATH")
        sentinel.collector.add_local(wid, Path(path))

    def render() -> list[dict]:
        rows = sentinel.rows()
        if fmt == "json":
            click.echo(json.dumps(sentinel.status_doc(), indent=2))
        else:
            _render_anomaly_rows(rows)
        return rows

    try:
        if watch:
            n = 0
            try:
                while True:
                    sentinel.refresh_once()
                    n += 1
                    rep = sentinel.last_tick
                    if fmt == "table":
                        click.echo(f"-- tick {n}: "
                                   f"{rep.windows if rep else 0} window(s)"
                                   + (f" on {rep.device}" if rep else ""),
                                   err=True)
                    rows = render()
                    if ticks and n >= ticks:
                        break
                    time.sleep(max(0.05, sentinel.interval_s))
            except KeyboardInterrupt:
                rows = sentinel.rows()
        else:
            sentinel.collector.wait_quiescent(2.0)
            n = sentinel.refresh_once()
            if n == 0 and not sentinel.rows():
                # a tick that failed says why, not that nothing was there
                why = (f"scoring failed: {sentinel.last_error}"
                       if sentinel.last_error
                       else "no scorable windows in any worker stream")
                click.echo(f"fleet anomaly: {why}", err=True)
                raise SystemExit(1)
            rows = render()
    finally:
        sentinel.stop()
    if any(r.get("flagged") for r in rows):
        raise SystemExit(2)


def _render_anomaly_rows(rows: list[dict]) -> None:
    click.echo("\t".join(_ANOMALY_COLUMNS))
    for r in rows:
        click.echo("\t".join(str(x) for x in (
            r["agent"], r["worker"] or "-", r["windows"],
            r["latest_z"], r["peak_z"], r.get("stream_records", 0),
            "ANOMALOUS" if r.get("flagged") else "-")))


# ------------------------------------------------------------------- loop

ENV_DRIVER = "CLAWKER_TPU_DRIVER"


class Factory:
    """The dependencies ``loop`` needs, built lazily: the port's copy of
    the ``config`` and ``driver`` properties of
    ``clawker_tpu/cli/factory.py``.  Tests pass a driver in; the CLI
    takes it from ``CLAWKER_TPU_DRIVER`` or settings ``runtime.driver``."""

    def __init__(self, *, cwd: Path | None = None, driver=None,
                 config=None):
        self.cwd = cwd or Path.cwd()
        self._driver_override = driver
        self._config_override = config

    @functools.cached_property
    def config(self):
        from .config import load_config

        if self._config_override is not None:
            return self._config_override
        return load_config(self.cwd)

    @functools.cached_property
    def driver(self):
        from .engine.drivers import get_driver

        if self._driver_override is not None:
            return self._driver_override
        return get_driver(self.config.settings,
                          override=os.environ.get(ENV_DRIVER, ""))


class _TwoStageInterrupt:
    """First Ctrl-C drains gracefully (a clean ``shutdown`` journal
    record); a second Ctrl-C hard-exits."""

    def __init__(self, sched):
        self.sched = sched
        self.hits = 0

    def __call__(self, signum=None, frame=None) -> None:
        self.hits += 1
        if self.hits == 1:
            click.echo("\ninterrupt: draining loops (Ctrl-C again to "
                       "hard-exit)", err=True)
            self.sched.request_shutdown("sigint")
        else:
            click.echo("\nsecond interrupt: hard exit", err=True)
            os._exit(130)


def _no_daemon(what: str) -> click.ClickException:
    return click.ClickException(
        f"{what} needs the loopd daemon, which is not yet ported to "
        "clawker_tpu_torch: the port runs loops in process only")


def _not_ported(what: str) -> click.ClickException:
    return click.ClickException(
        f"{what} is not yet ported to clawker_tpu_torch")


@cli.group("loop", invoke_without_command=True)
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
              help="Per-worker warm pool depth (not yet ported: any "
                   "depth above 0 is refused).")
@click.option("--image", default="@", help="Agent image ('@' = project default).")
@click.option("--prompt", default="", help="Prompt handed to each harness loop.")
@click.option("--worktrees/--no-worktrees", default=False,
              help="One git worktree per agent loop (not yet ported: "
                   "refused).")
@click.option("--gitguard/--no-gitguard", "gitguard", default=None,
              help="Git-protocol firewall for worktree runs (not yet "
                   "ported: refused).")
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
              help="Resume a journaled run (not yet ported: refused).")
@click.option("--metrics-port", type=int, default=None,
              help="Prometheus scrape port (not yet ported: any port "
                   "above 0 is refused).")
@click.option("--sentinel/--no-sentinel", "sentinel_flag", default=None,
              help="Attach the online fleet sentinel in place of the "
                   "egress AnomalyWatch: fused egress + behavior windows "
                   "scored on the GPU each tick, flags as typed "
                   "anomaly.flag events (default: settings "
                   "sentinel.enable).")
@click.option("--ship-telemetry/--no-ship-telemetry", "ship_telemetry",
              default=None,
              help="Bulk-ship telemetry into the monitor stack (not yet "
                   "ported: refused).")
@click.option("--chaos-plan", "chaos_plan", type=click.Path(exists=True),
              default=None, help="Chaos fault plan (not yet ported: refused).")
@click.option("--json", "as_json", is_flag=True, help="Final status as JSON.")
@click.option("--keep", is_flag=True, help="Keep containers after the run.")
@click.option("--daemon/--no-daemon", "use_daemon", default=None,
              help="--no-daemon runs in process, which the port always "
                   "does; --daemon is refused (no loopd yet).")
@click.option("--workerd/--no-workerd", "use_workerd", default=None,
              help="--no-workerd keeps the direct engine path, which the "
                   "port always takes; --workerd is refused (no workerd "
                   "yet).")
@click.option("--detach", is_flag=True,
              help="Daemon mode only: refused (no loopd yet).")
@click.option("--pods", "use_pods", is_flag=True,
              help="Federated mode: refused (no loopd yet).")
@click.pass_context
def loop_group(ctx, parallel, iterations, placement, tenant, tenant_weight,
               max_inflight_per_worker, warm_pool, image, prompt, worktrees,
               gitguard, env_kv, failover, orphan_grace, resume_run,
               metrics_port, sentinel_flag, ship_telemetry, chaos_plan,
               as_json, keep, use_daemon, use_workerd, detach, use_pods):
    """Fan autonomous agent loops across the runtime's workers, in
    process, with fleet anomaly scoring on the GPU."""
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
    from .errors import ClawkerError
    from .loop import LoopScheduler, LoopSpec

    for flag, what in ((use_daemon, "--daemon"), (detach, "--detach"),
                       (use_pods, "--pods")):
        if flag:
            raise _no_daemon(what)
    if use_workerd:
        raise click.ClickException(
            "--workerd needs the workerd daemon, which is not yet ported "
            "to clawker_tpu_torch: the port calls the engines directly")
    if resume_run:
        raise _not_ported("--resume")
    if chaos_plan:
        raise _not_ported("--chaos-plan")
    env = {}
    for kv in env_kv:
        if "=" not in kv:
            raise click.BadParameter(f"--env {kv!r}: expected KEY=VAL")
        k, _, v = kv.partition("=")
        env[k] = v
    try:
        cfg = f.config
        driver = f.driver
    except ClawkerError as e:
        raise click.ClickException(str(e))
    settings = cfg.settings
    tele = settings.telemetry
    port = metrics_port if metrics_port is not None else tele.metrics_port
    if port:
        raise _not_ported("the metrics server (--metrics-port, settings "
                          "telemetry.metrics_port)")
    if tele.otlp:
        raise _not_ported("the OTLP metrics lane (settings telemetry.otlp)")
    want_ship = (ship_telemetry if ship_telemetry is not None
                 else settings.monitoring.shipper.enable)
    if want_ship:
        raise _not_ported("the telemetry shipper (--ship-telemetry, "
                          "settings monitoring.shipper.enable)")
    # the riders score on the GPU: without one (and without
    # CLAWKER_TORCH_DEVICE=cpu) the run never starts
    device = _device("loop")
    _bring_up("loop", device)
    defaults = settings.loop
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

    def on_event(agent, event, detail=""):
        if event == "trace.span":
            return      # spans go to the flight recorder; the stderr
            #             lines stay the lifecycle stream
        click.echo(f"[{agent}] {event}" + (f" {detail}" if detail else ""),
                   err=True)

    if settings.capacity.enable:
        raise _not_ported("the elastic capacity controller (settings "
                          "capacity.enable)")
    try:
        sched = LoopScheduler(cfg, driver, spec, on_event=on_event)
    except ClawkerError as e:
        raise click.ClickException(str(e))
    # fleet anomaly scoring rides along: scores land in the status JSON
    # and as scheduler events past the threshold.  With --sentinel (or
    # settings sentinel.enable) the single-file AnomalyWatch is replaced
    # by the online fleet sentinel.  Strictly observe-only either way.
    ss = settings.sentinel
    want_sentinel = (sentinel_flag if sentinel_flag is not None
                     else ss.enable)
    if want_sentinel:
        from .sentinel import FleetSentinel

        watch = FleetSentinel(
            cfg, driver, run_id=sched.loop_id, interval_s=ss.interval_s,
            window_s=ss.window_s, train_steps=ss.train_steps,
            threshold=ss.threshold, baseline_window=ss.baseline_window,
            device=device)
        sched.attach_sentinel(watch)
    else:
        from .analytics.runtime import AnomalyWatch

        watch = AnomalyWatch(cfg.logs_dir / "ebpf-egress.jsonl",
                             device=device)
        sched.attach_anomaly_watch(watch)
    watch.start()
    signal.signal(signal.SIGINT, _TwoStageInterrupt(sched))
    signal.signal(signal.SIGTERM,
                  lambda *_: sched.request_shutdown("sigterm"))
    click.echo(
        f"loop {sched.loop_id}: {spec.parallel} agent(s), "
        f"{spec.iterations or 'unbounded'} iteration(s), {spec.placement} "
        f"placement, {spec.failover} failover"
        + (f", tenant {spec.tenant}" if spec.tenant != "default" else ""),
        err=True)
    try:
        sched.start()
        loops = sched.run()
    finally:
        watch.stop()
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
                       f"({stor.get('faults', 0)} fault(s))", err=True)
        for l in loops:
            codes = ",".join(map(str, l.exit_codes)) or "-"
            click.echo(f"{l.agent}\t{l.worker.id}\t{l.status}\t"
                       f"iters={l.iteration}\texits={codes}")
        if sched.flight is not None:
            click.echo(f"trace: {sched.flight.path}", err=True)
    # orphaned loops never completed their budget (worker died, no
    # failover outcome before stop): that is not a success either
    if any(l.status in ("failed", "orphaned") for l in loops):
        raise SystemExit(1)


@loop_group.command("attach")
@click.argument("run")
@click.option("--json", "as_json", is_flag=True, help="Final status as JSON.")
def loop_attach(run, as_json):
    """Re-attach to a daemon-owned run: refused (no loopd yet)."""
    raise _no_daemon("loop attach")


def main(argv=None) -> int:
    try:
        cli.main(args=argv, prog_name="python -m clawker_tpu_torch",
                 standalone_mode=False)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else 1
    except click.ClickException as e:
        e.show()
        return e.exit_code
    except click.exceptions.Abort:
        return 1
    return 0
