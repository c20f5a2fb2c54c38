"""Command line of the port: ``python -m clawker_tpu_torch <group> <verb>``.

``monitor anomalies`` has the options, table/JSON output and exit codes
of the reference's ``clawker monitor anomalies``
(``clawker_tpu/cli/cmd_monitor.py:115-185``): 0 scored, 1 no scorable
windows (or no accelerator), 2 when an agent's latest z crosses
``--threshold``.  ``fleet anomaly`` those of ``clawker fleet anomaly``
(``clawker_tpu/cli/cmd_fleet.py:761-900``): 0 scored, 1 no scorable
windows (or no accelerator), 2 when an agent's window flags; with a
loopd answering, the one-shot renders the daemon sentinel's rows
(``cmd_fleet.py:123-140,806-822``).  ``loop`` is ``clawker loop``
(``clawker_tpu/cli/cmd_loop.py:87-781``) but for ``--pods``: it
submits to this project's loopd when one answers (``--detach``, ``loop
attach``), else runs the port's own
:class:`~clawker_tpu_torch.loop.LoopScheduler` in process over the
driver that ``CLAWKER_TPU_DRIVER`` / settings ``runtime.driver`` names,
with the anomaly riders scoring on the GPU, the warm pool
(``--warm-pool``) and the launch data plane on any workerd that answers
(``--workerd/--no-workerd``); ``loop --resume RUN`` replays a run's
journal in process and reconciles it (never under a daemon).  ``loopd
start|stop|status`` is ``clawker_tpu/cli/cmd_loopd.py``, ``workerd
start|stop|status`` ``clawker_tpu/cli/cmd_workerd.py``, ``trace``
``clawker_tpu/cli/cmd_trace.py`` and ``journal verify [--repair]``
``clawker_tpu/cli/cmd_journal.py`` (exit 0 clean, 2 on corruption).
``loop`` takes ``--chaos-plan`` (in process only), ``--ship-telemetry``
and settings ``capacity.enable`` as the reference's does, and ``chaos
run|replay|plan`` is ``clawker_tpu/cli/cmd_chaos.py``: the soak, whose
sentinel scenarios and observe-only twin score on the GPU (without one
``chaos run`` exits 1 before any scenario runs).  On a terminal, and
without ``--json``, an in-process ``loop`` paints the reference's
``LoopDashboard`` (its ANOM-Z column holds the riders' scores);
``--metrics-port`` (settings ``telemetry.metrics_port``) serves the
metrics registry and settings ``telemetry.otlp`` ships it to a
collector.  ``fleet console`` is ``clawker fleet console``
(``clawker_tpu/cli/cmd_fleet.py:901-972``).  The device comes from
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

# analytics.runtime.DEVICE_ENV, spelt here so that importing the CLI
# loads no torch
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

    device = art.env_device()
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
    from .analytics import runtime as art

    try:
        art.bring_up(device)
    except (RuntimeError, OSError) as e:    # CUDA errors, KernelCompileError
        click.echo(f"{verb}: cannot bring up {device}: {e}", err=True)
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
              help="Score locally even when a loopd daemon hosts a "
                   "sentinel.")
@click.pass_context
def fleet_anomaly(ctx, watch, interval, ticks, window, train_steps,
                  threshold, streams, fmt, no_daemon):
    """Live fleet-wide anomaly scores: every agent's fused egress +
    behavior windows fitted and scored on the GPU in one fit and one
    score per tick.

    One-shot by default: collect the host worker's streams
    (``ebpf-egress-local-0.jsonl`` and ``ebpf-egress.jsonl`` under the
    logs dir) and every ``--stream``, score once, and exit 2 when any
    agent's window flags past the threshold.  ``--watch`` keeps ticking
    and re-prints live scores.  With a loopd daemon hosting a sentinel
    (settings sentinel.enable) the one-shot renders the daemon's LIVE
    rows instead of building a second scorer.
    """
    from .sentinel import FleetSentinel
    from .util.xdg import logs_dir

    if not watch:
        doc = _loopd_status(_factory(ctx), no_daemon)
        sent = (doc or {}).get("sentinel") if doc else None
        if sent and sent.get("enabled"):
            if fmt == "json":
                click.echo(json.dumps(
                    {"source": f"loopd:{doc.get('pid')}", **sent}, indent=2))
            else:
                click.echo(f"source: loopd (pid {doc.get('pid')}, run "
                           f"{sent.get('run') or '-'}, "
                           f"{sent.get('ticks', 0)} tick(s))", err=True)
                _render_anomaly_rows(sent.get("rows", []))
            if any(r.get("flagged") for r in sent.get("rows", [])):
                raise SystemExit(2)
            return
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


@fleet_group.command("console")
@click.option("--fps", type=float, default=4.0,
              help="Repaint rate for the live view.")
@click.option("--once", is_flag=True,
              help="Render one plain frame and exit (scripts/CI).")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table",
              help="json emits the console feed document -- the same "
                   "schema `loopd status --format json` carries under its "
                   "`console` key.")
@click.option("--no-spans", is_flag=True,
              help="Skip the flight-recorder span waterfalls.")
@click.pass_context
def fleet_console(ctx, fps, once, fmt, no_spans):
    """Live multi-run fleet console over the loopd status RPC.

    One pane of glass over every run the daemon hosts: per-loop status
    with the daemon sentinel's ANOM-Z, per-worker breaker/admission-token/
    workerd rows, tenant queues, warm pools, ingest state, and span
    waterfalls tailed from each run's flight recorder.  Requires a
    running loopd (`loopd start`); Ctrl-C exits the console, never a
    run.  ``clawker_tpu/cli/cmd_fleet.py:901-972``.
    """
    from .errors import ClawkerError
    from .loopd.client import discover_all
    from .loopd.feed import console_feed, merge_feeds
    from .ui.fleetconsole import FleetConsole

    f = _factory(ctx)
    # every federated pod's daemon (single-pod fleets get exactly the
    # one canonical socket)
    clients = discover_all(f.config, require_project=_project(f))
    if not clients:
        click.echo("fleet console: no loopd daemon answering (start one "
                   "with `loopd start`)", err=True)
        raise SystemExit(1)

    def feed_fn() -> dict:
        return merge_feeds([console_feed(c.status()) for c in clients])

    try:
        if fmt == "json":
            click.echo(json.dumps(feed_fn(), indent=2))
            return
        console = FleetConsole(
            f.streams, feed_fn,
            logs_dir=None if no_spans else f.config.logs_dir, fps=fps)
        if once or not f.streams.is_stdout_tty():
            click.echo(console.snapshot())
            return
        try:
            while True:
                console.render_once()
                time.sleep(1.0 / max(0.5, fps))
        except KeyboardInterrupt:
            pass
    except (ClawkerError, OSError) as e:
        # OSError too: a daemon killed mid-poll surfaces as a raw
        # BrokenPipe from the socket send, not a wrapped protocol error
        raise click.ClickException(f"fleet console: loopd went away ({e})")
    finally:
        for c in clients:
            c.close()


def _loopd_status(f, no_daemon: bool) -> dict | None:
    """One status RPC to this project's loopd, or None (score locally).
    Project-scoped like the loop submit path: another project's daemon
    state is not this fleet's."""
    if no_daemon:
        return None
    from .errors import ClawkerError
    from .loopd.client import discover

    try:
        client = discover(f.config, require_project=_project(f))
    except ClawkerError:
        return None         # unreadable settings: no daemon to find
    if client is None:
        return None
    try:
        doc = client.status()
    except Exception as e:      # noqa: BLE001 -- view must degrade
        click.echo(f"loopd status failed ({e}); scoring locally", err=True)
        return None
    finally:
        client.close()
    return doc


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
    """The dependencies the verbs need, built lazily: the port's copy of
    the ``streams``, ``config`` and ``driver`` properties of
    ``clawker_tpu/cli/factory.py``.  Tests pass a driver in; the CLI
    takes it from ``CLAWKER_TPU_DRIVER`` or settings ``runtime.driver``."""

    def __init__(self, *, cwd: Path | None = None, driver=None,
                 config=None):
        self.cwd = cwd or Path.cwd()
        self._driver_override = driver
        self._config_override = config

    @functools.cached_property
    def streams(self):
        from .ui import IOStreams

        return IOStreams()

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
              help="Federated mode (not yet ported: refused).")
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
    from .errors import ClawkerError
    from .loop import LoopScheduler, LoopSpec

    if use_pods:
        raise _not_ported("--pods (federation)")
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
    # --- daemon mode (docs/loopd.md): when a loopd answers on this
    # project's socket the CLI becomes a thin control client -- the run
    # executes inside the daemon (shared admission caps + fairness
    # across every concurrent CLI, the daemon's sentinel) and survives
    # this process exiting.  No daemon = the in-process path below.
    # --resume and --chaos-plan stay in process: resume reconciles
    # against a DEAD scheduler's journal, and the chaos controller needs
    # the scheduler in process to kill it
    if use_daemon is not False and run_image is None and chaos_plan is None:
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
        from .capacity import CapacityController, make_scaler

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
        from .chaos.plan import FaultPlan
        from .chaos.runner import ChaosController

        try:
            plan = FaultPlan.load(chaos_plan)
        except ClawkerError as e:
            if executors is not None:
                executors.close_all()
            raise click.ClickException(str(e))
        chaos = ChaosController(sched, driver, plan)
        click.echo(f"chaos: applying {len(plan.events)} event(s) from "
                   f"{chaos_plan} (seed {plan.seed})", err=True)
    from . import telemetry

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
        from .monitor.shipper import TelemetryShipper

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
    if live:
        # the shared monitor TUI over the fan-out, with every worker's
        # egress stream merged into the ticker
        from .fleet.egress_tail import EgressFeed
        from .ui.dashboard import LoopDashboard

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
    from .loop.journal import RUNS_DIR, journal_path

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
    from .loop.journal import RunJournal, replay

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
    from .workerd.executor import discover_executors

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


def _run_loops_client(f: Factory, client, spec, *, detach: bool,
                      as_json: bool, keep: bool) -> None:
    """Submit the run to loopd and (unless ``--detach``) stream it."""
    from .errors import ClawkerError

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
    from .agentd.protocol import ProtocolError
    from .errors import ClawkerError

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


def _factory(ctx: click.Context) -> Factory:
    return ctx.obj if isinstance(ctx.obj, Factory) else Factory()


def _project(f: Factory) -> str | None:
    try:
        return f.config.project_name()
    except LookupError:
        return None


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
    from .errors import ClawkerError
    from .loopd.client import discover

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


# ------------------------------------------------------------------ loopd


@cli.group("loopd")
def loopd_group():
    """Host-resident loop supervisor: runs outlive the CLI."""


@loopd_group.command("start")
@click.option("--foreground", is_flag=True,
              help="Run the daemon in THIS process (debugging/ops; "
                   "Ctrl-C drains and exits).")
@click.pass_context
def loopd_start(ctx, foreground):
    """Start the daemon (no-op when one already answers).

    The daemon is project-scoped: start it from the project it will
    serve.  Once up, every ``loop`` in this project submits its runs to
    the daemon instead of scheduling in-process.  With settings
    ``sentinel.enable`` its sentinel scores on the GPU
    (``CLAWKER_TORCH_DEVICE``, default ``cuda``): without one the daemon
    refuses to start and this verb exits 1.
    """
    from .errors import ClawkerError
    from .loopd import logfile_path, socket_path, spawn_daemon
    from .loopd.client import discover

    f = _factory(ctx)
    client = discover(f.config)
    if client is not None:
        pong = client.ping()
        client.close()
        click.echo(f"loopd already running (pid {pong.get('pid')}, "
                   f"{pong.get('runs', 0)} live run(s)) on "
                   f"{socket_path(f.config)}")
        return
    try:
        if foreground:
            from .loopd.server import LoopdServer

            server = LoopdServer(f.config, f.driver)
            signal.signal(signal.SIGINT, lambda *_: server.stop())
            signal.signal(signal.SIGTERM, lambda *_: server.stop())
            server.start()
            click.echo(f"loopd listening on {server.sock_path} "
                       f"(pid {os.getpid()}; Ctrl-C drains)", err=True)
            server.serve_forever()
            return
        pid = spawn_daemon(f.config, cwd=f.cwd)
    except ClawkerError as e:
        raise click.ClickException(str(e))
    click.echo(f"loopd started (pid {pid}) on {socket_path(f.config)}; "
               f"log: {logfile_path(f.config)}")


@loopd_group.command("stop")
@click.option("--force", is_flag=True,
              help="SIGTERM the pidfile's process when the socket does "
                   "not answer (wedged daemon).")
@click.pass_context
def loopd_stop(ctx, force):
    """Drain every hosted run and stop the daemon.

    Drained runs journal a durable ``shutdown`` record first.
    """
    from .loopd import pidfile_path, socket_path
    from .loopd.client import discover

    f = _factory(ctx)
    client = discover(f.config)
    if client is not None:
        client.shutdown()
        client.close()
        # the drain is asynchronous; wait for the socket to go away so
        # `loopd stop && loopd start` cannot race the old daemon
        sock = socket_path(f.config)
        deadline = time.monotonic() + f.config.settings.loopd.drain_grace_s + 5
        while time.monotonic() < deadline and sock.exists():
            time.sleep(0.1)
        if sock.exists():
            # a wedged drain must not report success: the very next
            # `loopd start` would hit "already running"
            raise click.ClickException(
                "loopd did not drain within the grace period (socket "
                f"still present at {sock}); retry with --force to "
                "SIGTERM it")
        click.echo("loopd stopped")
        return
    pidfile = pidfile_path(f.config)
    if force and pidfile.exists():
        try:
            pid = int(pidfile.read_text().strip())
            os.kill(pid, signal.SIGTERM)
            click.echo(f"loopd: SIGTERM sent to pid {pid}")
            return
        except (OSError, ValueError) as e:
            raise click.ClickException(f"loopd: force-stop failed: {e}")
    click.echo("loopd: not running", err=True)


_RUN_COLUMNS = ("RUN", "STATE", "TENANT", "CLIENT", "LOOPS", "PLACEMENT",
                "SUBS", "DROPS")


@loopd_group.command("status")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
@click.option("--json", "as_json", is_flag=True,
              help="The same as --format json.")
@click.pass_context
def loopd_status(ctx, fmt, as_json):
    """Daemon status: hosted runs, admission tokens, worker breakers.

    Exits non-zero when no daemon answers -- scriptable as a liveness
    probe.
    """
    from .loopd.client import discover
    from .loopd.feed import console_feed

    client = discover(_factory(ctx).config)
    if client is None:
        click.echo("loopd: not running (start one with `loopd start`)",
                   err=True)
        raise SystemExit(1)
    try:
        doc = client.status()
    finally:
        client.close()
    doc.pop("type", None)
    if as_json or fmt == "json":
        # `console` is THE script-facing schema (docs/fleet-console.md)
        doc["console"] = console_feed(doc)
        click.echo(json.dumps(doc, indent=2))
        return
    click.echo(f"loopd pid {doc['pid']} project={doc.get('project') or '-'} "
               f"uptime={doc.get('uptime_s', 0)}s "
               f"socket={doc.get('socket')}")
    runs = doc.get("runs", [])
    if runs:
        click.echo("\t".join(_RUN_COLUMNS))
        for r in runs:
            click.echo("\t".join(str(x) for x in (
                r["run"], r["state"], r["tenant"], r["client"],
                r["parallel"], r["placement"], r["subscribers"],
                r.get("events_dropped", 0))))
    else:
        click.echo("no hosted runs")
    adm = doc.get("admission", {})
    for wid, w in sorted(adm.get("workers", {}).items()):
        click.echo(f"worker {wid}: tokens {w['inflight']}/{w['capacity']} "
                   f"hwm={w['inflight_hwm']} pending={w['pending']} "
                   f"dispatched={w['dispatched']} rejected={w['rejected']}")
    for tenant, t in sorted(adm.get("tenants", {}).items()):
        click.echo(f"tenant {tenant}: weight={t['weight']} "
                   f"inflight={t['inflight']} queued={t['queued']} "
                   f"dispatched={t['dispatched']}")


# ---------------------------------------------------------------- workerd


@cli.group("workerd")
def workerd_group():
    """Worker-resident launch daemon (docs/workerd.md)."""


@workerd_group.command("start")
@click.option("--driver", "driver_override", default="",
              help="Runtime driver the daemon serves (default: settings "
                   "runtime.driver).")
@click.pass_context
def workerd_start(ctx, driver_override):
    """Start workerd detached on THIS host.

    The daemon binds a 0600 unix socket in a 0700 runtime dir under the
    state dir and executes launch intents against this host's engine;
    it outlives this CLI.  Idempotent: a daemon already answering is
    left alone.
    """
    from .errors import ClawkerError
    from .workerd import socket_path, spawn_daemon
    from .workerd.executor import ping_socket

    f = _factory(ctx)
    sock = socket_path(f.config)
    if ping_socket(sock):
        click.echo(f"workerd already running on {sock}")
        return
    try:
        pid = spawn_daemon(f.config, cwd=f.cwd,
                           driver_override=driver_override)
    except ClawkerError as e:
        raise click.ClickException(str(e))
    click.echo(f"workerd started (pid {pid}) on {sock}")


@workerd_group.command("status")
@click.option("--json", "as_json", is_flag=True, help="Status as JSON.")
@click.pass_context
def workerd_status(ctx, as_json):
    """Probe the local workerd (exit 1 when nothing answers).

    Also renders per-worker liveness for the active runtime driver:
    ``live`` (socket answers), ``degraded`` (socket exists, daemon
    dead -- that worker's data plane silently fell back to the WAN
    path), ``absent`` (never provisioned).
    """
    import socket as _s

    from .agentd import protocol
    from .errors import ClawkerError
    from .workerd import liveness, socket_path

    f = _factory(ctx)
    try:
        driver = f.driver
    except ClawkerError as e:
        raise click.ClickException(str(e))
    sock = socket_path(f.config)
    doc = None
    try:
        with _s.socket(_s.AF_UNIX, _s.SOCK_STREAM) as s:
            s.settimeout(2.0)
            s.connect(str(sock))
            protocol.write_msg(s, {"type": "status"})
            doc = protocol.read_msg(s)
    except OSError:
        doc = None
    fleet = liveness(f.config, driver)
    if as_json:
        click.echo(json.dumps({"local": doc, "workers": fleet}, indent=2))
    else:
        if doc is not None:
            click.echo(f"workerd pid {doc.get('pid')} on {sock}: "
                       f"{doc.get('intents', 0)} intent(s), "
                       f"{doc.get('events', 0)} event(s) in "
                       f"{doc.get('batches', 0)} batch(es), "
                       f"uptime {doc.get('uptime_s', 0)}s")
        else:
            click.echo(f"no workerd answering on {sock}", err=True)
        for wid in sorted(fleet):
            click.echo(f"{wid}\t{fleet[wid]}")
    if doc is None:
        raise SystemExit(1)


@workerd_group.command("stop")
@click.pass_context
def workerd_stop(ctx):
    """Stop a running workerd (graceful; in-flight intents finish on
    the local lane, clients degrade to the direct path)."""
    import socket as _s

    from .agentd import protocol
    from .util.daemon import DaemonSpec
    from .workerd import pidfile_path, socket_path

    f = _factory(ctx)
    sock = socket_path(f.config)
    pid_path = pidfile_path(f.config)
    try:
        pid = int(pid_path.read_text().strip())
    except (OSError, ValueError):
        pid = 0
    try:
        with _s.socket(_s.AF_UNIX, _s.SOCK_STREAM) as s:
            s.settimeout(2.0)
            s.connect(str(sock))
            protocol.write_msg(s, {"type": "shutdown"})
            protocol.read_msg(s)
    except OSError:
        # nothing answering: sweep a stale pidfile/socket best-effort
        if not DaemonSpec._pid_alive(pid):
            raise click.ClickException(
                f"no workerd answering on {sock} (and no live pidfile)")
        DaemonSpec._terminate(pid)
    # the daemon unlinks its socket, then its pidfile, as it stops
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and (sock.exists()
                                           or pid_path.exists()):
        time.sleep(0.1)
    click.echo("workerd stopped" if not sock.exists()
               else "workerd stop requested (socket still present)")


# ------------------------------------------------------------------ trace


def _trace_run_id(f: Factory, run: str | None) -> str:
    """A run id from an id, an unambiguous prefix, a flight-recorder
    path, or (when omitted) the newest scheduler recorder."""
    from .monitor.ledger import FLIGHT_DIR

    flight_dir = f.config.logs_dir / FLIGHT_DIR
    if run:
        as_path = Path(run)
        if as_path.is_file():
            return as_path.stem.removeprefix("loop-")
        matches = sorted(flight_dir.glob(f"loop-{run}*.jsonl"))
        if len(matches) == 1:
            return matches[0].stem.removeprefix("loop-")
        if matches:
            names = ", ".join(m.stem.removeprefix("loop-") for m in matches)
            raise click.ClickException(f"run {run!r} is ambiguous: {names}")
        return run      # daemon recorders may hold it without a local file
    latest = max(flight_dir.glob("loop-*.jsonl"), default=None,
                 key=lambda p: p.stat().st_mtime)
    if latest is None:
        raise click.ClickException(
            f"no flight records under {flight_dir} (runs record one by "
            "default; check settings telemetry.flight_recorder)")
    return latest.stem.removeprefix("loop-")


def _trace_flags(rec) -> str:
    out = []
    wan = rec.attrs.get("wan_ms")
    if wan is not None:
        out.append(f"wan={float(wan):.1f}ms")
    if rec.attrs.get("skew_adjusted"):
        out.append(f"skew={float(rec.attrs.get('skew_s', 0.0)) * 1000:+.1f}ms")
    if rec.attrs.get("skew_suspect"):
        out.append("SKEW-SUSPECT")
    if rec.attrs.get("gap"):
        out.append(f"GAP(expect={rec.attrs.get('expect', '?')})")
    if rec.status not in ("ok", ""):
        out.append(rec.status)
    return "  ".join(out)


def _trace_render(node, t0: float, depth: int, out: list[str]) -> None:
    rec = node.record
    label = (f"iteration {rec.attrs.get('iteration', '?')}"
             if rec.name == "iteration" else rec.name)
    who = rec.agent or rec.worker or "-"
    src = rec.attrs.get("source", "")
    off = (rec.t_start - t0) * 1000.0
    wall = rec.wall_s * 1000.0
    flags = _trace_flags(rec)
    out.append(f"  {'  ' * depth}{label:<24} {who:<14} "
               f"{src:<18} +{off:>8.1f}ms {wall:>9.1f}ms"
               + (f"  {flags}" if flags else ""))
    for child in node.children:
        _trace_render(child, t0, depth + 1, out)


@cli.command("trace")
@click.argument("run", required=False)
@click.option("--json", "as_json", is_flag=True,
              help="Merged trace forest as JSON.")
@click.pass_context
def trace_cmd(ctx, run, as_json):
    """Cross-process trace waterfall for a loop run.

    RUN is a loop id (as printed by `loop`), an unambiguous id prefix,
    or a path to a flight-recorder JSONL file; the newest run is traced
    when omitted.  Joins the router/loopd/scheduler/workerd flight
    recorders into one causal tree per iteration (docs/tracing.md):
    per-hop WAN wait, clock-skew-adjusted offsets, explicit gap spans
    where a daemon's segment is missing.
    """
    from .tracing.merge import hop_waits, merge_run

    f = _factory(ctx)
    run_id = _trace_run_id(f, run)
    res = merge_run(f.config.logs_dir, run_id)
    if as_json:
        click.echo(json.dumps(res.to_dict(), indent=2))
        return
    if not res.roots:
        raise click.ClickException(
            f"no spans for run {run_id!r} in any recorder under "
            f"{f.config.logs_dir}")
    srcs = ", ".join(f"{k}={v}" for k, v in sorted(res.sources.items()))
    click.echo(f"run {run_id}: {res.spans} span(s) from [{srcs}]")
    if res.gaps or res.skew_suspects:
        click.echo(f"  {res.gaps} gap(s), "
                   f"{res.skew_suspects} skew suspect(s)")
    t0 = min(r.record.t_start for r in res.roots)
    out: list[str] = []
    for root in res.roots:
        _trace_render(root, t0, 0, out)
    for line in out:
        click.echo(line)
    waits = hop_waits(res.roots)
    if waits:
        click.echo("per-hop WAN wait:")
        for name, ms in waits.items():
            click.echo(f"  {name:<24} {ms:>9.1f}ms")


# ----------------------------------------------------------------- journal


@cli.group("journal")
def journal_group():
    """Inspect and repair run journals (docs/durability.md)."""


def _quarantine_and_rewrite(path: Path) -> dict:
    """Move every damaged line to ``<path>.quarantine`` (appended, with
    a line-number prefix) and atomically rewrite the journal with the
    intact lines verbatim -- kept records are NOT re-encoded, so a
    repair never invents bytes the writer didn't fsync."""
    from .monitor.ledger import classify_line

    kept: list[str] = []
    bad: list[tuple[int, str]] = []
    with path.open("r", encoding="utf-8", errors="replace") as fh:
        lines = fh.read().splitlines()
    for i, line in enumerate(lines, start=1):
        status, _ = classify_line(line)
        if status == "blank":
            continue
        if status in ("ok", "legacy"):
            kept.append(line)
        else:
            bad.append((i, line))
    if bad:
        sidecar = path.with_name(path.name + ".quarantine")
        with sidecar.open("a", encoding="utf-8") as fh:
            for i, line in bad:
                fh.write(f"{i}:{line}\n")
    tmp = path.with_name(path.name + ".repair")
    with tmp.open("w", encoding="utf-8") as fh:
        fh.write("".join(l + "\n" for l in kept))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return {"kept": len(kept), "quarantined": len(bad)}


@journal_group.command("verify")
@click.argument("run")
@click.option("--repair", is_flag=True,
              help="Quarantine damaged lines to a .quarantine sidecar "
                   "and atomically rewrite the journal with the intact "
                   "records.")
@click.option("--json", "as_json", is_flag=True,
              help="Integrity report as JSON.")
@click.pass_context
def journal_verify(ctx, run, repair, as_json):
    """Checksum-scan RUN's journal (a run id, unambiguous prefix, or a
    journal file path).

    Exit 0 when every record verifies (legacy pre-checksum records and
    a single torn final record are tolerated), exit 2 on corruption.
    With ``--repair`` the damaged lines move to a sidecar and the exit
    reflects the REWRITTEN journal.
    """
    from .monitor.ledger import verify_jsonl

    path = _resolve_journal(_factory(ctx), run)
    report = verify_jsonl(path)
    repaired = None
    if repair and not report.ok:
        repaired = _quarantine_and_rewrite(path)
        report = verify_jsonl(path)
    if as_json:
        doc = report.to_doc()
        if repaired is not None:
            doc["repaired"] = repaired
        click.echo(json.dumps(doc, indent=2))
    else:
        click.echo(f"{path.name}: {report.total} record(s) -- "
                   f"{report.verified} verified, {report.legacy} legacy, "
                   f"{report.corrupt} corrupt"
                   + (", torn tail" if report.torn_tail else ""))
        if repaired is not None:
            click.echo(f"repaired: kept {repaired['kept']}, quarantined "
                       f"{repaired['quarantined']} -> "
                       f"{path.name}.quarantine")
        if not report.ok:
            click.echo(f"first corrupt record at line "
                       f"{report.first_corrupt_line} -- resume folds only "
                       "the prefix above it (docs/durability.md#verify)",
                       err=True)
    if not report.ok:
        raise SystemExit(2)


# ------------------------------------------------------------------- chaos
#
# ``chaos run|replay|plan``: clawker_tpu/cli/cmd_chaos.py.  ``run``
# resolves the sentinel's device as ``loop`` does (exit 1 before any
# scenario without a GPU unless CLAWKER_TORCH_DEVICE=cpu); ``replay``
# does so for a sentinel plan.


@cli.group("chaos")
def chaos_group():
    """Deterministic chaos injection against the loop scheduler's
    robustness stack (breakers/failover, journal/--resume, admission,
    warm pools)."""


@chaos_group.command("run")
@click.option("--scenarios", "-n", type=int, default=None,
              help="Seeded scenarios to execute "
                   "(default: settings chaos.scenarios).")
@click.option("--seed", "-s", type=int, default=None,
              help="Soak seed: scenario i replays as (seed, i) "
                   "(default: settings chaos.seed).")
@click.option("--parallel", "-p", type=int, default=None,
              help="Agent loops per scenario (default: settings "
                   "chaos.parallel).")
@click.option("--workers", "-w", type=int, default=None,
              help="Fake pod size per scenario (default: settings "
                   "chaos.workers).")
@click.option("--iterations", type=int, default=None,
              help="Iteration budget per loop (default: settings "
                   "chaos.iterations).")
@click.option("--keep-going", is_flag=True,
              help="Run every scenario even after a failure "
                   "(default: stop and shrink the first).")
@click.option("--no-shrink", is_flag=True,
              help="Skip minimal-repro shrinking of failing schedules.")
@click.option("--json", "as_json", is_flag=True, help="Report as JSON.")
@click.pass_context
def chaos_run(ctx, scenarios, seed, parallel, workers, iterations,
              keep_going, no_shrink, as_json):
    """Run a seeded chaos soak and audit fleet invariants.

    Every scenario builds a fresh fake pod, executes its generated
    fault schedule (kill/resume cycles included), and cross-audits
    engine state vs journal replay vs telemetry.  Exit is non-zero on
    any invariant violation; the report names the exact
    ``chaos replay --seed S --scenario I`` repro and, unless
    --no-shrink, the minimal failing schedule.
    """
    from .chaos.runner import run_soak

    f = _factory(ctx)
    # the sentinel scenarios and the observe-only twin score on the GPU:
    # without one (and without CLAWKER_TORCH_DEVICE=cpu) no scenario runs
    device = _device("chaos run")
    _bring_up("chaos run", device)
    cs = f.config.settings.chaos
    scenarios = scenarios if scenarios is not None else cs.scenarios
    seed = seed if seed is not None else cs.seed

    def progress(result):
        if not as_json:
            mark = "ok" if result.ok else "FAIL"
            click.echo(
                f"scenario {result.scenario}: {mark} "
                f"({result.wall_s:.2f}s, {result.injected} fault(s), "
                f"{result.kills} kill(s), gen {result.generations})",
                err=True)

    report = run_soak(
        scenarios, seed,
        n_workers=workers if workers is not None else cs.workers,
        n_loops=parallel if parallel is not None else cs.parallel,
        iterations=(iterations if iterations is not None
                    else cs.iterations),
        shrink=not no_shrink, keep_going=keep_going,
        on_progress=progress, cfg=f.config, device=device)
    if as_json:
        click.echo(json.dumps(report, indent=2))
    else:
        click.echo(
            f"chaos: {report['passed']}/{report['scenarios']} scenario(s) "
            f"passed (seed {report['seed']}, {report['injected']} "
            f"injection(s), {report['kills']} kill/resume cycle(s), "
            f"{report['wall_s']}s)")
        for fail in report["failures"]:
            click.echo(f"FAILED scenario {fail['scenario']}:", err=True)
            for v in fail["violations"]:
                click.echo(f"  - {v}", err=True)
            click.echo(f"  repro: {fail['repro']}", err=True)
            if "minimal_plan" in fail:
                click.echo("  minimal schedule: "
                           + json.dumps(fail["minimal_plan"]["events"]),
                           err=True)
    if not report["ok"]:
        raise SystemExit(1)


@chaos_group.command("replay")
@click.option("--seed", "-s", type=int, default=None,
              help="Seed of the soak that found the failure.")
@click.option("--scenario", "-i", type=int, default=0,
              help="Scenario index within the soak (default 0).")
@click.option("--workers", "-w", type=int, default=None,
              help="Fleet shape of the soak that found the failure "
                   "(default: settings chaos.workers).")
@click.option("--parallel", "-p", type=int, default=None,
              help="Loops per scenario of that soak (default: settings "
                   "chaos.parallel).")
@click.option("--iterations", type=int, default=None,
              help="Iteration budget of that soak (default: settings "
                   "chaos.iterations).")
@click.option("--plan", "plan_file", type=click.Path(exists=True),
              default=None,
              help="Replay a saved plan JSON instead of (seed, scenario).")
@click.option("--json", "as_json", is_flag=True, help="Result as JSON.")
@click.pass_context
def chaos_replay(ctx, seed, scenario, workers, parallel, iterations,
                 plan_file, as_json):
    """Deterministically re-execute one scenario.

    Either --seed/--scenario (regenerates the exact schedule the soak
    ran -- pass the soak's --workers/--parallel/--iterations too if it
    used a non-default fleet shape, as the schedule depends on it) or
    --plan FILE (a saved or hand-edited schedule).  Exit is non-zero
    when an invariant is violated.
    """
    from .chaos.plan import FaultPlan, generate_plan
    from .chaos.runner import run_plan

    f = _factory(ctx)
    cs = f.config.settings.chaos
    if plan_file is not None:
        plan = FaultPlan.load(plan_file)
    elif seed is not None:
        plan = generate_plan(
            seed, scenario,
            n_workers=workers if workers is not None else cs.workers,
            n_loops=parallel if parallel is not None else cs.parallel,
            iterations=(iterations if iterations is not None
                        else cs.iterations))
    else:
        raise click.UsageError("need --seed (with --scenario) or --plan")
    # a sentinel plan scores on the GPU: without one (and without
    # CLAWKER_TORCH_DEVICE=cpu) it exits 1 before the scenario runs
    kw = {}
    if plan.sentinel:
        kw["device"] = _device("chaos replay")
        _bring_up("chaos replay", kw["device"])
    result = run_plan(plan, cfg=f.config, **kw)
    if as_json:
        click.echo(json.dumps({**result.to_doc(),
                               "plan": plan.to_doc()}, indent=2))
    else:
        click.echo(f"scenario ({plan.seed}, {plan.scenario}): "
                   + ("ok" if result.ok else "FAILED"))
        for v in result.violations:
            click.echo(f"  - {v}", err=True)
    if not result.ok:
        raise SystemExit(1)


@chaos_group.command("plan")
@click.option("--seed", "-s", type=int, required=True,
              help="Soak seed to generate from.")
@click.option("--scenario", "-i", type=int, default=0,
              help="Scenario index (default 0).")
@click.option("--workers", "-w", type=int, default=None,
              help="Fleet shape the soak used (default: settings "
                   "chaos.workers; the schedule depends on it).")
@click.option("--parallel", "-p", type=int, default=None,
              help="Loops per scenario (default: settings chaos.parallel).")
@click.option("--iterations", type=int, default=None,
              help="Iteration budget (default: settings chaos.iterations).")
@click.option("--out", "out_file", type=click.Path(), default=None,
              help="Write the plan JSON here instead of stdout "
                   "(editable; replay with --plan).")
@click.pass_context
def chaos_plan(ctx, seed, scenario, workers, parallel, iterations,
               out_file):
    """Print (or save) the fault schedule for one (seed, scenario).

    The schedule is exactly what ``chaos run``/``chaos replay`` would
    execute under the same fleet shape -- save it, edit the events, and
    replay the edited plan to bisect a failure by hand.
    """
    from .chaos.plan import generate_plan

    f = _factory(ctx)
    cs = f.config.settings.chaos
    plan = generate_plan(
        seed, scenario,
        n_workers=workers if workers is not None else cs.workers,
        n_loops=parallel if parallel is not None else cs.parallel,
        iterations=(iterations if iterations is not None
                    else cs.iterations))
    if out_file:
        path = plan.save(out_file)
        click.echo(f"wrote {path}")
    else:
        click.echo(plan.to_json(), nl=False)


def ensure_daemon(f: Factory):
    """Autostart path for ``loop``: a connected client when a daemon
    answers (spawning one first if settings ``loopd.autostart`` asks for
    it), else None -- the caller degrades in-process."""
    from .loopd import LoopdError, spawn_daemon
    from .loopd.client import discover

    project = _project(f)
    client = discover(f.config, require_project=project)
    if client is not None:
        return client
    if not f.config.settings.loopd.autostart:
        return None
    try:
        spawn_daemon(f.config, cwd=f.cwd)
    except LoopdError as e:
        click.echo(f"loopd autostart failed ({e}); running in-process",
                   err=True)
        return None
    return discover(f.config, require_project=project)


def main(argv=None) -> int:
    from .errors import ClawkerError

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
    except ClawkerError as e:
        # a domain error (a daemon that is not there, a refused
        # setting) is one clean line, as the reference's root group
        # renders it (clawker_tpu/cli/root.py:_RootGroup.invoke)
        click.ClickException(str(e)).show()
        return 1
    return 0
