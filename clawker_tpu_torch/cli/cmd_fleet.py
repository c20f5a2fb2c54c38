"""``fleet workers|provision|status|anomaly|console``: the port's copy of
those verbs of ``clawker_tpu/cli/cmd_fleet.py``.  ``fleet anomaly``
(:761-900) exits 0 scored, 1 no scorable windows (or no accelerator), 2
when an agent's window flags; its sentinel tails the configured driver's
workers with settings ``sentinel``'s defaults under the flags, and with
a loopd answering, the one-shot renders the daemon sentinel's rows
(:123-140,806-822).  ``fleet workers|provision|status`` are the
reference's (:23-121,973-996) but that ``provision`` refuses the
per-worker control plane by name (pass ``--no-cp``).  ``fleet console``
is :901-972.  ``fleet health``, ``placement`` and ``warmpool`` are not
ported yet (ROADMAP §1 item 13).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import click

from .factory import _device, _factory, _project


@click.group("fleet")
def fleet_group():
    """Fleet-wide verbs."""


_ANOMALY_COLUMNS = ("AGENT", "WORKER", "WINDOWS", "LATEST-Z", "PEAK-Z",
                    "RECORDS", "FLAG")


def _transports(f):
    """One SSH transport per discovered pod worker, in pod order
    (``clawker_tpu/cli/cmd_fleet.py:23-35``)."""
    from ..fleet.inventory import discover_workers
    from ..fleet.transport import SSHTransport

    tpu = f.config.settings.runtime.tpu
    hosts = discover_workers(tpu)
    if not hosts:
        raise click.ClickException(
            "no TPU workers configured (runtime.tpu.workers / runtime.tpu.pod)"
        )
    mux = f.config.ssh_mux_dir
    return [SSHTransport(tpu, h, i, mux_dir=mux) for i, h in enumerate(hosts)]


@fleet_group.command("workers")
@click.pass_context
def fleet_workers(ctx):
    """List the pod's worker hosts in pod order."""
    from ..fleet.inventory import discover_workers

    hosts = discover_workers(_factory(ctx).config.settings.runtime.tpu)
    for i, h in enumerate(hosts):
        click.echo(f"{i}\t{h}")
    if not hosts:
        raise SystemExit(1)


@fleet_group.command("provision")
@click.option("--dry-run", is_flag=True, help="Print the plan, touch nothing.")
@click.option("--no-firewall", is_flag=True, help="Skip the eBPF/kernel half.")
@click.option("--no-cp", is_flag=True, help="Skip the per-worker control plane.")
@click.option("--worker", "only", type=int, default=-1,
              help="Provision a single worker index.")
@click.option("--jobs", "-j", type=int, default=8,
              help="Concurrent worker provisions (bounded pool).")
@click.pass_context
def fleet_provision(ctx, dry_run, no_firewall, no_cp, only, jobs):
    """Install the worker stack (native bits, eBPF).

    Workers provision concurrently (one payload tar shared by all);
    step results stream as they land, prefixed with the worker index.
    The per-worker control plane is not ported yet: without --no-cp
    the verb refuses (exit 1) before it dials any worker.
    """
    from ..errors import ConfigError
    from ..fleet.provision import build_plan, provision_fleet

    f = _factory(ctx)
    try:
        plan = build_plan(with_firewall=not no_firewall, with_cp=not no_cp)
    except ConfigError as e:
        raise click.ClickException(str(e))
    if dry_run:
        for step in plan:
            opt = " (optional)" if step.optional else ""
            click.echo(f"{step.name}{opt}\n    {step.cmd}")
        return
    repo_root = Path(__file__).resolve().parents[2]
    transports = _transports(f)
    if only >= 0:
        chosen = [t for t in transports if t.index == only]
        if not chosen:
            valid = ", ".join(str(t.index) for t in transports)
            raise click.ClickException(
                f"--worker {only}: no such worker index (valid: {valid})")
        transports = chosen

    echo_lock = threading.Lock()   # step lines land from worker threads

    def on_step(index, r):
        mark = "+" if r.ok else "!"
        with echo_lock:
            click.echo(f"worker {index}: {mark} {r.name}"
                       + (f": {r.detail}" if r.detail else ""))

    def on_report(report):
        """Per-worker summary the moment THAT worker finishes: a slow
        worker must not hold back the fast workers' verdicts."""
        if report.ok:
            line = f"worker {report.index} ({report.host}): ok"
        else:
            # the streamed '!' line may be interleaved far above: the
            # summary must carry the failure on its own
            bad = next((r for r in report.results if not r.ok), None)
            why = ""
            if bad is not None:
                why = f" at {bad.name}" + (f": {bad.detail}" if bad.detail else "")
            line = f"worker {report.index} ({report.host}): FAILED{why}"
        with echo_lock:
            click.echo(line)

    reports = provision_fleet(
        transports, repo_root,
        with_firewall=not no_firewall, with_cp=not no_cp,
        monitor=f.config.settings.monitoring.enable,
        max_workers=max(1, jobs), on_step=on_step, on_report=on_report)
    if any(not r.ok for r in reports):
        raise SystemExit(1)


@fleet_group.command("status")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@click.pass_context
def fleet_status(ctx, fmt):
    """Per-worker daemon + control-plane health over SSH."""
    from .. import consts

    rows = []
    for t in _transports(_factory(ctx)):
        docker = t.run("docker info --format '{{.ServerVersion}}'", timeout=20.0)
        cp = t.run(
            f"curl -fsS -m 3 http://127.0.0.1:{consts.CP_HEALTH_PORT}/healthz",
            timeout=20.0,
        )
        rows.append({
            "worker": t.index, "host": t.host,
            "docker": docker.out.strip() if docker.rc == 0 else "DOWN",
            "control_plane": "ok" if cp.rc == 0 else "DOWN",
        })
    if fmt == "json":
        click.echo(json.dumps(rows, indent=2))
        return
    for r in rows:
        click.echo(f"{r['worker']}\t{r['host']}\tdocker={r['docker']}\tcp={r['control_plane']}")


@fleet_group.command("anomaly")
@click.option("--watch", is_flag=True,
              help="Keep scoring and re-print the table every interval.")
@click.option("--interval", type=float, default=None,
              help="Scoring tick seconds with --watch (default: settings "
                   "sentinel.interval_s).")
@click.option("--ticks", type=int, default=0,
              help="With --watch: stop after N ticks (0 = until Ctrl-C).")
@click.option("--window", type=int, default=None,
              help="Window seconds (default: settings sentinel.window_s).")
@click.option("--train-steps", type=int, default=None,
              help="Denoising fit steps per tick (default: settings "
                   "sentinel.train_steps).")
@click.option("--threshold", type=float, default=None,
              help="Worker-relative robust z past which an agent flags "
                   "(default: settings sentinel.threshold).")
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

    One-shot by default: collect every worker's stream (local reads on
    local/fake, ``tail -F`` over the SSH mux for tpu_vm) and every
    ``--stream``, score once, and exit 2 when any agent's window flags
    past the threshold (default: settings ``sentinel``).  ``--watch``
    keeps ticking and re-prints live scores.  With a loopd daemon
    hosting a sentinel (settings sentinel.enable) the one-shot renders
    the daemon's LIVE rows instead of building a second scorer.
    """
    from ..sentinel import FleetSentinel

    f = _factory(ctx)
    ss = f.config.settings.sentinel
    if not watch:
        doc = _loopd_status(f, no_daemon)
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
    sentinel = FleetSentinel(
        f.config, f.driver,
        interval_s=(interval if interval is not None else ss.interval_s),
        window_s=window or ss.window_s,
        train_steps=train_steps or ss.train_steps,
        threshold=(threshold if threshold is not None else ss.threshold),
        baseline_window=ss.baseline_window, device=device)
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
            # remote (tpu_vm) tails replay worker history asynchronously
            # over the SSH mux: let the feed settle before the one
            # verdict tick, or a busy fleet reads as empty
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
    from ..errors import ClawkerError
    from ..loopd.client import discover_all
    from ..loopd.feed import console_feed, merge_feeds
    from ..ui.fleetconsole import FleetConsole

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
    from ..errors import ClawkerError
    from ..loopd.client import discover

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


def register(root: click.Group) -> None:
    root.add_command(fleet_group)
