"""``loopd start|stop|status``: the port's copy of
``clawker_tpu/cli/cmd_loopd.py``, with ``ensure_daemon``, the autostart
path of ``loop``.
"""

from __future__ import annotations

import json
import os
import signal
import time

import click

from .factory import Factory, _factory, _project


@click.group("loopd")
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
    from ..errors import ClawkerError
    from ..loopd import logfile_path, socket_path, spawn_daemon
    from ..loopd.client import discover

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
            from ..loopd.server import LoopdServer

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
    from ..loopd import pidfile_path, socket_path
    from ..loopd.client import discover

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
    from ..loopd.client import discover
    from ..loopd.feed import console_feed

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


def ensure_daemon(f: Factory):
    """Autostart path for ``loop``: a connected client when a daemon
    answers (spawning one first if settings ``loopd.autostart`` asks for
    it), else None -- the caller degrades in-process."""
    from ..loopd import LoopdError, spawn_daemon
    from ..loopd.client import discover

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


def register(root: click.Group) -> None:
    root.add_command(loopd_group)
