"""``workerd start|stop|status``: the port's copy of
``clawker_tpu/cli/cmd_workerd.py``.
"""

from __future__ import annotations

import json
import time

import click

from .factory import _factory


@click.group("workerd")
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
    from ..errors import ClawkerError
    from ..workerd import socket_path, spawn_daemon
    from ..workerd.executor import ping_socket

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

    from ..agentd import protocol
    from ..errors import ClawkerError
    from ..workerd import liveness, socket_path

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

    from ..agentd import protocol
    from ..util.daemon import DaemonSpec
    from ..workerd import pidfile_path, socket_path

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


def register(root: click.Group) -> None:
    root.add_command(workerd_group)
