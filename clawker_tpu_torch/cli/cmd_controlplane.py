"""controlplane verbs: up/down/status/agents.

Parity reference: internal/cmd/controlplane (up/down/status/agents,
SURVEY.md 2.4) -- status and agents go through the AdminService with the
mTLS + bearer contract, exactly like the reference's adminclient Dial.

The port's copy of ``clawker_tpu/cli/cmd_controlplane.py``, whole.
"""

from __future__ import annotations

import json

import click

from ..controlplane import manager
from ..errors import ClawkerError
from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)


def _admin_client(f: Factory):
    try:
        return manager.admin_client(f.config)
    except manager.ControlPlaneError as e:
        raise click.ClickException(str(e)) from None


@click.group("controlplane")
def cp_group():
    """Manage the control-plane daemon."""


@cp_group.command("up")
@pass_factory
def cp_up(f: Factory):
    manager.ensure_running(f.config)
    click.echo("control plane running")


@cp_group.command("down")
@pass_factory
def cp_down(f: Factory):
    if manager.stop(f.config):
        click.echo("control plane stopped")
    else:
        click.echo("control plane not running")


@cp_group.command("status")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def cp_status(f: Factory, fmt):
    h = manager.health(f.config)
    if h is None:
        if fmt == "json":
            click.echo(json.dumps({"running": False}))
        else:
            click.echo("control plane: not running")
        raise SystemExit(1)
    if fmt == "json":
        click.echo(json.dumps({"running": True, **h}, indent=2))
        return
    click.echo("control plane: running")
    for k in ("admin", "agent_service", "feeder", "watcher"):
        click.echo(f"  {k:14} {'ok' if h.get(k) else 'DOWN'}")
    if h.get("unavailable"):
        click.echo(f"  unavailable    {', '.join(h['unavailable'])}")
    click.echo(f"  uptime         {h.get('uptime_s', 0):.0f}s")


@cp_group.command("agents")
@click.option("--project", default="", help="Filter by project.")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def cp_agents(f: Factory, project, fmt):
    try:
        reply = _admin_client(f).call("ListAgents", {"project": project})
    except ClawkerError as e:
        raise click.ClickException(str(e)) from e
    agents = reply.get("agents", [])
    if fmt == "json":
        click.echo(json.dumps(agents, indent=2))
        return
    if not agents:
        click.echo("no agents")
        return
    click.echo(f"{'AGENT':32} {'STATE':12} {'INIT':5} {'REG':5} CONTAINER")
    for a in agents:
        click.echo(
            f"{a['full_name']:32} {a['state']:12} "
            f"{'yes' if a['initialized'] else 'no':5} "
            f"{'yes' if a['registered'] else 'no':5} {a['container_id'][:12]}"
        )


def register(root: click.Group) -> None:
    root.add_command(cp_group)
