"""network verbs: Docker-parity surface over MANAGED networks only.

Parity reference: internal/cmd/network (SURVEY.md 2.4); the label jail
means these verbs can only see/touch clawker-created networks.

The port's copy of ``clawker_tpu/cli/cmd_network.py``, whole.
"""

from __future__ import annotations

import json

import click

from .. import consts
from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)


@click.group("network")
def net_group():
    """Manage clawker networks (label-jailed)."""


@net_group.command("ls")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def net_ls(f: Factory, fmt):
    nets = f.engine().api.network_list(
        filters={"label": [f"{consts.LABEL_MANAGED}={consts.MANAGED_VALUE}"]})
    if fmt == "json":
        click.echo(json.dumps(nets, indent=2))
        return
    for n in nets:
        subnet = ""
        cfgs = (n.get("IPAM") or {}).get("Config") or []
        if cfgs:
            subnet = cfgs[0].get("Subnet", "")
        click.echo(f"{n.get('Name')}\t{n.get('Driver','bridge')}\t{subnet}")


@net_group.command("ensure")
@click.argument("name", default=consts.NETWORK_NAME)
@click.option("--subnet", default="", help="CIDR for the new network.")
@pass_factory
def net_ensure(f: Factory, name, subnet):
    """Idempotently create a managed bridge network."""
    n = f.engine().ensure_network(name, subnet=subnet)
    click.echo(f"{n['Name']} ready")


@net_group.command("inspect")
@click.argument("name")
@pass_factory
def net_inspect(f: Factory, name):
    click.echo(json.dumps(f.engine().api.network_inspect(name), indent=2))


@net_group.command("rm")
@click.argument("name")
@pass_factory
def net_rm(f: Factory, name):
    f.engine().remove_network(name)
    click.echo(f"removed network {name}")


def register(cli: click.Group) -> None:
    cli.add_command(net_group)
