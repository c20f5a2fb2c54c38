"""Volume verbs (reference: internal/cmd/volume; the network group
lives in cmd_network.py).

The port's copy of ``clawker_tpu/cli/cmd_volume.py``, whole.
"""

from __future__ import annotations

import json

import click

from .. import consts
from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)


@click.group("volume")
def volume_group():
    """Manage agent volumes."""


@volume_group.command("ls")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def volume_ls(f: Factory, fmt):
    vols = f.engine().list_volumes()
    if fmt == "json":
        click.echo(json.dumps(vols, indent=2))
        return
    for v in vols:
        labels = v.get("Labels") or {}
        click.echo(
            f"{v['Name']}\t{labels.get(consts.LABEL_PROJECT, '')}"
            f"\t{labels.get(consts.LABEL_VOLUME_PURPOSE, '')}"
        )


@volume_group.command("rm")
@click.argument("names", nargs=-1, required=True)
@click.option("--force", "-f", is_flag=True)
@pass_factory
def volume_rm(f: Factory, names, force):
    if not f.confirm_destructive(
            f"Remove volume(s) {', '.join(names)}? Data is not recoverable.",
            skip=force):
        raise SystemExit(1)
    for n in names:
        f.engine().remove_volume(n, force=force)
        click.echo(n)


def register(root: click.Group) -> None:
    root.add_command(volume_group)
