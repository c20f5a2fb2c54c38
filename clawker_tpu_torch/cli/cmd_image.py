"""Image verbs: ls/rm now; `build` joins with the bundler milestone
(reference: internal/cmd/image).

The port's copy of ``clawker_tpu/cli/cmd_image.py``, whole.
"""

from __future__ import annotations

import json

import click

from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)


@click.group("image")
def image_group():
    """Manage project images."""


@image_group.command("ls")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def image_ls(f: Factory, fmt):
    imgs = f.engine().list_images()
    if fmt == "json":
        click.echo(json.dumps(imgs, indent=2))
        return
    for i in imgs:
        for tag in i.get("RepoTags") or []:
            click.echo(tag)


@image_group.command("rm")
@click.argument("refs", nargs=-1, required=True)
@click.option("--force", "-f", is_flag=True)
@pass_factory
def image_rm(f: Factory, refs, force):
    for r in refs:
        f.engine().remove_image(r, force=force)
        click.echo(r)


def register(root: click.Group) -> None:
    root.add_command(image_group)
