"""harness/stack listing.

Parity reference: internal/cmd/{harness,stack} listing verbs.

The port's copy of ``clawker_tpu/cli/cmd_harness.py`` but for
``gen-docs`` (the CLI reference and schema generator, ``docs.py``),
which is refused by name (ROADMAP §1 item 13).
"""

from __future__ import annotations

import click

from ..bundle.resolver import Resolver
from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)


@click.group("harness")
def harness_group():
    """Agent harness bundles (claude, codex, ...)."""


@harness_group.command("ls")
@pass_factory
def harness_ls(f: Factory):
    for h in Resolver(f.config).list("harness"):
        click.echo(f"{h.name}\t{getattr(h, 'description', '') or ''}")


@click.group("stack")
def stack_group():
    """Language stack bundles (python, go, node, ...)."""


@stack_group.command("ls")
@pass_factory
def stack_ls(f: Factory):
    for s in Resolver(f.config).list("stack"):
        click.echo(f"{s.name}\t{getattr(s, 'base_image', '') or ''}")


def register(cli: click.Group) -> None:
    cli.add_command(harness_group)
    cli.add_command(stack_group)
