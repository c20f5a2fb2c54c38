"""`clawker init` -- scaffold project config (reference: internal/cmd/init).

The port's copy of ``clawker_tpu/cli/cmd_init.py``, whole.
"""

from __future__ import annotations

import click

from .. import consts
from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)

TEMPLATE = """\
# clawker project configuration
project: {name}

build:
  stack: {stack}          # language stack bundle: python | go | node | ...
  harness: {harness}         # agent harness bundle

workspace:
  mode: {mode}              # bind (live) | snapshot (ephemeral copy)

security:
  egress: []              # extra allowed domains, e.g.
  #  - dst: pypi.org
  #    proto: https
"""


def _slug(raw: str) -> str:
    import re

    return re.sub(r"[^a-z0-9_-]+", "-", raw.lower()).strip("-_") or "project"


def _wizard(f: Factory, name: str, stack: str) -> tuple[str, str, str, str]:
    """Interactive init wizard (reference: internal/tui wizard used by
    init, SURVEY.md 2.4): name, stack (from the resolved bundle
    inventory), harness, workspace mode -- flags pre-answer.  Only
    called on promptable streams (init_cmd gates)."""
    harness = "claude"
    from ..bundle.resolver import Resolver

    p = f.prompter
    pname = _slug(p.string("Project name", default=_slug(name or f.cwd.name)))
    stacks = sorted(s.name for s in Resolver(f.config).list("stack"))
    if stack not in stacks:
        # honor an explicit --stack even without a bundle for it (loose/
        # installed tiers may provide it later) instead of silently
        # defaulting to the alphabetically-first bundle
        stacks = [stack] + stacks
    idx = p.select("Language stack", stacks, default=stacks.index(stack))
    stack = stacks[idx]
    harnesses = sorted(h.name for h in Resolver(f.config).list("harness")) \
        or [harness]
    hidx = p.select("Agent harness", harnesses,
                    default=harnesses.index("claude")
                    if "claude" in harnesses else 0)
    harness = harnesses[hidx]
    midx = p.select("Workspace mode",
                    ["bind (live project tree)",
                     "snapshot (ephemeral copy per agent)"], default=0)
    mode = "bind" if midx == 0 else "snapshot"
    return pname, stack, harness, mode


@click.command("init")
@click.option("--name", default="", help="Project name (default: directory name).")
@click.option("--stack", default="python", show_default=True)
@click.option("--yes", "-y", is_flag=True,
              help="Skip the wizard; take flags/defaults as-is.")
@click.option("--force", is_flag=True, help="Overwrite existing config.")
@pass_factory
def init_cmd(f: Factory, name, stack, yes, force):
    """Initialize a clawker project in the current directory.

    Interactive terminals get a short wizard (name, stack, harness,
    workspace mode); --yes or a non-TTY run takes the flags/defaults."""
    target = f.cwd / consts.PROJECT_FLAT_FORM
    if target.exists() and not force:
        raise click.ClickException(f"{target} already exists (use --force)")
    if yes or not f.streams.can_prompt():
        pname, harness, mode = _slug(name or f.cwd.name), "claude", "bind"
    else:
        pname, stack, harness, mode = _wizard(f, name, stack)
    target.write_text(TEMPLATE.format(name=pname, stack=stack,
                                      harness=harness, mode=mode))
    click.echo(f"initialized project {pname!r} ({target})")


def register(root: click.Group) -> None:
    root.add_command(init_cmd)
