"""Project + worktree verbs (reference: internal/cmd/project,
internal/cmd/worktree).  Registry/worktree domain logic lives in
clawker_tpu_torch.project; these are thin command shims.

The port's copy of ``clawker_tpu/cli/cmd_project.py``, whole but for
``project edit``, which needs the field browser (``storeui.py``,
``ui/fieldbrowser.py``) and is refused by name (ROADMAP §1 item 13).
"""

from __future__ import annotations

import json

import click

from .factory import Factory, _not_ported

pass_factory = click.make_pass_decorator(Factory)


@click.group("project")
def project_group():
    """Manage registered projects."""


@project_group.command("register")
@pass_factory
def project_register(f: Factory):
    """Register the current project in the global registry."""
    from ..project.manager import ProjectManager

    pm = ProjectManager(f.config)
    rec = pm.register_current()
    click.echo(f"registered {rec.name} -> {rec.root}")


@project_group.command("list")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def project_list(f: Factory, fmt):
    from ..project.manager import ProjectManager

    pm = ProjectManager(f.config)
    projects = pm.list_projects()
    if fmt == "json":
        click.echo(json.dumps([p.__dict__ for p in projects], indent=2, default=str))
        return
    for p in projects:
        click.echo(f"{p.name}\t{p.root}\t{len(p.worktrees)} worktrees")


@project_group.command("edit")
@click.option("--select", "select_mode", is_flag=True,
              help="Numbered-select editor instead of the full browser.")
@pass_factory
def project_edit(f: Factory, select_mode):
    """Interactively browse + edit project config fields (reference
    internal/config/storeui/project)."""
    raise _not_ported("project edit (the field browser)")


@project_group.command("remove")
@click.argument("name")
@click.option("--yes", "-y", is_flag=True, help="Skip the confirmation prompt.")
@pass_factory
def project_remove(f: Factory, name, yes):
    from ..project.manager import ProjectManager

    if not f.confirm_destructive(
            f"Remove project {name!r} from the registry?", skip=yes):
        raise SystemExit(1)
    ProjectManager(f.config).remove(name)
    click.echo(name)


@click.group("worktree")
def worktree_group():
    """Manage git worktrees for parallel agents."""


@worktree_group.command("add")
@click.argument("name")
@click.option("--branch", default="", help="Branch name (default: clawker/<name>).")
@pass_factory
def worktree_add(f: Factory, name, branch):
    from ..project.manager import ProjectManager

    pm = ProjectManager(f.config)
    wt = pm.add_worktree(f.config.project_name(), name, branch=branch)
    click.echo(f"{wt.name}\t{wt.path}\t{wt.branch}")


@worktree_group.command("list")
@pass_factory
def worktree_list(f: Factory):
    from ..project.manager import ProjectManager

    pm = ProjectManager(f.config)
    for wt in pm.list_worktrees(f.config.project_name()):
        click.echo(f"{wt.name}\t{wt.path}\t{wt.branch}")


@worktree_group.command("remove")
@click.argument("name")
@click.option("--force", is_flag=True, help="Remove even with local changes.")
@pass_factory
def worktree_remove(f: Factory, name, force):
    from ..project.manager import ProjectManager

    if not f.confirm_destructive(f"Remove worktree {name!r}?", skip=force):
        raise SystemExit(1)
    pm = ProjectManager(f.config)
    pm.remove_worktree(f.config.project_name(), name, force=force)
    click.echo(name)


@worktree_group.command("prune")
@pass_factory
def worktree_prune(f: Factory):
    from ..project.manager import ProjectManager

    pm = ProjectManager(f.config)
    for name in pm.prune_worktrees(f.config.project_name()):
        click.echo(f"pruned {name}")


def register(root: click.Group) -> None:
    root.add_command(project_group)
    root.add_command(worktree_group)
