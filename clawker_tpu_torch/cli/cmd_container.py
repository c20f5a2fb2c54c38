"""Container verbs: run / create / start / attach / stop / kill / rm / ps /
logs / inspect, as a ``container`` group plus Docker-style top-level aliases
(reference: internal/cmd/container 20 verbs; builtin aliases aliases.go:132).

The port's copy of ``clawker_tpu/cli/cmd_container.py``, whole but for
``run``'s bundle auto-update (``BundleManager.auto_update_check``), which
waits for ``bundle/manager.py`` with the image builds (ROADMAP §1).
These verbs compute nothing on the card and load no torch.
"""

from __future__ import annotations

import io
import json
import re
import sys

import click

from .. import consts
from ..runtime.names import container_name
from ..runtime.orchestrate import CreateOptions
from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)

_HEX_ID = re.compile(r"^[0-9a-f]{12,64}$")


def _resolve_ref(f: Factory, name_or_agent: str) -> str:
    """Accept a bare agent name (scoped to the current project) or a full
    container name/id (reference: cmdutil name resolution)."""
    if "." in name_or_agent or _HEX_ID.match(name_or_agent):
        return name_or_agent
    return container_name(f.config.project_name(), name_or_agent)


# ------------------------------------------------------------------- run


@click.command("run", context_settings={
    # docker semantics: everything after the first CMD token belongs to
    # the container command ("run ... sh -c 'exit 7'"), never to clawker
    "ignore_unknown_options": True,
    "allow_interspersed_args": False,
})
@click.option("--agent", "-a", default=None, help="Agent name (default: project config).")
@click.option("--image", default="@", show_default=True, help="Image ('@' = project image).")
@click.option("--env", "-e", multiple=True, help="KEY=VALUE (repeatable).")
@click.option("--env-file", "env_files", multiple=True,
              type=click.Path(exists=True),
              help="Read KEY=VALUE pairs from a dotenv file (repeatable; "
                   "--env wins on conflicts).")
@click.option("--workspace", type=click.Choice(["bind", "snapshot"]), default=None)
@click.option("--replace", is_flag=True, help="Replace an existing agent container.")
@click.option("--detach", "-d", is_flag=True, help="Start without attaching.")
@click.option("--no-tty", is_flag=True, help="Disable TTY allocation.")
@click.option("--worktree", default="", help="Run in the named git worktree.")
@click.option("--workdir", default="",
              help="Override the container working directory.")
@click.argument("cmd", nargs=-1, type=click.UNPROCESSED)
@pass_factory
def run_cmd(f: Factory, agent, image, env, env_files, workspace, replace,
            detach, no_tty, worktree, workdir, cmd):
    """Create an agent container and attach to it (create+start+attach)."""
    cfg = f.config
    # the reference refreshes bundles here (BundleManager.auto_update_check,
    # reference cmdutil.RunBundleAutoUpdate, run.go:166): not ported yet,
    # bundle/manager.py waits with the image builds
    agent = agent or (cfg.project.agent.default if cfg.project else "dev")
    envd = _assemble_env(env, env_files)
    opts = CreateOptions(
        agent=agent,
        image=image,
        cmd=list(cmd),
        env=envd,
        tty=not no_tty,
        workspace_mode=workspace or "",
        replace=replace,
        workdir=workdir,
    )
    if worktree:
        from ..project.manager import ProjectManager

        pm = ProjectManager(cfg)
        wt = pm.get_worktree(cfg.project_name(), worktree)
        opts.workspace_root = wt.path
        opts.worktree_git_dir = wt.main_git_dir
        opts.workspace_mode = "bind"
    rt = f.runtime()
    cid = rt.create(opts)
    name = container_name(cfg.project_name(), agent)
    if detach:
        rt.start(cid)
        click.echo(name)
        return
    code = rt.attach_and_run(cid, tty=not no_tty)
    if code != 0:
        raise SystemExit(code)


# ------------------------------------------------------------------ group


@click.group("container")
def container_group():
    """Manage agent containers."""


def _assemble_env(env: tuple, env_files: tuple) -> dict[str, str]:
    """dotenv files first (in order), explicit --env pairs win."""
    from ..util.dotenv import parse_file

    out: dict[str, str] = {}
    for path in env_files:
        out.update(parse_file(path))
    out.update(dict(e.split("=", 1) if "=" in e else (e, "") for e in env))
    return out


@container_group.command("create", context_settings={
    "ignore_unknown_options": True,
    "allow_interspersed_args": False,
})
@click.option("--agent", "-a", default=None)
@click.option("--image", default="@")
@click.option("--env", "-e", multiple=True)
@click.option("--env-file", "env_files", multiple=True,
              type=click.Path(exists=True))
@click.option("--replace", is_flag=True)
@click.option("--workspace", type=click.Choice(["bind", "snapshot"]),
              default=None)
@click.option("--workdir", default="",
              help="Override the container working directory.")
@click.argument("cmd", nargs=-1, type=click.UNPROCESSED)
@pass_factory
def create_cmd(f: Factory, agent, image, env, env_files, replace, workspace,
               workdir, cmd):
    """Create an agent container without starting it."""
    cfg = f.config
    agent = agent or (cfg.project.agent.default if cfg.project else "dev")
    envd = _assemble_env(env, env_files)
    f.runtime().create(
        CreateOptions(agent=agent, image=image, cmd=list(cmd), env=envd,
                      replace=replace, workspace_mode=workspace or "",
                      workdir=workdir)
    )
    click.echo(container_name(cfg.project_name(), agent))


@container_group.command("ls")
@click.option("--all/--running", "-A", "all_", default=True, help="Include stopped (default) or only running.")
@click.option("--project", "-p", default=None, help="Filter by project.")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def ls_cmd(f: Factory, all_, project, fmt):
    """List agent containers (all projects by default)."""
    rows = []
    for w in f.driver.workers():
        for c in f.runtime(w.require_engine()).list_agents(all=all_, project=project):
            labels = c.get("Labels", {})
            rows.append(
                {
                    "name": c["Names"][0].lstrip("/"),
                    "project": labels.get(consts.LABEL_PROJECT, ""),
                    "agent": labels.get(consts.LABEL_AGENT, ""),
                    "state": c.get("State", ""),
                    "image": c.get("Image", ""),
                    "worker": w.id,
                }
            )
    if fmt == "json":
        click.echo(json.dumps(rows, indent=2))
        return
    if not rows:
        click.echo("no agent containers")
        return
    widths = {k: max(len(k), *(len(r[k]) for r in rows)) for k in rows[0]}
    click.echo("  ".join(k.upper().ljust(widths[k]) for k in rows[0]))
    for r in rows:
        click.echo("  ".join(str(r[k]).ljust(widths[k]) for k in r))


@container_group.command("start")
@click.argument("name")
@pass_factory
def start_cmd(f: Factory, name):
    """Start a stopped agent container."""
    f.runtime().start(_resolve_ref(f, name))
    click.echo(name)


@container_group.command("attach")
@click.argument("name")
@click.option("--no-tty", is_flag=True)
@pass_factory
def attach_cmd(f: Factory, name, no_tty):
    """Attach to a running agent container."""
    ref = _resolve_ref(f, name)
    engine = f.engine()
    info = engine.inspect_container(ref)
    if not info["State"]["Running"]:
        raise click.ClickException(f"{name} is not running (use `clawker start`)")
    stream = engine.attach_container(ref, tty=not no_tty)
    from ..runtime import attach as attach_mod

    attach_mod.wire_resize(engine, ref)
    attach_mod.pump_streams(stream, sys.stdin.buffer, sys.stdout.buffer)
    code = engine.wait_container(ref)
    if code != 0:
        raise SystemExit(code)


@container_group.command("stop")
@click.argument("names", nargs=-1, required=True)
@click.option("--time", "-t", default=10, show_default=True)
@pass_factory
def stop_cmd(f: Factory, names, time):
    """Stop running agent containers."""
    for n in names:
        f.engine().stop_container(_resolve_ref(f, n), timeout=time)
        click.echo(n)


@container_group.command("kill")
@click.argument("names", nargs=-1, required=True)
@click.option("--signal", "-s", default="KILL", show_default=True)
@pass_factory
def kill_cmd(f: Factory, names, signal):
    """Kill running agent containers."""
    for n in names:
        f.engine().kill_container(_resolve_ref(f, n), signal=signal)
        click.echo(n)


@container_group.command("rm")
@click.argument("names", nargs=-1, required=True)
@click.option("--force", "-f", is_flag=True)
@click.option("--volumes", "-v", is_flag=True, help="Also remove agent volumes.")
@pass_factory
def rm_cmd(f: Factory, names, force, volumes):
    """Remove agent containers."""
    what = ", ".join(names) + (" (and volumes)" if volumes else "")
    if not f.confirm_destructive(f"Remove {what}?", skip=force):
        raise SystemExit(1)
    for n in names:
        f.engine().remove_container(_resolve_ref(f, n), force=force, volumes=volumes)
        click.echo(n)


@container_group.command("inspect")
@click.argument("name")
@pass_factory
def inspect_cmd(f: Factory, name):
    """Inspect an agent container (JSON)."""
    click.echo(json.dumps(f.engine().inspect_container(_resolve_ref(f, name)), indent=2))


@container_group.command("logs")
@click.argument("name")
@click.option("--follow", "-F", is_flag=True)
@click.option("--tail", default="all", show_default=True)
@pass_factory
def logs_cmd(f: Factory, name, follow, tail):
    """Print container logs."""
    for chunk in f.engine().logs(_resolve_ref(f, name), follow=follow, tail=tail):
        sys.stdout.buffer.write(chunk)
    sys.stdout.flush()


@container_group.command("wait")
@click.argument("name")
@pass_factory
def wait_cmd(f: Factory, name):
    """Block until the container exits; echo its exit code."""
    click.echo(f.engine().wait_container(_resolve_ref(f, name)))


@click.command("exec", context_settings={
    "ignore_unknown_options": True,
    "allow_interspersed_args": False,
})
@click.option("--tty", "-t", is_flag=True, help="Allocate a pseudo-TTY.")
@click.option("--interactive", "-i", is_flag=True, help="Keep stdin open.")
@click.option("--env", "-e", multiple=True, help="KEY=VALUE (repeatable).")
@click.option("--user", "-u", default="", help="User inside the container.")
@click.option("--workdir", default="", help="Working directory for the command.")
@click.argument("name")
@click.argument("cmd", nargs=-1, type=click.UNPROCESSED, required=True)
@pass_factory
def exec_cmd(f: Factory, tty, interactive, env, user, workdir, name, cmd):
    """Run a command inside a running agent container.

    Reference parity: clawker container exec / clawker exec
    (docs/cli-reference/clawker_container_exec.md); exit code propagates.
    """
    ref = _resolve_ref(f, name)
    engine = f.engine()
    envd = dict(e.split("=", 1) if "=" in e else (e, "") for e in env)
    eid, stream = engine.exec(ref, list(cmd), user=user, env=envd,
                              tty=tty, stdin=interactive, workdir=workdir)
    from ..runtime import attach as attach_mod

    stdin: object = sys.stdin.buffer if interactive else io.BytesIO(b"")
    if tty and interactive and sys.stdin.isatty() and sys.stdout.isatty():
        # same raw-mode discipline as the attach path: without it the
        # local cooked terminal double-echoes and eats Ctrl-C
        with attach_mod.raw_terminal(sys.stdin.fileno()):
            attach_mod.pump_streams(stream, stdin, sys.stdout.buffer)
    else:
        attach_mod.pump_streams(stream, stdin, sys.stdout.buffer)
    code = engine.exec_exit_code(eid)
    if code != 0:
        raise SystemExit(code)


def register(root: click.Group) -> None:
    root.add_command(run_cmd)
    root.add_command(container_group)
    # Docker-style top-level aliases (reference: root/aliases.go)
    root.add_command(ls_cmd, "ps")
    root.add_command(start_cmd, "start")
    root.add_command(stop_cmd, "stop")
    root.add_command(rm_cmd, "rm")
    root.add_command(attach_cmd, "attach")
    root.add_command(kill_cmd, "kill")
    root.add_command(logs_cmd, "logs")
    root.add_command(exec_cmd, "exec")
    container_group.add_command(exec_cmd)
