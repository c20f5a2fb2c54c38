"""Root command wiring: the port's copy of ``clawker_tpu/cli/root.py``.

``_RootGroup`` expands user aliases (``<config>/aliases.yaml``) on the
argv before dispatch and renders the domain errors: ``ExitError`` exits
with its code, ``SilentError`` with 1, ``FlagError`` as a usage error
(2), any other ``ClawkerError`` as one line (1); ``main`` returns the
reference's codes, 130 with ``aborted`` on ``click.Abort``.  The
start-up notices (``_start_notices``/``_finish_notices``: the update
check and the changelog teaser over ``state.py`` and ``changelog.py``)
run on a thread beside the command, only on a TTY, unless
``CLAWKER_TPU_NO_NOTICES`` is set.  Left out: the verb that waits for
its modules (``WAITING``: ``analyze``), which is refused by name.  One
departure: the root closes the driver that the factory built when the
command ends, so no forward of a ``tpu_vm`` driver outlives the verb.
The firewall's monitor-mode handler is not the driver's: it lives as
long as the process, as the reference's does (``firewall/lifecycle.py``).
"""

from __future__ import annotations

import click

from .. import __version__, logsetup
from ..errors import ClawkerError, ExitError, FlagError, SilentError
from .factory import Factory, _not_ported

CONTEXT_SETTINGS = {"help_option_names": ["-h", "--help"], "max_content_width": 100}

# the reference's verbs whose modules are not ported yet (ROADMAP §1)
WAITING = ("analyze",)


class _RootGroup(click.Group):
    """Centralized domain-error rendering (reference: internal/clawker/cmd.go
    error presentation): ClawkerErrors become clean one-line CLI errors in
    both standalone and embedded (test) invocation modes.  Unknown names
    fall back to user aliases (reference: root/useraliases.go), resolved
    by walking the expansion words through the command tree."""

    def resolve_command(self, ctx: click.Context, args: list):
        # argv-level alias expansion (docker/gh-style): flags and
        # arguments inside an expansion survive, because parsing restarts
        # on the rewritten argv rather than resolving a command object
        if args and super().get_command(ctx, args[0]) is None:
            if args[0] in WAITING:
                raise _not_ported(f"clawker {args[0]}")
            from .cmd_settings import load_aliases

            expansion = load_aliases(None).get(args[0], "")
            if expansion:
                args = expansion.split() + list(args[1:])
        return super().resolve_command(ctx, args)

    def invoke(self, ctx: click.Context):
        try:
            return super().invoke(ctx)
        except ExitError as e:
            raise SystemExit(e.code) from e
        except SilentError:
            raise SystemExit(1) from None
        except FlagError as e:
            raise click.UsageError(str(e)) from e
        except ClawkerError as e:
            raise click.ClickException(str(e)) from e


@click.group(cls=_RootGroup, context_settings=CONTEXT_SETTINGS)
@click.option("--verbose", "-v", is_flag=True, help="Debug logging to stderr.")
@click.version_option(__version__, prog_name="clawker")
@click.pass_context
def cli(ctx: click.Context, verbose: bool) -> None:
    """clawker -- run AI coding agents in locked-down containers on your
    laptop's Docker daemon or across the worker VMs of a Cloud TPU pod,
    with the fleet's anomaly model on PyTorch/CUDA."""
    logsetup.setup("debug" if verbose else "warning")
    # one Factory for the whole command; the driver it builds is closed
    # when the command ends
    if not isinstance(ctx.obj, Factory):
        ctx.obj = Factory()
    ctx.call_on_close(ctx.obj.close)


def _start_notices() -> "object | None":
    """Kick off the update check + changelog teaser CONCURRENTLY with the
    command (reference: internal/clawker cmd.go:79-120 background
    notification goroutines).  Returns the thread, or None when notices
    are disabled.  The probe must never delay the user: the collector at
    command end waits at most a beat, and a missed fetch just retries on
    a later run (the TTL cache absorbs the cost)."""
    import os
    import sys
    import threading

    if not sys.stderr.isatty() or os.environ.get("CLAWKER_TPU_NO_NOTICES"):
        return None
    lines: list[str] = []

    def probe() -> None:
        try:
            from ..changelog import teaser
            from ..state import check_for_update

            lines.extend(l for l in (check_for_update(), teaser()) if l)
        except Exception:  # noqa: BLE001 - notices never break a command
            pass

    t = threading.Thread(target=probe, name="notices", daemon=True)
    t.lines = lines  # type: ignore[attr-defined]
    t.start()
    return t


def _finish_notices(t) -> None:
    if t is None:
        return
    t.join(0.3)
    if not t.is_alive():
        for line in t.lines:
            click.echo(line, err=True)


def main(argv: list[str] | None = None) -> int:
    notices = _start_notices()
    try:
        cli.main(args=argv, prog_name="python -m clawker_tpu_torch",
                 standalone_mode=False)
        _finish_notices(notices)
        return 0
    except click.exceptions.Exit as e:
        return e.exit_code
    except SystemExit as e:
        if e.code is None or isinstance(e.code, int):
            return int(e.code or 0)
        return 1        # a message: Python's own exit status for it
    except click.ClickException as e:
        e.show()
        return e.exit_code
    except click.Abort:
        click.echo("aborted", err=True)
        return 130
    except ExitError as e:
        return e.code
    except SilentError:
        return 1
    except FlagError as e:
        click.echo(f"error: {e}", err=True)
        return 2
    except ClawkerError as e:
        click.echo(f"error: {e}", err=True)
        return 1


def register_commands() -> None:
    """Attach all command groups (import-cycle-free late binding)."""
    from . import (
        cmd_build,
        cmd_bundle,
        cmd_chaos,
        cmd_container,
        cmd_controlplane,
        cmd_fed,
        cmd_firewall,
        cmd_fleet,
        cmd_harness,
        cmd_image,
        cmd_init,
        cmd_journal,
        cmd_loop,
        cmd_loopd,
        cmd_monitor,
        cmd_network,
        cmd_plugin,
        cmd_project,
        cmd_settings,
        cmd_trace,
        cmd_volume,
        cmd_workerd,
    )

    cmd_build.register(cli)
    cmd_bundle.register(cli)
    cmd_chaos.register(cli)
    cmd_container.register(cli)
    cmd_controlplane.register(cli)
    cmd_fed.register(cli)
    cmd_firewall.register(cli)
    cmd_fleet.register(cli)
    cmd_harness.register(cli)
    cmd_image.register(cli)
    cmd_init.register(cli)
    cmd_journal.register(cli)
    cmd_loop.register(cli)
    cmd_loopd.register(cli)
    cmd_monitor.register(cli)
    cmd_network.register(cli)
    cmd_plugin.register(cli)
    cmd_project.register(cli)
    cmd_settings.register(cli)
    cmd_trace.register(cli)
    cmd_volume.register(cli)
    cmd_workerd.register(cli)


register_commands()
