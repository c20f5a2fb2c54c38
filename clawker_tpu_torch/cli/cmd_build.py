"""`clawker build` -- build the project's base + harness images
(reference: internal/cmd/image/build/build.go:110; progress tree parity
with tui.RunProgress at :395).

The port's copy of ``clawker_tpu/cli/cmd_build.py``, whole.
"""

from __future__ import annotations

import click

from ..bundler.build import ProjectBuilder
from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)


@click.command("build")
@click.option("--harness", default="", help="Harness override (default: project config).")
@click.option("--no-cache", is_flag=True, help="Build without layer cache.")
@click.option("--quiet", "-q", is_flag=True, help="Only print the final image ref.")
@click.option("--plain", is_flag=True, help="Raw build output (no progress tree).")
@click.option("--secret", "secret_specs", multiple=True,
              help="id=NAME,src=PATH secret for RUN --mount=type=secret "
                   "(BuildKit session lane; repeatable).")
@click.option("--ssh", "ssh_spec", default="",
              help="Forward an ssh agent into the build: 'default' uses "
                   "$SSH_AUTH_SOCK, or default=/path/to/sock.")
@pass_factory
def build_cmd(f: Factory, harness, no_cache, quiet, plain, secret_specs,
              ssh_spec):
    """Build the project image (base stage + harness stage + :default tag)."""
    from ..ui.buildview import BuildProgressView
    from ..ui.progress import ProgressTree

    ca_pem = None
    if f.config.settings.firewall.enable:
        from ..firewall.pki import ensure_ca

        ca_pem = ensure_ca(f.config.pki_dir).cert_pem

    if quiet:
        progress = lambda _line: None  # noqa: E731
        view = None
    elif plain:
        progress = lambda line: click.echo(line)  # noqa: E731
        view = None
    else:
        tree = ProgressTree(f.streams)
        view = BuildProgressView(tree)

        def progress(line: str) -> None:
            # stage boundary lines come from the builder itself
            if line.startswith(("building ", "tagged ")):
                view.stage(line)
            else:
                view.line(line)

    secrets = _parse_secrets(secret_specs)
    ssh_sock = _parse_ssh(ssh_spec)
    builder = ProjectBuilder(f.engine(), f.config, ca_cert_pem=ca_pem,
                             progress=progress)
    kw = dict(harness_override=harness, no_cache=no_cache,
              secrets=secrets, ssh_auth_sock=ssh_sock)
    if view is not None:
        with view.tree:
            try:
                res = builder.build(**kw)
                view.done()
            except Exception as e:
                view.failed(str(e))
                raise
    else:
        res = builder.build(**kw)
    click.echo(res.default_ref)
    if not res.with_agentd and not quiet:
        click.echo(
            "warning: agentd binary not found -- image runs the harness "
            "directly without PID-1 supervision (build native/ first)",
            err=True,
        )


def register(root: click.Group) -> None:
    root.add_command(build_cmd)


def _parse_secrets(specs: tuple[str, ...]) -> dict[str, bytes] | None:
    """docker-compatible: --secret id=NAME,src=PATH (also env=VAR)."""
    import os

    out: dict[str, bytes] = {}
    for spec in specs:
        kv = dict(part.split("=", 1) for part in spec.split(",") if "=" in part)
        sid = kv.get("id", "")
        if not sid:
            raise click.BadParameter(f"--secret {spec!r}: id= required")
        if "src" in kv or "source" in kv:
            path = kv.get("src") or kv.get("source", "")
            try:
                out[sid] = open(path, "rb").read()
            except OSError as e:
                raise click.BadParameter(f"--secret {sid}: {e}") from None
        elif "env" in kv:
            val = os.environ.get(kv["env"])
            if val is None:
                raise click.BadParameter(
                    f"--secret {sid}: env {kv['env']} not set")
            out[sid] = val.encode()
        else:
            raise click.BadParameter(f"--secret {spec!r}: src= or env= required")
    return out or None


def _parse_ssh(spec: str) -> str:
    import os

    if not spec:
        return ""
    name, _, path = spec.partition("=")
    if path:
        return path
    sock = os.environ.get("SSH_AUTH_SOCK", "")
    if not sock:
        raise click.BadParameter("--ssh default: SSH_AUTH_SOCK not set")
    return sock
