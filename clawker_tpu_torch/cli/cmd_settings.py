"""settings + auth + version + alias verbs.

Parity reference: internal/cmd/{settings,auth,version,alias}
(SURVEY.md 2.4).  ``settings`` reads/writes the layered YAML through
the same provenance-routed store the rest of the framework uses; user
aliases expand before dispatch in root.py.

The port's copy of ``clawker_tpu/cli/cmd_settings.py``, whole but for
``settings edit``, which needs the field browser (``storeui.py``,
``ui/fieldbrowser.py``) and is refused by name (ROADMAP §1 item 13).
"""

from __future__ import annotations

import json

import click
import yaml

from .. import consts
from ..config.schema import to_dict
from .factory import Factory, _not_ported

pass_factory = click.make_pass_decorator(Factory)


# ------------------------------------------------------------------ settings

@click.group("settings")
def settings_group():
    """Inspect and edit settings.yaml."""


def _dotted_get(tree, path: str):
    cur = tree
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(path)
        cur = cur[part]
    return cur


@settings_group.command("list")
@pass_factory
def settings_list(f: Factory):
    click.echo(yaml.safe_dump(to_dict(f.config.settings), sort_keys=True) or "{}")


@settings_group.command("get")
@click.argument("path")
@pass_factory
def settings_get(f: Factory, path):
    """Read one dotted key (e.g. firewall.enable)."""
    try:
        val = _dotted_get(to_dict(f.config.settings), path)
    except KeyError:
        # unset-but-valid keys answer their schema default
        from dataclasses import is_dataclass

        from ..config.schema import Settings

        try:
            cur = Settings()
            for part in path.split("."):
                cur = getattr(cur, part)
            val = cur
        except AttributeError:
            raise click.ClickException(f"unknown settings key {path!r}")
        if is_dataclass(val):
            # full subtree incl. defaults (to_dict drops default values)
            import dataclasses

            val = dataclasses.asdict(val)
    click.echo(json.dumps(val) if not isinstance(val, str) else val)


@settings_group.command("edit")
@click.option("--select", "select_mode", is_flag=True,
              help="Numbered-select editor instead of the full browser.")
@pass_factory
def settings_edit(f: Factory, select_mode):
    """Interactively browse + edit settings fields (reflection-driven,
    reference internal/storeui + internal/tui field browser)."""
    raise _not_ported("settings edit (the field browser)")


@settings_group.command("set")
@click.argument("path")
@click.argument("value")
@pass_factory
def settings_set(f: Factory, path, value):
    """Write one dotted key into the user settings layer."""
    from ..config.config import settings_store

    try:
        parsed = json.loads(value)
    except json.JSONDecodeError:
        parsed = value
    # schema guard: the dotted path must exist AND the value must match
    # the field type -- `set firewall.enable no` silently storing the
    # truthy string "no" would invert a security setting
    from ..config.schema import Settings

    cur = Settings()
    parts = path.split(".")
    try:
        for part in parts[:-1]:
            cur = getattr(cur, part)
        current = getattr(cur, parts[-1])
    except AttributeError:
        raise click.ClickException(f"unknown settings key {path!r}")
    if isinstance(current, bool):
        if not isinstance(parsed, bool):
            raise click.ClickException(
                f"{path} is a boolean; use `true` or `false` (got {value!r})")
    elif isinstance(current, int) and not isinstance(parsed, (int, float)):
        raise click.ClickException(f"{path} is a number (got {value!r})")
    elif isinstance(current, float) and not isinstance(parsed, (int, float)):
        raise click.ClickException(f"{path} is a number (got {value!r})")
    elif isinstance(current, str) and not isinstance(parsed, str):
        parsed = str(parsed)
    elif isinstance(current, list) and not isinstance(parsed, list):
        raise click.ClickException(
            f"{path} is a list; pass JSON, e.g. '[\"a\", \"b\"]'")
    store = settings_store()
    store.set(path, parsed)
    click.echo(f"{path} = {json.dumps(parsed)}")


# ---------------------------------------------------------------------- auth

@click.group("auth")
def auth_group():
    """PKI and identity management."""


@auth_group.command("rotate")
@click.confirmation_option(
    prompt="Rotate the CA? Every agent leaf and MITM cert becomes invalid; "
           "images must be rebuilt and agents re-enrolled.")
@pass_factory
def auth_rotate(f: Factory):
    """Rotate the framework CA (reference: auth rotate -> RotateCA)."""
    from ..firewall import pki

    pki.rotate_ca(f.config.pki_dir)
    # stale CP/agent leaves are now untrusted; remove so they re-mint
    for leaf in ("cp.crt", "cp.key"):
        (f.config.pki_dir / leaf).unlink(missing_ok=True)
    click.echo("CA rotated; rebuild images (`clawker build`) and restart "
               "the control plane to re-mint service certs")


@auth_group.command("status")
@pass_factory
def auth_status(f: Factory):
    from cryptography import x509

    ca_path = f.config.pki_dir / "ca.crt"
    if not ca_path.exists():
        click.echo("CA: not initialized (minted on first use)")
        return
    cert = x509.load_pem_x509_certificate(ca_path.read_bytes())
    click.echo(f"CA: {cert.subject.rfc4514_string()}")
    click.echo(f"  serial: {cert.serial_number:x}")
    click.echo(f"  not after: {cert.not_valid_after_utc.isoformat()}")


# ------------------------------------------------------------------- version

@click.command("version")
def version_cmd():
    """Show the framework version."""
    from .. import __version__

    click.echo(f"{consts.PRODUCT} {__version__}")


# --------------------------------------------------------------------- alias

@click.group("alias")
def alias_group():
    """User command aliases (expanded before dispatch)."""


def _alias_path(f: Factory | None):
    from ..util import xdg

    return xdg.config_dir() / "aliases.yaml"


def load_aliases(f: Factory | None) -> dict[str, str]:
    p = _alias_path(f)
    if not p.exists():
        return {}
    try:
        raw = yaml.safe_load(p.read_text()) or {}
    except (yaml.YAMLError, OSError):
        return {}
    if not isinstance(raw, dict):
        return {}
    # hand-edited files must never crash command dispatch
    return {str(k): v for k, v in raw.items() if isinstance(v, str)}


@alias_group.command("set")
@click.argument("name")
@click.argument("expansion")
@pass_factory
def alias_set(f: Factory, name, expansion):
    """e.g. `clawker alias set co "container"`."""
    aliases = load_aliases(f)
    aliases[name] = expansion
    _alias_path(f).parent.mkdir(parents=True, exist_ok=True)
    _alias_path(f).write_text(yaml.safe_dump(aliases, sort_keys=True))
    click.echo(f"{name} -> {expansion}")


@alias_group.command("ls")
@pass_factory
def alias_ls(f: Factory):
    for name, exp in sorted(load_aliases(f).items()):
        click.echo(f"{name}\t{exp}")


@alias_group.command("rm")
@click.argument("name")
@pass_factory
def alias_rm(f: Factory, name):
    aliases = load_aliases(f)
    if name not in aliases:
        raise click.ClickException(f"no alias {name!r}")
    del aliases[name]
    _alias_path(f).write_text(yaml.safe_dump(aliases, sort_keys=True))
    click.echo(f"removed alias {name}")


def register(cli: click.Group) -> None:
    cli.add_command(settings_group)
    cli.add_command(auth_group)
    cli.add_command(version_cmd)
    cli.add_command(alias_group)
