"""firewall verbs: the 13 AdminService RPCs from the command line.

The port's copy of ``clawker_tpu/cli/cmd_firewall.py``, whole: every
verb goes through ``call_firewall`` (``firewall/lifecycle.py``), over
the control plane's AdminService or the in-process monitor-mode
handler, as the reference's does.

Parity reference: internal/cmd/firewall (13 verbs -> AdminService,
SURVEY.md 2.4).  Every verb talks to the control-plane handler over the
admin API when a CP is running; init/enable/status fall back to an
in-process handler for CP-less local use (same fallback the run path's
lifecycle hooks apply).
"""

from __future__ import annotations

import json

import click

from .factory import Factory

pass_factory = click.make_pass_decorator(Factory)


def _call(f: Factory, method: str, payload: dict) -> dict:
    from ..firewall.lifecycle import call_firewall

    return call_firewall(f.config, f.driver, method, payload)


def _echo(res: dict) -> None:
    click.echo(json.dumps(res, indent=2, default=str))


@click.group("firewall")
def fw_group():
    """Manage the egress firewall (eBPF + DNS gate + Envoy)."""


@fw_group.command("init")
@pass_factory
def fw_init(f: Factory):
    """Bring up the data plane and re-enroll running containers."""
    _echo(_call(f, "FirewallInit", {}))


@fw_group.command("enable")
@click.argument("container")
@pass_factory
def fw_enable(f: Factory, container):
    """Enroll CONTAINER's cgroup for enforcement."""
    _echo(_call(f, "FirewallEnable", {"container_id": container}))


@fw_group.command("disable")
@click.argument("container")
@pass_factory
def fw_disable(f: Factory, container):
    _echo(_call(f, "FirewallDisable", {"container_id": container}))


@fw_group.command("bypass")
@click.argument("container")
@click.option("--duration", "duration_s", type=float, default=300.0,
              help="Seconds until the dead-man timer re-engages enforcement.")
@pass_factory
def fw_bypass(f: Factory, container, duration_s):
    """Temporarily allow all egress for CONTAINER (dead-man timed)."""
    _echo(_call(f, "FirewallBypass",
                {"container_id": container, "duration_s": duration_s}))


@fw_group.command("add-rule")
@click.argument("dst")
@click.option("--proto", default="https",
              type=click.Choice(["https", "http", "tcp", "udp", "ssh", "git"]),
              help="tcp is the generic opaque lane (explicit port required).")
@click.option("--port", type=int, default=0, help="0 = protocol default.")
@click.option("--path", "paths", multiple=True,
              help="HTTP path prefix (repeatable; forces MITM inspection).")
@click.option("--deny", is_flag=True,
              help="Domain-level deny (NXDOMAIN carve-out under a wildcard).")
@pass_factory
def fw_add_rule(f: Factory, dst, proto, port, paths, deny):
    """Allow egress to DST (domain or *.wildcard).

    Rules are validated at ingestion: a glob path or a bad action errors
    here, not at traffic time."""
    rule = {"dst": dst, "proto": proto, "port": port, "paths": list(paths),
            "action": "deny" if deny else "allow"}
    _echo(_call(f, "FirewallAddRules", {"rules": [rule]}))


@fw_group.command("remove-rule")
@click.argument("key")
@pass_factory
def fw_remove_rule(f: Factory, key):
    """Remove a dynamic rule by its dst:proto:port key."""
    _echo(_call(f, "FirewallRemoveRule", {"key": key}))


@fw_group.command("rules")
@pass_factory
def fw_rules(f: Factory):
    """List the effective rule set (base + dynamic)."""
    _echo(_call(f, "FirewallListRules", {}))


@fw_group.command("reload")
@pass_factory
def fw_reload(f: Factory):
    """Re-render Envoy/gate/kernel state from the effective rules."""
    _echo(_call(f, "FirewallReload", {}))


@fw_group.command("status")
@pass_factory
def fw_status(f: Factory):
    _echo(_call(f, "FirewallStatus", {}))


@fw_group.command("rotate-ca")
@click.confirmation_option(
    prompt="Rotating the CA invalidates every MITM cert and agent leaf; "
           "images must be rebuilt. Continue?")
@pass_factory
def fw_rotate_ca(f: Factory):
    _echo(_call(f, "FirewallRotateCA", {}))


@fw_group.command("sync-routes")
@pass_factory
def fw_sync_routes(f: Factory):
    """Force a kernel route-table resync."""
    _echo(_call(f, "FirewallSyncRoutes", {}))


@fw_group.command("resolve")
@click.argument("hostname")
@pass_factory
def fw_resolve(f: Factory, hostname):
    """Explain what the policy would do for HOSTNAME."""
    _echo(_call(f, "FirewallResolveHostname", {"hostname": hostname}))


@fw_group.command("remove")
@click.confirmation_option(prompt="Tear down the firewall (detach all, flush maps)?")
@pass_factory
def fw_remove(f: Factory):
    _echo(_call(f, "FirewallRemove", {}))


def register(cli: click.Group) -> None:
    cli.add_command(fw_group)
