"""Firewall bring-up hooks on the container run path + verb routing.

The port's copy of ``clawker_tpu/firewall/lifecycle.py``, whole.  The
monitor-mode handler lives as long as the process, as the reference's
does: a ``firewall`` verb leaves it up for the next verb of the same
process (its queue thread and gate are daemon threads, so a forked verb
still exits when it ends).

Pre-start: make the data plane exist (rules -> Envoy + DNS gate + kernel
routes) before the agent container can emit its first packet.
Post-start: enroll the started container's cgroup so enforcement begins
the moment the process tree exists.

``call_firewall`` is the single router every entry path uses (run-path
hooks here, ``clawker firewall`` verbs in the CLI):

- Real enforcement (pinned kernel programs present, or the CP explicitly
  enabled): the control-plane daemon must own the handler, because the
  DNS gate and bypass timers need a long-lived process -- the CP is
  auto-started and the verb rides its AdminService (the reference path:
  container_start.go:103/:297 -> AdminService).
- Monitor fallback (no kernel half, ``default_deny: false``): an
  in-process handler -- nothing is enforced, so process lifetime doesn't
  matter.
- Strict mode without the kernel half: FirewallUnavailable, loudly.
"""

from __future__ import annotations

import threading

from .. import logsetup
from ..config import Config
from ..engine.drivers import RuntimeDriver

log = logsetup.get("firewall.lifecycle")

_local_lock = threading.Lock()
_local_handlers: dict[str, object] = {}  # keyed by data dir (testenv isolation)


def _local(cfg: Config, driver: RuntimeDriver):
    """Per-process monitor-mode handler (shared by N runs in one CLI)."""
    from .runtime import build_handler

    key = str(cfg.data_dir)
    with _local_lock:
        if key not in _local_handlers:
            _local_handlers[key] = build_handler(
                cfg, driver.engine(),
                monitor_fallback=not cfg.settings.firewall.default_deny,
                # drivers whose containers have no real cgroups on this
                # host cannot take the in-process kernel lane
                inprocess_ok=getattr(driver, "real_cgroups", True),
            )
        return _local_handlers[key]


def call_firewall(cfg: Config, driver: RuntimeDriver, method: str, payload: dict) -> dict:
    from ..controlplane import manager
    from .runtime import kernel_available

    if kernel_available() or cfg.settings.control_plane.enable:
        if manager.health(cfg) is None:
            manager.ensure_running(cfg)
        return manager.admin_client(cfg, ensure_material=True).call(method, payload)
    handler = _local(cfg, driver)
    verb = {
        "FirewallInit": handler.init, "FirewallEnable": handler.enable,
        "FirewallDisable": handler.disable, "FirewallBypass": handler.bypass,
        "FirewallAddRules": handler.add_rules,
        "FirewallRemoveRule": handler.remove_rule,
        "FirewallListRules": handler.list_rules,
        "FirewallReload": handler.reload, "FirewallStatus": handler.status,
        "FirewallRotateCA": handler.rotate_ca,
        "FirewallSyncRoutes": handler.sync_routes,
        "FirewallResolveHostname": handler.resolve_hostname,
        "FirewallRemove": handler.remove,
    }[method]
    return verb(payload)


def firewall_pre_start(cfg: Config, driver: RuntimeDriver, container_ref: str) -> None:
    res = call_firewall(cfg, driver, "FirewallInit", {})
    log.info("firewall init: %s", res)


def firewall_post_start(cfg: Config, driver: RuntimeDriver, container_ref: str) -> None:
    res = call_firewall(cfg, driver, "FirewallEnable", {"container_id": container_ref})
    log.info("firewall enable %s: %s", container_ref, res)
