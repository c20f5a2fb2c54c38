"""Pre/post-start service bootstrap hooks.

Parity reference: internal/cmd/container/shared/container_start.go --
BootstrapServicesPreStart (:103 -- CP EnsureRunning, firewall init+rules,
host proxy) and BootstrapServicesPostStart (:297 -- firewall enable on the
container's cgroup, socket bridge).

Port of ``clawker_tpu/controlplane/bootstrap.py``.
:func:`pre_start_services` starts the port's host proxy
(``python -m clawker_tpu_torch.hostproxy``) when settings
``host_proxy.enable`` is set, as the reference does, and
:func:`post_start_services` runs the socket bridge, with the reference's
degraded path (the ``event=socketbridge_unavailable`` warning) for the
reference's reasons.  With settings ``firewall.enable`` they run the
firewall's hooks where the reference does (``firewall_pre_start`` brings
up the data plane, ``firewall_post_start`` enrolls the started
container) through ``call_firewall``, which takes the reference's lane
(the control plane's AdminService, or the monitor-mode handler in
process).  With settings ``control_plane.enable`` (off by default)
:func:`pre_start_services` first makes sure the port's control-plane
daemon is up (``python -m clawker_tpu_torch.controlplane``), as the
reference does.
"""

from __future__ import annotations

from .. import logsetup
from ..config import Config
from ..engine.drivers import RuntimeDriver

log = logsetup.get("cp.bootstrap")

def pre_start_services(cfg: Config, driver: RuntimeDriver, container_ref: str) -> None:
    if cfg.settings.control_plane.enable:
        from . import manager

        manager.ensure_running(cfg)
    if cfg.settings.firewall.enable:
        from ..firewall.lifecycle import firewall_pre_start

        firewall_pre_start(cfg, driver, container_ref)
    if cfg.settings.host_proxy.enable:
        from ..hostproxy.manager import ensure_running as hostproxy_ensure

        hostproxy_ensure(cfg)


def post_start_services(cfg: Config, driver: RuntimeDriver, container_ref: str) -> None:
    if cfg.settings.firewall.enable:
        from ..firewall.lifecycle import firewall_post_start

        firewall_post_start(cfg, driver, container_ref)
    _ensure_socket_bridge(cfg, driver, container_ref)


def _ensure_socket_bridge(cfg: Config, driver: RuntimeDriver, container_ref: str) -> None:
    """SSH/GPG agent forwarding (reference: container_start.go:349-371
    socketbridge EnsureBridge).  Best-effort: a missing host agent or a
    non-exec-capable engine degrades loudly, never fails the start.

    The manager lives ON the engine (not a module global) so it dies with
    the engine/factory; individual bridges self-close when their exec
    stream EOFs -- i.e. when the container stops."""
    try:
        from ..socketbridge.host import SocketBridgeManager

        engine = driver.engine()
        mgr = getattr(engine, "_socketbridge_manager", None)
        if mgr is None:
            mgr = SocketBridgeManager(engine)
            engine._socketbridge_manager = mgr
        mgr.ensure_bridge(container_ref)
    except Exception as e:
        log.warning("event=socketbridge_unavailable container=%s error=%s",
                    container_ref, e)
