"""``python -m clawker_tpu_torch.controlplane`` -- the CP daemon entrypoint.

Parity reference: cmd/clawkercp (thin main over internal/controlplane
cmd.go:193 Main).  Config comes from the same layered settings the CLI
reads; the runtime driver (and thus which daemon the CP watches) follows
settings.runtime.driver / CLAWKER_TPU_DRIVER exactly like the CLI.

The port's copy of ``clawker_tpu/controlplane/__main__.py``, whole.
"""

from __future__ import annotations

import os
import sys

from .. import consts, logsetup
from ..config import load_config
from ..engine.drivers import get_driver
from .daemon import ControlPlaneDaemon, CPConfig


def main() -> int:
    logsetup.setup(os.environ.get("CLAWKER_TPU_CP_LOG", "info"))
    cfg = load_config()
    # per-subsystem OTLP lanes (controlplane/otel): the CP's own logs
    # ship on the clawkercp lane, the netlogger rides the ebpf-egress
    # lane (SAME lane set, so an mTLS collector's infra certs cover
    # both); https collectors get per-subsystem client certs.
    # Best-effort: no collector, no lanes, no failed connects.
    lanes = {}
    try:
        from .otel import build_lanes

        lanes = build_lanes(cfg)
        if "clawkercp" in lanes:
            import logging

            logging.getLogger().addHandler(lanes["clawkercp"].handler())
    except Exception as e:  # noqa: BLE001 - telemetry never blocks boot
        logsetup.get("cp").warning("otel lanes unavailable: %s", e)
    driver = get_driver(cfg.settings, override=os.environ.get("CLAWKER_TPU_DRIVER", ""))
    cp = cfg.settings.control_plane
    firewall = None
    netlogger = None
    if cfg.settings.firewall.enable:
        # resilience contract: a failed enforcement build degrades the CP
        # (verbs answer 501 -> agent starts fail loudly), never kills it
        from ..firewall.runtime import build_handler

        try:
            firewall = build_handler(
                cfg, driver.engine(),
                monitor_fallback=not cfg.settings.firewall.default_deny,
                inprocess_ok=getattr(driver, "real_cgroups", True),
            )
        except Exception as e:
            import logging

            logging.getLogger("cp").error("event=firewall_unavailable error=%s", e)
        if firewall is not None:
            from ..monitor.netlogger import NetLogger, handler_resolvers

            rc, rz = handler_resolvers(firewall)
            # the egress stream rides its OWN subsystem lane from the
            # shared lane set (carries the infra client cert when the
            # collector terminates mTLS) -- one endpoint policy, one PKI
            netlogger = NetLogger(
                firewall.maps,
                out_path=cfg.logs_dir / "ebpf-egress.jsonl",
                resolve_cgroup=rc,
                resolve_zone=rz,
                lane=lanes.get("ebpf-egress"),
            )
    daemon = ControlPlaneDaemon(
        CPConfig(
            pki_dir=cfg.pki_dir,
            registry_path=cfg.data_dir / "agents.db",
            admin_port=cp.admin_port,
            agent_port=cp.agent_port,
            health_port=cp.health_port,
            cp_host=os.environ.get("CLAWKER_TPU_CP_HOST", "")
            or cp.advertise_host
            or consts.DOCKER_BRIDGE_GATEWAY,
            drain_to_zero=cp.drain_to_zero,
        ),
        driver.engine(),
        firewall=firewall,
        netlogger=netlogger,
    )
    return daemon.run_forever()


if __name__ == "__main__":
    sys.exit(main())
