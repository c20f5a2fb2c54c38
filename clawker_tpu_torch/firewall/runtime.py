"""Firewall runtime assembly: one factory both the CP daemon and the
CLI-local path use to build a working handler.

The port's copy of ``clawker_tpu/firewall/runtime.py``, whole.

Map backend selection is explicit and loud: with loaded+pinned kernel
programs (``/sys/fs/bpf/clawker-tpu`` present) the handler drives
``PinnedMaps`` and real cgroup attach via fwctl; otherwise construction
fails with instructions, unless the caller opts into ``monitor_fallback``
(userspace-only maps: rules/routes/DNS-gate still function and log, but
no kernel enforcement -- used by tests and by `firewall status` on
machines without the kernel half installed).
"""

from __future__ import annotations

from pathlib import Path

from .. import consts, logsetup
from ..config import Config
from ..engine.api import Engine
from ..errors import ClawkerError
from .enroll import Attacher, CgroupResolver, FakeAttacher, FakeCgroupResolver
from .handler import FirewallHandler
from .maps import FakeMaps, FirewallMaps
from .rules import RulesStore
from .stack import FirewallStack

log = logsetup.get("firewall.runtime")


class FirewallUnavailable(ClawkerError):
    pass


def kernel_available(pin_dir: str = consts.BPF_PIN_DIR) -> bool:
    return (Path(pin_dir) / "containers").exists()


def inprocess_kernel_available() -> bool:
    """bpf(2) PROG_LOAD + writable cgroup-v2 from this process."""
    try:
        from .bpfkern import kernel_available as probe

        return probe()
    except Exception:  # noqa: BLE001 - any failure means the lane is out
        return False


def build_handler(
    cfg: Config,
    engine: Engine,
    *,
    maps: FirewallMaps | None = None,
    resolver: CgroupResolver | None = None,
    attacher: Attacher | None = None,
    monitor_fallback: bool = False,
    inprocess_ok: bool = True,
    dns_host: str = "",
    dns_port: int = consts.DNS_PORT,
) -> FirewallHandler:
    """``inprocess_ok`` gates the in-process verifier-loaded lane: it
    only makes sense when the engine runs REAL containers whose cgroups
    exist on this host (callers with a fake driver pass False)."""
    if maps is None:
        ka = None
        if not kernel_available() and inprocess_ok \
                and inprocess_kernel_available():
            # no pinned object, but bpf(2) + cgroup-v2 work: try to
            # assemble + verifier-load the programs in-process.  A probe
            # that passed does not guarantee the full set loads (older
            # kernels, verifier limits), so a failure here degrades to
            # the next lane instead of sinking every firewall verb.
            from .enroll import KernelAttacher

            try:
                ka = KernelAttacher()
            except Exception as e:  # noqa: BLE001 - lane probe
                log.warning("firewall: in-process kernel lane failed "
                            "(%s); falling back", e)
        if kernel_available():
            from .bpfsys import PinnedMaps

            maps = PinnedMaps()
            resolver = resolver or CgroupResolver()
            attacher = attacher or Attacher(pin_dir=consts.BPF_PIN_DIR)
            log.info("firewall: kernel enforcement (pinned maps)")
        elif ka is not None:
            maps = ka.maps
            resolver = resolver or CgroupResolver()
            attacher = attacher or ka
            log.info("firewall: kernel enforcement (in-process verifier-"
                     "loaded programs)")
        elif monitor_fallback:
            maps = FakeMaps()
            resolver = resolver or FakeCgroupResolver()
            attacher = attacher or FakeAttacher()
            # no kernel redirect exists to deliver :53 traffic to the
            # gateway address, so the monitor-mode gate binds loopback
            if not dns_host:
                dns_host, dns_port = "127.0.0.1", 0
            log.warning(
                "firewall: kernel programs not loaded -- userspace monitor "
                "mode only, NO enforcement"
            )
        else:
            raise FirewallUnavailable(
                f"firewall enabled but no pinned programs under "
                f"{consts.BPF_PIN_DIR}; build + load them with "
                f"`make -C native/ebpf && fwctl load` (the tpu_vm "
                f"provisioner does this per worker), or disable "
                f"firewall.enable in settings.yaml"
            )
    else:
        resolver = resolver or FakeCgroupResolver()
        attacher = attacher or FakeAttacher()

    stack = FirewallStack(
        engine,
        maps,
        conf_dir=cfg.data_dir / "firewall" / "envoy",
        pki_dir=cfg.pki_dir,
        dns_host=dns_host,
        dns_port=dns_port,
        upstreams=tuple(cfg.settings.firewall.dns_upstreams) or consts.UPSTREAM_DNS,
        gitguard_hosts=(tuple(cfg.settings.gitguard.hosts)
                        if cfg.settings.gitguard.enable else ()),
        gitguard_socket=cfg.settings.gitguard.socket,
    )
    return FirewallHandler(
        stack=stack,
        maps=maps,
        rules_store=RulesStore(cfg.egress_rules_path),
        base_rules=cfg.egress_rules(),
        pki_dir=cfg.pki_dir,
        resolver=resolver,
        attacher=attacher,
        hostproxy_port=cfg.settings.host_proxy.port,
        allow_hostproxy=cfg.settings.host_proxy.enable,
        state_path=cfg.data_dir / "firewall" / "enrollments.json",
    )
