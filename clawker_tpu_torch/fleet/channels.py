"""Per-worker side channels: host proxy + monitor streams over SSH -R.

The port's copy of ``clawker_tpu/fleet/channels.py``, local branch
only: a local or fake engine (no SSH transport) gets the host-gateway
URLs.  A remote engine raises: the SSH reverse forwards come with the
``gpu_host`` driver (ROADMAP §1).

The host proxy (browser-open / OAuth / git-credential --
hostproxy/server.py) and the monitor stack's OTLP collector run on the
LAPTOP.  Containers on a remote TPU-VM worker reach them through reverse
forwards bound to the worker's clawker-net gateway address, so the
in-container URLs look exactly like the local-Docker case -- the
firewall's FW_R_HOSTPROXY lane (fw_decide step 6) and the netlogger's
OTLP lane work unchanged on remote workers.

Parity reference: internal/hostproxy/server.go:38 serves only
127.0.0.1:18374 -- the reference never runs containers off-host; this
module is what makes BASELINE configs 2-4 (remote workers with the full
side channel) possible.  north_star: "tunnel monitor/TUI streams back".
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import consts, logsetup
from ..config import Config
from ..errors import ClawkerError

log = logsetup.get("fleet.channels")

OTLP_HTTP_PORT = consts.OTLP_HTTP_PORT


@dataclass
class SideChannels:
    """Worker-side URLs for the laptop services (empty = unavailable)."""

    hostproxy_url: str = ""
    otlp_endpoint: str = ""
    remote: bool = False


def open_side_channels(engine, cfg: Config) -> SideChannels:
    """Ensure the laptop services are reachable from containers on the
    worker behind ``engine``; idempotent per engine (cached).

    Local/fake engines (no SSH transport) get the host-gateway URLs the
    create path already uses; remote engines get reverse forwards bound
    to the worker's clawker-net gateway.
    """
    cached = getattr(engine, "_side_channels", None)
    if cached is not None:
        return cached

    transport = getattr(engine, "transport", None)
    ch = SideChannels()
    hp = cfg.settings.host_proxy
    mon = cfg.settings.monitoring

    if transport is None:
        if hp.enable:
            ch.hostproxy_url = f"http://host.docker.internal:{hp.port}"
        if mon.enable:
            ch.otlp_endpoint = f"http://host.docker.internal:{OTLP_HTTP_PORT}"
        engine._side_channels = ch
        return ch

    raise ClawkerError(
        "side channels to a remote worker (SSH reverse forwards) are not "
        "yet ported to clawker_tpu_torch")
