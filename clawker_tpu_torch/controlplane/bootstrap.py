"""Pre/post-start service bootstrap hooks.

Port of ``clawker_tpu/controlplane/bootstrap.py``.  None of the services
these hooks bring up is ported yet (ROADMAP §1: the host proxy and
socket bridge first).  So :func:`pre_start_services` raises a
:class:`ConfigError` naming each one that settings enable
(``control_plane``, ``firewall``, ``host_proxy``; the last is on by
default), and :func:`post_start_services` takes the reference's own
degraded path for the best-effort socket bridge: the same
``event=socketbridge_unavailable`` warning, with "not yet ported" as
the error.  That path changes no status, journal record or event.
"""

from __future__ import annotations

from .. import logsetup
from ..config import Config
from ..engine.drivers import RuntimeDriver
from ..errors import ConfigError

log = logsetup.get("cp.bootstrap")

# settings section -> what the reference brings up for it
_PRE_START = (
    ("control_plane", "the control plane"),
    ("firewall", "the firewall"),
    ("host_proxy", "the host proxy"),
)


def pre_start_services(cfg: Config, driver: RuntimeDriver, container_ref: str) -> None:
    for section, what in _PRE_START:
        if getattr(cfg.settings, section).enable:
            raise ConfigError(
                f"{what} is not yet ported to clawker_tpu_torch: set "
                f"{section}: {{enable: false}} in settings.yaml")


def post_start_services(cfg: Config, driver: RuntimeDriver, container_ref: str) -> None:
    if cfg.settings.firewall.enable:
        raise ConfigError(
            "the firewall is not yet ported to clawker_tpu_torch: set "
            "firewall: {enable: false} in settings.yaml")
    log.warning("event=socketbridge_unavailable container=%s error=%s",
                container_ref, "the socket bridge is not yet ported")
