"""Host-proxy daemon lifecycle over the shared DaemonSpec state machine.

Parity reference: internal/hostproxy manager.go:156 daemon spawn.  The
spawn/liveness/terminate discipline lives in util/daemon.py, shared with
the control-plane manager so the two can never diverge.

The port's copy of ``clawker_tpu/hostproxy/manager.py``: the daemon it
forks is ``python -m clawker_tpu_torch.hostproxy``.
"""

from __future__ import annotations

from .. import logsetup
from ..config import Config
from ..errors import ClawkerError
from ..util.daemon import DaemonError, DaemonSpec

log = logsetup.get("hostproxy.manager")


class HostProxyError(ClawkerError):
    pass


def _spec(cfg: Config) -> DaemonSpec:
    return DaemonSpec(
        name="host proxy",
        module="clawker_tpu_torch.hostproxy",
        pidfile=cfg.state_dir / "hostproxy.pid",
        logfile=cfg.logs_dir / "hostproxy.log",
        health_url=f"http://127.0.0.1:{cfg.settings.host_proxy.port}/healthz",
        start_deadline_s=10.0,
    )


def health(cfg: Config, timeout: float = 1.5) -> dict | None:
    return _spec(cfg).health(timeout)


def running(cfg: Config) -> bool:
    return _spec(cfg).running()


def ensure_running(cfg: Config) -> None:
    try:
        # pre-start hot path: a proxy proven healthy in the last few
        # seconds is not re-probed for every agent create
        _spec(cfg).ensure_running(log=log, probe_ttl_s=3.0)
    except DaemonError as e:
        raise HostProxyError(str(e)) from None


def stop(cfg: Config) -> bool:
    return _spec(cfg).stop()
