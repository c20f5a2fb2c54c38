"""Host-side control-plane lifecycle: ensure-running / stop / status.

Parity reference: controlplane/manager (bootstrap.go EnsureRunning / Stop /
CPRunning).  The reference runs clawkercp as PID1 of a privileged container
with a content-derived image tag; this build runs the CP as a supervised
host daemon (``python -m clawker_tpu_torch.controlplane``) -- on a TPU-VM worker
the same entrypoint runs per-worker under the tpu_vm driver's SSH
provisioner, which is the graft shape BASELINE.json asks for (CP per
worker, streams tunneled).  Liveness is grounded in the healthz aggregate
probe, not the pidfile: a stale pidfile never blocks bring-up and a wedged
CP (pid alive, healthz dead) is restarted.

The port's copy of ``clawker_tpu/controlplane/manager.py``, whole.
"""

from __future__ import annotations

from .. import logsetup
from ..config import Config
from ..errors import ClawkerError
from ..util.daemon import DaemonError, DaemonSpec

log = logsetup.get("cp.manager")

START_DEADLINE_S = 15.0
STOP_DEADLINE_S = 10.0


class ControlPlaneError(ClawkerError):
    pass


def _spec(cfg: Config) -> DaemonSpec:
    return DaemonSpec(
        name="control plane",
        module="clawker_tpu_torch.controlplane",
        pidfile=cfg.state_dir / "cp.pid",
        logfile=cfg.logs_dir / "cp.log",
        health_url=(
            f"http://127.0.0.1:{cfg.settings.control_plane.health_port}/healthz"
        ),
        start_deadline_s=START_DEADLINE_S,
    )


def health(cfg: Config, timeout: float = 2.0) -> dict | None:
    """The healthz aggregate, or None when no CP answers.  A 503 is a
    live-but-degraded CP (body still returned) -- see DaemonSpec.health."""
    return _spec(cfg).health(timeout)


def running(cfg: Config) -> bool:
    return _spec(cfg).running()


def ensure_running(cfg: Config, *, wait_s: float = START_DEADLINE_S) -> None:
    """Idempotent bring-up: healthy CP -> no-op; wedged CP -> replace."""
    spec = _spec(cfg)
    spec.start_deadline_s = wait_s
    try:
        spec.ensure_running(log=log)
    except DaemonError as e:
        raise ControlPlaneError(str(e)) from None


def stop(cfg: Config) -> bool:
    """Stop the CP if running; returns whether anything was stopped."""
    return _spec(cfg).stop()


def admin_client(cfg: Config, *, ensure_material: bool = False):
    """The one place the CLI-side mTLS + bearer admin client is assembled
    (cmd_controlplane, cmd_firewall and the run-path firewall hooks all
    route through here so connection/token logic can't drift)."""
    from ..firewall import pki
    from .adminapi import AdminClient, mint_admin_token

    cert = cfg.pki_dir / "cp.crt"
    key = cfg.pki_dir / "cp.key"
    ca_path = cfg.pki_dir / "ca.crt"
    if not (cert.exists() and key.exists() and ca_path.exists()):
        if not ensure_material:
            # read paths must not mint fresh PKI a running CP would reject
            raise ControlPlaneError(
                "control-plane PKI not initialized (run `clawker controlplane up` first)"
            )
        from .daemon import ensure_cp_material

        cert, key, ca_path = ensure_cp_material(cfg.pki_dir)
    ca = pki.ensure_ca(cfg.pki_dir)  # loads the existing CA, never re-mints
    return AdminClient(
        "127.0.0.1",
        cfg.settings.control_plane.admin_port,
        cert_file=cert,
        key_file=key,
        ca_file=ca_path,
        token=mint_admin_token(ca),
    )
