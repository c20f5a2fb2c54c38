"""Fleet scalers: how a capacity decision becomes workers.

The port's copy of ``clawker_tpu/capacity/scaler.py``, whole.
:class:`TPUVMScaler` provisions through ``fleet/provision.py`` over
``SSHTransport``; by default (``with_cp=True``) it starts the port's
per-worker control plane too.

The controller decides *when* to grow or shrink the fleet; a
:class:`FleetScaler` owns *how*.  Three implementations:

- :class:`NullScaler` -- the default: decisions are journaled and
  emitted but touch nothing (observe-only autoscale, the safe default
  for settings ``capacity.autoscale.enable: false`` paths that still
  want the signals).
- :class:`FakeFleetScaler` -- grows/shrinks a
  :class:`~clawker_tpu_torch.engine.drivers.FakeDriver` pod in place (tests,
  chaos, the elastic bench).
- :class:`TPUVMScaler` -- provisions ``tpu_vm`` standby hosts
  through the concurrent provisioner.

Every scaler call happens AFTER the controller journaled the decision
durable (WAL-before-mutation: a crash between the record and the
provision replays as an intent the next generation re-audits, never as
an untracked worker).
"""

from __future__ import annotations

from .. import logsetup

log = logsetup.get("capacity.scaler")


def make_scaler(driver, cfg, *, max_workers: int) -> "FleetScaler":
    """The one scaler-selection rule both wiring layers (loopd and the
    in-process CLI path) share: an elastically growable fake pod gets
    the in-place scaler, ``tpu_vm`` gets the concurrent provisioner,
    anything else degrades to decisions-without-side-effects."""
    if hasattr(driver, "add_worker"):
        return FakeFleetScaler(driver, max_workers=max_workers)
    if getattr(driver, "name", "") == "tpu_vm":
        return TPUVMScaler(cfg)
    return NullScaler()


class FleetScaler:
    """Interface: provision ``n`` workers / drain one by id."""

    def provision(self, n: int) -> list[str]:
        """Bring up ``n`` workers; returns the new worker ids (possibly
        fewer than asked -- a scaler out of standby capacity returns
        what it could)."""
        raise NotImplementedError

    def drain(self, worker_id: str) -> bool:
        """Tear one worker down.  Only called once the controller's
        journal-replay gate proved zero live placements on it."""
        raise NotImplementedError


class NullScaler(FleetScaler):
    """Decisions without side effects; keeps an audit trail."""

    def __init__(self):
        self.provisioned: list[int] = []
        self.drained: list[str] = []

    def provision(self, n: int) -> list[str]:
        self.provisioned.append(int(n))
        return []

    def drain(self, worker_id: str) -> bool:
        self.drained.append(worker_id)
        return True


class FakeFleetScaler(FleetScaler):
    """Scale a FakeDriver pod in place (tests / chaos / bench)."""

    def __init__(self, driver, *, max_workers: int = 16):
        self.driver = driver
        self.max_workers = int(max_workers)
        self.provisioned: list[str] = []
        self.drained: list[str] = []

    def provision(self, n: int) -> list[str]:
        out: list[str] = []
        for _ in range(max(0, int(n))):
            if len(self.driver.workers()) >= self.max_workers:
                break
            worker = self.driver.add_worker()
            out.append(worker.id)
        self.provisioned.extend(out)
        return out

    def drain(self, worker_id: str) -> bool:
        ok = self.driver.remove_worker(worker_id)
        if ok:
            self.drained.append(worker_id)
        return ok


class TPUVMScaler(FleetScaler):
    """Provision/drain ``tpu_vm`` standby hosts via the concurrent
    provisioner.

    ``standby_hosts`` are hosts present in the pod but not yet serving
    (``runtime.tpu.workers`` beyond the active set): ``provision``
    installs the worker stack on the next ``n`` of them concurrently
    (fleet/provision.py -- one shared payload tar, streamed steps).
    ``drain`` has no remote teardown: the engine-side drain (pool
    members removed, lane retired) is the scheduler's, gated by the
    controller; the VM just stops receiving placements.
    """

    def __init__(self, cfg, *, with_firewall: bool = True,
                 with_cp: bool = True):
        self.cfg = cfg
        self.with_firewall = with_firewall
        self.with_cp = with_cp
        self._active: set[str] = set()
        self.provisioned: list[str] = []
        self.drained: list[str] = []

    def _standby(self) -> list[str]:
        from ..fleet.inventory import discover_workers

        hosts = discover_workers(self.cfg.settings.runtime.tpu)
        return [h for h in hosts if h not in self._active]

    def provision(self, n: int) -> list[str]:
        from pathlib import Path

        from ..fleet.provision import provision_fleet
        from ..fleet.transport import SSHTransport

        tpu = self.cfg.settings.runtime.tpu
        targets = self._standby()[:max(0, int(n))]
        if not targets:
            return []
        transports = [
            SSHTransport(tpu, h, i, mux_dir=self.cfg.ssh_mux_dir)
            for i, h in enumerate(targets)]
        repo_root = Path(__file__).resolve().parents[2]
        reports = provision_fleet(
            transports, repo_root, with_firewall=self.with_firewall,
            with_cp=self.with_cp,
            monitor=self.cfg.settings.monitoring.enable)
        out = [r.host for r in reports if r.ok]
        self._active.update(out)
        self.provisioned.extend(out)
        for r in reports:
            if not r.ok:
                log.warning("capacity provision of %s failed", r.host)
        return out

    def drain(self, worker_id: str) -> bool:
        self._active.discard(worker_id)
        self.drained.append(worker_id)
        return True
