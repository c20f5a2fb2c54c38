"""Fleet scalers: how a capacity decision becomes workers.

The port's copy of ``clawker_tpu/capacity/scaler.py`` but for
``TPUVMScaler`` (the reference's ``scaler.py:99``): it provisions
through ``fleet/provision.py`` over ``SSHTransport``, which wait for
the ``gpu_host`` driver (ROADMAP §1 item 12b).  :func:`make_scaler`
refuses a ``tpu_vm`` driver by name.

The controller decides *when* to grow or shrink the fleet; a
:class:`FleetScaler` owns *how*.  Three implementations:

- :class:`NullScaler` -- the default: decisions are journaled and
  emitted but touch nothing (observe-only autoscale, the safe default
  for settings ``capacity.autoscale.enable: false`` paths that still
  want the signals).
- :class:`FakeFleetScaler` -- grows/shrinks a
  :class:`~clawker_tpu_torch.engine.drivers.FakeDriver` pod in place (tests,
  chaos, the elastic bench).
- ``TPUVMScaler`` -- the reference's standby-host provisioner; not
  ported (above).

Every scaler call happens AFTER the controller journaled the decision
durable (WAL-before-mutation: a crash between the record and the
provision replays as an intent the next generation re-audits, never as
an untracked worker).
"""

from __future__ import annotations

from .. import logsetup
from ..errors import ConfigError

log = logsetup.get("capacity.scaler")


def make_scaler(driver, cfg, *, max_workers: int) -> "FleetScaler":
    """The one scaler-selection rule both wiring layers (loopd and the
    in-process CLI path) share: an elastically growable fake pod gets
    the in-place scaler, ``tpu_vm`` is refused by name (its provisioner
    waits for the ``gpu_host`` driver), anything else degrades to
    decisions-without-side-effects."""
    if hasattr(driver, "add_worker"):
        return FakeFleetScaler(driver, max_workers=max_workers)
    if getattr(driver, "name", "") == "tpu_vm":
        raise ConfigError(
            "capacity: the tpu_vm fleet scaler (TPUVMScaler) is not yet "
            "ported to clawker_tpu_torch (ROADMAP §1 item 12b, gpu_host)")
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
