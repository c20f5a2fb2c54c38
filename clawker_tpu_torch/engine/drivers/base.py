"""RuntimeDriver seam: pluggable container backends.

The port's copy of ``clawker_tpu/engine/drivers/base.py``.  Of the
reference's drivers ``local``, ``tpu_vm`` and ``fake`` are ported:
``get_driver`` raises a :class:`ConfigError` naming ``nsd`` as not yet
ported (ROADMAP §1 item 13).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from ...errors import ConfigError, DriverError
from ..api import Engine

if TYPE_CHECKING:
    from ...config.schema import Settings


@dataclass
class Worker:
    """One daemon endpoint (a host that can run agent containers).

    For the local driver there is exactly one.  For ``tpu_vm`` there is one
    per TPU-VM worker; ``index`` is the TPU worker index (used for
    topology-aware placement by the loop scheduler) and ``hostname`` the
    SSH target.
    """

    id: str
    index: int = 0
    hostname: str = "localhost"
    engine: Engine | None = None
    meta: dict = field(default_factory=dict)

    def require_engine(self) -> Engine:
        if self.engine is None:
            why = self.meta.get("dial_error", "")
            raise DriverError(f"worker {self.id}: engine not connected"
                              + (f" ({why})" if why else ""))
        return self.engine


class RuntimeDriver:
    """Abstract driver: a named set of workers with engines.

    Subclasses implement :meth:`connect` (build Worker list with live
    engines) plus any transport-specific provisioning.
    """

    name = "abstract"
    # do this driver's containers have real cgroup dirs on THIS host?
    # (gates kernel-enforcement lanes; the fake driver says no)
    real_cgroups = True

    def connect(self) -> list[Worker]:
        raise NotImplementedError

    def workers(self) -> list[Worker]:
        raise NotImplementedError

    def default_worker(self) -> Worker:
        ws = self.workers()
        if not ws:
            raise DriverError(f"driver {self.name}: no workers available")
        return ws[0]

    def engine(self) -> Engine:
        """Engine of the default worker (single-daemon callers)."""
        return self.default_worker().require_engine()

    def probe(self, worker: Worker) -> None:
        """One lightweight health round-trip against the worker's engine;
        raises on any failure.  ``ping`` proves the daemon answers at
        all, the label-jailed ``list_containers`` proves it can serve a
        real (filtered) query -- the pair is what the scheduler's control
        plane actually depends on.  Deadline enforcement is the caller's
        job: health.monitor runs probes under a hard per-attempt deadline
        so a wedged engine call reads as a failure, not a stall.
        """
        engine = worker.require_engine()
        if not engine.ping():
            raise DriverError(f"worker {worker.id}: engine ping failed")
        engine.list_containers(all=False)

    def diagnose(self, worker: Worker) -> str:
        """Best-effort one-liner on WHY a probe is failing, consulted by
        the health monitor when a probe overruns its deadline (the probe
        itself never got to say).  Must be cheap and bounded; empty
        string = nothing to add."""
        return ""

    def close(self) -> None:
        pass


def _seeded_fake_driver() -> "RuntimeDriver":
    """Fake driver seeded from the environment, so the real CLI can be driven
    end-to-end from a shell with no Docker daemon.

    ``CLAWKER_TPU_FAKE_IMAGES`` -- comma-separated image refs to pre-load.
    Seeded images run an exit(0) behavior that prints one line, so an
    attached ``run`` streams output and terminates instead of idling.
    """
    import os

    from .fakedriver import FakeDriver

    drv = FakeDriver()
    refs = [r.strip() for r in os.environ.get("CLAWKER_TPU_FAKE_IMAGES", "").split(",") if r.strip()]
    if refs:
        from ..fake import exit_behavior

        for api in drv.apis:
            for ref in refs:
                api.add_image(ref)
                api.set_behavior(ref, exit_behavior(b"fake agent ran\r\n", 0))
    return drv


# the reference's other drivers (clawker_tpu/engine/drivers/__init__.py)
UNPORTED_DRIVERS = ("nsd",)


def get_driver(settings: "Settings", *, override: str = "") -> RuntimeDriver:
    """Driver factory from settings.runtime.driver (or explicit override)."""
    from .local import LocalDriver

    name = override or settings.runtime.driver
    if name == "local":
        return LocalDriver(docker_host=settings.runtime.docker_host)
    if name == "fake":
        return _seeded_fake_driver()
    if name == "tpu_vm":
        from .tpu_vm import TPUVMDriver

        return TPUVMDriver(settings.runtime.tpu)
    if name in UNPORTED_DRIVERS:
        raise ConfigError(
            f"runtime driver {name!r} is not yet ported to clawker_tpu_torch "
            "(only 'local', 'tpu_vm' and 'fake' are)")
    raise ConfigError(
        f"unknown runtime driver {name!r} (expected local|tpu_vm|nsd|fake)")
