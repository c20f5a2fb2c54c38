"""Cloud TPU-VM runtime driver: every pod worker is a daemon endpoint.

Provisions and attaches to Docker daemons on the worker VMs of a TPU pod
over SSH (BASELINE.json north_star).  Worker order follows pod order
(inventory index = TPU worker index), which the loop scheduler uses for
topology-aware placement.  Engines ride SSH-forwarded docker sockets
(fleet/transport.py), so the whole jailed-engine stack works unchanged
against remote daemons.

The port's copy of ``clawker_tpu/engine/drivers/tpu_vm.py``, whole: the
driver name, its settings (``runtime.tpu``) and its worker ids
(``tpu-<i>``) stay the reference's, whatever the hosts' accelerator.
"""

from __future__ import annotations

from ... import logsetup
from ...config.schema import TPUSettings
from ...errors import DriverError
from .base import RuntimeDriver, Worker

log = logsetup.get("drivers.tpu_vm")


class TPUVMDriver(RuntimeDriver):
    name = "tpu_vm"

    def __init__(self, tpu: TPUSettings, *, runner=None):
        self.tpu = tpu
        self.runner = runner          # fleet.transport.Runner seam (tests)
        self._workers: list[Worker] | None = None

    def hosts(self) -> list[str]:
        from ...fleet.inventory import discover_workers

        hosts = discover_workers(self.tpu)
        if not hosts:
            raise DriverError(
                f"tpu_vm: no workers found for pod {self.tpu.pod!r} "
                "(set runtime.tpu.workers or runtime.tpu.pod in settings.yaml)"
            )
        return hosts

    def connect(self) -> list[Worker]:
        from concurrent.futures import ThreadPoolExecutor

        from ...fleet import transport as fleet_transport

        hosts = self.hosts()

        def dial(args):
            i, host = args
            try:
                engine = fleet_transport.connect_worker_engine(
                    self.tpu, host, i, runner=self.runner)
            except Exception as e:      # noqa: BLE001 -- any dial failure
                # machine failure is the common case, not the exception:
                # a worker that won't dial joins the fleet engine-less
                # (its health breaker opens on the first probe, failover
                # routes around it) instead of killing the whole connect
                log.warning("worker %d (%s): dial failed: %s", i, host, e)
                return Worker(id=f"tpu-{i}", index=i, hostname=host,
                              meta={"dial_error": str(e)})
            return Worker(id=f"tpu-{i}", index=i, hostname=host,
                          engine=engine)

        # dial workers concurrently: 8 serial SSH handshakes would eat the
        # whole <10s cold-start budget on a v5e-8
        with ThreadPoolExecutor(max_workers=min(16, len(hosts))) as pool:
            self._workers = list(pool.map(dial, enumerate(hosts)))
        if all(w.engine is None for w in self._workers):
            raise DriverError(
                "tpu_vm: no worker could be dialed ("
                + "; ".join(f"{w.id}: {w.meta.get('dial_error', '?')}"
                            for w in self._workers) + ")")
        return self._workers

    def workers(self) -> list[Worker]:
        if self._workers is None:
            return self.connect()
        return self._workers

    def diagnose(self, worker: Worker) -> str:
        """Deadline-exceeded probes never reach probe()'s ssh follow-up
        (the attempt thread is still stuck in the engine call), so the
        monitor asks separately: is the HOST at least alive?"""
        transport = getattr(worker.engine, "transport", None)
        if transport is None:
            return ""
        try:
            rtt = transport.probe(timeout=2.0)
        except DriverError:
            return "host unreachable over ssh"
        return f"host ssh alive ({rtt * 1000:.0f}ms rtt); daemon hung?"

    def probe(self, worker: Worker) -> None:
        """Engine probe, with an SSH-level follow-up on failure: a dead
        forwarded daemon behind a live host and a dead VM are different
        operator problems (restart dockerd vs recreate the worker), so
        the failure detail says which one this is."""
        try:
            super().probe(worker)
        except DriverError as engine_err:
            transport = getattr(worker.engine, "transport", None)
            if transport is None:
                raise
            try:
                rtt = transport.probe()
            except DriverError:
                raise DriverError(
                    f"worker {worker.id}: host unreachable over ssh "
                    f"(engine: {engine_err})") from engine_err
            raise DriverError(
                f"worker {worker.id}: docker daemon unreachable but host "
                f"ssh alive ({rtt * 1000:.0f}ms rtt; engine: {engine_err})"
            ) from engine_err

    def close(self) -> None:
        for w in self._workers or []:
            if w.engine is not None:
                # drain pooled keep-alive sockets while the forward is
                # still up, then tear down the ssh -N forward itself
                w.engine.close()
            transport = getattr(w.engine, "transport", None)
            if transport is not None:
                transport.close()
        self._workers = None
