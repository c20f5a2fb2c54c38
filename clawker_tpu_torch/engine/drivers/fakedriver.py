"""Fake driver: N in-process fake daemons (test seam for multi-worker paths).

The port's copy of ``clawker_tpu/engine/drivers/fakedriver.py``, whole.

Per-worker fault injection rides a :class:`_FaultGate` between each
worker's ``Engine`` and its ``FakeDockerAPI``: tests (and the failover
bench) kill, wedge, or flap one worker's daemon without touching the
fake's semantic state, then revive it -- the seam the health subsystem's
probes, breakers, and the scheduler's migration path are tested through.
"""

from __future__ import annotations

import threading
import time

from ...errors import DriverError
from ..api import Engine
from ..fake import FakeDockerAPI
from .base import RuntimeDriver, Worker

# a wedged call must eventually die even if the test forgets to revive
# the worker (daemon threads would otherwise pile up across a session)
WEDGE_ABANDON_S = 60.0

FAULT_KINDS = ("refuse", "wedge", "flap", "slow", "burst", "probe_drop")


class _FaultGate:
    """Injectable fault seam in front of one worker's FakeDockerAPI.

    - ``refuse``: every call raises DriverError immediately (dial
      refusal: daemon process gone, socket forward torn down).
    - ``wedge``: every call blocks until the fault clears (hung daemon:
      probes hit their deadline, lanes wedge).
    - ``flap``: every other call refuses (a worker bouncing between
      alive and dead -- the breaker must quarantine it, not bounce
      loops on and off it).
    - ``slow``: slow-loris -- every call pays ``delay_s`` before
      executing (a congested daemon: latency-weighted placement should
      shift load away without the breaker opening).
    - ``burst``: the next ``count`` calls fail like a daemon 5xx /
      mid-response ECONNRESET, then the gate self-heals (the transient
      burst the engine pool's stale-retry and the scheduler's strand
      ceiling must absorb without quarantining a healthy worker).
    - ``probe_drop``: ``ping`` fails while data-path calls succeed (a
      dropped SSH-mux probe channel: health must not condemn a worker
      whose engine still serves traffic without corroboration).

    Lifecycle/telemetry passthroughs (``close``/``close_events``/
    ``pool_stats``) are never gated: draining a dead worker's engine on
    shutdown must not raise.

    Fake-WAN RTT (``rtt_s``, docs/workerd.md#fake-wan): every call
    arriving through the REMOTE view (the ``Worker.engine`` the
    scheduler dials, i.e. the host side of the host<->worker link) pays
    an injected per-call round trip before executing -- the
    deterministic stand-in for an SSH-mux-forwarded daemon on a real
    pod.  The LOCAL view (:meth:`local_view`, what a worker-resident
    workerd dials) pays every injected FAULT (a dead daemon is dead
    from any side) but never the WAN rtt.
    """

    _UNGATED = {"close", "close_events", "pool_stats"}
    # calls that begin launch work against the daemon: what the
    # admission token bucket meters (docs/loop-placement.md); the gate
    # tracks their concurrency high-water mark so tests can assert a
    # worker's daemon never saw more than its cap at once
    _LAUNCH_CALLS = {"container_create", "container_start"}

    def __init__(self, inner: FakeDockerAPI):
        self.inner = inner
        self._mode: str | None = None
        self._cleared = threading.Event()
        self._cleared.set()
        self._lock = threading.Lock()
        self._calls = 0
        self._inflight = 0
        self._launch_inflight = 0
        self._burst_left = 0        # remaining 'burst' failures
        self._delay_s = 0.0         # per-call delay under 'slow'
        self.rtt_s = 0.0            # injected host<->worker WAN round trip
        #                             per REMOTE call (local_view skips it)
        self.injected = 0           # gated calls that were made to fail
        self.call_hwm = 0           # concurrent daemon calls, any kind
        self.launch_hwm = 0         # concurrent create/start calls

    def set_fault(self, mode: str | None, *, count: int = 3,
                  delay_s: float = 0.1) -> None:
        if mode is not None and mode not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {mode!r} "
                             f"(expected {'|'.join(FAULT_KINDS)})")
        with self._lock:
            # mode and event flip together: publishing 'wedge' before
            # clearing the event would let a concurrent call slip
            # through the wedge ungated
            self._mode = mode
            self._burst_left = int(count) if mode == "burst" else 0
            self._delay_s = float(delay_s) if mode == "slow" else 0.0
            if mode == "wedge":
                self._cleared.clear()
            else:
                self._cleared.set()

    def set_rtt(self, rtt_s: float) -> None:
        """Inject a per-call WAN round trip on the remote view."""
        self.rtt_s = max(0.0, float(rtt_s))

    def local_view(self) -> "_LocalGateView":
        """The worker-resident side of this daemon: same faults, no
        injected WAN rtt (what a WorkerdServer should be built on)."""
        return _LocalGateView(self)

    def _gate(self, name: str, *, local: bool = False) -> None:
        if not local and self.rtt_s > 0:
            # the remote caller's request/response round trip; paid
            # BEFORE mode handling so even refused dials cost the wire
            time.sleep(self.rtt_s)
        with self._lock:
            mode = self._mode
            delay = self._delay_s
            self._calls += 1
            n = self._calls
            if mode == "burst":
                if self._burst_left <= 0:
                    self._mode, mode = None, None   # burst spent: heal
                else:
                    self._burst_left -= 1
            if mode in ("refuse", "burst") or (mode == "flap" and n % 2) \
                    or (mode == "probe_drop" and name == "ping"):
                self.injected += 1
        if mode == "refuse":
            raise DriverError("injected fault: connection refused")
        if mode == "burst":
            raise DriverError(
                "injected fault: daemon 5xx / connection reset by peer")
        if mode == "wedge":
            if not self._cleared.wait(WEDGE_ABANDON_S):
                raise DriverError("injected fault: wedged (never revived)")
        if mode == "flap" and n % 2:
            raise DriverError("injected fault: flapping connection refused")
        if mode == "slow" and delay > 0:
            # interruptible: a revive (set_fault(None)) sets _cleared,
            # but slow keeps it set -- plain sleep, delays are small
            time.sleep(delay)
        if mode == "probe_drop" and name == "ping":
            raise DriverError("injected fault: probe channel dropped")

    def _wrap(self, name: str, *, local: bool):
        attr = getattr(self.inner, name)
        if not callable(attr) or name in self._UNGATED:
            return attr
        is_launch = name in self._LAUNCH_CALLS

        def call(*args, **kwargs):
            self._gate(name, local=local)
            with self._lock:
                self._inflight += 1
                self.call_hwm = max(self.call_hwm, self._inflight)
                if is_launch:
                    self._launch_inflight += 1
                    self.launch_hwm = max(self.launch_hwm,
                                          self._launch_inflight)
            try:
                return attr(*args, **kwargs)
            finally:
                with self._lock:
                    self._inflight -= 1
                    if is_launch:
                        self._launch_inflight -= 1

        return call

    def __getattr__(self, name: str):
        return self._wrap(name, local=False)


class _LocalGateView:
    """Worker-resident view of a gated fake daemon: shares the gate's
    faults, counters, and high-water marks (the daemon is ONE daemon),
    but never pays the injected WAN ``rtt_s`` -- calls from this side
    never cross the fake WAN.  Built by ``FakeDriver.local_engine``."""

    def __init__(self, gate: _FaultGate):
        self._gate_obj = gate

    def __getattr__(self, name: str):
        return self._gate_obj._wrap(name, local=True)


class FakeDriver(RuntimeDriver):
    name = "fake"
    real_cgroups = False

    def __init__(self, n_workers: int = 1, *, prefix: str = "fake"):
        # `prefix` namespaces worker ids/hostnames so several fake pods
        # (one FakeDriver each) coexist in one journal without id
        # collisions -- the federation migration path resumes a dead
        # pod's run on a survivor and its stand-in workers must never
        # alias the survivor's live ones (docs/federation.md)
        self.prefix = prefix
        self.apis = [FakeDockerAPI() for _ in range(n_workers)]
        self.gates = [_FaultGate(api) for api in self.apis]
        self._workers = [
            Worker(
                id=f"{prefix}-{i}",
                index=i,
                hostname=f"{prefix}-worker-{i}",
                engine=Engine(gate),
            )
            for i, gate in enumerate(self.gates)
        ]
        self._drained: set[str] = set()     # scaled-down worker ids

    def connect(self) -> list[Worker]:
        return self.workers()

    def workers(self) -> list[Worker]:
        if not self._drained:
            return self._workers
        return [w for w in self._workers if w.id not in self._drained]

    @property
    def api(self) -> FakeDockerAPI:
        """Default worker's fake API (single-worker tests)."""
        return self.apis[0]

    def inject_fault(self, index: int, kind: str = "refuse", **kw) -> None:
        """Fault worker ``index``'s daemon (see _FaultGate): refuse |
        wedge | flap | slow(delay_s=) | burst(count=) | probe_drop."""
        self.gates[index].set_fault(kind, **kw)

    def set_rtt(self, index: int, rtt_s: float) -> None:
        """Inject a deterministic host<->worker WAN round trip paid by
        every REMOTE engine call against worker ``index`` (the fake-WAN
        harness; docs/workerd.md#fake-wan).  ``local_engine`` calls --
        a worker-resident workerd's -- never pay it."""
        self.gates[index].set_rtt(rtt_s)

    def set_rtt_all(self, rtt_s: float) -> None:
        for gate in self.gates:
            gate.set_rtt(rtt_s)

    def local_engine(self, index: int) -> Engine:
        """An Engine over the worker-resident view of worker ``index``'s
        daemon: pays injected faults, never the injected WAN rtt.  What
        an in-process WorkerdServer for that worker should be built on."""
        return Engine(self.gates[index].local_view())

    def clear_fault(self, index: int) -> None:
        """Revive worker ``index`` (blocked 'wedge' calls proceed)."""
        self.gates[index].set_fault(None)

    # ----------------------------------------------------------- elasticity
    # The fake pod can grow and shrink in place: what the capacity
    # controller's FakeFleetScaler scales (docs/elastic-capacity.md).
    # Consumers that re-read workers() each tick (placement context,
    # pool tick) pick the change up naturally; ids are never reused and
    # apis/gates stay index-aligned with all_workers(), so audits over
    # a drained worker's call history keep working.

    def add_worker(self) -> Worker:
        """Provision one more fake worker; returns it."""
        index = len(self.apis)
        api = FakeDockerAPI()
        gate = _FaultGate(api)
        self.apis.append(api)
        self.gates.append(gate)
        worker = Worker(id=f"{self.prefix}-{index}", index=index,
                        hostname=f"{self.prefix}-worker-{index}",
                        engine=Engine(gate))
        self._workers.append(worker)
        self._drained.discard(worker.id)
        return worker

    def remove_worker(self, worker_id: str) -> bool:
        """Drain one worker out of the serving set, modeling VM
        deletion: it leaves ``workers()`` (no more placements, probes,
        or sweeps) and its containers vanish with the VM -- but its
        api/gate call recorders survive, index-aligned under
        ``all_workers()``, so post-scenario audits still see every call
        the daemon ever executed."""
        for w in self._workers:
            if w.id == worker_id and w.id not in self._drained:
                self._drained.add(w.id)
                i = next(j for j, x in enumerate(self._workers)
                         if x.id == worker_id)
                self.apis[i].containers.clear()
                return True
        return False

    def all_workers(self) -> list[Worker]:
        """Every worker ever provisioned (drained included), aligned
        index-for-index with ``apis``/``gates`` -- the audit view."""
        return list(self._workers)

    def close(self) -> None:
        for w in self._workers:
            if w.engine is not None:
                w.engine.close()
