"""Per-worker admission control: token buckets, bounded queues, fairness.

The port's copy of ``clawker_tpu/placement/admission.py``, whole.

The PR-1 scheduler submitted every launch straight onto its worker's
serial lane: a 64-loop burst parked 16 creates deep on each lane, so
polls and halts queued behind minutes of bootstrap work and one slow
daemon wedged a whole lane's control traffic.  The
:class:`AdmissionController` sits between placement and the lanes:

- **Token bucket per worker.**  At most ``max_inflight_per_worker``
  create/start launches may be outstanding against one worker at a
  time; the rest wait in the controller's pending queue, NOT on the
  lane, so the lane stays responsive for polls and halts and each
  daemon drains the burst at its sustainable rate.
- **Bounded pending queue.**  Beyond ``max_pending_per_worker`` a
  submission is REJECTED (``admission_rejections_total``); the caller
  re-places it elsewhere or retries -- unbounded queues just move the
  stampede one hop upstream.
- **Weighted fair queueing across tenants.**  Pending launches dequeue
  by virtual-finish-time WFQ over each tenant's weight, with optional
  per-tenant max-in-flight caps: two runs sharing a pod split each
  worker's tokens by weight instead of first-burst-wins.

One controller may serve several schedulers (that is how two tenant
runs share a pod in-process today, and the interface a worker-resident
agentd will implement for the cross-process case).  Thread-safe: lane
done-callbacks release tokens, run threads submit, and dispatch
callbacks always run OUTSIDE the controller lock.

Admission wait time lands in ``placement_admission_wait_seconds``
(queue wait before dispatch); the lane's own queueing stays visible as
``loop_lane_queue_seconds`` -- the two sum to the full pre-create wait.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from .. import logsetup, telemetry

log = logsetup.get("placement.admission")

DEFAULT_MAX_INFLIGHT = 4
DEFAULT_MAX_PENDING = 256
DEFAULT_RETRY_AFTER_S = 0.25    # backoff hint before any launch latency
#                                 was measured (one fallback tick)
LAUNCH_EWMA_ALPHA = 0.2         # dispatch->release latency smoothing

# submit() outcomes
ADMISSION_DISPATCHED = "dispatched"
ADMISSION_QUEUED = "queued"
ADMISSION_REJECTED = "rejected"


class AdmissionOutcome(str):
    """A submit() outcome that still compares equal to the bare outcome
    strings (``st == ADMISSION_REJECTED`` keeps working everywhere) but
    carries the backoff hint a rejection owes its caller: how long
    until the worker's queue is expected to have room, derived from the
    queue depth and the measured launch latency.  0.0 on non-rejected
    outcomes.  ``reason`` distinguishes a full queue from a capacity-
    controller shed (SLO unattainable)."""

    retry_after_s: float
    reason: str

    def __new__(cls, value: str, retry_after_s: float = 0.0,
                reason: str = ""):
        self = super().__new__(cls, value)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        return self

_QUEUE_DEPTH = telemetry.gauge(
    "placement_queue_depth", "Launches waiting in the admission queue",
    labels=("tenant",))
_REJECTIONS = telemetry.counter(
    "admission_rejections_total",
    "Launch submissions rejected by a full admission queue",
    labels=("worker",))
_ADMIT_WAIT = telemetry.histogram(
    "placement_admission_wait_seconds",
    "Time a launch waited in the admission queue before dispatch",
    labels=("worker",))
_INFLIGHT = telemetry.gauge(
    "placement_inflight_launches", "Admitted launches not yet completed",
    labels=("worker",))


@dataclass(eq=False)        # identity semantics: tickets are work items
class AdmissionTicket:
    """One pending launch.  ``run`` receives a ``release`` callable the
    launch must invoke exactly once on completion (success or failure);
    ``cancelled`` is polled at dispatch time so stale work (orphaned
    placements, stopped runs) melts out of the queue without consuming
    a token; ``on_cancel`` lets the submitter settle its bookkeeping
    (e.g. complete the in-flight future) when that happens."""

    worker_id: str
    tenant: str
    run: Callable[[Callable[[], None]], None]
    cancelled: Callable[[], bool] = lambda: False
    on_cancel: Callable[[], None] | None = None
    enqueued_at: float = 0.0
    vfinish: float = 0.0
    epoch: int = 0              # gate epoch at dispatch (token ownership)


class _TenantShare:
    def __init__(self, name: str, weight: float, max_inflight: int):
        self.name = name
        self.weight = max(0.01, float(weight))
        self.max_inflight = max(0, int(max_inflight))
        self.vfinish = 0.0          # virtual finish time of the last enqueue
        self.inflight = 0
        self.inflight_hwm = 0
        self.queued = 0
        self.dispatched = 0
        self.rejected = 0
        self.cancelled = 0


class _WorkerGate:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.inflight = 0
        self.inflight_hwm = 0
        self.inflight_by_tenant: dict[str, int] = {}  # who holds the tokens
        self.epoch = 0              # bumped by reset(): stale releases no-op
        self.pending: list[AdmissionTicket] = []
        self.dispatched = 0
        self.rejected = 0
        self.launch_ewma_s = 0.0    # dispatch->release wall EWMA: what the
        #                             capacity controller scales tokens from
        #                             and retry_after estimates divide by
        self.shed_retry_after_s = 0.0   # > 0: the capacity controller
        #                             flipped this worker's bounded queue
        #                             to reject-with-retry-after (the SLO
        #                             is unattainable at current depth)


class AdmissionController:
    """Token-bucket + WFQ admission for launch work across a pod."""

    def __init__(self, *, max_inflight_per_worker: int = DEFAULT_MAX_INFLIGHT,
                 max_pending_per_worker: int = DEFAULT_MAX_PENDING,
                 clock=time.monotonic):
        self.max_inflight = max(1, int(max_inflight_per_worker))
        self.max_pending = max(1, int(max_pending_per_worker))
        self._clock = clock
        self._lock = threading.Lock()
        self._workers: dict[str, _WorkerGate] = {}
        self._tenants: dict[str, _TenantShare] = {}
        self._vtime = 0.0           # WFQ virtual clock (advances on dispatch)

    # ------------------------------------------------------------- tenants

    def register_tenant(self, tenant: str, *, weight: float = 1.0,
                        max_inflight: int = 0) -> None:
        """Declare (or re-weight) a tenant.  Unregistered tenants that
        submit get weight 1.0 and no cap -- registration is for shares,
        not permission."""
        with self._lock:
            share = self._tenants.get(tenant)
            if share is None:
                self._tenants[tenant] = _TenantShare(
                    tenant, weight, max_inflight)
            else:
                share.weight = max(0.01, float(weight))
                share.max_inflight = max(0, int(max_inflight))

    def _tenant(self, tenant: str) -> _TenantShare:
        share = self._tenants.get(tenant)
        if share is None:
            share = _TenantShare(tenant, 1.0, 0)
            self._tenants[tenant] = share
        return share

    def _gate(self, worker_id: str) -> _WorkerGate:
        gate = self._workers.get(worker_id)
        if gate is None:
            gate = _WorkerGate(self.max_inflight)
            self._workers[worker_id] = gate
        return gate

    # -------------------------------------------------------------- submit

    def submit(self, worker_id: str, tenant: str,
               run: Callable[[Callable[[], None]], None], *,
               cancelled: Callable[[], bool] | None = None,
               on_cancel: Callable[[], None] | None = None) -> AdmissionOutcome:
        """Admit a launch against ``worker_id`` billed to ``tenant``.

        Returns ``dispatched`` (token acquired, ``run`` called before
        returning), ``queued`` (waiting for a token or its tenant's
        cap), or ``rejected`` (pending queue full, or the capacity
        controller shed the queue -- nothing retained; the caller owns
        the retry/re-place, and the outcome's ``retry_after_s`` says
        when the queue is expected to have room)."""
        ticket = AdmissionTicket(
            worker_id=worker_id, tenant=tenant, run=run,
            cancelled=cancelled or (lambda: False), on_cancel=on_cancel,
            enqueued_at=self._clock())
        dispatches: list[AdmissionTicket] = []
        with self._lock:
            gate = self._gate(worker_id)
            share = self._tenant(tenant)
            full = len(gate.pending) >= self.max_pending
            # shed mode (docs/elastic-capacity.md): the SLO is provably
            # unattainable at current queue depth, so a submission that
            # would QUEUE is rejected with the honest backoff instead
            # of joining a line it cannot clear in time.  A submission
            # a free token would dispatch immediately still goes in.
            shed = (gate.shed_retry_after_s > 0
                    and (gate.pending or gate.inflight >= gate.capacity))
            if full or shed:
                gate.rejected += 1
                share.rejected += 1
                _REJECTIONS.labels(worker_id).inc()
                retry = (gate.shed_retry_after_s if shed
                         else self._retry_after_locked(gate))
                return AdmissionOutcome(
                    ADMISSION_REJECTED, retry,
                    "queue shed (SLO unattainable)" if shed
                    else "admission queue full")
            # WFQ stamp: the ticket finishes 1/weight of virtual time
            # after the later of the global clock and the tenant's last
            # enqueue -- back-to-back bursts from one tenant stack up,
            # an idle tenant's first ticket starts "now"
            start = max(self._vtime, share.vfinish)
            ticket.vfinish = start + 1.0 / share.weight
            share.vfinish = ticket.vfinish
            gate.pending.append(ticket)
            share.queued += 1
            _QUEUE_DEPTH.labels(tenant).set(share.queued)
            self._pump_locked(dispatches)
            queued = not any(t is ticket for t in dispatches)
        self._run_dispatches(dispatches)
        return AdmissionOutcome(ADMISSION_QUEUED if queued
                                else ADMISSION_DISPATCHED)

    def _retry_after_locked(self, gate: _WorkerGate) -> float:
        """Backoff hint for a full-queue rejection: the time the current
        backlog needs to drain at the measured launch rate.  Before any
        launch completed there is no rate -- one fallback tick."""
        if gate.launch_ewma_s <= 0:
            return DEFAULT_RETRY_AFTER_S
        backlog = len(gate.pending) + gate.inflight
        return max(0.05, backlog * gate.launch_ewma_s
                   / max(1, gate.capacity))

    # ------------------------------------------------------------ dispatch

    def _pump_locked(self, dispatches: list[AdmissionTicket]) -> None:
        """Move tickets pending -> dispatched wherever a worker has free
        tokens and the WFQ picks an un-capped tenant.  Collects the
        tickets; the caller runs them outside the lock."""
        progress = True
        while progress:
            progress = False
            for gate in self._workers.values():
                # melt cancelled tickets BEFORE the capacity check: a
                # stopped run's queue must settle (on_cancel fires, the
                # pending slot frees) even on a worker whose tokens are
                # all held by wedged launches that will never release
                for t in list(gate.pending):
                    if t.cancelled():
                        gate.pending.remove(t)
                        share = self._tenant(t.tenant)
                        share.queued -= 1
                        share.cancelled += 1
                        _QUEUE_DEPTH.labels(t.tenant).set(share.queued)
                        if t.on_cancel is not None:
                            # bookkeeping only (futures settle); never
                            # user dispatch work -- safe under the lock
                            try:
                                t.on_cancel()
                            except Exception:
                                log.exception("admission on_cancel failed")
                if gate.inflight >= gate.capacity or not gate.pending:
                    continue
                best: AdmissionTicket | None = None
                for t in gate.pending:
                    share = self._tenant(t.tenant)
                    if (share.max_inflight
                            and share.inflight >= share.max_inflight):
                        continue
                    if best is None or t.vfinish < best.vfinish:
                        best = t
                if best is None:
                    continue
                gate.pending.remove(best)
                best.epoch = gate.epoch
                share = self._tenant(best.tenant)
                share.queued -= 1
                share.dispatched += 1
                share.inflight += 1
                share.inflight_hwm = max(share.inflight_hwm, share.inflight)
                gate.inflight += 1
                gate.inflight_hwm = max(gate.inflight_hwm, gate.inflight)
                gate.inflight_by_tenant[best.tenant] = (
                    gate.inflight_by_tenant.get(best.tenant, 0) + 1)
                gate.dispatched += 1
                self._vtime = max(self._vtime, best.vfinish)
                _QUEUE_DEPTH.labels(best.tenant).set(share.queued)
                _INFLIGHT.labels(best.worker_id).set(gate.inflight)
                _ADMIT_WAIT.labels(best.worker_id).observe(
                    max(0.0, self._clock() - best.enqueued_at))
                dispatches.append(best)
                progress = True

    def _run_dispatches(self, dispatches: list[AdmissionTicket]) -> None:
        for t in dispatches:
            release = self._make_release(t.worker_id, t.tenant, t.epoch)
            try:
                t.run(release)
            except Exception:
                # a dispatch that never started holds no launch: return
                # the token or the slot leaks forever
                log.exception("admission dispatch failed for %s", t.worker_id)
                release()

    def _make_release(self, worker_id: str, tenant: str, epoch: int):
        """One-shot, epoch-guarded token return.  A release from work
        admitted before a ``reset_worker`` (a launch wedged on a retired
        lane that finally unblocks) must not free a token in the NEW
        epoch's bucket.  ``epoch`` is the gate epoch stamped at dispatch
        accounting time (inside the pump's lock hold) -- re-reading it
        here would race a reset_worker landing between dispatch and this
        call and hand the stranded launch the NEW epoch."""
        done = threading.Event()
        t_dispatch = self._clock()

        def release() -> None:
            if done.is_set():
                return
            done.set()
            held_s = max(0.0, self._clock() - t_dispatch)
            dispatches: list[AdmissionTicket] = []
            with self._lock:
                gate = self._workers.get(worker_id)
                if gate is None or gate.epoch != epoch:
                    return
                # dispatch->release wall: the launch latency the SLO
                # scaling law and retry_after estimates divide by
                gate.launch_ewma_s = (
                    held_s if gate.launch_ewma_s <= 0 else
                    gate.launch_ewma_s + LAUNCH_EWMA_ALPHA
                    * (held_s - gate.launch_ewma_s))
                gate.inflight = max(0, gate.inflight - 1)
                held = gate.inflight_by_tenant.get(tenant, 0)
                if held > 1:
                    gate.inflight_by_tenant[tenant] = held - 1
                else:
                    gate.inflight_by_tenant.pop(tenant, None)
                share = self._tenant(tenant)
                share.inflight = max(0, share.inflight - 1)
                _INFLIGHT.labels(worker_id).set(gate.inflight)
                self._pump_locked(dispatches)
            self._run_dispatches(dispatches)

        return release

    # ----------------------------------------------------- capacity seams

    def set_worker_capacity(self, worker_id: str, capacity: int) -> None:
        """Scale one worker's token bucket (the elastic-capacity
        controller's SLO loop; docs/elastic-capacity.md).  Raising the
        cap pumps immediately so queued launches take the new tokens;
        lowering never revokes outstanding ones -- in-flight launches
        drain naturally and the bucket settles at the new cap."""
        dispatches: list[AdmissionTicket] = []
        with self._lock:
            gate = self._gate(worker_id)
            gate.capacity = max(1, int(capacity))
            self._pump_locked(dispatches)
        self._run_dispatches(dispatches)

    def set_shed(self, worker_id: str, retry_after_s: float) -> None:
        """Flip one worker's bounded queue into reject-with-retry-after
        (``retry_after_s > 0``) or back to normal queueing (``0``).
        While shedding, a submission that would QUEUE is rejected with
        the given backoff; one a free token can dispatch immediately is
        still admitted -- the SLO is unattainable for the QUEUE, not
        for work that starts now."""
        with self._lock:
            self._gate(worker_id).shed_retry_after_s = max(
                0.0, float(retry_after_s))

    def launch_latency_s(self, worker_id: str) -> float:
        """The measured dispatch->release launch latency EWMA."""
        with self._lock:
            gate = self._workers.get(worker_id)
            return gate.launch_ewma_s if gate is not None else 0.0

    # ----------------------------------------------------------- lifecycle

    def reset_worker(self, worker_id: str) -> None:
        """The worker's breaker opened: its lane is retired and admitted
        launches there will strand.  Zero the token bucket (epoch bump
        invalidates outstanding releases) and sweep now-stale pending
        tickets; non-stale ones stay queued for the worker's recovery."""
        dispatches: list[AdmissionTicket] = []
        with self._lock:
            gate = self._workers.get(worker_id)
            if gate is None:
                return
            gate.epoch += 1
            # the stranded launches' tenants get their in-flight slots
            # back now (their epoch-stale releases will no-op), or the
            # per-tenant cap would starve them on the healthy workers
            for t, held in gate.inflight_by_tenant.items():
                share = self._tenant(t)
                share.inflight = max(0, share.inflight - held)
            gate.inflight_by_tenant.clear()
            gate.inflight = 0
            _INFLIGHT.labels(worker_id).set(0)
            self._pump_locked(dispatches)   # sweeps cancelled tickets too
        self._run_dispatches(dispatches)

    def sweep(self) -> None:
        """Drop cancelled pending tickets and dispatch anything
        unblocked (run-loop tick hygiene: a stopped run's queue must
        melt even if no token ever releases again)."""
        dispatches: list[AdmissionTicket] = []
        with self._lock:
            self._pump_locked(dispatches)
        self._run_dispatches(dispatches)

    # ----------------------------------------------------------------- view

    def queue_depth(self, tenant: str | None = None) -> int:
        with self._lock:
            if tenant is not None:
                share = self._tenants.get(tenant)
                return share.queued if share is not None else 0
            return sum(len(g.pending) for g in self._workers.values())

    def stats(self) -> dict:
        """Snapshot for ``clawker fleet placement`` / tests."""
        with self._lock:
            return {
                "max_inflight_per_worker": self.max_inflight,
                "max_pending_per_worker": self.max_pending,
                "workers": {
                    wid: {
                        "inflight": g.inflight,
                        "inflight_hwm": g.inflight_hwm,
                        "capacity": g.capacity,
                        "pending": len(g.pending),
                        "dispatched": g.dispatched,
                        "rejected": g.rejected,
                        "launch_ewma_ms": round(g.launch_ewma_s * 1000, 2),
                        "shed_retry_after_s": round(
                            g.shed_retry_after_s, 3),
                    } for wid, g in sorted(self._workers.items())
                },
                "tenants": {
                    t: {
                        "weight": s.weight,
                        "max_inflight": s.max_inflight,
                        "inflight": s.inflight,
                        "inflight_hwm": s.inflight_hwm,
                        "queued": s.queued,
                        "dispatched": s.dispatched,
                        "rejected": s.rejected,
                        "cancelled": s.cancelled,
                    } for t, s in sorted(self._tenants.items())
                },
            }
