"""Per-worker warm pool: pre-created agent containers placements adopt.

Framework cold start is dominated by work that does NOT depend on which
agent asks for it: ``engine_create`` + ``workspace_seed`` +
``harness_seed`` + the expensive half of ``identity_bootstrap``
(BENCH_r05: 8.95ms p50, with identity 7.0ms and harness seeding 3.3ms).
The :class:`WarmPool` runs exactly those stages off the hot path: it
keeps each worker's pool at a configurable target depth of
created-not-yet-started containers under placeholder agent names, and a
placement that finds one ADOPTS it -- relabel/env-fixup + rename +
``engine_start`` -- instead of paying a full bootstrap
(docs/loop-warmpool.md; the adoption fixups live in
:meth:`~clawker_tpu_torch.runtime.orchestrate.AgentRuntime.adopt_pooled`).

Division of labor: the pool OWNS membership bookkeeping, depth
accounting, journaling, and telemetry; the scheduler owns every engine
interaction (fills and removals ride the owning worker's serial lane,
refill admission rides the shared token bucket under a dedicated
low-weight tenant so refills never starve live placements).

Durability: every membership transition is journaled write-ahead in the
run journal (``pool_add`` before the create is submitted, ``pool_ready``
once the engine returned a cid, ``pool_adopt`` before adoption fixups
start, ``pool_remove`` when a member is recycled/drained/swept), so
``clawker loop --resume`` restores still-usable members into the pool
and sweeps the rest -- a pre-created container can never leak as an
untracked ghost because the scheduler died mid-fill or mid-adoption.

Thread-safety: checkout runs on lane threads (inside ``_create``),
refill accounting on the run thread, fill completions on lane
done-callbacks -- one lock guards all membership state.

The port's copy of ``clawker_tpu/loop/warmpool.py``, whole: a fill
pays engine create, workspace seed and harness seed, and an adoption
the relabel, env fixup and rename.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .. import logsetup, telemetry
from ..engine.drivers import Worker
from .journal import (
    REC_POOL_ADD,
    REC_POOL_ADOPT,
    REC_POOL_READY,
    REC_POOL_REMOVE,
    receipt_synced,
)

log = logsetup.get("loop.warmpool")

POOL_TENANT = "~warmpool"       # admission fairness class refills bill
#                                 under -- low weight, so the WFQ hands
#                                 real placements the tokens first

_HITS = telemetry.counter(
    "warm_pool_hits_total",
    "Placements satisfied by adopting a warm-pool container",
    labels=("worker",))
_MISSES = telemetry.counter(
    "warm_pool_misses_total",
    "Placements that found the pool empty and paid a cold create",
    labels=("worker",))
_DEPTH = telemetry.gauge(
    "warm_pool_depth", "Adoptable warm-pool containers per worker",
    labels=("worker",))
_REFILLS = telemetry.counter(
    "warm_pool_refills_total", "Pool members created by refill fills",
    labels=("worker",))
_RECYCLED = telemetry.counter(
    "warm_pool_recycled_total",
    "Pool members removed (expired, failed adoption, drained, swept)",
    labels=("worker", "reason"))


@dataclass
class PoolEntry:
    """One adoptable pre-created container."""

    agent: str                  # placeholder agent name (names the container)
    worker: Worker
    cid: str
    created_at: float = 0.0


@dataclass
class _WorkerPool:
    worker: Worker
    ready: list[PoolEntry] = field(default_factory=list)
    inflight: int = 0           # refills admitted but not yet ready


class WarmPool:
    """Membership/bookkeeping half of the warm-pool subsystem.

    ``journal`` is the scheduler's ``_journal`` callable (or None);
    every mutation journals write-ahead through it.  The pool never
    touches an engine -- callers run the create/remove the pool's
    bookkeeping describes.
    """

    def __init__(self, run_id: str, *, depth: int, max_age_s: float = 600.0,
                 journal=None, clock=time.monotonic):
        self.run_id = run_id
        self.depth = max(0, int(depth))
        self.max_age_s = float(max_age_s)
        self.tenant = POOL_TENANT
        self._journal = journal or (lambda kind, **fields: None)
        self._clock = clock
        self._lock = threading.Lock()
        self._pools: dict[str, _WorkerPool] = {}
        self._targets: dict[str, int] = {}   # per-worker adaptive target
        #                             overrides (the elastic-capacity
        #                             controller's seam; docs/
        #                             elastic-capacity.md) -- absent
        #                             workers fall back to self.depth
        self._seq = 0
        self.draining = False
        self.hits = 0
        self.misses = 0
        self.refills = 0
        self.recycled = 0

    def _pool(self, worker: Worker) -> _WorkerPool:
        pool = self._pools.get(worker.id)
        if pool is None:
            pool = _WorkerPool(worker=worker)
            self._pools[worker.id] = pool
        return pool

    def _set_depth(self, pool: _WorkerPool) -> None:
        _DEPTH.labels(pool.worker.id).set(len(pool.ready))

    # ------------------------------------------------------------- checkout

    def checkout(self, worker_id: str, *, by: str, epoch: int
                 ) -> PoolEntry | None:
        """Pop the oldest adoptable member for ``worker_id`` (oldest
        first, so members cycle before ``max_age_s`` where demand
        allows).  Journals the adoption write-ahead -- the caller
        finalizes (relabel/env/rename) AFTER this returns, so a crash
        mid-adoption replays as a consumed member whose half-finalized
        container is swept, never double-adopted."""
        with self._lock:
            pool = self._pools.get(worker_id)
            if pool is None or not pool.ready:
                self.misses += 1
                _MISSES.labels(worker_id).inc()
                return None
            entry = pool.ready.pop(0)
            self.hits += 1
            _HITS.labels(worker_id).inc()
            self._set_depth(pool)
        rcpt = self._journal(REC_POOL_ADOPT, durable=True, agent=entry.agent,
                             worker=worker_id, cid=entry.cid, by=by,
                             epoch=epoch)
        if not receipt_synced(rcpt):
            # degrade loudly: the member is already popped and the
            # container exists -- a resume sweeps it by cid even
            # without the adopt record (scheduler handles the global
            # degraded-durability state)
            log.warning("pool adopt of %s not durable (storage fault)",
                        entry.agent)
        return entry

    def adoption_failed(self, entry: PoolEntry, reason: str) -> None:
        """The finalize fixups failed: the member is consumed (its
        container is the caller's to remove) and the placement falls
        back to a cold create."""
        self._journal(REC_POOL_REMOVE, agent=entry.agent,
                      worker=entry.worker.id, cid=entry.cid, reason=reason)
        with self._lock:
            self.recycled += 1
        _RECYCLED.labels(entry.worker.id, "adoption_failed").inc()

    # --------------------------------------------------------------- refill

    def target_of(self, worker_id: str) -> int:
        """The worker's live target depth: the adaptive per-worker
        override when the capacity controller set one, else the static
        ``depth`` the run was configured with."""
        with self._lock:
            return self._target_locked(worker_id)

    def _target_locked(self, worker_id: str) -> int:
        return self._targets.get(worker_id, self.depth)

    def set_target(self, worker_id: str, depth: int) -> None:
        """Adjust one worker's target depth (the elastic-capacity
        seam).  Raising takes effect at the next refill tick; lowering
        never removes ready members eagerly -- placements adopt the
        surplus down (oldest first), so shrink costs nothing."""
        with self._lock:
            self._targets[worker_id] = max(0, int(depth))

    def want(self, worker_id: str) -> int:
        """How many refills ``worker_id`` needs to reach target depth."""
        with self._lock:
            target = self._target_locked(worker_id)
            if self.draining or not target:
                return 0
            pool = self._pools.get(worker_id)
            if pool is None:
                return target
            return max(0, target - len(pool.ready) - pool.inflight)

    def begin_refill(self, worker: Worker) -> str | None:
        """Reserve one refill slot; returns the new member's placeholder
        agent name (journaled write-ahead, durable BEFORE the caller
        submits the create) or None when the pool needs nothing."""
        with self._lock:
            target = self._target_locked(worker.id)
            if self.draining or not target:
                return None
            pool = self._pool(worker)
            if len(pool.ready) + pool.inflight >= target:
                return None
            self._seq += 1
            agent = f"pool-{self.run_id[:6]}-p{self._seq}"
            pool.inflight += 1
        rcpt = self._journal(REC_POOL_ADD, durable=True, agent=agent,
                             worker=worker.id)
        if not receipt_synced(rcpt):
            # the add record is the write-ahead for the create: if it
            # is not durable a crash mid-fill leaks the container as an
            # untracked ghost.  Release the reservation and skip this
            # refill -- the pool retries next admission pass.
            with self._lock:
                pool = self._pool(worker)
                pool.inflight = max(0, pool.inflight - 1)
            log.warning("pool refill %s skipped: add record not durable "
                        "(storage fault)", agent)
            return None
        return agent

    def fill_done(self, worker: Worker, agent: str, cid: str | None,
                  error: str = "") -> bool:
        """Complete a refill.  With a ``cid`` the member becomes
        adoptable (journaled durable -- the cid is what a resume sweeps
        by); without one the reservation is released.  Returns False
        when the created container must be DISCARDED by the caller (the
        pool started draining while the fill was on the lane)."""
        with self._lock:
            pool = self._pool(worker)
            pool.inflight = max(0, pool.inflight - 1)
            if cid is None:
                self._journal(REC_POOL_REMOVE, agent=agent, worker=worker.id,
                              cid="", reason=error or "fill failed")
                return True
            if self.draining:
                keep = False
            else:
                keep = True
                pool.ready.append(PoolEntry(
                    agent=agent, worker=worker, cid=cid,
                    created_at=self._clock()))
                self.refills += 1
                self._set_depth(pool)
        if keep:
            _REFILLS.labels(worker.id).inc()
            rcpt = self._journal(REC_POOL_READY, durable=True, agent=agent,
                                 worker=worker.id, cid=cid)
            if not receipt_synced(rcpt):
                # degrade loudly: the member stays adoptable this
                # generation; without the ready record a resume sweeps
                # the container instead of restoring it
                log.warning("pool member %s ready record not durable "
                            "(storage fault)", agent)
        else:
            self._journal(REC_POOL_REMOVE, agent=agent, worker=worker.id,
                          cid=cid, reason="drained")
            _RECYCLED.labels(worker.id, "drained").inc()
        return keep

    def restore(self, worker: Worker, agent: str, cid: str) -> bool:
        """Re-adopt a journaled member found still ``created`` at
        resume reconcile.  Refuses (caller sweeps) past target depth."""
        with self._lock:
            target = self._target_locked(worker.id)
            if self.draining or not target:
                return False
            pool = self._pool(worker)
            if len(pool.ready) + pool.inflight >= target:
                return False
            # a fresh generation's seq restarts at 1: bump it past the
            # restored member so a refill can never reuse a LIVE
            # member's deterministic name (create with replace=True
            # would clobber the restored container)
            tail = agent.rsplit("-p", 1)
            if len(tail) == 2 and tail[1].isdigit():
                self._seq = max(self._seq, int(tail[1]))
            pool.ready.append(PoolEntry(
                agent=agent, worker=worker, cid=cid,
                created_at=self._clock()))
            self._set_depth(pool)
        rcpt = self._journal(REC_POOL_READY, durable=True, agent=agent,
                             worker=worker.id, cid=cid, resumed=True)
        if not receipt_synced(rcpt):
            log.warning("pool restore of %s not durable (storage fault)",
                        agent)
        return True

    # ------------------------------------------------------------ lifecycle

    def take_expired(self) -> list[PoolEntry]:
        """Pop members older than ``max_age_s`` (their pre-staged
        workspace/harness snapshot is stale); the caller removes the
        containers."""
        now = self._clock()
        out: list[PoolEntry] = []
        with self._lock:
            for pool in self._pools.values():
                fresh = []
                for e in pool.ready:
                    if now - e.created_at >= self.max_age_s:
                        out.append(e)
                    else:
                        fresh.append(e)
                if len(fresh) != len(pool.ready):
                    pool.ready = fresh
                    self._set_depth(pool)
        if out:
            with self._lock:
                self.recycled += len(out)
        for e in out:
            _RECYCLED.labels(e.worker.id, "expired").inc()
            self._journal(REC_POOL_REMOVE, agent=e.agent, worker=e.worker.id,
                          cid=e.cid, reason="expired")
        return out

    def begin_drain(self) -> None:
        """Stop refills; in-lane fills discard their containers."""
        with self._lock:
            self.draining = True

    def drain_worker(self, worker_id: str) -> list[PoolEntry]:
        """Pop every member on ``worker_id`` (runs on that worker's
        lane AFTER queued fills, so nothing can be added behind it);
        the caller removes the containers."""
        with self._lock:
            pool = self._pools.get(worker_id)
            if pool is None:
                return []
            out, pool.ready = pool.ready, []
            self.recycled += len(out)
            self._set_depth(pool)
        for e in out:
            _RECYCLED.labels(worker_id, "drained").inc()
            self._journal(REC_POOL_REMOVE, agent=e.agent, worker=worker_id,
                          cid=e.cid, reason="drained")
        return out

    def workers(self) -> list[Worker]:
        """Workers holding members or in-flight refills (drain targets)."""
        with self._lock:
            return [p.worker for p in self._pools.values()
                    if p.ready or p.inflight]

    # ----------------------------------------------------------------- view

    def depth_of(self, worker_id: str) -> int:
        with self._lock:
            pool = self._pools.get(worker_id)
            return len(pool.ready) if pool is not None else 0

    def stats(self) -> dict:
        with self._lock:
            workers = sorted(set(self._pools) | set(self._targets))
            return {
                "target_depth": self.depth,
                "adaptive": bool(self._targets),
                "hits": self.hits,
                "misses": self.misses,
                "refills": self.refills,
                "recycled": self.recycled,
                "workers": {
                    wid: {
                        "ready": len(self._pools[wid].ready)
                        if wid in self._pools else 0,
                        "inflight": self._pools[wid].inflight
                        if wid in self._pools else 0,
                        "target": self._target_locked(wid),
                    } for wid in workers
                },
            }
