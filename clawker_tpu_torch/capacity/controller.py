"""The elastic-capacity controller: three coupled control loops.

The port's copy of ``clawker_tpu/capacity/controller.py``, whole.

One :class:`CapacityController` ticks periodically (inside loopd, or on
the scheduler's run thread for ``--no-daemon`` runs) and closes the
loop from observed telemetry to every capacity knob that used to be a
static setting:

1. **Adaptive warm-pool sizing.**  Per-worker target depth derived from
   the EWMA arrival rate (``warm_pool_{hits,misses}_total`` deltas) and
   miss pressure, clamped to ``[pool_min_depth, pool_max_depth]`` and
   fed to the scheduler's :class:`~clawker_tpu_torch.loop.WarmPool` through
   the ``set_pool_target`` hook -- refills still ride admission under
   the ``~warmpool`` tenant, exactly as before.
2. **SLO-aware admission.**  Each worker's token bucket scales from the
   measured launch latency against the tightest configured tenant SLO
   (:func:`tokens_for` -- the pure, monotone scaling law).  When the
   SLO is provably unattainable even at ``token_max`` -- the queue
   cannot drain inside the SLO -- the bounded queue flips to
   reject-with-``retry_after_s`` (the ``set_shed`` hook) instead of
   queueing work that is already late.
3. **Fleet autoscale.**  Sustained queue depth past
   ``autoscale.queue_high`` provisions workers through the
   :class:`~.scaler.FleetScaler`; sustained idle capacity under
   ``autoscale.idle_low`` drains the least-loaded worker -- gated on
   the wiring layer's journal-replay proof that ZERO live placements
   (loops or pool members) sit on the victim.  A journaled run is never
   stranded by scale-down; the chaos ``stranded-by-drain`` invariant
   audits exactly this.

Every decision is journaled as a ``REC_CAPACITY_*`` record through the
``journal`` hook (write-ahead for scaler mutations) and emitted as a
typed ``capacity.decision`` bus event, so ``--resume`` restores the
controller's targets and the fleet console can replay the decisions.

Layering: rank 2 -- the controller imports placement-layer peers only
and reaches the scheduler exclusively through :class:`CapacityHooks`.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from .. import logsetup, telemetry
from ..monitor.events import CapacityDecisionEvent
from .scaler import FleetScaler
from .signals import EwmaRate, RegistrySampler

log = logsetup.get("capacity.controller")

# journal record kinds (loop/journal.py replays them into RunImage.capacity)
REC_CAPACITY_POOL = "capacity_pool"      # adaptive pool target changed
REC_CAPACITY_TOKENS = "capacity_tokens"  # SLO-scaled token cap changed
REC_CAPACITY_QUEUE = "capacity_queue"    # queue mode flip (reject|queue)
REC_CAPACITY_SCALE = "capacity_scale"    # fleet provision/drain decision

_POOL_TARGET = telemetry.gauge(
    "capacity_pool_target",
    "Adaptive warm-pool target depth per worker", labels=("worker",))
_TOKEN_CAP = telemetry.gauge(
    "capacity_token_cap",
    "SLO-scaled admission token cap per worker", labels=("worker",))
_ARRIVAL_RATE = telemetry.gauge(
    "capacity_arrival_rate",
    "EWMA placement arrival rate per worker (1/s)", labels=("worker",))
_SLO_HEADROOM = telemetry.gauge(
    "capacity_slo_headroom_seconds",
    "Tenant latency SLO minus the worst predicted admission wait",
    labels=("tenant",))
_SHED_RETRY = telemetry.gauge(
    "capacity_shed_retry_after_seconds",
    "retry_after_s the shed queue mode currently hands rejected "
    "submissions (0 = queueing normally)", labels=("worker",))
_DECISIONS = telemetry.counter(
    "capacity_decisions_total",
    "Capacity-controller decisions applied", labels=("kind",))
_FLEET_WORKERS = telemetry.gauge(
    "capacity_fleet_workers", "Workers the capacity controller governs")

MIN_RETRY_AFTER_S = 0.05
SHED_OVERSHOOT = 1.5        # drain time must exceed SLO by this factor
#                             before the queue flips to reject -- and
#                             fall back UNDER the SLO to flip back
#                             (hysteresis: the boundary must not flap)
FALLBACK_LEAD_S = 0.05      # refill lead before any latency was measured
TOKEN_DECAY_PERIOD_S = 0.25  # one token of cap decays per period once
#                             the measured wait is comfortably inside
#                             the SLO: caps ratchet up fast under
#                             pressure (a burst cannot wait for an
#                             EWMA) and bleed off slowly, so the NEXT
#                             burst finds the bucket still sized


def tokens_for(queued: int, inflight: int, launch_s: float, slo_s: float,
               lo: int, hi: int) -> tuple[int, float]:
    """The SLO token-scaling law: ``(cap, predicted_drain_s)``.

    The backlog needs ``(queued + inflight) * launch_s`` seconds of
    launch work; meeting a latency SLO of ``slo_s`` needs at least
    ``work / slo_s`` tokens draining it in parallel.  The cap is that
    requirement clamped to ``[lo, hi]`` (``lo`` is the static bucket --
    SLO scaling grows buckets, it never starves a worker below its
    configured default).  Monotone by construction: non-decreasing in
    ``queued``/``inflight``/``launch_s``, non-increasing in ``slo_s``
    (tests/test_capacity.py sweeps the grid).
    """
    lo = max(1, int(lo))
    hi = max(lo, int(hi))
    work = max(0, int(queued) + int(inflight)) * max(0.0, launch_s)
    if slo_s <= 0 or launch_s <= 0:
        return lo, 0.0
    need = math.ceil(work / slo_s) if work > 0 else 0
    cap = min(hi, max(lo, need))
    return cap, work / cap


def _synced(rcpt) -> bool:
    """Durability verdict of a ``hooks.journal(...)`` result (duck-typed
    so this layer never imports loop.journal: a real AppendReceipt
    answers with its ``synced`` bit, ``None`` means no WAL is wired and
    there is no contract to break)."""
    return rcpt is None or bool(getattr(rcpt, "synced", True))


@dataclass
class CapacityHooks:
    """The scheduler/loopd seam: every surface the controller may act
    on, as callables over the wiring layer's own objects.  The
    controller holds no scheduler, engine, or CLI reference."""

    workers: Callable[[], list[str]]
    admission_stats: Callable[[], dict]
    set_token_cap: Callable[[str, int], None]
    set_shed: Callable[[str, float], None]          # retry_after_s; 0 clears
    pool_stats: Callable[[], dict] | None = None
    set_pool_target: Callable[[str, int], None] | None = None
    # journal-replay drain gate: live placements (loops + pool members)
    # on a worker according to the run journal(s) -- the wiring layer
    # implements it by replaying, so a drain can never outrun the WAL
    live_placements: Callable[[str], int] | None = None
    # returns the wiring layer's AppendReceipt (or None when no WAL is
    # wired) -- durable call sites consume it via _synced() below
    journal: Callable[..., object] = field(
        default=lambda kind, **fields: None)
    emit: Callable[[CapacityDecisionEvent], None] = field(
        default=lambda ev: None)


class CapacityController:
    """Periodic elastic-capacity tick over a :class:`CapacityHooks`."""

    def __init__(self, settings=None, *, hooks: CapacityHooks | None = None,
                 scaler: FleetScaler | None = None, clock=time.monotonic,
                 registry=None):
        if settings is None:
            from ..config.schema import CapacitySettings

            settings = CapacitySettings()
        self.settings = settings
        self.hooks = hooks
        self.scaler = scaler
        self._clock = clock
        self._sampler = RegistrySampler(registry)
        self._lock = threading.Lock()
        self._last_tick = 0.0
        self._rates: dict[str, EwmaRate] = {}
        self.pool_targets: dict[str, int] = {}
        self.token_caps: dict[str, int] = {}
        self.shedding: dict[str, float] = {}    # worker -> retry_after_s
        self.headroom: dict[str, float] = {}    # tenant -> slo headroom s
        self._queue_high_since: float | None = None
        self._idle_since: float | None = None
        self._last_decay: dict[str, float] = {}
        self._pending_drain: list[str] = []
        self._drain_blocked: dict[str, int] = {}
        self.drained: list[str] = []
        self.provisioned: list[str] = []
        self.ticks = 0

    def bind(self, hooks: CapacityHooks) -> None:
        self.hooks = hooks

    # ------------------------------------------------------------- decisions

    def _decide(self, kind: str, worker: str, value: str,
                reason: str = "") -> None:
        _DECISIONS.labels(kind).inc()
        try:
            self.hooks.emit(CapacityDecisionEvent(kind, worker, value, reason))
        except Exception:       # noqa: BLE001 -- telemetry never raises
            log.exception("capacity decision emit failed")

    # ------------------------------------------------------------------ tick

    def maybe_tick(self, now: float | None = None) -> bool:
        """Tick when ``interval_s`` has elapsed; False otherwise."""
        now = self._clock() if now is None else now
        if now - self._last_tick < self.settings.interval_s:
            return False
        self.tick(now)
        return True

    def tick(self, now: float | None = None) -> None:
        """One pass of all three control loops."""
        now = self._clock() if now is None else now
        with self._lock:
            dt = max(1e-6, now - self._last_tick) if self._last_tick else 0.0
            self._last_tick = now
            try:
                workers = list(self.hooks.workers())
                admission = self.hooks.admission_stats()
            except Exception:   # noqa: BLE001 -- a dying run's stats
                return          # must not crash the tick loop
            self.ticks += 1
            _FLEET_WORKERS.set(len(workers))
            arrivals = self._sample_arrivals()
            self._tick_pool(workers, arrivals, admission, dt)
            self._tick_slo(workers, admission, now)
            self._tick_autoscale(workers, admission, now)
            self._service_drains(workers)

    # ------------------------------------------------- loop 1: pool sizing

    def _sample_arrivals(self) -> dict[str, tuple[float, float]]:
        """{worker: (placements delta, misses delta)} this tick, from
        the registry's warm-pool counters."""
        hits = self._sampler.delta("warm_pool_hits_total", "worker")
        misses = self._sampler.delta("warm_pool_misses_total", "worker")
        out: dict[str, tuple[float, float]] = {}
        for wid in set(hits) | set(misses):
            h, m = hits.get(wid, 0.0), misses.get(wid, 0.0)
            out[wid] = (h + m, m)
        return out

    def _launch_s(self, admission: dict, wid: str) -> float:
        row = (admission.get("workers") or {}).get(wid) or {}
        return float(row.get("launch_ewma_ms", 0.0)) / 1000.0

    def _tick_pool(self, workers: list[str],
                   arrivals: dict[str, tuple[float, float]],
                   admission: dict, dt: float) -> None:
        s = self.settings
        if self.hooks.set_pool_target is None or s.pool_max_depth <= 0:
            return
        for wid in workers:
            count, miss = arrivals.get(wid, (0.0, 0.0))
            rate = self._rates.setdefault(
                wid, EwmaRate(s.alpha_up, s.alpha_down))
            if dt > 0:
                rate.observe(count, dt)
            _ARRIVAL_RATE.labels(wid).set(round(rate.value, 3))
            lead = s.refill_lead_s or max(
                self._launch_s(admission, wid), FALLBACK_LEAD_S)
            raw = math.ceil(rate.value * max(lead, s.interval_s))
            target = min(s.pool_max_depth, max(s.pool_min_depth, raw))
            if miss > 0:
                # misses are direct evidence of under-provisioning:
                # grow past the rate estimate immediately (the EWMA
                # catches up; the p99 cannot wait for it)
                target = min(s.pool_max_depth,
                             max(target,
                                 self.pool_targets.get(wid, 0) + int(miss)))
            if wid not in self.pool_targets and count == 0 and target == 0:
                # never seen traffic on this worker: leave whatever
                # static depth the run configured in place -- adaptive
                # sizing takes over at the first observed arrival
                continue
            if target == self.pool_targets.get(wid):
                continue
            self.pool_targets[wid] = target
            _POOL_TARGET.labels(wid).set(target)
            try:
                self.hooks.set_pool_target(wid, target)
            except Exception:   # noqa: BLE001 -- a draining pool is fine
                continue
            self.hooks.journal(REC_CAPACITY_POOL, worker=wid, target=target,
                               rate=round(rate.value, 3))
            self._decide("pool", wid, f"target={target}",
                         f"rate={rate.value:.2f}/s miss={int(miss)}")

    # --------------------------------------------- loop 2: SLO admission

    def _slo_for(self, tenant: str) -> float:
        s = self.settings.slo
        return float(s.tenants.get(tenant, s.default_s))

    def _effective_slo(self) -> float:
        """The tightest configured SLO (the bound every worker's bucket
        must be able to meet); 0 = SLO scaling disabled."""
        s = self.settings.slo
        values = [v for v in s.tenants.values() if v > 0]
        if s.default_s > 0:
            values.append(s.default_s)
        return min(values) if values else 0.0

    def _tick_slo(self, workers: list[str], admission: dict,
                  now: float) -> None:
        s = self.settings
        slo = self._effective_slo()
        if slo <= 0:
            return
        rows = admission.get("workers") or {}
        base = int(admission.get("max_inflight_per_worker", 1))
        lo = s.token_min or base
        worst_wait = 0.0
        # measured admission wait this tick, per worker (registry
        # histogram delta): the feedback half of the scaling -- the
        # launch-latency EWMA that feeds the model is diluted by fast
        # pool hits, but an SLO violation shows up in the WAIT
        # distribution no matter what mix produced it
        wait_deltas = self._sampler.hist_delta(
            "placement_admission_wait_seconds", "worker")
        for wid in workers:
            row = rows.get(wid) or {}
            queued = int(row.get("pending", 0))
            inflight = int(row.get("inflight", 0))
            launch_s = self._launch_s(admission, wid)
            if launch_s <= 0:
                continue        # no measured latency yet: nothing to scale
            cap_model, drain_s = tokens_for(queued, inflight, launch_s, slo,
                                            lo, s.token_max)
            worst_wait = max(worst_wait, drain_s)
            n_wait, sum_wait = wait_deltas.get(wid, (0.0, 0.0))
            mean_wait = sum_wait / n_wait if n_wait else 0.0
            cur = int(self.token_caps.get(wid)
                      or row.get("capacity") or lo)
            if mean_wait > slo:
                # measured violation: ratchet the cap multiplicatively
                # -- the feed-forward model under-reacts when pool hits
                # dilute the latency EWMA, the wait distribution never
                # lies
                cap = min(s.token_max, max(cap_model, max(cur, lo) * 2))
            elif mean_wait <= slo / 4 and queued == 0:
                # comfortably inside the SLO and nothing queued: bleed
                # one token per decay period back toward the model
                if cur > max(cap_model, lo) and now - self._last_decay.get(
                        wid, 0.0) >= TOKEN_DECAY_PERIOD_S:
                    cap = cur - 1
                    self._last_decay[wid] = now
                else:
                    cap = cur
            else:
                cap = max(cur, cap_model)
            if cap != self.token_caps.get(wid, row.get("capacity")):
                self.token_caps[wid] = cap
                _TOKEN_CAP.labels(wid).set(cap)
                self.hooks.set_token_cap(wid, cap)
                self.hooks.journal(REC_CAPACITY_TOKENS, worker=wid, cap=cap,
                                   launch_ms=round(launch_s * 1000, 2))
                self._decide("tokens", wid, f"cap={cap}",
                             f"queue={queued} wait={mean_wait * 1000:.0f}ms "
                             f"launch={launch_s * 1000:.1f}ms "
                             f"slo={slo:.2f}s")
            # SLO attainability at the MAX bucket: when even token_max
            # cannot drain the backlog inside the SLO, queueing more
            # work only makes every waiter later -- flip to reject with
            # an honest retry_after until the backlog clears
            _, drain_at_max = tokens_for(queued, inflight, launch_s, slo,
                                         lo, s.token_max)
            shedding = self.shedding.get(wid, 0.0)
            if drain_at_max > slo * SHED_OVERSHOOT:
                retry = max(MIN_RETRY_AFTER_S, drain_at_max - slo)
                if abs(retry - shedding) > MIN_RETRY_AFTER_S or not shedding:
                    self.shedding[wid] = retry
                    _SHED_RETRY.labels(wid).set(round(retry, 3))
                    self.hooks.set_shed(wid, retry)
                    self.hooks.journal(REC_CAPACITY_QUEUE, worker=wid,
                                       mode="reject",
                                       retry_after_s=round(retry, 3))
                    self._decide("queue", wid,
                                 f"reject retry_after_s={retry:.2f}",
                                 f"drain@max={drain_at_max:.2f}s "
                                 f"slo={slo:.2f}s")
            elif shedding and drain_at_max <= slo:
                self.shedding.pop(wid, None)
                _SHED_RETRY.labels(wid).set(0.0)
                self.hooks.set_shed(wid, 0.0)
                self.hooks.journal(REC_CAPACITY_QUEUE, worker=wid,
                                   mode="queue", retry_after_s=0.0)
                self._decide("queue", wid, "queue",
                             f"drain@max={drain_at_max:.2f}s back under "
                             f"slo={slo:.2f}s")
        # per-tenant headroom: the SLO minus the worst predicted wait
        # anywhere in the fleet -- what `fleet placement` renders
        tenants = dict(s.slo.tenants)
        if s.slo.default_s > 0:
            tenants.setdefault("default", s.slo.default_s)
        for tenant, tenant_slo in tenants.items():
            if tenant_slo <= 0:
                continue
            headroom = tenant_slo - worst_wait
            self.headroom[tenant] = round(headroom, 3)
            _SLO_HEADROOM.labels(tenant).set(round(headroom, 3))

    # ---------------------------------------------- loop 3: fleet autoscale

    def _tick_autoscale(self, workers: list[str], admission: dict,
                        now: float) -> None:
        a = self.settings.autoscale
        if not a.enable or self.scaler is None or not workers:
            return
        rows = admission.get("workers") or {}
        pending = sum(int((rows.get(w) or {}).get("pending", 0))
                      for w in workers)
        inflight = sum(int((rows.get(w) or {}).get("inflight", 0))
                       for w in workers)
        capacity = sum(int((rows.get(w) or {}).get(
            "capacity", admission.get("max_inflight_per_worker", 1)))
            for w in workers)
        # sustained queue depth: grow
        if pending / len(workers) > a.queue_high and \
                len(workers) < a.max_workers:
            if self._queue_high_since is None:
                self._queue_high_since = now
            elif now - self._queue_high_since >= a.sustain_s:
                self._queue_high_since = None
                self._scale_up(pending)
        else:
            self._queue_high_since = None
        # sustained idle capacity: drain the least-loaded worker
        busy = (pending + inflight) / max(1, capacity)
        if busy < a.idle_low and len(workers) > a.min_workers \
                and not self._pending_drain:
            if self._idle_since is None:
                self._idle_since = now
            elif now - self._idle_since >= a.sustain_s:
                self._idle_since = None
                victim = min(workers, key=lambda w: (
                    int((rows.get(w) or {}).get("inflight", 0))
                    + int((rows.get(w) or {}).get("pending", 0))))
                self.request_drain(victim)
        else:
            self._idle_since = None

    def _scale_up(self, pending: int) -> None:
        # WAL before the provisioner call: a crash in between replays
        # as a durable intent the next generation can audit
        rcpt = self.hooks.journal(REC_CAPACITY_SCALE, durable=True,
                                  action="provision", worker="",
                                  phase="intent", pending=pending)
        if not _synced(rcpt):
            # storage fault: without a durable intent a crash mid-
            # provision leaks an unauditable worker -- skip the scale;
            # the sustain window re-triggers once storage recovers
            log.warning("capacity provision skipped: intent not durable "
                        "(storage fault)")
            return
        try:
            new = self.scaler.provision(1)
        except Exception as e:  # noqa: BLE001 -- a failed provision is a
            log.warning("capacity provision failed: %s", e)  # retry next
            new = []            # sustain window, never a crashed tick
        self.hooks.journal(REC_CAPACITY_SCALE, action="provision",
                           worker=",".join(new), phase="done")
        self.provisioned.extend(new)
        self._decide("provision", ",".join(new) or "-",
                     f"workers+{len(new)}", f"queue depth {pending}")

    def request_drain(self, worker_id: str) -> None:
        """Queue a drain; it fires only once the journal-replay gate
        proves zero live placements on the victim (chaos scale_down and
        the idle loop both land here).  Callable from any thread: a
        duplicate append is tolerated (the drain servicer removes every
        copy), so no lock juggling with the tick is needed."""
        if worker_id not in self._pending_drain:
            self._pending_drain.append(worker_id)

    def _service_drains(self, workers: list[str]) -> None:
        if not self._pending_drain or self.scaler is None:
            return
        a = self.settings.autoscale
        for victim in list(dict.fromkeys(self._pending_drain)):
            if victim not in self._pending_drain:
                continue
            if victim not in workers:
                while victim in self._pending_drain:
                    self._pending_drain.remove(victim)
                continue
            if len(workers) <= max(1, a.min_workers):
                continue        # the fleet shrank under us: hold the drain
            # stop refilling the victim's pool first -- members melt as
            # placements adopt them, and want() goes to zero
            if self.hooks.set_pool_target is not None:
                try:
                    self.hooks.set_pool_target(victim, 0)
                except Exception:   # noqa: BLE001
                    pass
                if self.pool_targets.get(victim):
                    self.pool_targets[victim] = 0
                    _POOL_TARGET.labels(victim).set(0)
                    self.hooks.journal(REC_CAPACITY_POOL, worker=victim,
                                       target=0, rate=0.0)
            live = 0
            if self.hooks.live_placements is not None:
                try:
                    live = int(self.hooks.live_placements(victim))
                except Exception:   # noqa: BLE001 -- an unreadable journal
                    live = 1        # is NOT proof of zero placements
            if live > 0:
                n = self._drain_blocked.get(victim, 0)
                self._drain_blocked[victim] = n + 1
                if n == 0:      # journal the block once, not per tick
                    self.hooks.journal(REC_CAPACITY_SCALE, action="drain",
                                       worker=victim, phase="blocked",
                                       live=live)
                    self._decide("drain_blocked", victim,
                                 f"live={live}", "journal replay shows "
                                 "live placements; drain deferred")
                continue
            # WAL-before-mutation: the drain intent is durable before
            # the scaler acts, so a crash mid-drain replays as an
            # auditable intent against a victim PROVEN empty
            rcpt = self.hooks.journal(REC_CAPACITY_SCALE, durable=True,
                                      action="drain", worker=victim,
                                      phase="intent")
            if not _synced(rcpt):
                # storage fault: leave the victim queued in
                # _pending_drain so the drain retries next tick
                log.warning("capacity drain of %s deferred: intent not "
                            "durable (storage fault)", victim)
                continue
            try:
                ok = self.scaler.drain(victim)
            except Exception as e:      # noqa: BLE001
                log.warning("capacity drain of %s failed: %s", victim, e)
                ok = False
            self.hooks.journal(REC_CAPACITY_SCALE, action="drain",
                               worker=victim,
                               phase="done" if ok else "failed")
            while victim in self._pending_drain:
                self._pending_drain.remove(victim)
            self._drain_blocked.pop(victim, None)
            if ok:
                self.drained.append(victim)
            self._decide("drain", victim, "done" if ok else "failed")

    # ------------------------------------------------------- resume / view

    def restore(self, state: dict) -> None:
        """Re-apply journaled controller state at ``--resume`` (the
        ``RunImage.capacity`` fold): targets, caps, and queue modes are
        pushed back through the hooks WITHOUT re-journaling -- the
        records that set them are already in the journal."""
        for wid, target in (state.get("pool_targets") or {}).items():
            self.pool_targets[wid] = int(target)
            _POOL_TARGET.labels(wid).set(int(target))
            if self.hooks.set_pool_target is not None:
                self.hooks.set_pool_target(wid, int(target))
        for wid, cap in (state.get("token_caps") or {}).items():
            self.token_caps[wid] = int(cap)
            _TOKEN_CAP.labels(wid).set(int(cap))
            self.hooks.set_token_cap(wid, int(cap))
        for wid, retry in (state.get("queue_modes") or {}).items():
            retry = float(retry)
            if retry > 0:
                self.shedding[wid] = retry
            self.hooks.set_shed(wid, retry)
        for wid in state.get("pending_drain") or []:
            # a drain requested-but-gated when the scheduler died: the
            # journaled intent survives the crash, so the resumed
            # generation keeps holding it against the same gate
            self.request_drain(wid)

    def state(self) -> dict:
        """Live controller state for the status RPC / `fleet` views."""
        with self._lock:
            pool = {}
            if self.hooks is not None and self.hooks.pool_stats is not None:
                try:
                    pool = (self.hooks.pool_stats() or {}).get("workers", {})
                except Exception:   # noqa: BLE001 -- a draining run's
                    pool = {}       # pool must not break status
            workers = sorted(set(self.pool_targets) | set(self.token_caps)
                             | set(pool) | set(self.shedding))
            return {
                "ticks": self.ticks,
                "slo_s": self._effective_slo(),
                "workers": {
                    wid: {
                        "pool_target": self.pool_targets.get(wid, 0),
                        "pool_ready": int(
                            (pool.get(wid) or {}).get("ready", 0)),
                        "token_cap": self.token_caps.get(wid, 0),
                        "arrival_rate": round(
                            self._rates[wid].value, 3)
                        if wid in self._rates else 0.0,
                        "shed_retry_after_s": round(
                            self.shedding.get(wid, 0.0), 3),
                    } for wid in workers
                },
                "tenants": {
                    t: {"slo_s": self._slo_for(t), "headroom_s": h}
                    for t, h in sorted(self.headroom.items())
                },
                "autoscale": {
                    "enabled": bool(self.settings.autoscale.enable
                                    and self.scaler is not None),
                    "pending_drain": list(self._pending_drain),
                    "drained": list(self.drained),
                    "provisioned": list(self.provisioned),
                },
            }
