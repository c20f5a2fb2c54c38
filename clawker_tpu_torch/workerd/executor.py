"""WorkerdExecutor: the scheduler-side half of the workerd data plane.

One executor per worker owns ONE persistent channel to that worker's
workerd (docs/workerd.md).  The scheduler's ``_submit_launch`` routes a
launch through admission exactly as before, but dispatch hands the
work to the executor instead of a local lane: the executor queues an
*intent*, the sender thread coalesces queued intents into one frame
(one WAN crossing per batch), and the reader thread turns the event
stream back into scheduler accounting calls -- created/started/exited
land in the same journal records, spans, and status transitions the
direct path writes, on the same locks.

Failure model:

- **partition** (channel dies, daemon lives): pending intents are KEPT
  for ``intent_deadline_s`` while the monitor thread redials; on
  reconnect it re-sends them (workerd dedups by (kind, agent, epoch,
  iteration) -- no duplicate creates) and ``resync``s the scheduler's
  running view against workerd's local container reality, so exits the
  partition swallowed are accounted exactly once.  The seam
  ``workerd.post_reconnect`` fires at that boundary.
- **daemon death**: redials fail, pending intents hit the deadline and
  strand their loops WITHOUT a breaker penalty (workerd death is not
  engine sickness); ``live()`` reads False, so the scheduler resumes
  direct polling and launches fall back to the in-process lane -- the
  degrade matrix row `fleet health` renders as ``degraded``.

The port's copy of ``clawker_tpu/workerd/executor.py``.  One branch of
:func:`discover_executors` waits for the ``tpu_vm`` driver (ROADMAP §1
item 12b): the socket its transport forwards over the SSH mux
(``transport.forward_workerd``); the port discovers the local worker's
canonical socket.  The seam it fires (``workerd.post_reconnect``) rides
the scheduler's ``seams``.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path

from .. import logsetup, telemetry
from ..agentd import protocol
from ..chaos.seams import SeamAbort
from ..errors import ClawkerError
from ..tracing.skew import ChannelClock
from . import WorkerdError

log = logsetup.get("workerd.executor")

_RECONNECTS = telemetry.counter(
    "workerd_reconnects_total", "Channel reconnects after a partition",
    labels=("worker",))
_CHANNEL_FAILS = telemetry.counter(
    "workerd_channel_failures_total",
    "Pending intents failed over to the direct path", labels=("worker",))
_INTENT_BATCHES = telemetry.counter(
    "workerd_intent_batches_total",
    "Intent frames sent (intents/batch = coalescing ratio)",
    labels=("worker",))

CONNECT_TIMEOUT_S = 2.0
MONITOR_TICK_S = 0.2


def ping_socket(path: Path) -> bool:
    """True when a workerd answers a ping on ``path``."""
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(1.0)
            s.connect(str(path))
            protocol.write_msg(s, {"type": "ping"})
            return protocol.read_msg(s).get("type") == "pong"
    except (OSError, ClawkerError):
        return False


@dataclass
class _Pending:
    """One in-flight intent awaiting its terminal event."""

    seq: int
    kind: str                   # launch | start | create
    doc: dict                   # the full intent (re-sent on reconnect)
    handle: Future
    t_submit: float
    loop: object = None         # AgentLoop for launch/start
    epoch: int = 0
    worker: object = None
    pool_entry: object = None   # warm-pool entry adopted by this launch
    cid: str = ""               # filled by the created event


class WorkerdExecutor:
    """One worker's persistent intent channel + pending-intent table."""

    def __init__(self, worker_id: str, sock_path: Path | str, *,
                 rtt_s: float = 0.0, intent_deadline_s: float = 60.0,
                 connect: bool = True):
        self.worker_id = worker_id
        self.sock_path = Path(sock_path)
        # fake-WAN model (docs/workerd.md#fake-wan): one-way propagation
        # delay paid once per FRAME (rtt/2 before an intent batch goes
        # out, rtt/2 before an event batch dispatches) -- pipelined
        # messages share a batch, so an iteration costs ~1 RTT instead
        # of one RTT per engine call
        self.rtt_s = float(rtt_s)
        self.intent_deadline_s = float(intent_deadline_s)
        self.sched = None
        self._seq = 0
        self._pending: dict[int, _Pending] = {}
        self._plock = threading.Lock()
        self._sendq: queue.SimpleQueue = queue.SimpleQueue()
        self._sock: socket.socket | None = None
        self._wlock = threading.Lock()
        self._live = False
        self._ever_connected = False
        # per-channel clock-skew estimator (docs/tracing.md#clock-skew):
        # fed by the ``ts`` field on hello_ack/resync_ack round-trips
        # this channel already pays -- never a new RPC
        self.clock = ChannelClock()
        self._closed = threading.Event()
        self._dead = threading.Event()      # channel needs a redial
        self.reconnects = 0
        self.stats = {"intents": 0, "batches": 0, "events": 0,
                      "failed_over": 0, "seeds": 0}
        self._seeded: set[str] = set()   # digests already shipped to the
        #                                  worker's seed store (the
        #                                  once-per-(digest,worker) gate)
        threading.Thread(target=self._sender, daemon=True,
                         name=f"workerd-send-{worker_id}").start()
        threading.Thread(target=self._monitor, daemon=True,
                         name=f"workerd-mon-{worker_id}").start()
        if connect and not self._try_connect():
            self._dead.set()        # monitor keeps redialing

    # ------------------------------------------------------------- wiring

    def bind(self, sched) -> None:
        """Attach the scheduler whose accounting the event stream
        drives (one scheduler per executor set; loopd-hosted runs keep
        the in-process path -- docs/workerd.md degrade matrix).

        Re-binding (a resumed generation adopting the channels of the
        one that died) drops the dead generation's pending intents
        without accounting: their loop objects belong to a frozen
        scheduler, and the resume reconcile re-derives everything they
        could have said from engine state + the journal."""
        if self.sched is not None and sched is not self.sched:
            with self._plock:
                stale, self._pending = self._pending, {}
            for p in stale.values():
                if not p.handle.done():
                    p.handle.set_result(None)
        self.sched = sched

    def live(self) -> bool:
        return self._live and not self._closed.is_set()

    def close(self) -> None:
        self._closed.set()
        self._dead.set()
        self._drop_sock()

    def _drop_sock(self) -> None:
        sock, self._sock = self._sock, None
        self._live = False
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------ connect

    def _try_connect(self) -> bool:
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(CONNECT_TIMEOUT_S)
            s.connect(str(self.sock_path))
            t0 = time.time()
            protocol.write_msg(s, {"type": "hello"})
            ack = protocol.read_msg(s)
            if ack.get("type") != "hello_ack":
                s.close()
                return False
            # the handshake round-trip doubles as a clock-skew sample;
            # the resync frame hands the daemon its CUMULATIVE offset to
            # the root clock so its spans carry an auditable ``skew_s``
            self.clock.observe(t0, float(ack.get("ts") or 0.0), time.time())
            view = self._running_view()
            t0 = time.time()
            protocol.write_msg(s, {
                "type": "resync", "running": view,
                "clock_offset_s": round(
                    self.clock.cumulative(self._upstream_offset()), 6)})
            # the resync_ack may be preceded by event frames the server
            # flushes the moment the sink opens: dispatch them in order
            while True:
                msg = protocol.read_msg(s)
                if msg.get("type") == "resync_ack":
                    self.clock.observe(t0, float(msg.get("ts") or 0.0),
                                       time.time())
                    break
                if msg.get("type") == "events":
                    self._dispatch_events(msg)
            s.settimeout(None)
        except (OSError, ClawkerError):
            try:
                s.close()
            except OSError:
                pass
            return False
        self._sock = s
        self._dead.clear()
        self._live = True
        reconnect = self._ever_connected
        self._ever_connected = True
        threading.Thread(target=self._reader, args=(s,), daemon=True,
                         name=f"workerd-read-{self.worker_id}").start()
        # re-send every pending intent: undelivered ones execute now,
        # delivered ones dedup server-side and their (buffered) events
        # arrive via the stream either way
        with self._plock:
            pend = [p.doc for p in self._pending.values()]
        for doc in pend:
            self._sendq.put(doc)
        if reconnect:
            self.reconnects += 1
            _RECONNECTS.labels(self.worker_id).inc()
            log.info("workerd channel to %s re-established (%d pending "
                     "re-synced)", self.worker_id, len(pend))
            self._fire_seam("workerd.post_reconnect")
        return True

    def _running_view(self) -> list[dict]:
        sched = self.sched
        if sched is None:
            return []
        return sched._workerd_running_view(self.worker_id)

    def _upstream_offset(self) -> float:
        """The scheduler's own cumulative offset to the root clock (0
        when the scheduler IS the root viewer; the loopd-supplied value
        on a federated run) -- chained into this channel's estimate."""
        return float(getattr(self.sched, "_trace_offset_s", 0.0) or 0.0)

    def _tp(self, loop) -> str:
        """The traceparent for one loop's intents: run trace id plus the
        open iteration-root span id when the scheduler has opened it
        (adopt intents); "" when tracing is off or no scheduler bound."""
        fn = getattr(self.sched, "_trace_tp", None)
        if fn is None:
            return ""
        try:
            return fn(loop)
        except Exception:   # noqa: BLE001 -- tracing never fails a launch
            return ""

    def _fire_seam(self, name: str) -> None:
        sched = self.sched
        if sched is None:
            return
        try:
            sched.seams.fire(name)
        except SeamAbort:
            pass        # the armed kill already froze the scheduler

    def _monitor(self) -> None:
        """Redial a dead channel; expire pending intents past the
        deadline (a wedged/killed daemon must not hang a launch
        forever -- the loop strands into the normal rescue path).

        The body is hardened per tick: if this thread died, pending
        intents would never expire and their loops would stay busy
        forever -- the one failure mode the degrade matrix cannot
        absorb."""
        backoff = 0.05
        while not self._closed.is_set():
            self._dead.wait(MONITOR_TICK_S)
            if self._closed.is_set():
                return
            try:
                if self._dead.is_set():
                    if self._try_connect():
                        backoff = 0.05
                    else:
                        time.sleep(backoff)
                        backoff = min(backoff * 2, 0.5)
                self._expire_pending()
            except Exception:   # noqa: BLE001 -- keep the lifeline up
                log.exception("workerd monitor tick failed (%s)",
                              self.worker_id)

    def _expire_pending(self) -> None:
        now = time.monotonic()
        expired: list[_Pending] = []
        with self._plock:
            for seq, p in list(self._pending.items()):
                if now - p.t_submit >= self.intent_deadline_s:
                    expired.append(self._pending.pop(seq))
        for p in expired:
            self._fail_pending(p, "workerd intent deadline exceeded "
                                  "(daemon dead or wedged)")

    def _fail_pending(self, p: _Pending, reason: str) -> None:
        self.stats["failed_over"] += 1
        _CHANNEL_FAILS.labels(self.worker_id).inc()
        sched = self.sched
        if p.kind in ("launch", "start") and sched is not None:
            sched._workerd_failed(p.loop, p.epoch, p.worker, "channel",
                                  reason, driverish=True, penalize=False,
                                  pool_entry=p.pool_entry)
            if not p.handle.done():
                p.handle.set_result(None)
        else:
            if not p.handle.done():
                p.handle.set_exception(WorkerdError(reason))

    # -------------------------------------------------------------- sends

    def _sender(self) -> None:
        """Coalesce queued intents into one frame per flush: the send
        half of O(1) WAN crossings per batch."""
        while not self._closed.is_set():
            try:
                first = self._sendq.get(timeout=0.5)
            except queue.Empty:
                continue
            batch = [first]
            while True:
                try:
                    batch.append(self._sendq.get_nowait())
                except queue.Empty:
                    break
            if self.rtt_s > 0:
                # one-way propagation: intents queued during the flight
                # ride the same batch (the drain below)
                time.sleep(self.rtt_s / 2)
                while True:
                    try:
                        batch.append(self._sendq.get_nowait())
                    except queue.Empty:
                        break
            sock = self._sock
            if sock is None:
                continue    # link down: pending re-send covers these
            try:
                with self._wlock:
                    protocol.write_msg(sock, {"type": "intents",
                                              "batch": batch})
                self.stats["batches"] += 1
                _INTENT_BATCHES.labels(self.worker_id).inc()
            except (OSError, ClawkerError):
                self._drop_sock()
                self._dead.set()

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _submit(self, doc: dict, pending: _Pending) -> Future:
        with self._plock:
            self._pending[pending.seq] = pending
        self.stats["intents"] += 1
        self._sendq.put(doc)
        return pending.handle

    def submit_launch(self, loop, epoch: int, worker, *, opts_doc: dict,
                      state: dict | None = None, pool_cid: str = "",
                      pool_entry=None) -> Future:
        seq = self._next_seq()
        doc = {"kind": "launch", "seq": seq, "agent": loop.agent,
               "epoch": epoch, "iteration": loop.iteration,
               "opts": opts_doc, "pool_cid": pool_cid, "state": state,
               "tp": self._tp(loop)}
        return self._submit(doc, _Pending(
            seq=seq, kind="launch", doc=doc, handle=Future(),
            t_submit=time.monotonic(), loop=loop, epoch=epoch,
            worker=worker, pool_entry=pool_entry))

    def submit_start(self, loop, epoch: int, worker, *, cid: str,
                     fresh: bool, state: dict | None = None) -> Future:
        seq = self._next_seq()
        doc = {"kind": "start", "seq": seq, "agent": loop.agent,
               "epoch": epoch, "iteration": loop.iteration, "cid": cid,
               "fresh": fresh, "state": state, "tp": self._tp(loop)}
        return self._submit(doc, _Pending(
            seq=seq, kind="start", doc=doc, handle=Future(),
            t_submit=time.monotonic(), loop=loop, epoch=epoch,
            worker=worker))

    def submit_pool_fill(self, pool_agent: str, opts_doc: dict) -> Future:
        """Warm-pool refill executed worker-side; resolves to the cid."""
        seq = self._next_seq()
        doc = {"kind": "create", "seq": seq, "agent": pool_agent,
               "epoch": -1, "iteration": 0, "opts": opts_doc}
        return self._submit(doc, _Pending(
            seq=seq, kind="create", doc=doc, handle=Future(),
            t_submit=time.monotonic()))

    def submit_adopt(self, loop, epoch: int) -> None:
        """Arm a worker-local exit waiter on an adopted container
        (--resume: the iteration keeps streaming its exit despite the
        scheduler never polling this worker over the WAN)."""
        self._sendq.put({"kind": "adopt", "seq": self._next_seq(),
                         "agent": loop.agent, "epoch": epoch,
                         "iteration": loop.iteration,
                         "cid": loop.container_id,
                         "tp": self._tp(loop)})

    def submit_halt(self, cid: str, timeout: int = 2) -> None:
        self._sendq.put({"kind": "halt", "seq": self._next_seq(),
                         "cid": cid, "timeout": timeout})

    def seeded(self, digest: str) -> bool:
        """Has this channel already shipped ``digest`` to the worker?"""
        return digest in self._seeded

    def submit_seed(self, digest: str, tar: bytes) -> bool:
        """Ship a workspace seed to the worker's seed store, at most once
        per digest per channel (docs/loop-worktrees.md#worker-resident-
        seeds).  Fire-and-forget on the ordered intent queue: the
        server's serial lane stores the seed before it executes any
        launch queued after this call, so launches referencing the
        digest hit the store.  A transfer lost to a dead link simply
        degrades those launches to the per-create fallback -- seeding is
        an optimization, never a correctness dependency.  Returns True
        when a transfer was actually queued."""
        if digest in self._seeded:
            return False
        self._seeded.add(digest)
        self.stats["seeds"] += 1
        self._sendq.put({"kind": "seed", "seq": self._next_seq(),
                         "digest": digest, "tar": protocol.b64(tar)})
        return True

    # ------------------------------------------------------------- events

    def _reader(self, sock: socket.socket) -> None:
        while not self._closed.is_set() and self._sock is sock:
            try:
                msg = protocol.read_msg(sock)
            except (protocol.ProtocolError, ClawkerError, OSError):
                if self._sock is sock:
                    self._drop_sock()
                    self._dead.set()
                return
            if msg.get("type") == "events":
                if self.rtt_s > 0:
                    time.sleep(self.rtt_s / 2)   # one-way propagation
                self._dispatch_events(msg)

    def _dispatch_events(self, msg: dict) -> None:
        for ev in msg.get("batch") or []:
            self.stats["events"] += 1
            try:
                self._dispatch_one(ev)
            except SeamAbort:
                return      # armed chaos kill fired in a handler
            except Exception:   # noqa: BLE001 -- one bad event must not
                log.exception("workerd event dispatch failed: %r", ev)

    @staticmethod
    def _wan_ms(p: _Pending, ev: dict) -> float:
        """Per-hop WAN wait: client wall elapsed since submit minus the
        server-side ms the event reports -- queueing + propagation +
        batching for this intent, attributed on the scheduler's span."""
        elapsed_ms = (time.monotonic() - p.t_submit) * 1000.0
        return max(0.0, round(elapsed_ms - float(ev.get("ms", 0.0)), 3))

    def _dispatch_one(self, ev: dict) -> None:
        kind = str(ev.get("ev", ""))
        sched = self.sched
        if kind == "exited":
            if sched is not None:
                sched._workerd_exited(
                    str(ev.get("agent", "")), int(ev.get("epoch", 0)),
                    int(ev.get("iteration", 0)), ev.get("code"),
                    str(ev.get("detail", "")))
            return
        seq = int(ev.get("seq", 0))
        with self._plock:
            p = self._pending.get(seq)
        if p is None:
            return      # already resolved (dedup echo, late duplicate)
        if kind == "created":
            p.cid = str(ev.get("cid", ""))
            entry, p.pool_entry = p.pool_entry, None
            # pool_entry cleared BEFORE the handler: the created
            # handler fully accounts the member (adopted, or recycled
            # on a remote adoption failure), so a later failed/expiry
            # on this same intent must not recycle it a second time
            if sched is not None:
                sched._workerd_created(
                    p.loop, p.epoch, p.worker, p.cid,
                    bool(ev.get("pool")), str(ev.get("pool_error", "")),
                    entry, float(ev.get("ms", 0.0)),
                    wan_ms=self._wan_ms(p, ev))
        elif kind == "started":
            with self._plock:
                self._pending.pop(seq, None)
            if sched is not None:
                sched._workerd_started(p.loop, p.epoch, p.worker,
                                       float(ev.get("ms", 0.0)),
                                       wan_ms=self._wan_ms(p, ev))
            if not p.handle.done():
                p.handle.set_result(None)
        elif kind == "pool_ready":
            with self._plock:
                self._pending.pop(seq, None)
            if not p.handle.done():
                p.handle.set_result(str(ev.get("cid", "")))
        elif kind == "failed":
            with self._plock:
                self._pending.pop(seq, None)
            if p.kind == "create":
                if not p.handle.done():
                    p.handle.set_exception(WorkerdError(
                        f"{ev.get('phase')}: {ev.get('error')}"))
            else:
                if sched is not None:
                    sched._workerd_failed(
                        p.loop, p.epoch, p.worker,
                        str(ev.get("phase", "?")),
                        str(ev.get("error", "")),
                        driverish=bool(ev.get("driverish")),
                        pool_entry=p.pool_entry)
                if not p.handle.done():
                    p.handle.set_result(None)


class ExecutorSet:
    """worker id -> WorkerdExecutor, plus the degrade seam: a worker
    with no live executor (absent, partitioned past deadline, killed)
    transparently uses the direct in-process path."""

    def __init__(self, executors: dict[str, WorkerdExecutor] | None = None):
        self.executors: dict[str, WorkerdExecutor] = dict(executors or {})

    def bind(self, sched) -> None:
        for ex in self.executors.values():
            ex.bind(sched)

    def for_worker(self, worker_id: str) -> WorkerdExecutor | None:
        """The worker's executor, only while its channel is LIVE."""
        ex = self.executors.get(worker_id)
        return ex if ex is not None and ex.live() else None

    def any_for(self, worker_id: str) -> WorkerdExecutor | None:
        """The executor regardless of liveness (liveness views)."""
        return self.executors.get(worker_id)

    def sockets(self) -> dict[str, Path]:
        return {wid: ex.sock_path for wid, ex in self.executors.items()}

    def close_all(self) -> None:
        for ex in self.executors.values():
            ex.close()

    def __len__(self) -> int:
        return len(self.executors)

    def __bool__(self) -> bool:
        return bool(self.executors)


def discover_executors(cfg, driver) -> ExecutorSet:
    """Build executors for every worker whose workerd answers
    (docs/workerd.md#discovery): the host's canonical socket for the
    single local worker (the ``tpu_vm`` workers' forwarded sockets wait
    for that driver).  Workers with nothing
    answering get no executor -- the scheduler's direct path serves
    them unchanged."""
    from . import socket_path

    ws = cfg.settings.workerd
    out: dict[str, WorkerdExecutor] = {}
    if not ws.enable:
        return ExecutorSet(out)
    for worker in driver.workers():
        sock: Path | None = None
        if getattr(driver, "name", "") == "local":
            cand = socket_path(cfg)
            sock = cand if cand.exists() else None
        if sock is None or not ping_socket(sock):
            continue
        out[worker.id] = WorkerdExecutor(
            worker.id, sock, intent_deadline_s=ws.intent_deadline_s)
    return ExecutorSet(out)
