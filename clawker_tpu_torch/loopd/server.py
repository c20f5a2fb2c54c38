"""The loopd server: pod-scale loop supervision behind a unix socket.

One :class:`LoopdServer` per host owns the state PR-6 left in-process:

- **one** :class:`~clawker_tpu_torch.placement.AdmissionController` -- every
  hosted run's launches bill the same per-worker token buckets, so two
  concurrent ``clawker loop`` clients can never jointly exceed
  ``max_inflight_per_worker`` the way two in-process controllers could;
- **one** :class:`~clawker_tpu_torch.loop.LaneRegistry` -- engine mutations
  against a worker serialize on one lane across runs;
- **daemon-owned health breakers** -- a
  :class:`~clawker_tpu_torch.health.HealthMonitor` probing the fleet for the
  daemon's whole lifetime, feeding ``clawker fleet health`` without a
  CLI-side probe round;
- the hosted runs themselves: each ``submit_run`` builds a
  :class:`~clawker_tpu_torch.loop.LoopScheduler` (shared admission + lanes)
  and drives it on a daemon thread, so the run OUTLIVES the submitting
  CLI -- detach closes the stream, ``clawker loop attach`` re-streams.

Wire protocol: length-prefixed JSON frames (``agentd/protocol.py``
framing) over a unix socket in a 0700 runtime dir with a 0600 socket --
filesystem permissions are the authentication, the bksession/nsd
pattern (docs/loopd.md#security).

Durability: hosted schedulers journal write-ahead exactly as the
in-process path does (same :class:`~clawker_tpu_torch.loop.RunJournal`
records under the same ``logs/runs`` dir), so a SIGKILLed daemon
resumes via ``clawker loop --resume`` with the same adoption
semantics.  The daemon fires the chaos seams ``loopd.post_submit`` /
``loopd.post_ack`` at its own transition boundaries, and
:meth:`LoopdServer.kill` freezes every hosted scheduler the way
process death would (the soak/crash-test seam).

**The port.**  The port's copy of ``clawker_tpu/loopd/server.py`` with
two additions.  One is a ``device`` keyword (default: ``CLAWKER_TORCH_DEVICE``,
else ``cuda``, as the CLI resolves it) for the daemon-lifetime
:class:`~clawker_tpu_torch.sentinel.FleetSentinel`: every scored tick is
one K3 fit and one K1 score on the card (K5 and a K1 per card when its
mesh spans several).  With settings ``sentinel.enable`` and a CUDA
device, :meth:`LoopdServer.start` brings up the card and builds or
loads the kernels before it binds the socket, and refuses to start
with a :class:`LoopdError` when it cannot: the daemon never runs on
with no sentinel and never scores on the CPU unless asked.  A tick that
fails after start goes to the daemon's log through ``on_error``.  The
sentinel writes its ``sentinel.tick`` spans into the daemon's flight
record.  The other: the status RPC's ``workerd`` rows probe the
sockets of the executors the daemon dispatches through (a plain
:class:`~clawker_tpu_torch.workerd.executor.ExecutorSet` or the sets a
factory made for its hosted runs) besides the reference's resolution,
so a fake pod's workers read ``live`` / ``degraded`` where the
reference's, which passes no socket map, read ``absent``.

What waits for its slice is refused by name: the capacity controller
(settings ``capacity.enable``, ROADMAP §1 item 9), the telemetry shipper
and the metrics server (settings ``monitoring.shipper.enable`` and a
metrics port, §1 item 10) raise a :class:`ConfigError` at start;
a spec the port's scheduler refuses (worktrees, gitguard: §1 item 6)
gets an error ack.  ``adopt_run`` replays a run's journal from the
shared logs dir and resumes it here (``LoopScheduler.resume`` +
``reconcile`` on the drive thread), and hosted runs take
``warm_pool_depth``.  Hosted runs dispatch through workerd when
``executors=`` is given (a set, or a factory called once per hosted run
and closed after it); the scheduler's own chaos seams wait for §1 item
8 (the daemon fires its two).
"""

from __future__ import annotations

import collections
import os
import queue
import socket
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .. import __version__, logsetup, telemetry
from ..agentd import protocol
from ..chaos.seams import NULL_SEAMS
from ..config import Config
from ..engine.drivers import RuntimeDriver
from ..errors import ClawkerError, ConfigError
from ..health import HealthMonitor
from ..loop import LaneRegistry, LoopScheduler, LoopSpec
from ..monitor.events import TRACE_SPAN
from ..placement import AdmissionController
from . import LoopdError, pidfile_path, socket_path

log = logsetup.get("loopd.server")

_CONNECTIONS = telemetry.counter(
    "loopd_connections_total", "Client connections accepted by loopd")
_RUNS = telemetry.counter(
    "loopd_runs_total", "Loop runs submitted to loopd", labels=("tenant",))
_ACTIVE_RUNS = telemetry.gauge(
    "loopd_active_runs", "Hosted runs currently executing")
_EVENTS_DROPPED = telemetry.counter(
    "loopd_events_dropped_total",
    "Stream events dropped on slow subscriber queues")

EVENT_RING = 512                # recent events kept per run for attach
SUB_QUEUE_MAX = 4096            # per-subscriber buffered frames
DRIVE_POLL_S = 0.05             # scheduler tick cadence inside the daemon
DONE_RUNS_KEPT = 64             # finished runs retained for attach/status;
#                                 beyond this the oldest done runs are
#                                 evicted (a resident daemon must not
#                                 accumulate every run it ever hosted)
LEASE_POOL_FACTOR = 4           # leasable launch credits per admission
#                                 token: a lease bounds a ROUTER's burst
#                                 (router-side flow control), while the
#                                 daemon's own admission buckets still
#                                 meter the actual inflight launches --
#                                 so credits may safely exceed the
#                                 instantaneous token count
#                                 (docs/federation.md#leases)


def spec_from_doc(doc: dict) -> LoopSpec:
    """Submitted spec doc -> LoopSpec (the same key set the journal's
    run header uses, so client and WAL stay one vocabulary)."""
    return LoopSpec(
        parallel=max(1, int(doc.get("parallel") or 1)),
        iterations=int(doc.get("iterations") or 0),
        placement=str(doc.get("placement") or "spread"),
        tenant=str(doc.get("tenant") or "default"),
        tenant_weight=float(doc.get("tenant_weight") or 1.0),
        tenant_max_inflight=int(doc.get("tenant_max_inflight") or 0),
        max_inflight_per_worker=int(doc.get("max_inflight_per_worker") or 0),
        image=str(doc.get("image") or "@"),
        prompt=str(doc.get("prompt") or ""),
        worktrees=bool(doc.get("worktrees") or False),
        gitguard=(bool(doc["gitguard"])
                  if doc.get("gitguard") is not None else None),
        workspace_mode=str(doc.get("workspace_mode") or ""),
        agent_prefix=str(doc.get("agent_prefix") or "loop"),
        env={str(k): str(v) for k, v in (doc.get("env") or {}).items()},
        failover=str(doc.get("failover") or "migrate"),
        orphan_grace_s=(float(doc["orphan_grace_s"])
                        if doc.get("orphan_grace_s") is not None else None),
        warm_pool_depth=int(doc.get("warm_pool_depth") or 0),
        telemetry=bool(doc.get("telemetry", True)),
        trace_parent=str(doc.get("trace_parent") or ""),
        clock_offset_s=float(doc.get("clock_offset_s") or 0.0),
    )


@dataclass
class _Lease:
    """One federation capacity lease: a bounded, renewable block of
    launch credits granted to a front-tier router so cross-pod
    placement pays ZERO admission round-trips on the launch hot path
    (the router spends credits locally; the daemon's admission buckets
    still meter the real launches).  TTL-bounded: a partitioned
    router's credits lapse back to the pod (docs/federation.md)."""

    lease_id: str
    tenant: str
    granted: int                # credits in this block
    remaining: int              # credits not yet spent (renew refreshes)
    ttl_s: float
    expires_at: float           # monotonic deadline
    renewals: int = 0


@dataclass
class _DaemonRun:
    """One hosted run: its scheduler, drive thread, and subscribers.

    ``sched`` is built on the DRIVE thread (submit acks in one socket
    hop plus registration; journal/flight-recorder opens and the
    placement fan-out happen just after) -- readers must tolerate a
    brief ``None``."""

    run_id: str
    spec: LoopSpec
    tenant: str
    client: str                         # submitting client identity
    keep: bool = False
    resume_image: object | None = None  # adopt_run: the replayed journal
    #                                     image a drive thread resumes
    #                                     instead of starting fresh
    #                                     (cross-pod migration)
    adopt_orphan_grace_s: float | None = None
    sched: LoopScheduler | None = None
    thread: threading.Thread | None = None
    stop_requested: threading.Event = field(default_factory=threading.Event)
    done: threading.Event = field(default_factory=threading.Event)
    result: dict = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)
    ring: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=EVENT_RING))
    subs: dict[int, queue.Queue] = field(default_factory=dict)
    dropped: int = 0                    # frames dropped off slow subscriber
    #                                     queues (the per-run view of
    #                                     loopd_events_dropped_total; the
    #                                     status feed and the attach-stream
    #                                     footer both surface it)
    _next_sub: int = 0

    def subscribe(self) -> tuple[int, queue.Queue, list[dict], bool]:
        """(sub id, frame queue, ring snapshot, finished).  Snapshot and
        registration happen under one lock so no event can land between
        them unseen."""
        with self.lock:
            snapshot = list(self.ring)
            if self.done.is_set():
                return -1, queue.Queue(), snapshot, True
            self._next_sub += 1
            q: queue.Queue = queue.Queue(maxsize=SUB_QUEUE_MAX)
            self.subs[self._next_sub] = q
            return self._next_sub, q, snapshot, False

    def unsubscribe(self, sub_id: int) -> None:
        with self.lock:
            self.subs.pop(sub_id, None)

    def publish(self, frame: dict | None) -> None:
        """Push a frame to every subscriber (None = stream sentinel).
        A slow subscriber drops its OLDEST buffered frames rather than
        back-pressuring the scheduler's event bus -- the journal/flight
        record stay the durable history; the stream is a live view.
        Drop-oldest (not drop-newest) so the terminal ``run_done``
        frame and the None sentinel always land: dropping those would
        wedge the writer in ``q.get()`` and the client in ``events()``
        forever."""
        with self.lock:
            if frame is not None:
                self.ring.append(frame)
            for q in self.subs.values():
                while True:
                    try:
                        q.put_nowait(frame)
                        break
                    except queue.Full:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            continue
                        self.dropped += 1
                        _EVENTS_DROPPED.inc()

    def status_doc(self, cfg: Config) -> dict:
        sched = self.sched
        return {
            "run": self.run_id,
            "state": "done" if self.done.is_set() else "running",
            "tenant": self.tenant,
            "client": self.client,
            "parallel": self.spec.parallel,
            "iterations": self.spec.iterations,
            "placement": self.spec.placement,
            "agents": sched.status() if sched is not None else [],
            "gitguard": (_gitguard_off(cfg)
                         if sched is not None else {"enabled": False}),
            "storage": (sched.storage_summary()
                        if sched is not None else {"durability": "unknown"}),
            "subscribers": len(self.subs),
            "events_dropped": self.dropped,
            **({"ok": self.result.get("ok")} if self.done.is_set() else {}),
        }


def _gitguard_off(cfg: Config) -> dict:
    """The reference scheduler's ``gitguard_summary()`` for a run whose
    git firewall is not armed: the port refuses worktrees (and with them
    gitguard), so a hosted run never arms it."""
    return {"enabled": False, "running": False, "socket": "",
            "hosts": list(cfg.settings.gitguard.hosts), "rules": [],
            "decisions": {}}


class LoopdServer:
    """Accept loop, per-connection handlers, hosted-run supervision."""

    def __init__(self, cfg: Config, driver: RuntimeDriver, *,
                 sock_path=None, seams=None, metrics_port: int | None = None,
                 executors=None, device: str | None = None):
        self.cfg = cfg
        self.driver = driver
        # worker-resident launch data plane for hosted runs (an
        # ExecutorSet, or a factory of one; docs/workerd.md) -- every
        # hosted scheduler dispatches through it when a worker's
        # channel is live
        self.executors = executors
        # worker id -> the workerd socket the daemon dispatches through:
        # what the status RPC's liveness rows probe
        self._workerd_socks: dict = ({} if executors is None
                                     or callable(executors)
                                     else executors.sockets())
        # where the daemon sentinel scores: the CLI's rule (the env
        # variable, else the card), resolved and brought up at start()
        from ..analytics import runtime as art

        self.device = device or art.env_device()
        self.sock_path = sock_path if sock_path is not None else (
            socket_path(cfg))
        self.seams = seams if seams is not None else NULL_SEAMS
        ps = cfg.settings.loop.placement
        # THE pod-scale state (one per host, not per run):
        self.admission = AdmissionController(
            max_inflight_per_worker=ps.max_inflight_per_worker,
            max_pending_per_worker=ps.max_pending_per_worker)
        self.lanes = LaneRegistry()
        self.health: HealthMonitor | None = None
        self.runs: dict[str, _DaemonRun] = {}
        self._runs_lock = threading.Lock()
        # federation capacity leases (docs/federation.md#leases)
        self._leases: dict[str, _Lease] = {}
        self._leases_lock = threading.Lock()
        self._lease_grants = 0          # lease blocks ever granted
        self._lease_expired = 0         # leases lapsed by TTL
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()
        self._stopped = threading.Event()   # stop()/kill() COMPLETED
        self._aborted = False           # kill(): the chaos crash seam
        self._started_at = 0.0
        self._metrics_port = (metrics_port if metrics_port is not None
                              else cfg.settings.loopd.metrics_port)
        self.sentinel = None        # daemon-lifetime FleetSentinel when
        #                             settings sentinel.enable
        # distributed tracing (docs/tracing.md): daemon-lifetime recorder
        # for ``loopd.submit`` hop spans -- one file per pod, every hosted
        # run's hop in it (the merge filters by trace id)
        self.flight = None
        try:
            tele = cfg.settings.telemetry
            if tele.tracing.enable and tele.flight_recorder.enable:
                from ..monitor.ledger import FLIGHT_DIR, FlightRecorder
                self.flight = FlightRecorder(
                    Path(cfg.logs_dir) / FLIGHT_DIR
                    / f"loopd-{self.pod_name()}.jsonl",
                    max_bytes=tele.flight_recorder.max_bytes)
        except AttributeError:
            self.flight = None
        # daemon-lifetime disk-pressure monitor (docs/durability.md):
        # hosted schedulers tick their own, but the daemon must watch
        # too -- the emergency retention GC has to fire even with zero
        # hosted runs, before storage runs out
        self.pressure = None
        try:
            sp = cfg.settings.loop.storage_pressure
            if sp.enable:
                from ..loop.journal import retention_gc
                from ..monitor.pressure import DiskPressureMonitor
                keep = max(1, int(sp.retention_runs))
                self.pressure = DiskPressureMonitor(
                    Path(cfg.logs_dir), soft_free_pct=sp.soft_free_pct,
                    hard_free_pct=sp.hard_free_pct,
                    check_interval_s=sp.check_interval_s,
                    gc=lambda: retention_gc(Path(cfg.logs_dir), keep=keep))
        except AttributeError:
            self.pressure = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "LoopdServer":
        """Bind the control socket (0700 dir / 0600 socket -- the
        bksession/nsd hardening pattern), start the accept loop, the
        daemon health monitor and the sentinel.  Before anything binds:
        refuse by name what settings enable and the port does not carry,
        and bring up the sentinel's card (:meth:`_bring_up`)."""
        self._refuse_unported()
        self._bring_up()
        rt = self.sock_path.parent
        rt.mkdir(parents=True, exist_ok=True)
        os.chmod(rt, 0o700)
        if self.sock_path.exists():
            # a live daemon answering on the socket must not be usurped;
            # a stale socket from a SIGKILLed daemon is swept
            if self._socket_answers():
                raise LoopdError(
                    f"loopd already running on {self.sock_path}")
            self.sock_path.unlink()
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        old_umask = os.umask(0o177)     # cover the bind itself
        try:
            listener.bind(str(self.sock_path))
        finally:
            os.umask(old_umask)
        os.chmod(self.sock_path, 0o600)     # umask-proof pin
        listener.listen(64)
        self._listener = listener
        self._started_at = time.monotonic()
        try:
            pidfile_path(self.cfg).parent.mkdir(parents=True, exist_ok=True)
            pidfile_path(self.cfg).write_text(str(os.getpid()))
        except OSError:
            pass
        self.health = HealthMonitor(self.driver)
        self.health.start()
        self._start_sentinel()
        if self.pressure is not None:
            threading.Thread(target=self._pressure_loop, daemon=True,
                             name="loopd-pressure").start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="loopd-accept")
        self._accept_thread.start()
        log.info("loopd listening on %s (pid %d)", self.sock_path,
                 os.getpid())
        return self

    def _refuse_unported(self) -> None:
        """The daemon riders the port does not carry yet, each named
        only when settings (or the ``metrics_port`` argument) ask for
        it."""
        st = self.cfg.settings
        for on, what, item in (
                (st.capacity.enable, "the elastic capacity controller "
                 "(settings capacity.enable)", 9),
                (st.monitoring.shipper.enable, "the telemetry shipper "
                 "(settings monitoring.shipper.enable)", 10),
                (self._metrics_port, "the metrics server (settings "
                 "loopd.metrics_port)", 10)):
            if on:
                raise ConfigError(
                    f"loopd: {what} is not yet ported to clawker_tpu_torch "
                    f"(ROADMAP §1 item {item})")

    def _bring_up(self) -> None:
        """With settings ``sentinel.enable``: resolve the sentinel's
        device and, on a card, open its context and build or load every
        kernel -- the ``loop`` verb's helper (``runtime.bring_up``).  No
        card, or a kernel that does not build or load, refuses the start
        with a :class:`LoopdError`: the daemon never runs on without the
        sentinel its settings ask for, and never scores on the CPU unless
        ``device`` (or ``CLAWKER_TORCH_DEVICE``) says ``cpu``."""
        if not self.cfg.settings.sentinel.enable:
            return
        from ..analytics import runtime as art

        try:
            art.bring_up(self.device)
        except (RuntimeError, OSError) as e:
            raise LoopdError(
                f"loopd: the sentinel (settings sentinel.enable) cannot "
                f"score on {self.device!r}: {e}") from e

    def _start_sentinel(self) -> None:
        """Bring up the daemon-lifetime fleet sentinel when settings
        sentinel.enable is set (docs/analytics-online.md).  Hosted runs'
        event buses tap into its behavioral features at construction
        (_drive); fleet views render its rows off the status RPC; its
        ticks land in the daemon's flight record.  The card is already
        up (:meth:`_bring_up`); a tick that fails later is logged through
        ``on_error`` and the previous scores stand."""
        ss = self.cfg.settings.sentinel
        if not ss.enable:
            return
        from ..sentinel import FleetSentinel

        self.sentinel = FleetSentinel(
            self.cfg, self.driver, interval_s=ss.interval_s,
            window_s=ss.window_s, train_steps=ss.train_steps,
            threshold=ss.threshold, baseline_window=ss.baseline_window,
            on_error=lambda msg: log.error("loopd sentinel tick failed: %s",
                                           msg),
            device=self.device)
        self.sentinel.flight = self.flight
        self.sentinel.start()
        log.info("loopd sentinel up on %s (interval %.1fs)", self.device,
                 ss.interval_s)

    def _pressure_loop(self) -> None:
        """Tick the daemon disk-pressure ladder at its own cadence."""
        monitor = self.pressure
        while not self._stop.wait(monitor.check_interval_s):
            try:
                monitor.tick()
            except Exception:   # noqa: BLE001 -- pressure must never
                log.exception("pressure tick failed")   # kill the daemon

    def _socket_answers(self) -> bool:
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(1.0)
                s.connect(str(self.sock_path))
                protocol.write_msg(s, {"type": "ping"})
                return protocol.read_msg(s).get("type") == "pong"
        except (OSError, ClawkerError):
            return False

    def serve_forever(self) -> None:
        """Block until a stop/kill has COMPLETED (the ``__main__``
        entrypoint).  Waiting on the stop *flag* instead would let the
        daemon process exit while the `shutdown` RPC's stop thread is
        still mid-drain -- killing it before the runs journal their
        shutdown records and before the socket is unlinked."""
        self._stopped.wait()

    def stop(self, *, drain: bool = True) -> None:
        """Graceful shutdown: stop accepting, journal a durable
        ``shutdown`` for every live run and drain it (bounded by
        settings ``loopd.drain_grace_s``), close subscribers, unlink
        the socket.  Runs drained here resume later with
        ``clawker loop --resume`` exactly like a Ctrl-C'd CLI run."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._close_listener(unlink=True)
        grace = self.cfg.settings.loopd.drain_grace_s
        with self._runs_lock:
            live = [r for r in self.runs.values() if not r.done.is_set()]
        for run in live:
            run.stop_requested.set()
            sched = run.sched
            if sched is None:
                continue        # drive thread honors stop_requested
            if drain:
                sched.request_shutdown("loopd stop")
            else:
                sched.stop()
        for run in live:
            if run.thread is not None:
                run.thread.join(grace)
        if self.health is not None:
            self.health.stop()
        if self.sentinel is not None:
            self.sentinel.stop()
        if self.flight is not None:
            self.flight.close()
        self.lanes.close_all()
        self._drop_conns()
        pidfile_path(self.cfg).unlink(missing_ok=True)
        log.info("loopd stopped")
        self._stopped.set()

    def kill(self) -> None:
        """Simulate daemon SIGKILL (chaos/crash tests): freeze every
        hosted scheduler's bookkeeping the way process death would --
        no shutdown records, no cleanup, no pool drains -- and drop
        every connection mid-frame.  The socket FILE stays behind,
        exactly as a real SIGKILL leaves it; discovery treats a
        connection-refused socket as "no daemon"."""
        self._aborted = True
        self._stop.set()
        with self._runs_lock:
            runs = list(self.runs.values())
        for run in runs:
            if run.sched is not None:
                run.sched.kill()
        self._close_listener(unlink=False)
        self._drop_conns()
        if self.health is not None:
            self.health.stop()
        if self.sentinel is not None:
            self.sentinel.kill_collector()
        if self.flight is not None:
            # the recorder FILE stays behind: a killed pod's submit
            # spans are exactly the surviving trace evidence the merge
            # renders around (docs/tracing.md#gaps)
            self.flight.close()
        self._stopped.set()

    def _drop_conns(self) -> None:
        """Hard-drop every client connection.  ``shutdown`` before
        ``close``: a plain close cannot interrupt a thread blocked in
        recv on the same socket (the blocked call pins the fd open), so
        without it neither the peer's EOF nor our own stream reader
        threads would ever wake."""
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _close_listener(self, *, unlink: bool) -> None:
        listener, self._listener = self._listener, None
        if listener is not None:
            # a blocked accept() pins the listener fd, so close alone
            # cannot stop the accept loop: wake it with a throwaway
            # connection first (the loop sees _stop/_listener and exits)
            try:
                with socket.socket(socket.AF_UNIX,
                                   socket.SOCK_STREAM) as s:
                    s.settimeout(0.5)
                    s.connect(str(self.sock_path))
            except OSError:
                pass
            try:
                listener.close()
            except OSError:
                pass
        if unlink:
            try:
                self.sock_path.unlink(missing_ok=True)
            except OSError:
                pass

    # ------------------------------------------------------------- serving

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            listener = self._listener
            if listener is None:
                return
            try:
                conn, _ = listener.accept()
            except OSError:
                return          # listener closed by stop()/kill()
            if self._stop.is_set() or self._listener is None:
                try:
                    conn.close()    # the wake-up connection itself
                except OSError:
                    pass
                return
            _CONNECTIONS.inc()
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True, name="loopd-conn").start()

    def _handle_conn(self, conn: socket.socket) -> None:
        ident = "anonymous"
        try:
            conn.settimeout(30.0)
            while not self._stop.is_set():
                try:
                    msg = protocol.read_msg(conn)
                except (protocol.ConnectionClosed, OSError):
                    return
                kind = msg.get("type", "")
                if kind == "hello":
                    ident = (f"uid{msg.get('uid', '?')}:"
                             f"pid{msg.get('pid', '?')}")
                    protocol.write_msg(conn, {
                        "type": "hello_ack", "pid": os.getpid(),
                        "version": __version__,
                        "project": self._project_name(),
                        "pod": self.pod_name(),
                        # server wall clock: the client side of this
                        # round-trip feeds its per-pod skew estimator
                        # (docs/tracing.md#clock-skew)
                        "ts": time.time(),
                    })
                elif kind == "ping":
                    with self._runs_lock:
                        n = sum(1 for r in self.runs.values()
                                if not r.done.is_set())
                    protocol.write_msg(conn, {
                        "type": "pong", "pid": os.getpid(), "runs": n,
                        "ts": time.time()})
                elif kind == "status":
                    protocol.write_msg(conn, self._status_doc())
                elif kind == "submit_run":
                    self._handle_submit(conn, msg, ident)
                    if msg.get("stream", True):
                        return  # streaming connections are single-purpose
                    # stream=False is a unary verb: the federation router
                    # reuses ONE control connection per pod for lease +
                    # submit traffic (docs/federation.md#router)
                elif kind == "attach":
                    self._handle_attach(conn, msg)
                    return
                elif kind == "stop_run":
                    self._handle_stop_run(conn, msg)
                elif kind == "lease_acquire":
                    protocol.write_msg(conn, self._lease_acquire(msg, ident))
                elif kind == "lease_renew":
                    protocol.write_msg(conn, self._lease_renew(msg))
                elif kind == "lease_release":
                    protocol.write_msg(conn, self._lease_release(msg))
                elif kind == "adopt_run":
                    self._handle_adopt(conn, msg, ident)
                    if msg.get("stream", False):
                        return  # streaming: single-purpose like submit
                elif kind == "shutdown":
                    protocol.write_msg(conn, {"type": "ok"})
                    threading.Thread(target=self.stop, daemon=True,
                                     name="loopd-shutdown").start()
                    return
                else:
                    protocol.write_msg(conn, {
                        "type": "error",
                        "error": f"unknown request {kind!r}"})
        except (protocol.ProtocolError, OSError) as e:
            log.info("loopd connection dropped: %s", e)
        except ClawkerError as e:
            try:
                protocol.write_msg(conn, {"type": "error", "error": str(e)})
            except (OSError, ClawkerError):
                pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _project_name(self) -> str:
        try:
            return self.cfg.project_name()
        except LookupError:
            return ""

    def pod_name(self) -> str:
        """This daemon's pod name in a federation: settings
        ``federation.name``, else derived from the socket's directory
        (every fake pod in tests binds a distinct dir).  Single-pod
        deployments see the default ``loopd``."""
        return (self.cfg.settings.federation.name
                or self.sock_path.parent.name)

    # -------------------------------------------------------- lease verbs
    # Federation capacity leases: a front-tier router acquires a bounded,
    # renewable block of launch credits per pod instead of a router->pod
    # admission round-trip per launch -- the lease amortizes admission
    # the way workerd amortized engine calls (docs/federation.md#leases).
    # The daemon's own admission buckets still meter the real inflight
    # launches, so a rogue router cannot widen any per-worker cap.

    def _lease_pool(self) -> int:
        """Total leasable launch credits for this pod."""
        stats = self.admission.stats()
        workers = [w for w in self.driver.workers() if w.engine is not None]
        return max(1, len(workers)) * int(
            stats["max_inflight_per_worker"]) * LEASE_POOL_FACTOR

    def _lease_sweep_locked(self) -> None:
        now = time.monotonic()
        for lid in [lid for lid, le in self._leases.items()
                    if le.expires_at <= now]:
            del self._leases[lid]
            self._lease_expired += 1

    def _lease_acquire(self, msg: dict, ident: str) -> dict:
        from ..util import ids

        ttl = max(0.2, float(msg.get("ttl_s")
                             or self.cfg.settings.federation.lease_ttl_s))
        want = max(1, int(msg.get("tokens")
                          or self.cfg.settings.federation.lease_tokens))
        tenant = str(msg.get("tenant") or ident)
        with self._leases_lock:
            self._lease_sweep_locked()
            outstanding = sum(le.remaining for le in self._leases.values())
            grant = min(want, max(0, self._lease_pool() - outstanding))
            if grant <= 0:
                # every credit is out on unexpired leases: the router
                # retries after the shortest-lived one can lapse
                retry = min((le.expires_at for le in self._leases.values()),
                            default=time.monotonic() + ttl)
                return {"type": "lease", "lease": "", "tokens": 0,
                        "ttl_s": ttl, "pod": self.pod_name(),
                        "retry_after_s": round(
                            max(0.05, retry - time.monotonic()), 3)}
            lease = _Lease(lease_id=ids.short_id(), tenant=tenant,
                           granted=grant, remaining=grant, ttl_s=ttl,
                           expires_at=time.monotonic() + ttl)
            self._leases[lease.lease_id] = lease
            self._lease_grants += 1
        log.info("lease %s granted to %s (%d credit(s), ttl %.1fs)",
                 lease.lease_id, tenant, grant, ttl)
        return {"type": "lease", "lease": lease.lease_id,
                "tokens": grant, "ttl_s": ttl, "pod": self.pod_name(),
                "ts": time.time()}

    def _lease_renew(self, msg: dict) -> dict:
        lid = str(msg.get("lease", ""))
        with self._leases_lock:
            self._lease_sweep_locked()
            lease = self._leases.get(lid)
            if lease is None:
                # expired or never granted: the router must RE-ACQUIRE
                # (a lapsed lease's credits are already back in the pool)
                return {"type": "error",
                        "error": f"lease {lid!r} unknown or expired"}
            lease.remaining = lease.granted     # fresh credit block
            lease.expires_at = time.monotonic() + lease.ttl_s
            lease.renewals += 1
            return {"type": "lease", "lease": lease.lease_id,
                    "tokens": lease.granted, "ttl_s": lease.ttl_s,
                    "pod": self.pod_name(), "ts": time.time()}

    def _lease_release(self, msg: dict) -> dict:
        lid = str(msg.get("lease", ""))
        with self._leases_lock:
            released = self._leases.pop(lid, None) is not None
        return {"type": "ok", "lease": lid, "released": released}

    def _lease_stats(self) -> dict:
        with self._leases_lock:
            self._lease_sweep_locked()
            return {
                "active": len(self._leases),
                "outstanding_tokens": sum(le.remaining
                                          for le in self._leases.values()),
                "pool": self._lease_pool(),
                "granted_total": self._lease_grants,
                "expired_total": self._lease_expired,
            }

    # ----------------------------------------------------------- run verbs

    def _handle_submit(self, conn, msg: dict, ident: str) -> None:
        t_submit = time.time()
        doc = msg.get("spec") or {}
        spec = spec_from_doc(doc)
        # per-tenant accounting keyed by CLIENT IDENTITY: a run that
        # never named a tenant bills under its submitter, so two
        # anonymous CLIs on one pod still split tokens fairly instead
        # of pooling into one "default" share
        if spec.tenant in ("", "default"):
            spec.tenant = ident
        # _create_run validates the spec (unknown policy/failover raise
        # here = an error ack) and registers the run; the scheduler's
        # own start() -- WAL + launch submission -- runs on the drive
        # thread AFTER the ack, so submit latency is the socket hop
        # plus registration, not a journal fsync + fan-out
        run = self._create_run(spec, ident, keep=bool(msg.get("keep")))
        self._trace_submit(run, msg, t_submit)
        self.seams.fire("loopd.post_submit")
        client_gone = False
        try:
            protocol.write_msg(conn, {
                "type": "submitted", "run": run.run_id,
                "tenant": run.tenant,
                # deterministic per (run, slot) -- the same names the
                # scheduler will place (and the journal will record)
                "agents": [f"{spec.agent_prefix}-{run.run_id[:6]}-{i}"
                           for i in range(spec.parallel)],
                # skew sample for the submitting router's estimator
                "ts": time.time()})
        except (OSError, ClawkerError):
            client_gone = True      # ownership already transferred: the
            #                         run executes regardless
        self.seams.fire("loopd.post_ack")
        self._start_run(run)
        if not client_gone and msg.get("stream", True):
            self._stream(conn, run)

    def _trace_submit(self, run: _DaemonRun, msg: dict,
                      t_submit: float) -> None:
        """Record this pod's ``loopd.submit`` hop span and hand the spec
        its downstream trace linkage: the run id IS the trace id from
        here on (it did not exist before _create_run), the submit span
        is the scheduler's upstream parent, and the router's cumulative
        clock offset rides along so the hosted scheduler -- and every
        workerd below it -- stamps auditable ``skew_s`` values."""
        spec = run.spec
        offset = float(msg.get("clock_offset_s") or 0.0)
        spec.clock_offset_s = offset
        if self.flight is None or self._aborted:
            return
        from ..telemetry.spans import SpanRecord
        from ..tracing.context import TraceContext
        from ..tracing.names import SPAN_LOOPD_SUBMIT
        from ..util import ids

        up = TraceContext.from_header(str(msg.get("tp", "")))
        span_id = ids.short_id(16)
        spec.trace_parent = TraceContext(run.run_id, span_id).to_header()
        attrs = {"pod": self.pod_name(), "tenant": run.tenant}
        if up is not None and up.span_id:
            attrs["ctx_parent"] = up.span_id
        if offset:
            attrs["skew_s"] = round(offset, 6)
        self.flight.append(SpanRecord(
            trace_id=run.run_id, span_id=span_id, parent_id="",
            name=SPAN_LOOPD_SUBMIT, agent="", worker=self.pod_name(),
            t_start=t_submit, t_end=time.time(),
            attrs=attrs).to_json())

    def _create_run(self, spec: LoopSpec, ident: str, *,
                    keep: bool) -> _DaemonRun:
        """Validate the spec and REGISTER the run (the ack gate).  The
        expensive part -- journal/flight-recorder opens, placement,
        launch submission -- happens on the drive thread, so submit
        latency is one socket hop plus this registration."""
        from ..loop.scheduler import FAILOVER_POLICIES, refuse_unported
        from ..placement import get_policy
        from ..util import ids

        get_policy(spec.placement)          # raises on unknown policy
        if spec.failover not in FAILOVER_POLICIES:
            raise ClawkerError(
                f"loopd: unknown failover policy {spec.failover!r} "
                f"({'|'.join(FAILOVER_POLICIES)})")
        refuse_unported(spec)   # worktrees, gitguard: an error ack
        run = _DaemonRun(run_id=ids.short_id(), spec=spec,
                         tenant=spec.tenant, client=ident, keep=keep)
        with self._runs_lock:
            self.runs[run.run_id] = run
            # retention: evict the oldest DONE runs past the keep window
            # (dict order is insertion order = submit order); live runs
            # are never evicted.  The journal/flight record remain on
            # disk -- eviction only drops the in-memory view.
            done_ids = [rid for rid, r in self.runs.items()
                        if r.done.is_set()]
            for rid in done_ids[:max(0, len(done_ids) - DONE_RUNS_KEPT)]:
                del self.runs[rid]
            active = sum(1 for r in self.runs.values()
                         if not r.done.is_set())
        _RUNS.labels(spec.tenant).inc()
        _ACTIVE_RUNS.set(active)
        log.info("run %s submitted by %s (tenant %s, %d loop(s))",
                 run.run_id, ident, run.tenant, spec.parallel)
        return run

    def _handle_adopt(self, conn, msg: dict, ident: str) -> None:
        """Adopt a dead pod's journaled run onto THIS pod (cross-pod
        migration, docs/federation.md#migration): replay the run's WAL
        from the shared logs dir and resume it under this daemon's
        admission/lanes.  The dead pod's workers replay as engine-less
        stand-ins, their breakers pre-open, and the run's own failover
        policy re-places every orphaned loop onto this pod's workers --
        journal appends continue under the SAME run id (generation+1),
        so exit-accounted-once and duplicate-create audits hold across
        the pod boundary."""
        from ..loop.journal import RunJournal, journal_path, replay
        from ..loop.scheduler import refuse_unported

        run_ref = str(msg.get("run", ""))
        jpath = journal_path(self.cfg.logs_dir, run_ref)
        if not jpath.exists():
            raise LoopdError(
                f"adopt_run: no journal for run {run_ref!r} under "
                f"{self.cfg.logs_dir} (federation pods must share "
                "journal storage; docs/federation.md#migration)")
        image = replay(RunJournal.read(jpath))
        if not image.run_id:
            raise LoopdError(
                f"adopt_run: {jpath}: no usable run header -- the "
                "journal is too damaged to adopt")
        spec = spec_from_doc(image.spec)
        refuse_unported(spec)   # worktrees, gitguard: an error frame
        if spec.tenant in ("", "default"):
            spec.tenant = ident
        run = _DaemonRun(run_id=image.run_id, spec=spec,
                         tenant=spec.tenant, client=ident,
                         keep=bool(msg.get("keep")),
                         resume_image=image,
                         adopt_orphan_grace_s=(
                             float(msg["orphan_grace_s"])
                             if msg.get("orphan_grace_s") is not None
                             else None))
        with self._runs_lock:
            existing = self.runs.get(run.run_id)
            if existing is not None and not existing.done.is_set():
                raise LoopdError(
                    f"adopt_run: run {run.run_id} is already hosted "
                    "here and live")
            self.runs[run.run_id] = run
            active = sum(1 for r in self.runs.values()
                         if not r.done.is_set())
        _RUNS.labels(spec.tenant).inc()
        _ACTIVE_RUNS.set(active)
        log.info("run %s adopted by %s (tenant %s, %d loop(s))",
                 run.run_id, ident, run.tenant, spec.parallel)
        client_gone = False
        try:
            protocol.write_msg(conn, {
                "type": "adopted", "run": run.run_id,
                "tenant": run.tenant, "pod": self.pod_name()})
        except (OSError, ClawkerError):
            client_gone = True      # adoption proceeds regardless
        self._start_run(run)
        if not client_gone and msg.get("stream", True):
            self._stream(conn, run)

    def _start_run(self, run: _DaemonRun) -> None:
        """Spawn the drive thread (idempotent)."""
        if run.thread is not None:
            return
        run.thread = threading.Thread(target=self._drive, args=(run,),
                                      daemon=True,
                                      name=f"loopd-run-{run.run_id[:6]}")
        run.thread.start()

    def _drive(self, run: _DaemonRun) -> None:
        """Build and drive one hosted run to completion on a daemon
        thread.  The scheduler is constructed with the SHARED admission
        controller and lane registry; placements are journaled
        write-ahead and launches submitted exactly as in-process."""
        if self._aborted:
            return

        def on_event(agent, event, detail=""):
            if event == TRACE_SPAN:
                return      # spans live in the flight recorder; the
                #             stream carries the lifecycle events
            run.publish({"type": "event", "run": run.run_id,
                         "agent": agent, "event": event, "detail": detail})

        # an executor set binds to ONE scheduler, so hosted runs get a
        # fresh set each when a factory was supplied (a plain set is
        # the single-run convenience: tests, one-shot daemons)
        execset = (self.executors() if callable(self.executors)
                   else self.executors)
        if execset is not None:
            self._workerd_socks.update(execset.sockets())
        try:
            if run.resume_image is not None:
                # cross-pod adoption: resume the replayed journal image
                # under THIS daemon's shared admission (the run keeps
                # its id; reconcile() below adopts/relaunches/migrates)
                sched = LoopScheduler.resume(
                    self.cfg, self.driver, run.resume_image,
                    on_event=on_event,
                    orphan_grace_s=run.adopt_orphan_grace_s,
                    admission=self.admission,
                    executors=execset)
            else:
                sched = LoopScheduler(self.cfg, self.driver, run.spec,
                                      on_event=on_event,
                                      run_id=run.run_id,
                                      admission=self.admission,
                                      lanes=self.lanes,
                                      executors=execset)
            run.sched = sched
            if self.sentinel is not None:
                # the hosted run's typed events feed the daemon
                # sentinel's behavioral features (observe-only: the tap
                # reads records, the sentinel holds no scheduler ref)
                sched.events.add_tap(self.sentinel.behavior)
            if self._aborted:
                sched.kill()        # kill() raced the construction
                return
            if run.stop_requested.is_set():
                sched.request_shutdown("loopd stop_run")
            if run.resume_image is not None:
                sched.reconcile()
            else:
                sched.start()
            loops = sched.run(poll_s=DRIVE_POLL_S)
            if not (self._aborted or sched._aborted):
                sched.cleanup(remove_containers=not run.keep)
            agents = [l.summary() for l in loops]
            ok = not any(l.status in ("failed", "orphaned") for l in loops)
        except Exception as e:      # noqa: BLE001 -- a run must never
            #                         take the daemon down with it
            log.exception("hosted run %s crashed", run.run_id)
            agents = run.sched.status() if run.sched is not None else []
            ok = False
            run.result["error"] = repr(e)
        if callable(self.executors) and execset is not None:
            try:
                execset.close_all()     # factory-made: this run owned it
            except Exception:  # noqa: BLE001 -- teardown must not mask
                pass           #                the run's own result
        if self._aborted:
            return      # killed daemons publish nothing
        run.result.update({"agents": agents, "ok": ok})
        run.done.set()
        with self._runs_lock:
            _ACTIVE_RUNS.set(sum(1 for r in self.runs.values()
                                 if not r.done.is_set()))
        run.publish({"type": "run_done", "run": run.run_id,
                     "agents": agents, "ok": ok,
                     # surfaced in the attach-stream footer: drops mean
                     # the live view was lossy, the journal/flight
                     # record were not
                     "events_dropped": run.dropped})
        run.publish(None)

    def _resolve_run(self, ref: str) -> _DaemonRun:
        with self._runs_lock:
            run = self.runs.get(ref)
            if run is not None:
                return run
            matches = [r for rid, r in self.runs.items()
                       if rid.startswith(ref)]
        if len(matches) == 1:
            return matches[0]
        if matches:
            names = ", ".join(r.run_id for r in matches)
            raise LoopdError(f"run {ref!r} is ambiguous: {names}")
        raise LoopdError(f"loopd hosts no run {ref!r}")

    def _handle_attach(self, conn, msg: dict) -> None:
        run = self._resolve_run(str(msg.get("run", "")))
        protocol.write_msg(conn, {
            "type": "attached", "run": run.run_id,
            "state": "done" if run.done.is_set() else "running",
            "agents": (run.sched.status()
                       if run.sched is not None else [])})
        self._stream(conn, run)

    def _handle_stop_run(self, conn, msg: dict) -> None:
        run = self._resolve_run(str(msg.get("run", "")))
        run.stop_requested.set()
        if run.sched is not None:
            run.sched.request_shutdown("loopd stop_run")
        protocol.write_msg(conn, {"type": "ok", "run": run.run_id})

    # ------------------------------------------------------------ streaming

    def _stream(self, conn, run: _DaemonRun) -> None:
        """Push the run's event frames until it completes or the client
        detaches.  Detaching (an explicit ``detach`` frame, or just
        closing the socket) unsubscribes and returns -- it must NEVER
        stop the run; that is the whole point of a daemon-owned run."""
        sub_id, q, snapshot, finished = run.subscribe()
        conn.settimeout(None)
        detached = threading.Event()

        def reader():
            # the client side of a stream only ever says "detach" (or
            # vanishes); either way the writer must wake promptly
            try:
                while True:
                    m = protocol.read_msg(conn)
                    if m.get("type") == "detach":
                        break
            except (protocol.ProtocolError, OSError):
                pass
            detached.set()
            try:
                q.put_nowait(None)
            except queue.Full:
                pass

        threading.Thread(target=reader, daemon=True,
                         name="loopd-stream-reader").start()
        try:
            for frame in snapshot:
                protocol.write_msg(conn, frame)
            if finished:
                protocol.write_msg(conn, {
                    "type": "run_done", "run": run.run_id,
                    "agents": run.result.get("agents", []),
                    "ok": run.result.get("ok", False),
                    "events_dropped": run.dropped})
                return
            while not detached.is_set():
                frame = q.get()
                if frame is None:
                    if detached.is_set():
                        break
                    return      # run_done already pushed; stream over
                protocol.write_msg(conn, frame)
        except (protocol.ProtocolError, OSError):
            pass                # client vanished mid-write: same as detach
        finally:
            run.unsubscribe(sub_id)

    # -------------------------------------------------------------- status

    def _health_stats(self) -> list[dict]:
        """Per-worker health rows: the daemon's own monitor merged with
        every LIVE hosted run's monitor, keeping the most pessimistic
        breaker row per worker.  Placements consult the RUN monitors
        (each scheduler builds its own), so a fleet view fed only by
        the daemon's idle monitor could read all-closed while a hosted
        run is actively failing over -- the merge renders the breakers
        placements actually use."""
        monitors = [self.health] if self.health is not None else []
        with self._runs_lock:
            for r in self.runs.values():
                sched = r.sched
                if (not r.done.is_set() and sched is not None
                        and sched.health is not None):
                    monitors.append(sched.health)
        best: dict[str, dict] = {}
        for mon in monitors:
            try:
                rows = mon.stats()
            except Exception:       # noqa: BLE001 -- a dying run's
                continue            # monitor must not break status
            for row in rows:
                cur = best.get(row["worker"])
                if (cur is None or row["breaker_state_gauge"]
                        > cur["breaker_state_gauge"]):
                    best[row["worker"]] = row
        return [best[w] for w in sorted(best)]

    def _workerd_rows(self) -> dict:
        """Per-worker workerd liveness for the status RPC: `fleet
        health` renders it so a worker silently degraded to the WAN
        launch path is visible instead of just slow (docs/workerd.md).
        The executors' sockets are probed where the daemon has them."""
        from ..workerd import liveness

        try:
            return liveness(self.cfg, self.driver,
                            sock_by_worker=self._workerd_socks)
        except Exception:       # noqa: BLE001 -- a probe failure must
            return {}           # never break the status RPC

    def _storage_stats(self) -> dict:
        """Daemon-level storage health: the disk-pressure ladder
        (per-run journal health rides each run's ``status_doc``; the
        capacity WAL comes with the capacity controller)."""
        return {"pressure": (self.pressure.summary()
                             if self.pressure is not None else None)}

    def _status_doc(self) -> dict:
        with self._runs_lock:
            runs = [r.status_doc(self.cfg) for r in self.runs.values()]
        pools = {}
        with self._runs_lock:
            for r in self.runs.values():
                wp = (r.sched.warmpool if r.sched is not None else None)
                if wp is not None:
                    pools[r.run_id] = wp.stats()
        return {
            "type": "status",
            "pid": os.getpid(),
            "version": __version__,
            "project": self._project_name(),
            "pod": self.pod_name(),
            "socket": str(self.sock_path),
            "uptime_s": round(time.monotonic() - self._started_at, 1),
            "runs": runs,
            "admission": self.admission.stats(),
            "leases": self._lease_stats(),
            "health": self._health_stats(),
            "workerd": self._workerd_rows(),
            "warm_pools": pools,
            # the capacity controller and the shipper are refused (a
            # setting that asks for one never starts the daemon): their
            # sections read as the reference's when they are off
            "capacity": {"enabled": False},
            "storage": self._storage_stats(),
            "sentinel": (self.sentinel.status_doc()
                         if self.sentinel is not None
                         else {"enabled": False}),
            "shipper": {"enabled": False},
            "events_dropped_total": sum(r.get("events_dropped", 0)
                                        for r in runs),
            "settings": {
                "max_inflight_per_worker":
                    self.cfg.settings.loop.placement.max_inflight_per_worker,
                "max_pending_per_worker":
                    self.cfg.settings.loop.placement.max_pending_per_worker,
                "metrics_port": self._metrics_port,
            },
        }
