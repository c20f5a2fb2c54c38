"""The workerd server: the worker-resident launch data plane.

One :class:`WorkerdServer` per worker host owns a serial *local lane*
against that host's engine socket.  The scheduler (directly, or via
loopd) sends batched intents over one persistent channel; the server
executes them locally -- the whole create/start/wait burst that used to
cross the WAN per engine call now happens daemon-to-daemon over a unix
socket -- and streams batched typed events back.

Wire protocol (agentd length-prefixed JSON framing; docs/workerd.md):

==============  ========================================================
frame           meaning
==============  ========================================================
``hello``       client handshake -> ``hello_ack`` {pid, version, worker}
``ping``        liveness -> ``pong``
``status``      stats doc (executed/queued/buffered counts)
``intents``     {batch: [intent...]}; fire-and-forget, executed in order
                on the local lane.  Intent kinds: ``launch`` (create +
                first start), ``start`` (restart an existing container),
                ``create`` (create only -- warm-pool fill), ``adopt``
                (arm an exit waiter on a live container), ``halt``
                (stop a container), ``seed`` (stage a workspace seed
                tar by content digest in the worker-local seed store so
                later launches fan it out from the local socket --
                docs/loop-worktrees.md#worker-resident-seeds).
``resync``      {running: [...]}: the reconnect handshake -- workerd
                compares the scheduler's intent view against its LOCAL
                container reality, re-arms waiters for still-running
                containers, reports exits the partition swallowed, and
                then flushes every event buffered while the link was
                down -> ``resync_ack``
``shutdown``    graceful stop -> ``ok``
==============  ========================================================

Events (batched into ``{"type": "events", "batch": [...]}`` frames; one
WAN crossing per batch): ``created`` / ``started`` / ``pool_ready`` /
``failed`` echo the intent's ``seq``; ``exited`` is unsolicited and
keyed by (agent, epoch, iteration).  All carry worker-side span timings
(``ms``).

Crash safety: workerd holds NO durable state -- the write-ahead journal
stays with the scheduler.  Events that cannot be delivered (link down)
are buffered (bounded) and flushed after the next ``resync``; a killed
workerd loses its buffer, which the scheduler covers by degrading to
direct polling (the same engine socket is still forwarded).  Intents
are deduplicated by (kind, agent, epoch, iteration) so a client that
ever re-sends cannot double-create.

The port's copy of ``clawker_tpu/workerd/server.py``, whole: a launch
intent naming a ``pool_cid`` adopts that warm-pool member
(``AgentRuntime.adopt_pooled``) and falls back to a cold create, the
reason in ``pool_error``, when the adoption fails; ``create`` intents
carry the warm pool's fills and ``adopt`` intents the containers a
``--resume`` reconcile adopted.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import socket
import threading
import time

from .. import __version__, logsetup, telemetry
from ..agentd import protocol
from ..chaos.seams import NULL_SEAMS
from ..errors import ClawkerError, DriverError, NotFoundError
from ..tracing.names import (SPAN_WORKERD_CREATE, SPAN_WORKERD_START,
                             SPAN_WORKERD_WAIT)
from . import WorkerdError

log = logsetup.get("workerd.server")

_INTENTS = telemetry.counter(
    "workerd_intents_total", "Intents executed by workerd",
    labels=("worker", "kind"))
_EVENTS = telemetry.counter(
    "workerd_events_total", "Typed events emitted by workerd",
    labels=("worker", "kind"))
_BATCHES = telemetry.counter(
    "workerd_event_batches_total",
    "Event frames flushed by workerd (events/batch = coalescing ratio)",
    labels=("worker",))
_BUFFERED_DROPS = telemetry.counter(
    "workerd_events_dropped_total",
    "Events dropped off a full link-down buffer", labels=("worker",))

INTENT_KINDS = ("launch", "start", "create", "adopt", "halt", "seed")
EVENT_BUFFER = 4096             # events held while the link is down
FLUSH_WINDOW_S = 0.002          # coalesce window per event batch
DEDUP_KEYS_KEPT = 4096          # executed-intent keys retained; dedup
#                                 only needs the client-retry window, and
#                                 a daemon that outlives many runs must
#                                 not grow a key per intent forever


class SeedStore:
    """Worker-local content-addressed seed cache: digest -> tar bytes.

    Bounded by TOTAL bytes (``workerd.seed_cache_bytes``), evicting
    least-recently-used digests -- a long-lived daemon hosting many runs
    must not pin every seed it ever saw.  In-memory only: a killed
    daemon loses the store, and the launch path degrades to the
    per-create fallback (the scheduler's host-side cache still bounds
    the cost to one tar build)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max(0, int(max_bytes))
        self._entries: collections.OrderedDict[str, bytes] = \
            collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def put(self, digest: str, tar: bytes) -> bool:
        """Store one seed; returns False when the tar alone exceeds the
        cap (stored nothing -- callers fall back per-create)."""
        if len(tar) > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(digest, None)
            if old is not None:
                self._bytes -= len(old)
            while self._entries and self._bytes + len(tar) > self.max_bytes:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= len(evicted)
            self._entries[digest] = tar
            self._bytes += len(tar)
            return True

    def get(self, digest: str) -> bytes | None:
        with self._lock:
            tar = self._entries.get(digest)
            if tar is not None:
                self._entries.move_to_end(digest)
            return tar

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    @property
    def bytes_held(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class WorkerdServer:
    """Serve one worker's launch data plane on a unix socket.

    ``engine`` must be the LOCAL view of the worker's daemon: the
    direct unix socket on a real host, ``FakeDriver.local_engine(i)``
    on the fake pod (pays injected faults, never the injected WAN rtt).
    ``driver`` is optional; when given, creates run the same
    pre/post-start bootstrap hooks the in-process scheduler wires.
    """

    def __init__(self, cfg, engine, *, worker_id: str = "worker",
                 sock_path=None, driver=None, seams=None,
                 flush_window_s: float = FLUSH_WINDOW_S):
        from . import socket_path as default_sock

        self.cfg = cfg
        self.engine = engine
        self.driver = driver
        self.worker_id = worker_id
        self.sock_path = (sock_path if sock_path is not None
                          else default_sock(cfg))
        self.seams = seams if seams is not None else NULL_SEAMS
        self.flush_window_s = flush_window_s
        self.executed: dict[tuple, str] = {}    # dedup: intent key -> state
        try:
            seed_cap = int(cfg.settings.workerd.seed_cache_bytes)
        except AttributeError:
            seed_cap = 64 * 1024 * 1024
        self.seeds = SeedStore(seed_cap)
        # distributed tracing (docs/tracing.md): worker-side phase
        # timings become real remote SpanRecords in a per-daemon flight
        # recorder; the cumulative clock offset to the root clock
        # arrives on resync frames and is stamped on every span as
        # ``skew_s`` so the merge's adjustment is auditable
        self.trace_skew_s = 0.0
        self.flight = None
        try:
            tele = cfg.settings.telemetry
            if tele.tracing.enable and tele.flight_recorder.enable:
                from pathlib import Path as _P

                from ..monitor.ledger import FLIGHT_DIR, FlightRecorder
                self.flight = FlightRecorder(
                    _P(cfg.logs_dir) / FLIGHT_DIR
                    / f"workerd-{worker_id}.jsonl",
                    max_bytes=tele.flight_recorder.max_bytes)
        except AttributeError:
            self.flight = None
        self.stats = {"intents": 0, "events": 0, "batches": 0,
                      "dedup_hits": 0, "resyncs": 0,
                      "seeds_stored": 0, "seed_hits": 0, "seed_misses": 0}
        self._q: queue.SimpleQueue = queue.SimpleQueue()   # the local lane
        self._events: collections.deque = collections.deque()
        self._ev_lock = threading.Lock()
        self._ev_cond = threading.Condition(self._ev_lock)
        self._sink: socket.socket | None = None   # the live event channel
        self._sink_lock = threading.Lock()        # guards the POINTER only
        self._write_lock = threading.Lock()       # serializes frame writes
        #   (a length-prefixed stream corrupts if two writers interleave).
        #   Kept separate from _sink_lock on purpose: a writer can block
        #   inside write_msg when the peer stalls, and drop_conns/stop
        #   must still be able to clear the pointer and shut the socket
        #   down -- the shutdown is what unblocks the writer
        self._listener: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()
        self._aborted = False
        self._waited: set[tuple[str, int]] = set()   # (cid, iteration)
        self._started_at = 0.0

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "WorkerdServer":
        rt = self.sock_path.parent
        rt.mkdir(parents=True, exist_ok=True)
        os.chmod(rt, 0o700)
        if self.sock_path.exists():
            if self._socket_answers():
                raise WorkerdError(
                    f"workerd already running on {self.sock_path}")
            self.sock_path.unlink()
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        old_umask = os.umask(0o177)     # cover the bind itself
        try:
            listener.bind(str(self.sock_path))
        finally:
            os.umask(old_umask)
        os.chmod(self.sock_path, 0o600)
        listener.listen(16)
        self._listener = listener
        self._started_at = time.monotonic()
        try:
            from . import pidfile_path, socket_path

            # only the canonical one-daemon-per-host deployment owns
            # the pidfile (the wedged-daemon stop fallback); in-process
            # pods on explicit sockets share a cfg and must not clobber
            if self.sock_path == socket_path(self.cfg):
                pidfile_path(self.cfg).parent.mkdir(parents=True,
                                                    exist_ok=True)
                pidfile_path(self.cfg).write_text(str(os.getpid()))
                self._owns_pidfile = True
        except OSError:
            pass        # never a startup requirement
        threading.Thread(target=self._lane, daemon=True,
                         name=f"workerd-lane-{self.worker_id}").start()
        threading.Thread(target=self._flusher, daemon=True,
                         name=f"workerd-flush-{self.worker_id}").start()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"workerd-accept-{self.worker_id}").start()
        log.info("workerd for %s listening on %s (pid %d)",
                 self.worker_id, self.sock_path, os.getpid())
        return self

    def _socket_answers(self) -> bool:
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(1.0)
                s.connect(str(self.sock_path))
                protocol.write_msg(s, {"type": "ping"})
                return protocol.read_msg(s).get("type") == "pong"
        except (OSError, ClawkerError):
            return False

    def stop(self) -> None:
        """Graceful stop: close the listener, unlink the socket, let the
        lane drain.  In-flight waiters die with the process; the
        scheduler's degrade path (direct polling) covers their exits."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._q.put(None)
        self._close_listener(unlink=True)
        self.drop_conns()
        with self._ev_cond:
            self._ev_cond.notify_all()
        if getattr(self, "_owns_pidfile", False):
            try:
                from . import pidfile_path

                pidfile_path(self.cfg).unlink(missing_ok=True)
            except OSError:
                pass
        if self.flight is not None:
            self.flight.close()
        log.info("workerd for %s stopped", self.worker_id)

    def kill(self) -> None:
        """Simulate daemon SIGKILL (the chaos ``workerd_kill`` fault):
        freeze execution and drop every connection mid-frame.  The
        socket FILE stays behind, exactly as a real SIGKILL leaves it --
        liveness probes read it as ``degraded``."""
        self._aborted = True
        self._stop.set()
        self._q.put(None)
        self._close_listener(unlink=False)
        self.drop_conns()
        with self._ev_cond:
            self._events.clear()        # a killed process loses its buffer
            self._ev_cond.notify_all()
        self.seeds.clear()              # ...and its in-memory seed store
        if self.flight is not None:
            # the recorder FILE stays behind (a real SIGKILL leaves it);
            # spans already flushed are the surviving trace segment, and
            # anything in flight is the gap the merge marks
            self.flight.close()

    def drop_conns(self) -> None:
        """Hard-drop every client connection (the chaos
        ``workerd_partition`` fault: the mux channel dies, the daemon
        lives).  Buffered events survive and flush after resync."""
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        with self._sink_lock:
            self._sink = None
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
                return
            if self._stop.is_set() or self._listener is None:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True, name="workerd-conn").start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(None)
            while not self._stop.is_set():
                try:
                    msg = protocol.read_msg(conn)
                except (protocol.ConnectionClosed, OSError):
                    return
                kind = msg.get("type", "")
                if kind == "hello":
                    # NOTE: the event sink opens at resync, not hello --
                    # the client's handshake reads deterministically
                    # (hello_ack, then events*, then resync_ack).  ``ts``
                    # turns the round-trip the client already pays into
                    # one clock-skew sample (docs/tracing.md#clock-skew)
                    self._reply(conn, {
                        "type": "hello_ack", "pid": os.getpid(),
                        "version": __version__, "worker": self.worker_id,
                        "ts": time.time()})
                elif kind == "ping":
                    self._reply(conn, {"type": "pong", "pid": os.getpid(),
                                       "worker": self.worker_id,
                                       "ts": time.time()})
                elif kind == "status":
                    self._reply(conn, self._status_doc())
                elif kind == "intents":
                    for intent in msg.get("batch") or []:
                        self._q.put(intent)
                elif kind == "resync":
                    self._handle_resync(conn, msg)
                elif kind == "shutdown":
                    self._reply(conn, {"type": "ok"})
                    threading.Thread(target=self.stop, daemon=True,
                                     name="workerd-shutdown").start()
                    return
                else:
                    self._reply(conn, {"type": "error",
                                       "error": f"unknown frame {kind!r}"})
        except (protocol.ProtocolError, OSError) as e:
            log.info("workerd connection dropped: %s", e)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            with self._sink_lock:
                if self._sink is conn:
                    self._sink = None
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, conn, doc: dict) -> None:
        # unary replies share the frame-write lock with the event
        # flusher: two writers interleaving a length-prefixed stream
        # would corrupt it for good
        with self._write_lock:
            protocol.write_msg(conn, doc)

    def _status_doc(self) -> dict:
        with self._ev_lock:
            buffered = len(self._events)
        return {
            "type": "status", "pid": os.getpid(), "version": __version__,
            "worker": self.worker_id, "socket": str(self.sock_path),
            "uptime_s": round(time.monotonic() - self._started_at, 1),
            "buffered_events": buffered,
            "seed_store_bytes": self.seeds.bytes_held,
            "seed_store_entries": len(self.seeds),
            **{k: v for k, v in self.stats.items()},
        }

    def undelivered(self) -> int:
        """Events still waiting for a live channel (chaos invariant: a
        healed link must drain this to zero)."""
        with self._ev_lock:
            return len(self._events)

    # ------------------------------------------------------------- resync

    def _handle_resync(self, conn, msg: dict) -> None:
        """The reconnect handshake: compare the scheduler's view of
        running iterations against local container reality.  Still
        running -> re-arm the exit waiter; stopped -> report the exit
        the partition swallowed.  The ack precedes the buffered-event
        flush so the client can fire ``workerd.post_reconnect`` at the
        boundary the events replay across."""
        self.stats["resyncs"] += 1
        if msg.get("clock_offset_s") is not None:
            # the client's cumulative estimate of THIS daemon's clock
            # offset to the root clock (upstream offsets chained in) --
            # stamped on every span this daemon records from here on
            try:
                self.trace_skew_s = float(msg["clock_offset_s"])
            except (TypeError, ValueError):
                pass
        with self._sink_lock:
            self._sink = conn
        healed = 0
        for entry in msg.get("running") or []:
            agent = str(entry.get("agent", ""))
            epoch = int(entry.get("epoch", 0))
            iteration = int(entry.get("iteration", 0))
            cid = str(entry.get("cid", ""))
            if not cid:
                continue
            try:
                info = self.engine.inspect_container(cid)
                state = info.get("State") or {}
                running = bool(state.get("Running"))
            except NotFoundError:
                self._emit({"ev": "exited", "agent": agent, "epoch": epoch,
                            "iteration": iteration, "code": None,
                            "detail": "container vanished"})
                healed += 1
                continue
            except ClawkerError:
                continue        # local engine hiccup: the waiter retries
            if running:
                self._arm_waiter(agent, epoch, iteration, cid)
            else:
                code = state.get("ExitCode")
                self._emit({"ev": "exited", "agent": agent, "epoch": epoch,
                            "iteration": iteration,
                            "code": int(code) if code is not None else None,
                            "detail": ("" if code is not None
                                       else "stopped without exit code")})
                healed += 1
        self._reply(conn, {"type": "resync_ack", "healed": healed,
                           "buffered": self.undelivered(),
                           "ts": time.time()})
        with self._ev_cond:
            self._ev_cond.notify_all()      # flush the link-down backlog

    # ----------------------------------------------------------- the lane

    def _lane(self) -> None:
        """The worker-local serial lane: every engine mutation this
        daemon performs runs here, in intent order -- the same
        serialization contract the scheduler's per-worker lanes give
        the direct path."""
        while not self._stop.is_set():
            intent = self._q.get()
            if intent is None:
                return
            try:
                self._execute(intent)
            except Exception:       # noqa: BLE001 -- the lane must live
                log.exception("workerd intent crashed: %r", intent)

    def _execute(self, intent: dict) -> None:
        kind = str(intent.get("kind", ""))
        seq = int(intent.get("seq", 0))
        agent = str(intent.get("agent", ""))
        epoch = int(intent.get("epoch", 0))
        iteration = int(intent.get("iteration", 0))
        if kind not in INTENT_KINDS:
            self._emit({"ev": "failed", "seq": seq, "phase": "dispatch",
                        "error": f"unknown intent kind {kind!r}",
                        "driverish": False})
            return
        if kind == "seed":
            # naturally idempotent (a content-addressed put): skips the
            # positional dedup table, whose (agent, epoch, iteration) key
            # is meaningless for a digest-keyed transfer
            self.stats["intents"] += 1
            _INTENTS.labels(self.worker_id, kind).inc()
            self._do_seed(intent, seq)
            return
        key = (kind, agent, epoch, iteration)
        if kind in ("launch", "start", "create") and key in self.executed:
            # idempotence: a re-sent intent (client retry across a
            # partition) must never double-create or double-start
            self.stats["dedup_hits"] += 1
            return
        while len(self.executed) >= DEDUP_KEYS_KEPT:
            # FIFO eviction (dict order = insertion order): retries only
            # ever re-send RECENT intents, so the oldest keys are dead
            self.executed.pop(next(iter(self.executed)))
        self.executed[key] = "running"
        self.stats["intents"] += 1
        _INTENTS.labels(self.worker_id, kind).inc()
        try:
            if kind == "launch":
                self._do_launch(intent, seq, agent, epoch, iteration)
            elif kind == "start":
                self._do_start(intent, seq, agent, epoch, iteration)
            elif kind == "create":
                self._do_create_only(intent, seq)
            elif kind == "adopt":
                self._arm_waiter(agent, epoch, iteration,
                                 str(intent.get("cid", "")),
                                 tp=str(intent.get("tp", "")))
            elif kind == "halt":
                self._do_halt(intent)
        finally:
            self.executed[key] = "done"

    def _runtime(self):
        from ..runtime.orchestrate import AgentRuntime

        if self.driver is None:
            # in-process pods (tests/bench/chaos): the plain create path
            return AgentRuntime(self.engine, self.cfg)
        from ..controlplane.bootstrap import (
            post_start_services,
            pre_start_services,
        )
        from ..fleet.channels import open_side_channels

        channels = None
        try:
            channels = open_side_channels(self.engine, self.cfg)
        except Exception as e:      # noqa: BLE001 -- channels are optional
            log.info("workerd side channels unavailable: %s", e)
        return AgentRuntime(
            self.engine, self.cfg,
            pre_start=lambda ref: pre_start_services(
                self.cfg, self.driver, ref),
            post_start=lambda ref: post_start_services(
                self.cfg, self.driver, ref),
            channels=channels)

    def _do_seed(self, intent: dict, seq: int) -> None:
        """Stage a workspace seed in the worker-local store.  The ONE
        WAN transfer per (digest, worker): every launch that references
        the digest afterwards fans out over the local engine socket."""
        digest = str(intent.get("digest", ""))
        try:
            tar = protocol.unb64(str(intent.get("tar", "")))
        except (ValueError, TypeError):
            self._emit({"ev": "failed", "seq": seq, "phase": "seed",
                        "error": "undecodable seed tar", "driverish": False})
            return
        if not digest or not tar:
            self._emit({"ev": "failed", "seq": seq, "phase": "seed",
                        "error": "seed intent missing digest or tar",
                        "driverish": False})
            return
        stored = self.seeds.put(digest, tar)
        if stored:
            self.stats["seeds_stored"] += 1
        self._emit({"ev": "seeded", "seq": seq, "digest": digest,
                    "bytes": len(tar), "stored": stored})

    def drop_seeds(self) -> None:
        """Evict the whole seed store (the chaos ``seed_cache_evict``
        fault): later launches referencing a digest degrade to the
        per-create fallback path, never to an error."""
        self.seeds.clear()

    def _opts(self, doc: dict):
        from ..runtime.orchestrate import CreateOptions

        seed_digest = str(doc.get("seed_digest", ""))
        seed_tar = None
        if seed_digest:
            seed_tar = self.seeds.get(seed_digest)
            self.stats["seed_hits" if seed_tar is not None
                       else "seed_misses"] += 1
        return CreateOptions(
            agent=str(doc.get("agent", "dev")),
            image=str(doc.get("image", "@")),
            env={str(k): str(v) for k, v in (doc.get("env") or {}).items()},
            tty=bool(doc.get("tty", False)),
            workspace_mode=str(doc.get("workspace_mode", "")),
            worker=str(doc.get("worker", self.worker_id)),
            loop_id=str(doc.get("loop_id", "")),
            extra_labels={str(k): str(v) for k, v in
                          (doc.get("extra_labels") or {}).items()},
            replace=bool(doc.get("replace", True)),
            seed_digest=seed_digest,
            seed_tar=seed_tar)

    def _do_launch(self, intent: dict, seq: int, agent: str, epoch: int,
                   iteration: int) -> None:
        """create (or warm-pool adopt) + first start + exit waiter: the
        whole burst the direct path paid O(engine calls) WAN RTTs for,
        executed against the local socket."""
        opts = self._opts(intent.get("opts") or {})
        rt = self._runtime()
        tp = str(intent.get("tp", ""))
        t0 = time.monotonic()
        t0_wall = time.time()
        cid = ""
        pool_hit = False
        pool_cid = str(intent.get("pool_cid", ""))
        pool_error = ""
        sid = self._span_id(tp)
        try:
            with self._engine_ctx(tp, agent, sid):
                if pool_cid:
                    try:
                        # analyze: allow(wal-before-mutation): workerd
                        # executes intents the scheduler journaled
                        # write-ahead (REC_PLACEMENT durable before
                        # dispatch) -- the WAL lives on the control-plane
                        # side of the channel
                        rt.adopt_pooled(pool_cid, opts)
                        cid = pool_cid
                        pool_hit = True
                    except ClawkerError as e:
                        pool_error = str(e)  # cold-create fallback below
                if not cid:
                    # analyze: allow(wal-before-mutation): intent WAL'd by
                    # the dispatching scheduler (see above)
                    cid = rt.create(opts)
        except ClawkerError as e:
            self._emit({"ev": "failed", "seq": seq, "phase": "create",
                        "error": str(e),
                        "driverish": isinstance(e, DriverError)})
            return
        self._emit({"ev": "created", "seq": seq, "cid": cid,
                    "pool": pool_hit, "pool_error": pool_error,
                    "ms": round((time.monotonic() - t0) * 1000, 3)})
        self._record_span(tp, SPAN_WORKERD_CREATE, agent, iteration,
                          t0_wall, time.time(), span_id=sid,
                          cid=cid, pool=pool_hit)
        self._start_cid(rt, seq, agent, epoch, iteration, cid, fresh=True,
                        state_doc=intent.get("state"), tp=tp)

    def _do_start(self, intent: dict, seq: int, agent: str, epoch: int,
                  iteration: int) -> None:
        cid = str(intent.get("cid", ""))
        rt = self._runtime()
        self._start_cid(rt, seq, agent, epoch, iteration, cid,
                        fresh=bool(intent.get("fresh", False)),
                        state_doc=intent.get("state"),
                        tp=str(intent.get("tp", "")))

    def _start_cid(self, rt, seq: int, agent: str, epoch: int,
                   iteration: int, cid: str, *, fresh: bool,
                   state_doc=None, tp: str = "") -> None:
        t0 = time.monotonic()
        t0_wall = time.time()
        sid = self._span_id(tp)
        try:
            with self._engine_ctx(tp, agent, sid):
                if state_doc:
                    # the per-iteration context file (scheduler's
                    # _write_iteration): advisory, never fatal
                    try:
                        # analyze: allow(wal-before-mutation): advisory
                        # write into a cid whose REC_CREATED the scheduler
                        # already journaled
                        self.engine.put_archive(
                            cid, str(state_doc.get("dir", "/run/clawker")),
                            protocol.unb64(str(state_doc.get("tar", ""))))
                    except ClawkerError:
                        pass
                if fresh:
                    # analyze: allow(wal-before-mutation): start intents
                    # are WAL'd scheduler-side before dispatch
                    # (docs/workerd.md)
                    rt.start(cid)
                else:
                    # analyze: allow(wal-before-mutation): same contract
                    # as the fresh branch above
                    self.engine.start_container(cid)
                    if rt.post_start:
                        rt.post_start(cid)
        except ClawkerError as e:
            self._emit({"ev": "failed", "seq": seq, "phase": "start",
                        "error": str(e),
                        "driverish": isinstance(e, DriverError)})
            return
        self._emit({"ev": "started", "seq": seq, "cid": cid,
                    "ms": round((time.monotonic() - t0) * 1000, 3)})
        self._record_span(tp, SPAN_WORKERD_START, agent, iteration,
                          t0_wall, time.time(), span_id=sid, cid=cid)
        self._arm_waiter(agent, epoch, iteration, cid, tp=tp)

    def _do_create_only(self, intent: dict, seq: int) -> None:
        """Warm-pool fill: the expensive create-time stages, no start."""
        opts = self._opts(intent.get("opts") or {})
        rt = self._runtime()
        t0 = time.monotonic()
        try:
            # analyze: allow(wal-before-mutation): pool-fill intents carry
            # a durable REC_POOL_ADD journaled by warmpool.begin_refill
            # before dispatch (docs/loop-warmpool.md)
            cid = rt.create(opts)
        except ClawkerError as e:
            self._emit({"ev": "failed", "seq": seq, "phase": "create",
                        "error": str(e),
                        "driverish": isinstance(e, DriverError)})
            return
        self._emit({"ev": "pool_ready", "seq": seq, "cid": cid,
                    "ms": round((time.monotonic() - t0) * 1000, 3)})

    def _do_halt(self, intent: dict) -> None:
        cid = str(intent.get("cid", ""))
        try:
            self.engine.stop_container(cid,
                                       timeout=int(intent.get("timeout", 2)))
        except ClawkerError:
            pass        # best effort, like the scheduler's own halts

    def _arm_waiter(self, agent: str, epoch: int, iteration: int,
                    cid: str, *, tp: str = "") -> None:
        """Local blocking wait -> unsolicited ``exited`` event.  The
        waiter is worker-resident, so an iteration's whole execute
        window costs the WAN nothing."""
        key = (cid, iteration)
        if not cid or key in self._waited:
            return
        self._waited.add(key)

        def wait() -> None:
            t0 = time.monotonic()
            t0_wall = time.time()
            code: int | None
            detail = ""
            try:
                code = int(self.engine.wait_container(cid))
            except NotFoundError:
                code, detail = None, "container vanished"
            except ClawkerError:
                # wait hiccup: one inspect decides (mirrors _read_exit)
                try:
                    state = self.engine.inspect_container(cid).get(
                        "State") or {}
                    raw = state.get("ExitCode")
                    code = int(raw) if raw is not None else None
                    detail = "" if raw is not None else \
                        "stopped without exit code"
                except ClawkerError as e:
                    code, detail = None, f"exit unreadable: {e}"
            self._waited.discard(key)
            self._emit({"ev": "exited", "agent": agent, "epoch": epoch,
                        "iteration": iteration, "code": code,
                        "detail": detail,
                        "wait_ms": round((time.monotonic() - t0) * 1000, 1)})
            self._record_span(
                tp, SPAN_WORKERD_WAIT, agent, iteration, t0_wall,
                time.time(), cid=cid,
                status="ok" if code == 0 else "failed")

        threading.Thread(target=wait, daemon=True,
                         name=f"workerd-wait-{cid[:12]}").start()

    # ------------------------------------------------------------ events

    def _record_span(self, tp: str, name: str, agent: str, iteration: int,
                     t_start: float, t_end: float, *, status: str = "ok",
                     span_id: str = "", **attrs) -> None:
        """One remote SpanRecord into the per-daemon flight recorder.
        ``tp`` is the intent's propagated traceparent (trace id = the
        run id; span id = the upstream parent, often "" because the
        scheduler opens the iteration root only when the created event
        lands -- the merge then attaches by (agent, iteration)).  An
        explicit ``span_id`` lets the engine-context path pre-announce
        this span's id to its own children.  No recorder / no context =
        no work."""
        if self.flight is None or self._aborted or not tp:
            return
        from ..telemetry.spans import SpanRecord
        from ..tracing.context import TraceContext
        from ..util import ids

        ctx = TraceContext.from_header(tp)
        if ctx is None:
            return
        self.flight.append(SpanRecord(
            trace_id=ctx.trace_id, span_id=span_id or ids.short_id(16),
            parent_id=ctx.span_id, name=name, agent=agent,
            worker=self.worker_id, t_start=t_start, t_end=t_end,
            status=status,
            attrs={"iteration": iteration,
                   "skew_s": round(self.trace_skew_s, 6),
                   **attrs}).to_json())

    def _span_id(self, tp: str) -> str:
        """Pre-generated span id for a phase about to run, or "" when
        its span would not record anyway."""
        if self.flight is None or self._aborted or not tp:
            return ""
        from ..util import ids
        return ids.short_id(16)

    def _engine_ctx(self, tp: str, agent: str, span_id: str):
        """Ambient trace context around one phase's LOCAL engine work:
        httpapi records ``engine.request`` children into this daemon's
        recorder, parented to the phase span whose id was pre-generated
        via :meth:`_span_id` and recorded when the phase ends."""
        if not span_id:
            return contextlib.nullcontext()
        from ..tracing.context import TraceContext, use

        ctx = TraceContext.from_header(tp)
        if ctx is None:
            return contextlib.nullcontext()
        return use(TraceContext(ctx.trace_id, span_id, agent=agent,
                                worker=self.worker_id,
                                sink=self._engine_sink))

    def _engine_sink(self, rec) -> None:
        if self.flight is None or self._aborted:
            return
        doc = rec.to_json()
        doc["attrs"] = {"skew_s": round(self.trace_skew_s, 6),
                        **doc["attrs"]}
        self.flight.append(doc)

    def _emit(self, ev: dict) -> None:
        if self._aborted:
            return      # a killed daemon publishes nothing
        self.stats["events"] += 1
        _EVENTS.labels(self.worker_id, str(ev.get("ev", "?"))).inc()
        with self._ev_cond:
            if len(self._events) >= EVENT_BUFFER:
                # bound the link-down backlog; exits dropped here are
                # re-derived by resync (engine state is the authority)
                self._events.popleft()
                _BUFFERED_DROPS.labels(self.worker_id).inc()
            self._events.append(ev)
            self._ev_cond.notify_all()

    def _flusher(self) -> None:
        """Coalesce buffered events into one frame per flush window --
        the O(1)-round-trips-per-batch half of the contract."""
        while not self._stop.is_set():
            with self._ev_cond:
                while not self._events and not self._stop.is_set():
                    self._ev_cond.wait(0.5)
                if self._stop.is_set():
                    return
            # coalesce: events landing inside the window join this batch
            if self.flush_window_s > 0:
                time.sleep(self.flush_window_s)
            with self._sink_lock:
                sink = self._sink
            if sink is not None:
                with self._ev_cond:
                    batch = list(self._events)
                    self._events.clear()
                if batch:
                    try:
                        with self._write_lock:
                            protocol.write_msg(
                                sink, {"type": "events", "batch": batch})
                        self.stats["batches"] += 1
                        _BATCHES.labels(self.worker_id).inc()
                    except (OSError, ClawkerError):
                        # channel died mid-write: put the batch back
                        # in order; resync will re-open the sink
                        with self._ev_cond:
                            self._events.extendleft(reversed(batch))
                        with self._sink_lock:
                            if self._sink is sink:
                                self._sink = None
            if self._sink is None:
                # link down: wait for a resync instead of spinning
                with self._ev_cond:
                    self._ev_cond.wait(0.05)
