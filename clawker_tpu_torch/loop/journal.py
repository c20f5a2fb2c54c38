"""Durable run journal: the loop scheduler's write-ahead log.

The port's copy of ``clawker_tpu/loop/journal.py``, whole.

The scheduler's whole fleet state -- placements, iteration counts, exit
histories -- used to live in one CLI process: a killed ``clawker loop``
(OOM, SIGKILL, host reboot, dropped SSH session) evaporated it while
the agent containers kept running on the workers.  The journal makes
scheduler death survivable: every state transition is appended as one
JSONL record to ``logs/runs/<run>.journal`` *before* the engine call it
describes, and ``clawker loop --resume <run>`` replays the file into a
:class:`RunImage` that the scheduler reconciles against what is
actually running on each worker (docs/loop-resume.md).

Durability model -- **fsync-batched write-ahead**:

- Every append is written + flushed immediately (the OS has it even if
  the CLI dies; only a host crash can lose an unsynced tail).
- Records that gate *idempotent rediscovery* (``placement`` before a
  create is submitted, ``created`` once the engine returned a container
  id) are appended ``durable=True``: the append fsyncs before
  returning, and -- group commit -- that one fsync also covers every
  batched record written before it by any thread.
- Bookkeeping records (``started``/``exited``/...) batch: they fsync
  every ``fsync_batch_n`` records or ``fsync_interval_s`` seconds,
  whichever comes first.  Losing such a tail is safe because the
  reconcile pass re-derives the same facts from engine container state.

The read side rides the shared crash-tolerant tail-reader
(:func:`~clawker_tpu.monitor.ledger.read_jsonl`): a writer killed
mid-line degrades to "one torn record skipped", identically to the
flight recorder.  Every record is checksummed by the shared writer
(``monitor.ledger.encode_record``); the durable replay fold reads the
*verified prefix* and flags mid-file damage instead of folding past it
(docs/durability.md).

Fail-loud durability contract (docs/durability.md): every append
returns an :class:`AppendReceipt`; a write or fsync failure POISONS
the handle -- fsync is never retried on the same fd (a failed fsync
may have dropped the dirty pages and reports the error exactly once:
retrying would false-succeed).  Recovery reopens a fresh fd and
re-appends the unsynced records held in a small in-memory ring.  Every
fault surfaces through the ``on_fault`` callback, the
``storage_journal_*`` metrics, and the receipt -- a journal can
degrade, but never silently.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .. import telemetry
from ..capacity import (
    REC_CAPACITY_POOL,
    REC_CAPACITY_QUEUE,
    REC_CAPACITY_SCALE,
    REC_CAPACITY_TOKENS,
)
from ..errors import ClawkerError
from ..monitor.ledger import (
    IntegrityReport,
    encode_record,
    flight_path,
    read_jsonl,
    read_verified_prefix,
)

# storage-fault telemetry (docs/durability.md, docs/telemetry.md): the
# no-silent-drop invariant audits these -- any dropped or poisoned
# write MUST move a counter
_FAULTS = telemetry.counter(
    "storage_journal_faults_total",
    "journal storage faults (failed open/write/fsync/close)",
    labels=("op",))
_DROPPED = telemetry.counter(
    "storage_journal_dropped_total",
    "journal records dropped: never written durably, lost to the run")
_RECOVERIES = telemetry.counter(
    "storage_journal_recoveries_total",
    "poisoned-handle recoveries (reopen + re-append of the unsynced ring)")

RUNS_DIR = "runs"               # under Config.logs_dir

# record kinds (the `kind` field of every journal record)
REC_RUN = "run"                 # run header: spec + worker set
REC_PLACEMENT = "placement"     # agent placed on a worker (pre-create WAL)
REC_ADMIT_QUEUED = "admission_queued"  # launch entered the admission queue
#                                 (pre-submit WAL: --resume rebuilds the
#                                 pending queue in this order)
REC_CREATED = "created"         # engine returned a container id
REC_STARTED = "started"         # iteration N started executing
REC_EXITED = "exited"           # iteration N's exit accounted
REC_ORPHANED = "orphaned"       # worker died under the loop
REC_MIGRATED = "migrated"       # failover moved the loop src -> dst
REC_ADOPTED = "adopted"         # resume adopted a still-running container
REC_GHOST = "ghost"             # resume swept an unjournaled leftover
REC_LOOP_END = "loop_end"       # terminal loop status (done|failed|stopped)
REC_SHUTDOWN = "shutdown"       # clean scheduler drain (SIGINT/SIGTERM/stop)
REC_RESUME = "resume"           # a --resume generation picked the run up
REC_STORAGE_FAULT = "storage_fault"  # durable-append fault: the run is in
#                                 degraded-durability state from here on
#                                 (docs/durability.md) -- best-effort
#                                 record; the fault also surfaces via
#                                 metric + storage.fault event even when
#                                 the journal itself cannot take this
# warm-pool membership (docs/loop-warmpool.md): journaled write-ahead so
# --resume adopts still-usable pool members back into the pool and
# sweeps the rest -- a pre-created container must never leak as an
# untracked ghost just because the scheduler died mid-fill
REC_POOL_ADD = "pool_add"       # refill admitted (pre-create WAL)
REC_POOL_READY = "pool_ready"   # pool member created; cid known
REC_POOL_ADOPT = "pool_adopt"   # member consumed by a placement (pre-
#                                 finalize WAL: `by` names the adopter)
REC_POOL_REMOVE = "pool_remove"  # member recycled/swept/drained
# workspace-seed / worktree provisioning (docs/loop-worktrees.md):
# journaled write-ahead so --resume re-attaches agent worktrees and
# re-serves cached seeds with zero duplicate branch creates, clones, or
# seed transfers after a mid-provision SIGKILL
REC_SEED_TAR = "seed_tar"       # seed tar built: digest + byte count
#                                 (pre-transfer WAL for the fan-out)
REC_SEED_SHIP = "seed_ship"     # seed shipped to a worker's seed store
#                                 (pre-send WAL: at most one per
#                                 (digest, worker) pair per generation)
REC_SEED_WORKTREE = "seed_worktree"  # agent worktree provisioned:
#                                 branch + path (pre-`worktree add` WAL)
# gitguard (clawker_tpu/gitguard, docs/git-policy.md): the git-protocol
# firewall for worktree swarms.  Rule installs are journaled
# write-ahead so a --resume (or post-SIGKILL cleanup) tears down
# exactly the run-scoped egress rules this run added -- never a user's
# standing rules; every proxy verdict lands as a decision record, the
# evidence stream the chaos ref-isolation-at-proxy invariant audits.
REC_GITGUARD_RULES = "gitguard_rules"      # run-scoped git egress rules
#                                 installed (pre-add WAL: rule keys)
REC_GITGUARD_DECISION = "gitguard_decision"  # one proxy verdict
#                                 (allow/deny/down_refused + ref/agent)
# elastic-capacity decisions (clawker_tpu/capacity,
# docs/elastic-capacity.md): pool targets, token caps, queue-mode
# flips, and fleet provision/drain -- journaled through the same WAL so
# --resume restores the controller's state and the chaos
# stranded-by-drain invariant can audit every drain against the
# placements live at that point in the record stream.  The kind
# constants live in the capacity package (rank 2) and are re-exported
# here for replay's convenience.


def journal_path(logs_dir: Path, run_id: str) -> Path:
    """Canonical journal path for one loop run."""
    return Path(logs_dir) / RUNS_DIR / f"{run_id}.journal"


class JournalUnhealthy(ClawkerError):
    """A durable journal append could not be made durable (failed
    write or fsync, handle poisoned, recovery failed).  Raised by
    callers that run ``loop.journal.on_fault: fail`` -- the WAL
    contract is load-bearing there, so the run fail-stops rather than
    running on without its crash evidence."""


@dataclass(frozen=True)
class AppendReceipt:
    """What one :meth:`RunJournal.append` actually achieved.

    ``ok``: the record is written + flushed on a healthy fd (the OS has
    it; only a host crash can lose it).  ``synced``: the record is
    covered by a successful fsync -- for ``durable=True`` appends this
    is THE contract bit; a durable receipt with ``synced=False`` means
    the write-ahead promise is broken and the caller must react
    (docs/durability.md degrade matrix)."""

    ok: bool
    synced: bool
    seq: int = 0
    error: str = ""

    def require_durable(self) -> "AppendReceipt":
        """Raise :class:`JournalUnhealthy` unless the record is synced
        (the ``on_fault: fail`` consumption path)."""
        if not self.synced:
            raise JournalUnhealthy(
                f"durable journal append failed: {self.error or 'unsynced'}")
        return self


# a receipt for appends against a disabled/absent journal: the run
# carries no WAL, so there is no durability contract to break
NO_JOURNAL_RECEIPT = AppendReceipt(ok=True, synced=True, seq=0)


def receipt_synced(rcpt) -> bool:
    """Durability verdict of a ``journal(...)`` hook result.

    Subsystems that take an injected journal callable (warm pool,
    capacity controller) consume the result through this: a real
    :class:`AppendReceipt` answers with its ``synced`` bit; ``None``
    (the no-journal default hook) means there is no WAL and therefore
    no durability contract to break."""
    return rcpt is None or bool(getattr(rcpt, "synced", True))


@dataclass(frozen=True)
class JournalFault:
    """One storage fault, as handed to the ``on_fault`` callback (and
    folded into ``storage.fault`` bus events by the scheduler)."""

    op: str                     # open | write | fsync | close
    error: str
    recovered: bool             # reopen + re-append made the data safe
    dropped: int                # records lost to this fault


_RING_MAX = 256                 # unsynced-record ring bound (fsync every
#                                 8 records / 0.25s keeps it tiny; the cap
#                                 only guards a pathological config)
_REOPEN_BACKOFF_S = 1.0         # unhealthy-journal reopen retry cadence


class RunJournal:
    """Append-only JSONL write-ahead journal for one loop run.

    Thread-safe: lane threads, waiter threads, and the run thread all
    append.  ``seq`` totally orders records even when ``ts`` ties.

    Fault semantics (docs/durability.md): every append returns an
    :class:`AppendReceipt`.  A failed write or fsync poisons the
    current fd -- fsync is NEVER retried on the same handle -- and
    recovery reopens the path, newline-terminates any torn partial
    line, re-appends the unsynced in-memory ring, and fsyncs the fresh
    fd.  If recovery fails the journal turns unhealthy: appends drop
    (loudly: counted, receipted, ``on_fault``-notified) until a later
    append's lazy reopen succeeds -- e.g. after the disk-pressure GC
    freed space.  ``on_fault`` is invoked outside the journal lock.
    """

    def __init__(self, path: Path, *, fsync_batch_n: int = 8,
                 fsync_interval_s: float = 0.25, clock=time.time,
                 on_fault=None):
        self.path = Path(path)
        self.fsync_batch_n = max(1, int(fsync_batch_n))
        self.fsync_interval_s = float(fsync_interval_s)
        self._clock = clock
        self.on_fault = on_fault
        self._lock = threading.Lock()
        self._seq = 0
        self._seq_scanned = False
        self._pending = 0           # records flushed but not yet fsynced
        self._last_sync = 0.0
        self._ring: list[tuple[int, str]] = []  # unsynced (seq, line)
        self._reopen_at = 0.0       # monotonic gate for lazy reopen
        self._last_error = ""
        self.dropped = 0
        self.faults = 0
        self.recoveries = 0
        self.poisoned = 0           # fds abandoned after a fsync fault
        self._closed = False
        self._closed_bad = False    # closed while (or by) failing
        self._fh = None
        if not self._open_locked():
            self._note_fault(JournalFault(
                "open", self._last_error, False, 0))

    # ------------------------------------------------------------ plumbing

    @property
    def healthy(self) -> bool:
        """Open: a live fd.  Closed: whether the journal ENDED with its
        contract intact -- a cleanly-closed journal is not "unhealthy"
        just because the run finished (the post-run ``--json`` summary
        reads this after close)."""
        if self._closed:
            return not self._closed_bad
        return self._fh is not None

    @property
    def last_error(self) -> str:
        return self._last_error

    def _note_fault(self, fault: JournalFault) -> None:
        """Count + surface one fault.  Called OUTSIDE self._lock (the
        callback may take scheduler locks / emit events)."""
        self.faults += 1
        _FAULTS.labels(fault.op).inc()
        if self.on_fault is not None:
            try:
                self.on_fault(fault)
            except Exception:   # noqa: BLE001 -- fault surfacing must
                pass            # never compound the fault

    @staticmethod
    def _fsync_fh(fh) -> None:
        """fsync through the handle when it knows how (the chaos
        FaultFS shim intercepts here), else through its fileno."""
        fsync = getattr(fh, "fsync", None)
        if callable(fsync):
            fsync()
        else:
            os.fsync(fh.fileno())

    def _open_locked(self) -> bool:
        """(Re)open the journal file; continue seq from the on-disk
        tail exactly once (resume generations REOPEN the dead run's
        journal: restarting seq would interleave generations)."""
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        except OSError as e:
            self._fh = None
            self._last_error = str(e) or type(e).__name__
            self._reopen_at = time.monotonic() + _REOPEN_BACKOFF_S
            return False
        if not self._seq_scanned:
            self._seq_scanned = True
            for rec in read_jsonl(self.path):
                seq = rec.get("seq", 0)
                if isinstance(seq, (int, float)) and int(seq) > self._seq:
                    self._seq = int(seq)
        return True

    def _write_locked(self, line: str) -> str:
        """Write + flush one line on the current fd; '' or the error."""
        try:
            self._fh.write(line + "\n")
            self._fh.flush()
            return ""
        except OSError as e:
            return str(e) or type(e).__name__

    def _recover_locked(self) -> bool:
        """Abandon the poisoned fd, rebuild on a fresh one: reopen,
        newline-terminate any torn partial line, re-append every
        unsynced ring record, fsync the NEW fd.  Never retries fsync
        on the old handle -- a failed fsync reports once and may have
        dropped the dirty pages; retrying would false-succeed."""
        old, self._fh = self._fh, None
        self.poisoned += 1
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        try:
            fh = open(self.path, "a", encoding="utf-8")
        except OSError as e:
            self._last_error = str(e) or type(e).__name__
            self._reopen_at = time.monotonic() + _REOPEN_BACKOFF_S
            return False
        try:
            # a blank line is skipped by every reader: it terminates a
            # possibly-torn partial line so re-appends stay parseable
            fh.write("\n")
            for _seq, line in self._ring:
                fh.write(line + "\n")
            fh.flush()
            self._fsync_fh(fh)
        except OSError as e:
            self._last_error = str(e) or type(e).__name__
            try:
                fh.close()
            except OSError:
                pass
            self._reopen_at = time.monotonic() + _REOPEN_BACKOFF_S
            return False
        self._fh = fh
        self._ring.clear()
        self._pending = 0
        self._last_sync = time.monotonic()
        self.recoveries += 1
        _RECOVERIES.inc()
        return True

    def _fsync_locked(self, now: float) -> JournalFault | None:
        """Group-commit fsync; on failure the fd is poisoned and
        recovery (reopen + re-append the ring) runs immediately.
        Returns the fault to surface, or None on clean success."""
        try:
            self._fsync_fh(self._fh)
        except OSError as e:
            err = str(e) or type(e).__name__
            if self._recover_locked():
                return JournalFault("fsync", err, True, 0)
            lost = len(self._ring)
            self._ring.clear()
            self._pending = 0
            self.dropped += lost
            if lost:
                _DROPPED.inc(lost)
            return JournalFault("fsync", err, False, lost)
        self._pending = 0
        self._ring.clear()
        self._last_sync = now
        return None

    # ------------------------------------------------------------- append

    def append(self, kind: str, *, durable: bool = False,
               **fields) -> AppendReceipt:
        """Append one record; with ``durable`` the record (and every
        batched record before it) is fsynced before returning.  The
        receipt says what actually happened -- durable call sites must
        consume it (the ``durable-append-checked`` analyzer enforces
        this)."""
        fault: JournalFault | None = None
        with self._lock:
            now = time.monotonic()
            if self._fh is None and now >= self._reopen_at:
                self._open_locked()
            if self._fh is None:
                self.dropped += 1
                _DROPPED.inc()
                err = self._last_error or "journal unavailable"
                fault = JournalFault("write", err, False, 1)
                receipt = AppendReceipt(False, False, 0, error=err)
            else:
                self._seq += 1
                seq = self._seq
                rec = {"kind": kind, "seq": seq, "ts": self._clock(),
                       **fields}
                line = encode_record(rec)
                err = self._write_locked(line)
                if err:
                    # the fd may hold a torn half-line: rebuild on a
                    # fresh fd with this record riding the ring
                    self._ring.append((seq, line))
                    if self._recover_locked():
                        fault = JournalFault("write", err, True, 0)
                        receipt = AppendReceipt(True, True, seq, error=err)
                    else:
                        self._ring.pop()
                        self.dropped += 1
                        _DROPPED.inc()
                        fault = JournalFault("write", err, False, 1)
                        receipt = AppendReceipt(False, False, seq,
                                                error=err)
                else:
                    self._ring.append((seq, line))
                    if len(self._ring) > _RING_MAX:
                        del self._ring[0]
                    self._pending += 1
                    if (durable or self._pending >= self.fsync_batch_n
                            or now - self._last_sync
                            >= self.fsync_interval_s):
                        fault = self._fsync_locked(now)
                        if fault is None:
                            receipt = AppendReceipt(True, True, seq)
                        elif fault.recovered:
                            receipt = AppendReceipt(True, True, seq,
                                                    error=fault.error)
                        else:
                            receipt = AppendReceipt(
                                False, False, seq, error=fault.error)
                    else:
                        receipt = AppendReceipt(True, False, seq)
        if fault is not None:
            self._note_fault(fault)
        return receipt

    def sync(self) -> bool:
        """Force the batched tail to disk (graceful-shutdown barrier).
        True when everything previously appended is now durable."""
        fault: JournalFault | None = None
        with self._lock:
            if self._fh is None:
                return not self._ring and not self._pending
            if self._pending:
                fault = self._fsync_locked(time.monotonic())
        if fault is not None:
            self._note_fault(fault)
            return fault.recovered
        return True

    def close(self) -> None:
        """Final-sync + close.  The lock covers the WHOLE close (a
        concurrent append can never race the handoff), and a failed
        final fsync is reported like any other fault -- with its drop
        count -- instead of being swallowed."""
        fault: JournalFault | None = None
        with self._lock:
            already, self._closed = self._closed, True
            fh, self._fh = self._fh, None
            self._reopen_at = float("inf")  # closed: no lazy reopen
            pending, self._pending = self._pending, 0
            ring = list(self._ring)
            self._ring.clear()
            if fh is not None:
                err = ""
                if pending:
                    try:
                        self._fsync_fh(fh)
                        ring = []
                    except OSError as e:
                        err = str(e) or type(e).__name__
                try:
                    fh.close()
                except OSError as e:
                    err = err or str(e) or type(e).__name__
                if err and ring:
                    # last-ditch recovery on a fresh fd: the unsynced
                    # tail is the part of the WAL a resume needs most
                    lost = len(ring)
                    try:
                        nfh = open(self.path, "a", encoding="utf-8")
                        nfh.write("\n")
                        for _seq, line in ring:
                            nfh.write(line + "\n")
                        nfh.flush()
                        self._fsync_fh(nfh)
                        nfh.close()
                        lost = 0
                    except OSError:
                        pass
                    if lost:
                        self.dropped += lost
                        _DROPPED.inc(lost)
                        fault = JournalFault("close", err, False, lost)
                    else:
                        self.recoveries += 1
                        _RECOVERIES.inc()
                        fault = JournalFault("close", err, True, 0)
                elif err:
                    fault = JournalFault("close", err, False, 0)
            elif not already:
                # closing a journal that was already fault-poisoned
                # (no live fd): it ends unhealthy, visibly
                self._closed_bad = True
        if fault is not None:
            if not fault.recovered:
                self._closed_bad = True
            self._note_fault(fault)

    @staticmethod
    def read(path: Path) -> list[dict]:
        """Every parseable record, skipping a truncated tail (shared
        crash-tolerant reader -- monitor.ledger.read_jsonl), deduped
        by ``seq``."""
        return dedupe_by_seq(read_jsonl(path))

    @staticmethod
    def read_verified(path: Path) -> tuple[list[dict], IntegrityReport]:
        """The verified prefix + integrity report: what a ``--resume``
        durable fold reconciles from.  A damaged mid-file record stops
        the fold at the last verified record and flags it -- replaying
        past corruption would reconcile against fiction."""
        records, report = read_verified_prefix(path)
        return dedupe_by_seq(records), report


def dedupe_by_seq(records: list[dict]) -> list[dict]:
    """Drop re-appended duplicates, keeping FIRST occurrence per seq.

    A failed write or fsync poisons the journal fd and recovery
    re-appends the whole unsynced ring onto a fresh one
    (:meth:`RunJournal._recover_locked`) -- but a record written and
    flushed *before* the fault may already be in the file, and after a
    failed fsync there is no way to know which dirty pages survived.
    Exactly-once on disk is therefore impossible; the contract is
    at-least-once on disk, exactly-once at read, keyed by the ``seq``
    every record carries (seq continues across resume generations, so
    first-wins never collapses two real records).  Legacy records
    without a seq pass through untouched."""
    seen: set[int] = set()
    out: list[dict] = []
    for rec in records:
        seq = rec.get("seq")
        if isinstance(seq, int):
            if seq in seen:
                continue
            seen.add(seq)
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# replay: journal records -> the run image --resume reconciles from
# --------------------------------------------------------------------------

# statuses a resume picks back up ("stopped" is the clean-drain state --
# resuming after a graceful Ctrl-C is the whole point of journaling it)
RESUMABLE_STATUSES = ("pending", "running", "orphaned", "stopped")


@dataclass
class LoopImage:
    """One agent loop's journaled state, folded to the latest record."""

    agent: str
    worker: str = ""
    epoch: int = 0
    iteration: int = 0
    exit_codes: list[int] = field(default_factory=list)
    consecutive_failures: int = 0
    status: str = "pending"
    container_id: str = ""
    started: bool = False       # current iteration journaled as started
    migrations: int = 0
    abandoned: list[tuple[str, str]] = field(default_factory=list)

    @property
    def resumable(self) -> bool:
        return self.status in RESUMABLE_STATUSES


@dataclass
class PoolImage:
    """One warm-pool member's journaled state, folded to the latest
    record.  ``pending`` = admitted but never created (mid-refill
    crash); ``ready`` = created and adoptable; ``adopted`` /
    ``removed`` = consumed -- reconcile must not hand it out again."""

    agent: str                  # pool placeholder agent name
    worker: str = ""
    cid: str = ""
    state: str = "pending"      # pending | ready | adopted | removed
    adopted_by: str = ""


@dataclass
class RunImage:
    """A whole run's journaled state: what replay() hands the scheduler."""

    run_id: str = ""
    project: str = ""
    spec: dict = field(default_factory=dict)
    workers: list[str] = field(default_factory=list)
    loops: dict[str, LoopImage] = field(default_factory=dict)
    pool: dict[str, PoolImage] = field(default_factory=dict)
    clean_shutdown: bool = False
    generation: int = 0         # how many resumes already hit this run
    capacity: dict = field(default_factory=dict)
    #                             latest elastic-capacity controller
    #                             state: {pool_targets, token_caps,
    #                             queue_modes, drained} -- what a resume
    #                             hands CapacityController.restore()
    queued_order: list[str] = field(default_factory=list)
    #                             agents whose latest launch entered the
    #                             admission queue but never reached a
    #                             create/adopt/terminal record, in queue
    #                             order -- what --resume re-enqueues
    #                             FIRST so pending-queue order survives
    #                             a scheduler death
    seeds: dict[str, int] = field(default_factory=dict)
    #                             workspace seed digests built this run
    #                             (digest -> tar byte count): resume can
    #                             tell a re-build from a first build
    seeded: dict[str, list[str]] = field(default_factory=dict)
    #                             digest -> workers whose seed store
    #                             holds (or was mid-receiving) that
    #                             seed -- resume must not re-ship, just
    #                             re-verify (docs/loop-worktrees.md)
    worktrees: dict[str, dict] = field(default_factory=dict)
    #                             agent -> {path, branch, base}: every
    #                             worktree whose provision was journaled
    #                             write-ahead; resume RE-ATTACHES these
    #                             via the idempotent setup_worktree path
    #                             instead of creating duplicates
    gitguard_rules: list[str] = field(default_factory=list)
    #                             egress rule keys this run installed for
    #                             the gitguard lane (pre-add WAL): resume
    #                             re-arms teardown for exactly these keys
    gitguard_decisions: dict[str, int] = field(default_factory=dict)
    #                             verdict -> count folded from decision
    #                             records (status/summary surfaces)
    storage_faults: int = 0
    #                             journaled durable-append faults: > 0
    #                             means the run ran degraded at some
    #                             point and the journal may be missing
    #                             records (docs/durability.md) -- a
    #                             resume reconciles extra-carefully and
    #                             surfaces the degradation


def replay(records: list[dict]) -> RunImage:
    """Fold journal records (in FILE order) into a :class:`RunImage`.

    File order is chronological by construction -- the journal is
    append-only under one lock, across resume generations too -- so no
    re-sort happens here (sorting by ``seq`` would interleave a journal
    whose earlier generations were written by a pre-continuation-seq
    writer).  Tolerant by design: unknown kinds are skipped (a newer
    CLI's journal must still resume under an older one as far as it
    can), and every field read is defaulted -- a torn record that parsed
    as JSON but lost fields must not kill the replay.  Re-appended
    recovery duplicates fold once (:func:`dedupe_by_seq`) no matter
    which reader produced ``records``.
    """
    img = RunImage()
    for rec in dedupe_by_seq(records):
        kind = rec.get("kind", "")
        if kind == REC_RUN:
            img.run_id = str(rec.get("run", ""))
            img.project = str(rec.get("project", ""))
            img.spec = dict(rec.get("spec") or {})
            img.workers = [str(w) for w in rec.get("workers") or []]
            continue
        if kind == REC_SHUTDOWN:
            img.clean_shutdown = True
            continue
        if kind == REC_RESUME:
            img.generation = int(rec.get("generation", img.generation + 1))
            continue
        if kind == REC_STORAGE_FAULT:
            img.storage_faults += 1
            continue
        if kind in (REC_CAPACITY_POOL, REC_CAPACITY_TOKENS,
                    REC_CAPACITY_QUEUE, REC_CAPACITY_SCALE):
            # capacity decisions fold latest-wins into their own table:
            # a resume restores the controller where it left off
            cap = img.capacity
            wid = str(rec.get("worker", ""))
            if kind == REC_CAPACITY_POOL and wid:
                cap.setdefault("pool_targets", {})[wid] = int(
                    rec.get("target", 0))
            elif kind == REC_CAPACITY_TOKENS and wid:
                cap.setdefault("token_caps", {})[wid] = int(
                    rec.get("cap", 0))
            elif kind == REC_CAPACITY_QUEUE and wid:
                cap.setdefault("queue_modes", {})[wid] = (
                    float(rec.get("retry_after_s", 0.0))
                    if str(rec.get("mode", "")) == "reject" else 0.0)
            elif kind == REC_CAPACITY_SCALE:
                if str(rec.get("action", "")) != "drain" or not wid:
                    continue
                phase = str(rec.get("phase", ""))
                pending = cap.setdefault("pending_drain", [])
                if phase in ("blocked", "intent"):
                    if wid not in pending:
                        pending.append(wid)
                elif phase in ("done", "failed"):
                    if wid in pending:
                        pending.remove(wid)
                    if phase == "done":
                        cap.setdefault("drained", []).append(wid)
            continue
        if kind == REC_SEED_TAR:
            digest = str(rec.get("digest", ""))
            if digest:
                img.seeds[digest] = int(rec.get("bytes", 0))
            continue
        if kind == REC_SEED_SHIP:
            digest = str(rec.get("digest", ""))
            wid = str(rec.get("worker", ""))
            if digest and wid:
                shipped = img.seeded.setdefault(digest, [])
                if wid not in shipped:
                    shipped.append(wid)
            continue
        if kind == REC_SEED_WORKTREE:
            # worktree provisioning is keyed by agent but must NOT
            # materialize a LoopImage -- provisioning precedes placement
            wa = str(rec.get("agent", ""))
            if wa:
                img.worktrees[wa] = {
                    "path": str(rec.get("path", "")),
                    "branch": str(rec.get("branch", "")),
                    "base": str(rec.get("base", "")),
                }
            continue
        if kind == REC_GITGUARD_RULES:
            for key in rec.get("keys") or []:
                if str(key) not in img.gitguard_rules:
                    img.gitguard_rules.append(str(key))
            continue
        if kind == REC_GITGUARD_DECISION:
            verdict = str(rec.get("verdict", "")) or "unknown"
            img.gitguard_decisions[verdict] = (
                img.gitguard_decisions.get(verdict, 0) + 1)
            continue
        if kind in (REC_POOL_ADD, REC_POOL_READY, REC_POOL_ADOPT,
                    REC_POOL_REMOVE):
            # pool members fold into their own table -- their placeholder
            # agent names must never materialize as loops
            pa = str(rec.get("agent", ""))
            if not pa:
                continue
            member = img.pool.setdefault(pa, PoolImage(agent=pa))
            member.worker = str(rec.get("worker", member.worker))
            if kind == REC_POOL_READY:
                member.cid = str(rec.get("cid", member.cid))
                member.state = "ready"
            elif kind == REC_POOL_ADOPT:
                member.cid = str(rec.get("cid", member.cid))
                member.state = "adopted"
                member.adopted_by = str(rec.get("by", ""))
            elif kind == REC_POOL_REMOVE:
                member.state = "removed"
            continue
        agent = str(rec.get("agent", ""))
        if not agent:
            continue
        loop = img.loops.setdefault(agent, LoopImage(agent=agent))
        if kind == REC_ADMIT_QUEUED:
            # latest queue entry wins its position (a re-placement
            # re-enqueues at the back, exactly like the live queue)
            if agent in img.queued_order:
                img.queued_order.remove(agent)
            img.queued_order.append(agent)
            continue
        if kind in (REC_CREATED, REC_STARTED, REC_EXITED, REC_ADOPTED,
                    REC_ORPHANED, REC_LOOP_END):
            # the queued launch either dispatched (create/adopt) or the
            # placement it belonged to died: it is no longer pending
            if agent in img.queued_order:
                img.queued_order.remove(agent)
        if kind == REC_PLACEMENT:
            loop.worker = str(rec.get("worker", loop.worker))
            loop.epoch = int(rec.get("epoch", loop.epoch))
            loop.status = "pending"
            loop.container_id = ""
            loop.started = False
        elif kind == REC_CREATED:
            loop.container_id = str(rec.get("cid", ""))
        elif kind == REC_STARTED:
            loop.iteration = int(rec.get("iteration", loop.iteration))
            loop.started = True
            loop.status = "running"
        elif kind == REC_EXITED:
            code = rec.get("code")
            if code is not None:
                loop.exit_codes.append(int(code))
                loop.consecutive_failures = (
                    0 if int(code) == 0 else loop.consecutive_failures + 1)
            loop.iteration = int(rec.get("iteration", loop.iteration)) + 1
            loop.started = False
            loop.status = "running"
        elif kind == REC_ADOPTED:
            loop.container_id = str(rec.get("cid", loop.container_id))
            loop.iteration = int(rec.get("iteration", loop.iteration))
            loop.started = True
            loop.status = "running"
        elif kind == REC_ORPHANED:
            cid = str(rec.get("cid", ""))
            wid = str(rec.get("worker", loop.worker))
            if cid:
                loop.abandoned.append((wid, cid))
            loop.container_id = ""
            loop.started = False
            loop.status = "orphaned"
        elif kind == REC_MIGRATED:
            loop.migrations += 1
        elif kind == REC_LOOP_END:
            loop.status = str(rec.get("status", "stopped"))
            if loop.status == "stopped":
                # the drain deliberately halted any in-flight iteration:
                # billing its docker-stop kill code as a real exit would
                # burn budget and failure ceiling for work the scheduler
                # itself interrupted -- resume re-runs the iteration
                loop.started = False
    return img


# --------------------------------------------------------------------------
# emergency retention GC (docs/durability.md): the disk-pressure hard
# watermark's last resort before a durable append is allowed to fail
# --------------------------------------------------------------------------

RETENTION_RUNS = 64             # newest journals always kept


def run_is_done(img: RunImage) -> bool:
    """A journal whose replay shows a finished run: clean shutdown, or
    every loop folded to a terminal (non-resumable) status.  Only these
    are GC-eligible -- deleting a resumable run's WAL would destroy the
    exact evidence ``--resume`` needs."""
    if img.clean_shutdown:
        return True
    if not img.loops:
        return False            # headers only / unreadable: keep
    return all(l.status in ("done", "failed") for l in img.loops.values())


def retention_gc(logs_dir: Path, *, keep: int = RETENTION_RUNS) -> dict:
    """Delete journals + flight files of DONE runs past the newest
    ``keep`` (they otherwise live forever).  Called by the
    disk-pressure ladder at the hard watermark, and safe to call any
    time: resumable runs are never touched, recency is by mtime, and
    every unlink is best-effort.  Returns ``{"removed", "freed_bytes",
    "scanned"}`` for the ``storage_gc_*`` metrics and status surfaces.
    """
    runs_dir = Path(logs_dir) / RUNS_DIR
    try:
        journals = sorted(runs_dir.glob("*.journal"),
                          key=lambda p: p.stat().st_mtime, reverse=True)
    except OSError:
        return {"removed": 0, "freed_bytes": 0, "scanned": 0}
    removed = 0
    freed = 0
    for jp in journals[max(0, int(keep)):]:
        try:
            img = replay(read_jsonl(jp))
        except Exception:       # noqa: BLE001 -- an unreadable journal
            continue            # is evidence; never GC evidence blindly
        if not run_is_done(img):
            continue
        run_id = jp.stem
        victims = [jp]
        fp = flight_path(logs_dir, run_id)
        victims.extend([fp, Path(str(fp) + ".1")])
        for path in victims:
            try:
                size = path.stat().st_size
                path.unlink()
                freed += size
            except OSError:
                continue
        removed += 1
    return {"removed": removed, "freed_bytes": freed,
            "scanned": len(journals)}
