"""Fused fleet egress collection for the sentinel.

A copy of ``clawker_tpu/sentinel/collector.py`` over the port's own
``monitor.ledger`` reader.  ``add_remote`` takes any transport with the
reference's shape (``ssh_base()``, ``runner.spawn_piped(cmd)``); the
port has no SSH transport of its own yet.

One :class:`StreamCollector` owns every worker's ``ebpf-egress.jsonl``
tail and merges the records into one bounded, worker-tagged feed:

- **local sources** (``local``/``fake`` drivers, or a worker whose
  stream lands on this host) are tailed incrementally on the sentinel's
  own tick via :func:`monitor.ledger.tail_jsonl` -- a netlogger that
  died mid-line leaves a torn tail that is SKIPPED, never fatal, and a
  rotated file replays from the top;
- **remote sources** (``tpu_vm`` workers) ride ``tail -F`` over the
  worker's existing SSH ControlMaster (the same mux the side channels
  and the dashboard's egress ticker use), pumped by a daemon thread.

Sources are DEDUPED by path: on a fake pod every worker's stream may be
one host file, and tailing it once per worker would multiply every
record.  Records keep their own ``worker`` field when the netlogger
wrote one; otherwise they are tagged with the owning source's id.

``kill()`` is the chaos seam (docs/chaos.md ``sentinel`` scenario): it
drops every source mid-run the way a SIGKILLed collector process would,
and ``revive()`` re-wires -- the scoring engine above must degrade to
stale scores, never crash, and the scheduler must not notice at all.
"""

from __future__ import annotations

import collections
import threading
import time
from pathlib import Path

from .. import logsetup
from ..fleet.egress_tail import REMOTE_EGRESS_LOG
from ..monitor.ledger import TailState, parse_jsonl, tail_jsonl

log = logsetup.get("sentinel.collector")


class StreamCollector:
    """Thread-safe bounded merge of per-worker egress streams."""

    def __init__(self, maxlen: int = 100_000):
        self._buf: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._dead = threading.Event()
        self._local: dict[Path, tuple[str, TailState]] = {}
        self._procs: list = []
        self._threads: list[threading.Thread] = []
        self._counts: dict[str, int] = {}     # worker -> records collected
        self._wired: list[tuple] = []         # re-wire recipe for revive()

    # ------------------------------------------------------------ sources

    def add_local(self, worker_id: str, path: Path) -> None:
        """Tail a host-side stream for ``worker_id``.  Deduped by
        resolved path; a missing file reads as no news until it
        appears (a worker may not have logged yet)."""
        path = Path(path)
        self._wired.append(("local", worker_id, path))
        if path not in self._local:
            self._local[path] = (worker_id, TailState())

    def add_remote(self, worker_id: str, transport) -> None:
        """``tail -F`` the worker-side stream over its SSH mux; the
        remote shell resolves the worker's XDG state path."""
        self._wired.append(("remote", worker_id, transport))
        cmd = transport.ssh_base() + [
            f"tail -n +1 -F {REMOTE_EGRESS_LOG} 2>/dev/null"]
        try:
            proc = transport.runner.spawn_piped(cmd)
        except OSError as e:
            log.warning("sentinel tail for %s failed to start: %s",
                        worker_id, e)
            return
        self._procs.append(proc)
        t = threading.Thread(target=self._pump_proc,
                             args=(worker_id, proc),
                             name=f"sentinel-tail-{worker_id}", daemon=True)
        t.start()
        self._threads.append(t)

    # -------------------------------------------------------------- pumps

    def _tag(self, rec: dict, worker_id: str) -> None:
        if worker_id:
            rec.setdefault("worker", worker_id)
        with self._lock:
            self._buf.append(rec)
            wid = str(rec.get("worker") or worker_id or "unknown")
            self._counts[wid] = self._counts.get(wid, 0) + 1

    def _pump_proc(self, worker_id: str, proc) -> None:
        try:
            for raw in iter(proc.stdout.readline, b""):
                if self._dead.is_set():
                    break
                line = (raw.decode("utf-8", "replace")
                        if isinstance(raw, bytes) else raw)
                for rec in parse_jsonl([line]):
                    self._tag(rec, worker_id)
        except (OSError, ValueError):
            pass

    def poll(self) -> int:
        """Tail every local source once (remote pumps push
        asynchronously); returns records newly collected.  Called from
        the sentinel's tick thread."""
        if self._dead.is_set():
            return 0
        n = 0
        for path, (worker_id, state) in list(self._local.items()):
            for rec in tail_jsonl(path, state):
                self._tag(rec, worker_id)
                n += 1
        return n

    # -------------------------------------------------------------- reads

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def counts(self) -> dict[str, int]:
        """Per-worker collected-record counters (stream-silence and
        fusion evidence for the CLI/status surfaces)."""
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def wait_quiescent(self, deadline_s: float = 2.0,
                       settle_s: float = 0.15) -> None:
        """Block until the feed stops growing (or ``deadline_s``).

        A one-shot scorer wired over REMOTE tails must not score
        milliseconds after spawn -- the SSH ``tail -F`` pumps replay
        the worker-side history asynchronously, and an immediate tick
        would read a busy fleet as empty.  Local-only collectors
        return after one poll (their tail is synchronous)."""
        self.poll()
        if not self._procs:
            return
        deadline = time.monotonic() + max(0.0, deadline_s)
        last = self.total()
        while time.monotonic() < deadline:
            time.sleep(settle_s)
            self.poll()
            now = self.total()
            if now == last and now > 0:
                return
            last = now

    @property
    def alive(self) -> bool:
        return not self._dead.is_set()

    # ---------------------------------------------------------- lifecycle

    def kill(self) -> None:
        """Chaos seam: drop every source mid-run like a SIGKILL would --
        no flush, no unwind.  The collected buffer stays readable (a
        dead collector serves stale records, exactly what a scorer
        downstream of a dead process would see)."""
        self._dead.set()
        for proc in self._procs:
            try:
                proc.kill()
            except OSError:
                pass
        self._procs.clear()
        self._local = {}

    def revive(self) -> None:
        """Re-wire every source recorded by the add_* calls (collector
        restart after a chaos kill; tails resume from scratch)."""
        if not self._dead.is_set():
            return
        self._dead = threading.Event()
        wired, self._wired = list(self._wired), []
        for kind, worker_id, src in wired:
            if kind == "local":
                self.add_local(worker_id, src)
            else:
                self.add_remote(worker_id, src)

    def stop(self) -> None:
        self._dead.set()
        for proc in self._procs:
            try:
                proc.terminate()
            except OSError:
                pass
        for t in self._threads:
            t.join(1.0)
        self._threads.clear()
        self._procs.clear()


def wire_fleet(collector: StreamCollector, driver, cfg) -> None:
    """Wire one source per fleet worker: remote engines (a transport on
    the engine) tail worker-side over the SSH mux; local/fake workers
    read host files -- a per-worker ``ebpf-egress-<worker>.jsonl``
    beside the shared stream when present (how a multi-worker fake pod
    keeps distinct streams on one host), else the shared
    ``ebpf-egress.jsonl``."""
    shared = cfg.logs_dir / "ebpf-egress.jsonl"
    for worker in driver.workers():
        engine = worker.engine
        transport = getattr(engine, "transport", None) if engine else None
        if transport is not None:
            collector.add_remote(worker.id, transport)
            continue
        per_worker = cfg.logs_dir / f"ebpf-egress-{worker.id}.jsonl"
        collector.add_local(worker.id, per_worker)
        collector.add_local(worker.id, shared)
