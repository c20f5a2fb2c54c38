"""Merged multi-worker egress feed for the loop dashboard ticker.

``loop --parallel N`` on remote workers left the dashboard's egress
ticker blind: each worker's control plane writes ``ebpf-egress.jsonl``
on ITS host, while the dashboard tailed the laptop's copy (round-3
verdict weak #5).  This module tails every worker's stream -- a plain
file tail for local workers, a ``tail -F`` ridden over the worker's SSH
ControlMaster for remote ones (the same mux the side channels use) --
and merges the records into one bounded feed, each tagged with the
worker id.

North-star parity: "tunnel monitor/TUI streams back" (BASELINE.json);
reference transport substrate SURVEY.md 2.13.

The port's copy of ``clawker_tpu/fleet/egress_tail.py``, whole.
``add_remote`` needs only a transport's ``ssh_base()`` and
``runner.spawn_piped``; the port's SSH transport, its producer, waits
for ROADMAP §1 item 12b, so every worker of the fake and the local
drivers tails its local file.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from pathlib import Path

from .. import logsetup

log = logsetup.get("fleet.egress")

# Worker-side egress log location: the per-worker CP (systemd unit,
# fleet/provision.py) runs with default XDG dirs, so the path resolves
# through the remote shell, not ours.
REMOTE_EGRESS_LOG = (
    "${XDG_STATE_HOME:-$HOME/.local/state}/clawker-tpu/logs/ebpf-egress.jsonl")


class EgressFeed:
    """Thread-safe bounded merge of per-worker egress jsonl streams."""

    def __init__(self, maxlen: int = 256):
        self._buf: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._procs: list = []

    # ------------------------------------------------------------ sources

    def add_worker(self, worker, *, local_path: Path) -> None:
        """Wire one worker: remote engines (a transport on the engine)
        tail worker-side over SSH; local ones tail the local file."""
        transport = getattr(worker.require_engine(), "transport", None)
        if transport is not None:
            self.add_remote(worker.id, transport)
        else:
            self.add_local(worker.id, local_path)

    def add_local(self, worker_id: str, path: Path) -> None:
        t = threading.Thread(target=self._tail_local, args=(worker_id, path),
                             name=f"egress-{worker_id}", daemon=True)
        t.start()
        self._threads.append(t)

    def add_remote(self, worker_id: str, transport) -> None:
        """``tail -F`` over the worker's SSH mux.  ``-n +1`` replays the
        existing records so a late-joining dashboard still sees history;
        the remote shell resolves the worker-side XDG path."""
        cmd = transport.ssh_base() + [
            f"tail -n +1 -F {REMOTE_EGRESS_LOG} 2>/dev/null"]
        try:
            proc = transport.runner.spawn_piped(cmd)
        except OSError as e:
            log.warning("egress tail for %s failed to start: %s", worker_id, e)
            return
        self._procs.append(proc)
        t = threading.Thread(target=self._pump_proc, args=(worker_id, proc),
                             name=f"egress-{worker_id}", daemon=True)
        t.start()
        self._threads.append(t)

    # ------------------------------------------------------------- pumps

    def _push(self, worker_id: str, line: str) -> None:
        line = line.strip()
        if not line:
            return
        try:
            rec = json.loads(line)
        except ValueError:
            return
        rec.setdefault("worker", worker_id)
        with self._lock:
            self._buf.append(rec)

    def _tail_local(self, worker_id: str, path: Path) -> None:
        pos = 0
        while not self._stop.is_set():
            try:
                with path.open("rb") as fh:
                    size = path.stat().st_size
                    if size < pos:
                        pos = 0   # rotated/truncated: replay from the top
                    fh.seek(pos)
                    for raw in fh:
                        if not raw.endswith(b"\n"):
                            # partial line mid-write: leave it for the
                            # next poll (consuming a split record would
                            # drop BOTH halves as unparseable)
                            break
                        pos = fh.tell()
                        self._push(worker_id, raw.decode("utf-8", "replace"))
            except OSError:
                pass
            self._stop.wait(0.5)

    def _pump_proc(self, worker_id: str, proc) -> None:
        try:
            for raw in iter(proc.stdout.readline, b""):
                if self._stop.is_set():
                    break
                self._push(worker_id,
                           raw.decode("utf-8", "replace")
                           if isinstance(raw, bytes) else raw)
        except (OSError, ValueError):
            pass

    # ------------------------------------------------------------- reads

    def tail(self, max_lines: int = 64) -> list[dict]:
        with self._lock:
            return list(self._buf)[-max_lines:]

    def stop(self) -> None:
        self._stop.set()
        for proc in self._procs:
            try:
                proc.terminate()
            except OSError:
                pass
        for t in self._threads:
            t.join(1.0)
        self._threads.clear()
        self._procs.clear()

    def __enter__(self) -> "EgressFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
