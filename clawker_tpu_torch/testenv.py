"""Isolated test environments and fault shims (public test support).

The port's copy of three pieces of ``clawker_tpu/testenv.py``:

- :class:`TestEnv` -- throwaway XDG dirs wired through the
  ``CLAWKER_TPU_*_DIR`` overrides, so a run never touches the real user
  config (the chaos runner gives every scenario its own);
- :class:`FakeBulkIndex` -- the in-memory ``_bulk`` endpoint the
  shipper scenarios ship into;
- :class:`FaultFS` -- the disk-fault shim the storage scenarios wrap
  around a run journal's live handle (the journal's ``_fsync_fh`` seam
  prefers a handle-level ``fsync`` so the shim can intercept it).

The reference's lock-order tracer, stub Docker daemon and WAN-RTT
helper wait for the tooling they serve (ROADMAP §1 items 12-13).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from pathlib import Path

from . import consts


class TestEnv(contextlib.AbstractContextManager):
    """Creates throwaway XDG dirs and points CLAWKER_TPU_*_DIR at them."""

    __test__ = False  # pytest: helper, not a test class

    def __init__(self, base: Path | None = None):
        self._tmp = None
        if base is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="clawker-tpu-test-")
            base = Path(self._tmp.name)
        self.base = Path(base)
        self.config = self.base / "config"
        self.data = self.base / "data"
        self.state = self.base / "state"
        self.cache = self.base / "cache"
        self._saved: dict[str, str | None] = {}

    def __enter__(self) -> "TestEnv":
        for p in (self.config, self.data, self.state, self.cache):
            p.mkdir(parents=True, exist_ok=True)
        mapping = {
            consts.ENV_CONFIG_DIR: self.config,
            consts.ENV_DATA_DIR: self.data,
            consts.ENV_STATE_DIR: self.state,
            consts.ENV_CACHE_DIR: self.cache,
        }
        for k, v in mapping.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
        return self

    def __exit__(self, *exc) -> None:
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        if self._tmp is not None:
            self._tmp.cleanup()

    # convenience writers -------------------------------------------------

    def write_settings(self, text: str) -> Path:
        p = self.config / consts.SETTINGS_FILE
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
        return p

    def make_project(self, root: Path, text: str, *, form: str = "flat", local: str | None = None) -> Path:
        root.mkdir(parents=True, exist_ok=True)
        if form == "dir":
            d = root / consts.PROJECT_DIR_FORM
            d.mkdir(exist_ok=True)
            main = d / "clawker.yaml"
            main.write_text(text)
            if local is not None:
                (d / "clawker.local.yaml").write_text(local)
        else:
            main = root / consts.PROJECT_FLAT_FORM
            main.write_text(text)
            if local is not None:
                (root / ".clawker.local.yaml").write_text(local)
        return main


class FakeBulkIndex:
    """In-memory OpenSearch ``_bulk`` endpoint (test/bench support for
    the monitor shipper, docs/fleet-console.md#ingestion).

    Implements the shipper's sink contract -- ``bulk(payload) -> bool``
    -- by parsing the ndjson action/doc pairs into per-index doc lists,
    so tests and the ``ingest_docs_lag`` bench gate assert on what the
    index would actually hold.  Fault knobs model the chaos the shipper
    must degrade under:

    - ``down = True``: every bulk POST refuses (connection-refused
      index);
    - ``stall()`` / ``unstall()``: bulk POSTs block until released or
      ``stall_timeout_s`` passes, then fail -- a wedged index that eats
      the sink's deadline without answering;
    - ``delay_s``: fixed per-POST latency (a slow-but-healthy index).
    """

    def __init__(self, *, delay_s: float = 0.0,
                 stall_timeout_s: float = 2.0):
        import json

        self._json = json
        self.delay_s = delay_s
        self.stall_timeout_s = stall_timeout_s
        self.down = False
        self.docs: dict[str, list[dict]] = {}
        self.bulk_calls = 0
        self.refused = 0
        self._lock = threading.Lock()
        self._stalled = threading.Event()
        self._release = threading.Event()
        self._release.set()

    # fault knobs ---------------------------------------------------------

    def stall(self) -> None:
        self._release.clear()
        self._stalled.set()

    def unstall(self) -> None:
        self._release.set()
        self._stalled.clear()

    # sink contract -------------------------------------------------------

    def bulk(self, payload: bytes) -> bool:
        with self._lock:
            self.bulk_calls += 1
        if self._stalled.is_set():
            if not self._release.wait(self.stall_timeout_s):
                with self._lock:
                    self.refused += 1
                return False
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.down:
            with self._lock:
                self.refused += 1
            return False
        lines = payload.decode().splitlines()
        with self._lock:
            for action_line, doc_line in zip(lines[0::2], lines[1::2]):
                try:
                    action = self._json.loads(action_line)
                    doc = self._json.loads(doc_line)
                except ValueError:
                    continue
                index = str(action.get("index", {}).get("_index", ""))
                self.docs.setdefault(index, []).append(doc)
        return True

    # assertions ----------------------------------------------------------

    def count(self, index: str) -> int:
        with self._lock:
            return len(self.docs.get(index, []))

    def search(self, index: str, **match) -> list[dict]:
        """Every doc in ``index`` whose fields equal ``match``."""
        with self._lock:
            rows = list(self.docs.get(index, []))
        return [d for d in rows
                if all(d.get(k) == v for k, v in match.items())]


class FaultFS:
    """Disk-fault injection shim for the WAL chain (docs/durability.md,
    docs/chaos.md#disk-faults): a proxy wrapped around a journal's live
    file handle that makes storage lie on command.  The chaos runner
    installs it on a scheduler's ``RunJournal`` via :meth:`install`;
    unit tests wrap any open file.

    Fault knobs (armed counts; each triggered op decrements its arm):

    - ``fail_writes(n, errno_)``: the next ``n`` writes raise (ENOSPC
      by default -- a full disk; pass ``errno.EIO`` for a dying one);
    - ``short_writes(n)``: the next ``n`` writes write only half the
      payload, then raise -- a torn record on disk;
    - ``fail_fsyncs(n)``: the next ``n`` fsyncs raise EIO *after* the
      kernel may already have dropped the dirty pages -- the classic
      false-success trap the journal's poisoned-handle recovery exists
      for;
    - ``power_cut()``: truncate the real file at the last
      *successfully fsynced* offset -- everything after the last sync
      vanishes, exactly like a host losing power;
    - ``flip_bit(offset)`` / :func:`flip_bit_in_file`: corrupt one byte
      in place (checksum-verify must flag it).

    Counters (``writes``, ``failed_writes``, ``failed_fsyncs``,
    ``synced_offset``) are the evidence the chaos *no-silent-drop*
    audit compares against journal receipts and metrics.
    """

    def __init__(self, fh, path=None):
        import errno as _errno

        self._errno = _errno
        self._fh = fh
        self.path = path
        self._lock = threading.Lock()
        self._fail_writes = 0
        self._fail_errno = _errno.ENOSPC
        self._short_writes = 0
        self._fail_fsyncs = 0
        self.writes = 0
        self.failed_writes = 0
        self.short_written = 0
        self.failed_fsyncs = 0
        self.fsyncs = 0
        self.synced_offset = 0      # file size at the last good fsync

    # fault knobs ---------------------------------------------------------

    def fail_writes(self, n: int = 1, errno_: int | None = None) -> None:
        with self._lock:
            self._fail_writes = int(n)
            if errno_ is not None:
                self._fail_errno = int(errno_)

    def short_writes(self, n: int = 1) -> None:
        with self._lock:
            self._short_writes = int(n)

    def fail_fsyncs(self, n: int = 1) -> None:
        with self._lock:
            self._fail_fsyncs = int(n)

    def power_cut(self) -> int:
        """Truncate the REAL file at the last fsynced offset: the
        unsynced tail vanishes the way a power loss takes it.  Returns
        the number of bytes cut."""
        with self._lock:
            offset = self.synced_offset
        path = self.path or getattr(self._fh, "name", None)
        if path is None:
            return 0
        try:
            self._fh.flush()
        except (OSError, ValueError):
            pass
        try:
            size = os.path.getsize(path)
            with open(path, "rb+") as f:
                f.truncate(offset)
            return max(0, size - offset)
        except OSError:
            return 0

    @staticmethod
    def flip_bit_in_file(path, offset: int, bit: int = 0) -> bool:
        """Flip one bit of ``path`` in place (record corruption)."""
        try:
            with open(path, "rb+") as f:
                f.seek(offset)
                b = f.read(1)
                if not b:
                    return False
                f.seek(offset)
                f.write(bytes([b[0] ^ (1 << (bit & 7))]))
            return True
        except OSError:
            return False

    # file-handle proxy ---------------------------------------------------

    def write(self, data: str) -> int:
        with self._lock:
            if self._fail_writes > 0:
                self._fail_writes -= 1
                self.failed_writes += 1
                raise OSError(self._fail_errno,
                              os.strerror(self._fail_errno))
            if self._short_writes > 0:
                self._short_writes -= 1
                self.short_written += 1
                half = data[:max(1, len(data) // 2)]
                self._fh.write(half)
                self.failed_writes += 1
                raise OSError(self._errno.EIO, "short write")
            self.writes += 1
        return self._fh.write(data)

    def flush(self) -> None:
        self._fh.flush()

    def fsync(self) -> None:
        """The journal's fsync seam (``RunJournal._fsync_fh`` prefers
        a handle-level fsync exactly so this shim can intercept)."""
        with self._lock:
            if self._fail_fsyncs > 0:
                self._fail_fsyncs -= 1
                self.failed_fsyncs += 1
                raise OSError(self._errno.EIO, "fsync failed")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        with self._lock:
            self.fsyncs += 1
            try:
                self.synced_offset = os.path.getsize(
                    self.path or self._fh.name)
            except (OSError, AttributeError):
                pass

    def fileno(self) -> int:
        return self._fh.fileno()

    def close(self) -> None:
        self._fh.close()

    @classmethod
    def install(cls, journal) -> "FaultFS | None":
        """Wrap a live ``RunJournal``'s handle in a FaultFS and return
        it (None when the journal is disabled/unhealthy).  Subsequent
        reopen-recoveries deliberately bypass the shim -- recovery
        opens a FRESH fd, which is the behavior under test."""
        fh = getattr(journal, "_fh", None)
        if fh is None:
            return None
        shim = cls(fh, path=getattr(journal, "path", None))
        try:
            shim.synced_offset = os.path.getsize(shim.path)
        except (OSError, TypeError):
            pass
        journal._fh = shim
        return shim
