"""Isolated test environments and fault shims (public test support).

The port's copy of ``clawker_tpu/testenv.py``, and pieces of its own:

- :class:`TestEnv` -- throwaway XDG dirs wired through the
  ``CLAWKER_TPU_*_DIR`` overrides, so a run never touches the real user
  config (the chaos runner gives every scenario its own);
- :class:`StubDockerDaemon` -- the keep-alive HTTP daemon that answers
  every request with one canned body, for the engine client's pool;
- :class:`FakeBulkIndex` -- the in-memory ``_bulk`` endpoint the
  shipper scenarios ship into;
- :class:`FaultFS` -- the disk-fault shim the storage scenarios wrap
  around a run journal's live handle (the journal's ``_fsync_fh`` seam
  prefers a handle-level ``fsync`` so the shim can intercept it);
- :func:`inject_wan_rtt` -- a per-call host<->worker WAN round trip on
  every worker of a driver: ``FakeDriver.set_rtt_all`` (each remote
  engine call of a fake worker sleeps it), else each ``tpu_vm``
  worker's ``SSHTransport.rtt_s`` (each mux command pays it);
- :func:`lock_tracing` -- opt-in lock-order tracing for a block, over
  :mod:`clawker_tpu_torch.analysis.lockgraph`;
- :class:`FakeEngineDaemon` (the port's own) -- a
  :class:`~clawker_tpu_torch.engine.fake.FakeDockerAPI` served on a
  unix socket over HTTP/1.1, so the ``local`` driver's HTTP client runs
  against real sockets, keep-alive, streams and the ``101`` hijack
  where no Docker daemon exists.  Its wire handling follows the
  namespace daemon's (:mod:`clawker_tpu_torch.nsd.server`).

- :func:`install_ssh_shim` (the port's own) -- the loopback ``ssh``
  (:mod:`clawker_tpu_torch.sshseam`): a pod of SSH workers on this
  machine, each host a directory with its own Docker socket, so the
  ``tpu_vm`` driver's real transport runs its forwards, side channels
  and remote tails where no SSH server exists.
- :func:`install_nsd_double` (the port's own) -- a kernel-free double
  of the tools the namespace daemon runs (``unshare``, ``nsenter``,
  ``mount``, ``umount``), so :mod:`clawker_tpu_torch.nsd` serves real
  processes where no namespace, overlay or cgroup may be made;
  :func:`python_without_cgroups`, the interpreter a spawned daemon runs
  under there so that it makes no cgroup either.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import http
import json
import os
import re
import shlex
import socket
import struct
import sys
import tempfile
import threading
import time
import urllib.parse
from pathlib import Path

from . import consts
from .errors import ConflictError, NotFoundError


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


def inject_wan_rtt(driver, rtt_s: float) -> None:
    """Inject a deterministic per-call host<->worker WAN round trip on
    every worker of ``driver`` (see the module docstring).  Works on
    any driver exposing ``set_rtt_all`` (FakeDriver) or per-worker
    engine transports (tpu_vm); silently no-ops elsewhere -- tests can
    call it unconditionally."""
    set_all = getattr(driver, "set_rtt_all", None)
    if callable(set_all):
        set_all(rtt_s)
        return
    for w in driver.workers():
        transport = getattr(getattr(w, "engine", None), "transport", None)
        if transport is not None:
            transport.rtt_s = max(0.0, float(rtt_s))


@contextlib.contextmanager
def lock_tracing():
    """Opt-in lock-order tracing for a test or bench block
    (docs/static-analysis.md#lock-order-tracer): every
    ``threading.Lock``/``RLock`` created inside the block feeds a
    :class:`~clawker_tpu_torch.analysis.lockgraph.LockGraph`; yields the
    graph so the caller can assert ``graph.cycles() == []`` (the
    deadlock-freedom check the chaos soak gates on).

        with testenv.lock_tracing() as graph:
            ... run the workload ...
        assert not graph.cycles(), graph.render_cycles()

    The port's tracer is its own: never open this block while the
    reference's tracer is installed (the suite-wide
    ``CLAWKER_TPU_LOCKGRAPH=1`` hook), nor the reference's inside it."""
    from .analysis.lockgraph import install_lock_tracing, uninstall_lock_tracing

    graph = install_lock_tracing()
    try:
        yield graph
    finally:
        uninstall_lock_tracing()


class StubDockerDaemon:
    """Minimal keep-alive HTTP daemon over a unix socket (test/bench
    support for the engine client's connection pool).

    Answers EVERY request with one canned JSON body, so
    ``HTTPDockerAPI`` exercises real sockets, wire framing and
    keep-alive reuse without a real daemon behind them.  Counters:
    ``connections`` (accepts) and ``requests`` (responses served).

    ``max_requests_per_conn > 0`` closes the socket after N responses
    WITHOUT advertising ``Connection: close`` -- models a daemon reaping
    an idle keep-alive socket, which drives the client's
    retry-once-on-stale path.

    ``truncate_after > 0`` serves that many full responses per
    connection, then answers with a status line + headers advertising
    the full body but sends only half of it before closing -- models a
    daemon dying mid-response AFTER executing the request (the case the
    client must never retry).

    ``delay_after > 0`` serves that many prompt responses per
    connection, then sleeps ``response_delay_s`` before answering --
    models a healthy-but-slow daemon (a client read timeout here must
    NOT trigger a re-send).
    """

    __test__ = False  # pytest: helper, not a test class

    def __init__(self, sock_path: str | Path, *, body: bytes | None = None,
                 max_requests_per_conn: int = 0, truncate_after: int = 0,
                 delay_after: int = 0, response_delay_s: float = 0.0):
        self.sock_path = Path(sock_path)
        self.body = (body if body is not None
                     else b'{"Id": "stub", "StatusCode": 0, "Warnings": []}')
        self.max_requests_per_conn = max_requests_per_conn
        self.truncate_after = truncate_after
        self.delay_after = delay_after
        self.response_delay_s = response_delay_s
        self.connections = 0
        self.requests = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._srv: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._thread: threading.Thread | None = None

    def start(self) -> "StubDockerDaemon":
        self.sock_path.parent.mkdir(parents=True, exist_ok=True)
        if self.sock_path.exists():
            self.sock_path.unlink()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(str(self.sock_path))
        srv.listen(64)
        srv.settimeout(0.2)
        self._srv = srv
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(2.0)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                self.connections += 1
                self._conns.add(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        served = 0
        buf = b""
        try:
            while not self._stop.is_set():
                while b"\r\n\r\n" not in buf:
                    try:
                        chunk = conn.recv(65536)
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                head, _, buf = buf.partition(b"\r\n\r\n")
                length = 0
                for line in head.split(b"\r\n")[1:]:
                    k, _, v = line.partition(b":")
                    if k.strip().lower() == b"content-length":
                        length = int(v.strip() or b"0")
                while len(buf) < length:
                    try:
                        chunk = conn.recv(65536)
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                buf = buf[length:]
                # counted on receipt, before the response goes out: a
                # client that has READ response N must find requests >= N
                with self._lock:
                    self.requests += 1
                if self.delay_after and served >= self.delay_after:
                    time.sleep(self.response_delay_s)
                payload = self.body
                truncate = bool(self.truncate_after
                                and served >= self.truncate_after)
                if truncate:
                    payload = self.body[: len(self.body) // 2]
                try:
                    conn.sendall(
                        b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: application/json\r\n"
                        b"Content-Length: " + str(len(self.body)).encode()
                        + b"\r\n\r\n" + payload)
                except OSError:
                    return
                served += 1
                if truncate:
                    return
                if self.max_requests_per_conn and served >= self.max_requests_per_conn:
                    return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass


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


# --------------------------------------------------------- fake engine daemon

_VERSIONED = re.compile(r"^/v\d+(?:\.\d+)?(?=/)")
_HIJACK_REPLY = (b"HTTP/1.1 101 UPGRADED\r\n"
                 b"Content-Type: application/vnd.docker.raw-stream\r\n"
                 b"Connection: Upgrade\r\nUpgrade: tcp\r\n\r\n")
_STREAM_REPLY = (b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                 b"Connection: close\r\n\r\n")


class _Req:
    """One request read off a :class:`FakeEngineDaemon` connection."""

    def __init__(self, method: str, path: str, raw_query: str, body: bytes):
        self.method = method
        self.path = path              # unversioned, still percent-encoded
        self.raw_query = raw_query
        self.query = dict(urllib.parse.parse_qsl(raw_query,
                                                 keep_blank_values=True))
        self.body = body

    def json(self) -> dict:
        return json.loads(self.body) if self.body else {}

    def qbool(self, key: str) -> bool:
        return self.query.get(key, "") not in ("", "0", "false")

    def qjson(self, key: str):
        """A JSON-valued query parameter (``filters``); an empty filter
        set reads as None, as the fake's callers pass it."""
        raw = self.query.get(key, "")
        return (json.loads(raw) if raw else None) or None


class FakeEngineDaemon:
    """A :class:`~clawker_tpu_torch.engine.fake.FakeDockerAPI` served on a
    unix socket as the Docker Engine API (test support, no CLI reaches
    it).

    Real HTTP/1.1 on real sockets: keep-alive with ``Content-Length``
    bodies, a thread per connection (the client parks ``wait`` and
    ``stop`` on dedicated sockets, 8 or more at once), JSON-lines
    streams closed by the daemon (``/events``, image pull) and the
    ``101 UPGRADED`` hijack with raw bytes both ways (attach, exec
    start; non-TTY output framed as dockerd frames it).  It serves
    exactly the routes the port's ``HTTPDockerAPI`` speaks for the
    loop path and the everyday verbs -- ping, version, info; containers create, list, inspect,
    start, stop, kill, wait, remove, rename, resize, attach, logs and
    archive put/get; exec create, start and inspect; image list, inspect,
    pull, tag and remove; both build lanes and the build cancel; volumes;
    networks; events -- and answers any other route with a 404 that it
    also keeps in ``unrouted``.  The fake's
    ``NotFoundError`` answers 404, ``ConflictError`` 409 and anything
    else 500, the statuses ``errors_map.raise_for`` reads back to the
    same classes.

    Records: ``log`` (method, path, query string, and the first 16 hex
    digits of the body's sha256 or ""), ``routes`` (a counter by route: the
    fake's method name), ``builds`` (each ``/build``'s lane and parameters
    as read off the query), ``cancelled`` (the build ids of
    ``/build/cancel``), ``connections`` (accepts) and ``requests``.
    ``stop()`` closes every connection, parked waits and open streams
    too, so a client blocked on one fails instead of hanging.
    """

    __test__ = False  # pytest: helper, not a test class

    def __init__(self, sock_path: str | Path, api):
        self.sock_path = Path(sock_path)
        self.api = api
        self.log: list[tuple[str, str, str, str]] = []
        self.routes: collections.Counter = collections.Counter()
        self.unrouted: list[tuple[str, str]] = []
        self.builds: list[dict] = []
        self.cancelled: list[str] = []
        self.connections = 0
        self.requests = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._srv: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FakeEngineDaemon":
        self.sock_path.parent.mkdir(parents=True, exist_ok=True)
        if self.sock_path.exists():
            self.sock_path.unlink()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(str(self.sock_path))
        srv.listen(128)
        srv.settimeout(0.2)
        self._srv = srv
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="fake-engine-accept")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            _shut(c)
        self.api.close_events()
        if self._thread is not None:
            self._thread.join(2.0)
        try:
            self.sock_path.unlink()
        except OSError:
            pass

    def __enter__(self) -> "FakeEngineDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- wire

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(None)
            with self._lock:
                self.connections += 1
                self._conns.add(conn)
            threading.Thread(target=self._handle, args=(conn,), daemon=True,
                             name="fake-engine-conn").start()

    def _handle(self, conn: socket.socket) -> None:
        buf = b""
        try:
            while not self._stop.is_set():
                got = self._read(conn, buf)
                if got is None:
                    return
                req, buf = got
                if not self._dispatch(conn, req, buf):
                    return
        finally:
            with self._lock:
                self._conns.discard(conn)
            _shut(conn)

    @staticmethod
    def _read(conn: socket.socket, buf: bytes):
        """-> (request, leftover bytes) or None at EOF."""
        while b"\r\n\r\n" not in buf:
            try:
                chunk = conn.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        head, _, buf = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        method, target, _version = lines[0].split(" ", 2)
        headers = {}
        for line in lines[1:]:
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length") or 0)
        while len(buf) < length:
            try:
                chunk = conn.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        path, _, raw_query = target.partition("?")
        path = _VERSIONED.sub("", path)
        return _Req(method, path, raw_query, buf[:length]), buf[length:]

    def _dispatch(self, conn: socket.socket, req: _Req, leftover: bytes) -> bool:
        """Serve one request; -> whether the connection stays open."""
        digest = hashlib.sha256(req.body).hexdigest()[:16] if req.body else ""
        with self._lock:
            self.requests += 1
            self.log.append((req.method, req.path, req.raw_query, digest))
        for method, pattern, handler in self._ROUTES:
            m = pattern.match(req.path) if method == req.method else None
            if m is not None:
                break
        else:
            with self._lock:
                self.unrouted.append((req.method, req.path))
            return _reply(conn, 404, {"message": (
                f"FakeEngineDaemon: no route for {req.method} {req.path}")})
        name = handler.__name__.removeprefix("h_")
        with self._lock:
            self.routes[name] += 1
        args = [urllib.parse.unquote(g) for g in m.groups()]
        try:
            kind, *out = handler(self, req, *args)
        except Exception as e:  # noqa: BLE001 -- mapped to a status
            status = (404 if isinstance(e, NotFoundError)
                      else 409 if isinstance(e, ConflictError) else 500)
            return _reply(conn, status, {"message": str(e)})
        if kind == "json":
            return _reply(conn, *out)
        if kind == "raw":
            return _reply(conn, 200, out[0], ctype="application/x-tar")
        if kind == "stream":
            self._stream(conn, out[0])
        else:
            self._hijack(conn, out[0], out[1], leftover)
        return False

    def _stream(self, conn: socket.socket, items) -> None:
        """JSON lines until the iterator ends, the client goes or the
        daemon stops; the daemon closes the connection."""
        try:
            conn.sendall(_STREAM_REPLY)
            for item in items:
                if self._stop.is_set():
                    break
                conn.sendall(json.dumps(item).encode() + b"\n")
        except OSError:
            pass
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()

    def _hijack(self, conn: socket.socket, stream, tty: bool,
                leftover: bytes) -> None:
        """``101 UPGRADED``, then raw bytes both ways: the client's to
        the stream's stdin (EOF closes it), the stream's output to the
        client (framed as stdout when not a TTY) until it ends."""
        conn.sendall(_HIJACK_REPLY)

        def pump_in() -> None:
            data = leftover
            try:
                while True:
                    if data:
                        stream.write(data)
                    data = conn.recv(65536)
                    if not data:
                        break
            except OSError:
                pass
            stream.close_write()

        threading.Thread(target=pump_in, daemon=True,
                         name="fake-engine-stdin").start()
        try:
            while not self._stop.is_set():
                chunk = stream.read()
                if not chunk:
                    break
                if not tty:
                    chunk = (b"\x01\x00\x00\x00"
                             + struct.pack(">I", len(chunk)) + chunk)
                conn.sendall(chunk)
        except OSError:
            pass

    # ------------------------------------------------------------- routes

    def h_ping(self, req):
        self.api.ping()
        return "json", 200, (b"OK", "text/plain; charset=utf-8")

    def h_info(self, req):
        return "json", 200, self.api.info()

    def h_version(self, req):
        return "json", 200, self.api.version()

    def h_container_create(self, req):
        return "json", 201, self.api.container_create(req.query.get("name", ""),
                                                      req.json())

    def h_container_list(self, req):
        return "json", 200, self.api.container_list(
            all=req.qbool("all"), filters=req.qjson("filters"))

    def h_container_inspect(self, req, cid):
        return "json", 200, self.api.container_inspect(cid)

    def h_container_start(self, req, cid):
        return "json", 204, self.api.container_start(cid)

    def h_container_stop(self, req, cid):
        return "json", 204, self.api.container_stop(
            cid, int(req.query.get("t") or 10))

    def h_container_kill(self, req, cid):
        return "json", 204, self.api.container_kill(
            cid, req.query.get("signal") or "KILL")

    def h_container_wait(self, req, cid):
        return "json", 200, self.api.container_wait(
            cid, req.query.get("condition") or "not-running")

    def h_container_remove(self, req, cid):
        return "json", 204, self.api.container_remove(
            cid, force=req.qbool("force"), volumes=req.qbool("v"))

    def h_container_rename(self, req, cid):
        return "json", 204, self.api.container_rename(
            cid, req.query.get("name", ""))

    def h_container_resize(self, req, cid):
        return "json", 200, self.api.container_resize(
            cid, int(req.query.get("h") or 0), int(req.query.get("w") or 0))

    def h_container_attach(self, req, cid):
        tty = bool(self.api._find(cid).config.get("Tty"))
        return "hijack", self.api.container_attach(
            cid, tty=tty, stdin=req.qbool("stdin"), logs=req.qbool("logs")), tty

    def h_container_logs(self, req, cid):
        # the whole body at once, non-TTY output stdcopy-framed as the
        # fake frames it (``follow`` waits for the exit first)
        body = b"".join(self.api.container_logs(
            cid, follow=req.qbool("follow"),
            tail=req.query.get("tail", "all")))
        return "json", 200, (body, "application/vnd.docker.raw-stream")

    def h_put_archive(self, req, cid):
        self.api.put_archive(cid, req.query.get("path", ""), req.body)
        return "json", 200, None

    def h_get_archive(self, req, cid):
        return "raw", self.api.get_archive(cid, req.query.get("path", ""))

    def h_exec_create(self, req, cid):
        return "json", 201, self.api.exec_create(cid, req.json())

    def h_exec_start(self, req, eid):
        body = req.json()
        tty = bool(body.get("Tty"))
        if body.get("Detach"):
            self.api.exec_start(eid, tty=tty, detach=True)
            return "json", 200, None
        return "hijack", self.api.exec_start(eid, tty=tty), tty

    def h_exec_inspect(self, req, eid):
        return "json", 200, self.api.exec_inspect(eid)

    def h_image_list(self, req):
        return "json", 200, self.api.image_list(filters=req.qjson("filters"))

    def h_image_inspect(self, req, ref):
        return "json", 200, self.api.image_inspect(ref)

    def h_image_tag(self, req, ref):
        self.api.image_tag(ref, req.query.get("repo", ""),
                           req.query.get("tag", ""))
        return "json", 201, None

    def h_image_remove(self, req, ref):
        self.api.image_remove(ref, force=req.qbool("force"))
        return "json", 200, [{"Untagged": ref}]

    def h_build(self, req):
        """Both build lanes: ``version=2`` streams the fake's recorded
        BuildKit transcript, anything else the legacy stream.  Every
        ``t=`` is kept (the client sends one per tag); ``labels`` and
        ``buildargs`` are JSON as the client writes them."""
        tags = [v for k, v in urllib.parse.parse_qsl(
            req.raw_query, keep_blank_values=True) if k == "t"]
        kw = {"tags": tags, "labels": req.qjson("labels"),
              "dockerfile": req.query.get("dockerfile") or "Dockerfile",
              "buildargs": req.qjson("buildargs"),
              "target": req.query.get("target", ""),
              "pull": req.qbool("pull"), "no_cache": req.qbool("nocache")}
        v2 = req.query.get("version") == "2"
        record = {"version": "2" if v2 else "1", **kw}
        if v2:
            record.update(buildid=req.query.get("buildid", ""),
                          session=req.query.get("session", ""))
        with self._lock:
            self.builds.append(record)
        build = self.api.image_build_buildkit if v2 else self.api.image_build
        return "stream", build(req.body, **kw)

    def h_build_cancel(self, req):
        with self._lock:
            self.cancelled.append(req.query.get("id", ""))
        return "json", 200, None

    def h_image_pull(self, req):
        ref = req.query.get("fromImage", "")
        tag = req.query.get("tag", "")
        return "stream", self.api.image_pull(f"{ref}:{tag}" if tag else ref)

    def h_volume_create(self, req):
        body = req.json()
        return "json", 201, self.api.volume_create(
            body.get("Name", ""), body.get("Labels") or None)

    def h_volume_list(self, req):
        return "json", 200, self.api.volume_list(filters=req.qjson("filters"))

    def h_volume_inspect(self, req, name):
        return "json", 200, self.api.volume_inspect(name)

    def h_volume_remove(self, req, name):
        return "json", 204, self.api.volume_remove(name,
                                                   force=req.qbool("force"))

    def h_network_create(self, req):
        body = req.json()
        name = body.pop("Name", "")
        return "json", 201, self.api.network_create(name, body)

    def h_network_list(self, req):
        return "json", 200, self.api.network_list(filters=req.qjson("filters"))

    def h_network_inspect(self, req, ref):
        return "json", 200, self.api.network_inspect(ref)

    def h_network_remove(self, req, ref):
        return "json", 204, self.api.network_remove(ref)

    def h_network_connect(self, req, net):
        body = req.json()
        ipv4 = (((body.get("EndpointConfig") or {}).get("IPAMConfig") or {})
                .get("IPv4Address", ""))
        return "json", 200, self.api.network_connect(
            net, body.get("Container", ""), ipv4=ipv4)

    def h_network_disconnect(self, req, net):
        body = req.json()
        return "json", 200, self.api.network_disconnect(
            net, body.get("Container", ""), force=bool(body.get("Force")))

    def h_events(self, req):
        return "stream", self.api.events(filters=req.qjson("filters"))


def _route(method: str, pattern: str, handler) -> tuple:
    return (method, re.compile(pattern + "$"), handler)


_D = FakeEngineDaemon
FakeEngineDaemon._ROUTES = [
    _route("GET", r"/_ping", _D.h_ping),
    _route("GET", r"/info", _D.h_info),
    _route("GET", r"/version", _D.h_version),
    _route("POST", r"/containers/create", _D.h_container_create),
    _route("GET", r"/containers/json", _D.h_container_list),
    _route("GET", r"/containers/([^/]+)/json", _D.h_container_inspect),
    _route("POST", r"/containers/([^/]+)/start", _D.h_container_start),
    _route("POST", r"/containers/([^/]+)/stop", _D.h_container_stop),
    _route("POST", r"/containers/([^/]+)/kill", _D.h_container_kill),
    _route("POST", r"/containers/([^/]+)/wait", _D.h_container_wait),
    _route("DELETE", r"/containers/([^/]+)", _D.h_container_remove),
    _route("POST", r"/containers/([^/]+)/rename", _D.h_container_rename),
    _route("POST", r"/containers/([^/]+)/resize", _D.h_container_resize),
    _route("POST", r"/containers/([^/]+)/attach", _D.h_container_attach),
    _route("GET", r"/containers/([^/]+)/logs", _D.h_container_logs),
    _route("PUT", r"/containers/([^/]+)/archive", _D.h_put_archive),
    _route("GET", r"/containers/([^/]+)/archive", _D.h_get_archive),
    _route("POST", r"/containers/([^/]+)/exec", _D.h_exec_create),
    _route("POST", r"/exec/([^/]+)/start", _D.h_exec_start),
    _route("GET", r"/exec/([^/]+)/json", _D.h_exec_inspect),
    _route("GET", r"/images/json", _D.h_image_list),
    _route("GET", r"/images/([^/]+)/json", _D.h_image_inspect),
    _route("POST", r"/images/create", _D.h_image_pull),
    _route("POST", r"/images/([^/]+)/tag", _D.h_image_tag),
    _route("DELETE", r"/images/([^/]+)", _D.h_image_remove),
    _route("POST", r"/build", _D.h_build),
    _route("POST", r"/build/cancel", _D.h_build_cancel),
    _route("POST", r"/volumes/create", _D.h_volume_create),
    _route("GET", r"/volumes", _D.h_volume_list),
    _route("GET", r"/volumes/([^/]+)", _D.h_volume_inspect),
    _route("DELETE", r"/volumes/([^/]+)", _D.h_volume_remove),
    _route("POST", r"/networks/create", _D.h_network_create),
    _route("GET", r"/networks", _D.h_network_list),
    _route("GET", r"/networks/([^/]+)", _D.h_network_inspect),
    _route("DELETE", r"/networks/([^/]+)", _D.h_network_remove),
    _route("POST", r"/networks/([^/]+)/connect", _D.h_network_connect),
    _route("POST", r"/networks/([^/]+)/disconnect", _D.h_network_disconnect),
    _route("GET", r"/events", _D.h_events),
]
del _D


def _reply(conn: socket.socket, status: int, payload=None, *,
           ctype: str = "application/json") -> bool:
    """One keep-alive response: a JSON body (``payload`` an object),
    ``bytes`` as they are, or none (``payload`` None); -> whether the
    connection is still good."""
    if isinstance(payload, tuple):           # (bytes, content type)
        payload, ctype = payload
    if payload is None:
        body = b""
    elif isinstance(payload, bytes):
        body = payload
    else:
        body = json.dumps(payload).encode()
    head = f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}\r\n"
    if status != 204:
        head += f"Content-Length: {len(body)}\r\n"
        if body:
            head += f"Content-Type: {ctype}\r\n"
    head += "Api-Version: 1.43\r\n\r\n"
    try:
        conn.sendall(head.encode() + (body if status != 204 else b""))
    except OSError:
        return False
    return True


def _shut(conn: socket.socket) -> None:
    """Wake any thread blocked on ``conn``, then close it."""
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


def live_pids(match) -> list[int]:
    """Processes other than this one, not zombies, for which
    ``match(pid, stat, cmdline)`` holds: ``stat`` is ``/proc/<pid>/stat``'s
    fields after the command name (state, ppid, pgrp, session, ...),
    ``cmdline`` its raw ``cmdline``."""
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit() or int(d.name) == os.getpid():
            continue
        try:
            cmdline = (d / "cmdline").read_bytes()
            stat = (d / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if stat[0] != "Z" and match(int(d.name), stat, cmdline):
            out.append(int(d.name))
    return out


# ------------------------------------------------------------ loopback ssh

# the longest worker-side socket path the fleet transport forwards
# (``SSHTransport.remote_workerd_sock`` / ``remote_loopd_sock``)
_REMOTE_SOCKS = ("/var/run/docker.sock",
                 "/home/{user}/.local/state/clawker-tpu/workerd/workerd.sock",
                 "/home/{user}/.local/state/clawker-tpu/loopd/loopd.sock")


class SSHShim:
    """An installed loopback ``ssh``: its host map and its log.

    ``hosts`` maps each worker host to its root directory; the worker's
    ``/var/run/docker.sock`` is ``<root>/var/run/docker.sock`` and its
    home ``<root>/home/<user>``.  :meth:`set_down` and :meth:`set_delay`
    rewrite the map while forwards run."""

    __test__ = False

    def __init__(self, bin_dir: Path, hosts: dict, user: str):
        self.bin_dir = Path(bin_dir)
        self.program = self.bin_dir / "ssh"
        self.map_path = self.bin_dir / "ssh-hosts.json"
        self.log_path = self.bin_dir / "ssh-invocations.jsonl"
        self.user = user
        self._lock = threading.Lock()
        # two loopback addresses a worker (its gateway, its 127.0.0.1):
        # four workers' reverse forwards then bind one port side by side
        h = int(hashlib.sha256(str(self.bin_dir).encode()).hexdigest(), 16)
        a, b = 64 + h % 128, (h >> 8) % 256
        self._map = {"user": user, "log": str(self.log_path), "delay_s": 0.0,
                     "hosts": {}}
        for i, (host, root) in enumerate(hosts.items()):
            root = Path(root)
            self._map["hosts"][host] = {
                "root": str(root), "down": False,
                "gateway": f"127.{a}.{b}.{2 + 2 * i}",
                "loopback": f"127.{a}.{b}.{3 + 2 * i}"}

    def _write(self) -> None:
        tmp = self.map_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._map, indent=1))
        os.replace(tmp, self.map_path)

    def address(self, host: str) -> str:
        """The loopback address a worker's gateway maps to: where a
        reverse forward bound at the gateway listens here."""
        return self._map["hosts"][host]["gateway"]

    def set_down(self, host: str, down: bool = True) -> None:
        """Mark a host down (its forwards exit 255, every new call is
        refused) or up again."""
        with self._lock:
            self._map["hosts"][host]["down"] = bool(down)
            self._write()

    def set_delay(self, seconds: float) -> None:
        """A fake WAN: every invocation sleeps this long first."""
        with self._lock:
            self._map["delay_s"] = float(seconds)
            self._write()

    def env(self, base: dict | None = None) -> dict:
        """``base`` (default: this process's environment) with the
        shim first on ``PATH``."""
        env = dict(os.environ if base is None else base)
        env["PATH"] = f"{self.bin_dir}{os.pathsep}{env.get('PATH', '')}"
        return env

    def invocations(self) -> list[dict]:
        """Every logged invocation, oldest first: ``kind`` (``L``,
        ``R``, ``O``, ``cmd``, or ``L-failed``/``R-failed``), ``host``,
        ``argv`` and the remote ``cmd``."""
        try:
            lines = self.log_path.read_text().splitlines()
        except FileNotFoundError:
            return []
        return [json.loads(line) for line in lines if line.strip()]

    def live_pids(self) -> list[int]:
        """Processes still running that this shim started: the shim
        itself (its program path on the command line) or a remote
        command it exec'd (a worker root on the command line)."""
        needles = [str(self.program).encode()] + [
            (e["root"].rstrip("/") + "/").encode()
            for e in self._map["hosts"].values()]
        return live_pids(lambda pid, stat, cmdline: any(
            n in cmdline for n in needles))


def install_ssh_shim(bin_dir: str | Path, hosts: dict, *,
                     user: str = consts.TPU_SSH_USER_DEFAULT) -> SSHShim:
    """Write an executable ``ssh`` into ``bin_dir`` that serves each host
    of ``hosts`` ({host: root dir}) from this machine
    (:mod:`clawker_tpu_torch.sshseam`), and its host map.  Put
    ``bin_dir`` first on ``PATH`` (:meth:`SSHShim.env`).  Raises
    ``ValueError`` when a root is so deep that a worker socket path
    under it would pass the 107 bytes a unix socket path may hold."""
    from . import sshseam

    bin_dir = Path(bin_dir)
    bin_dir.mkdir(parents=True, exist_ok=True)
    for host, root in hosts.items():
        for sock in _REMOTE_SOCKS:
            path = str(Path(root)) + sock.format(user=user)
            if len(path.encode()) > sshseam.SUN_PATH_MAX:
                raise ValueError(
                    f"loopback ssh: {host}'s root {root} is too deep: "
                    f"{path} passes {sshseam.SUN_PATH_MAX} bytes")
        for sub in ("var/run", f"home/{user}"):
            (Path(root) / sub).mkdir(parents=True, exist_ok=True)
    shim = SSHShim(bin_dir, hosts, user)
    shim._write()
    shim.program.write_text(
        f"#!{sys.executable} -IS\n"
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('sshseam', "
        f"{sshseam.__file__!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"sys.exit(mod.main({str(shim.map_path)!r}, sys.argv[1:]))\n")
    shim.program.chmod(0o755)
    return shim


# ------------------------------------------------------------- nsd double

NSD_DOUBLE_TOOLS = ("unshare", "nsenter", "mount", "umount")
_PR_SET_PDEATHSIG = 1
_TIOCSCTTY = 0x540E
_DEFAULT_PATH = "/usr/local/sbin:/usr/local/bin:/usr/sbin:/usr/bin:/sbin:/bin"


class NsdDouble:
    """An installed kernel-free double of the tools nsd's runtime runs.

    ``bin_dir`` holds stand-in ``unshare``, ``nsenter``, ``mount`` and
    ``umount``; put it first on the daemon process's ``PATH``
    (:meth:`env`).  The runtime resolves ``unshare`` through its spawn
    env, which copies that ``PATH``, and the other three through the
    ``PATH`` itself, so no code of the daemon changes.

    - ``unshare`` forks one child, the container's init: a session of its
      own, killed when ``unshare`` dies (``--kill-child``), which runs
      the ``cmd`` of the shim's config with its ``env``, in its
      ``workdir`` under ``merged``, each bind a symlink under ``merged``
      to its source; ``unshare`` waits, kills what is left of the
      init's process group (a PID namespace ends with its init), and
      exits as the init did.
    - ``nsenter -t PID ... --wdns=DIR`` runs its command in the init's
      ``merged`` dir (``DIR`` under it, where that exists).
    - the overlay ``mount`` leaves ``merged`` a plain directory;
      ``umount`` succeeds.

    There is no isolation: the container's processes see the host's
    PIDs, hostname and filesystem."""

    __test__ = False

    def __init__(self, bin_dir: str | Path):
        self.bin_dir = Path(bin_dir)
        self.roots = self.bin_dir / "roots"      # init pid -> its merged dir
        self.inits = self.bin_dir / "inits"      # every init pid, one a line

    def env(self, base: dict | None = None) -> dict:
        """``base`` (default: this process's environment) with the double
        first on ``PATH``."""
        env = dict(os.environ if base is None else base)
        env["PATH"] = f"{self.bin_dir}{os.pathsep}{env.get('PATH', '')}"
        return env

    def init_pids(self) -> list[int]:
        try:
            return [int(x) for x in self.inits.read_text().split()]
        except FileNotFoundError:
            return []

    def live_pids(self) -> list[int]:
        """Processes still running that this double started: a stand-in
        (its program path on the command line) or a process of a
        container's session."""
        needle = (str(self.bin_dir) + "/").encode()
        sessions = set(self.init_pids())
        return live_pids(lambda pid, stat, cmdline: (
            needle in cmdline or int(stat[3]) in sessions))


# the three stand-ins a shell runs: a daemon calls ``mount`` at every
# create, start and archive write, so they cost a fork, not an interpreter
_NSD_SHELL_TOOLS = {
    "nsenter": """#!/bin/sh
# nsd double: run the command in the target init's rootfs
target= wd=/
while [ $# -gt 0 ]; do
  case "$1" in
    -t|--target) target=$2; shift 2 ;;
    --wdns=*) wd=${1#--wdns=}; shift ;;
    -*) shift ;;
    *) break ;;
  esac
done
root=$(cat "ROOTS/$target" 2>/dev/null) || {
  echo "nsenter: cannot open /proc/$target/ns/mnt: No such process" >&2
  exit 1
}
if [ -d "$root/$wd" ]; then cd "$root/$wd"; else cd "$root"; fi
exec "$@"
""",
    "mount": """#!/bin/sh
# nsd double: the overlay mount leaves merged a plain directory
case " $* " in
  *" -t overlay "*) for last; do :; done; mkdir -p "$last"; exit 0 ;;
esac
echo "mount (nsd double): only the overlay mount" >&2
exit 32
""",
    "umount": """#!/bin/sh
# nsd double: nothing was mounted
exit 0
""",
}


def install_nsd_double(bin_dir: str | Path) -> NsdDouble:
    """Write the stand-in ``unshare``, ``nsenter``, ``mount`` and
    ``umount`` (:class:`NsdDouble`) into ``bin_dir``."""
    double = NsdDouble(bin_dir)
    double.roots.mkdir(parents=True, exist_ok=True)
    root = str(Path(__file__).resolve().parent.parent)
    for tool in NSD_DOUBLE_TOOLS:
        prog = double.bin_dir / tool
        if tool == "unshare":
            prog.write_text(
                f"#!{sys.executable} -IS\n"
                "import sys\n"
                f"sys.path.insert(0, {root!r})\n"
                "from clawker_tpu_torch.testenv import NsdDouble, "
                "_double_unshare\n"
                f"sys.exit(_double_unshare(NsdDouble({str(bin_dir)!r}), "
                "sys.argv[1:]))\n")
        else:
            prog.write_text(_NSD_SHELL_TOOLS[tool].replace(
                "ROOTS", str(double.roots)))
        prog.chmod(0o755)
    return double


def python_without_cgroups(path: str | Path) -> Path:
    """Write at ``path`` an interpreter for ``NsdDriver``'s spawn (set
    ``sys.executable`` to it): ``<it> -m <package>.nsd ...`` runs that
    daemon with its package's ``firewall.bpfkern.cgroup2_root`` made
    None, so the daemon makes no directory under the host's cgroup-v2
    and puts no container in a cgroup.  The daemon's argv still holds
    ``-m <package>.nsd``; any other call runs this interpreter as it
    is.  -> ``path``."""
    code = ("import importlib, runpy, sys\n"
            "mod = sys.argv[2]\n"
            "kern = importlib.import_module("
            "mod.rsplit('.', 1)[0] + '.firewall.bpfkern')\n"
            "kern.cgroup2_root = lambda: None\n"
            "sys.argv = [mod] + sys.argv[3:]\n"
            "runpy.run_module(mod, run_name='__main__', alter_sys=True)\n")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    python = shlex.quote(sys.executable)
    path.write_text(f'#!/bin/sh\n[ "$1" = -m ] && exec {python} -c '
                    f'{shlex.quote(code)} "$@"\nexec {python} "$@"\n')
    path.chmod(0o755)
    return path


def _double_unshare(double: NsdDouble, argv: list[str]) -> int:
    import signal

    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        i += 1
    cmd = argv[i:]
    if len(cmd) != 4 or cmd[1] != "-m" or not cmd[2].endswith(".nsd.shim"):
        sys.stderr.write("unshare (nsd double): only nsd's shim runs\n")
        return 1
    cfg = json.loads(Path(cmd[3]).read_text())
    parent = os.getpid()
    pid = os.fork()
    if pid == 0:
        try:
            _double_init(double, cfg, parent)
        except BaseException as e:  # noqa: BLE001 - the init must not return
            sys.stderr.write(f"unshare (nsd double): {e}\n")
        finally:
            os._exit(127)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    # the init stays a zombie until the group is killed: its pid (the
    # group's id) cannot be reused meanwhile
    try:
        os.waitid(os.P_PID, pid, os.WEXITED | os.WNOWAIT)
    except OSError:                     # no WNOWAIT: reaped just after
        pass
    try:
        os.killpg(pid, signal.SIGKILL)
    except OSError:
        pass
    _, status = os.waitpid(pid, 0)
    (double.roots / str(pid)).unlink(missing_ok=True)
    if os.WIFSIGNALED(status):
        sig = os.WTERMSIG(status)
        signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)
    return os.waitstatus_to_exitcode(status)


def _double_init(double: NsdDouble, cfg: dict, parent: int) -> None:
    """The container's init: execs its command or raises."""
    import ctypes
    import signal

    os.setsid()
    ctypes.CDLL(None).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:                  # unshare died already
        os._exit(137)
    with open(double.inits, "a") as f:
        f.write(f"{os.getpid()}\n")
    merged = cfg["merged"]
    (double.roots / str(os.getpid())).write_text(merged)
    for bind in cfg.get("binds", []):
        parts = bind.split(":")
        if len(parts) < 2:
            continue
        target = os.path.join(merged, parts[1].strip("/"))
        if not os.path.lexists(target):
            os.makedirs(os.path.dirname(target), exist_ok=True)
            os.symlink(parts[0], target)
    hostname = cfg.get("hostname", "")
    env = dict(cfg.get("env") or {})
    env.setdefault("PATH", _DEFAULT_PATH)
    env.setdefault("HOSTNAME", hostname)
    workdir = os.path.join(merged, (cfg.get("workdir") or "/").strip("/"))
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    if cfg.get("tty"):
        import fcntl

        try:
            fcntl.ioctl(0, _TIOCSCTTY, 1)
        except OSError:
            pass
    argv = cfg["cmd"]
    try:
        os.execvpe(argv[0], argv, env)
    except OSError as e:
        sys.stderr.write(f"nsd shim: exec {argv[0]!r}: {e}\n")
        sys.stderr.flush()
        os._exit(127)
