"""Docker Engine HTTP API client (no SDK dependency).

Speaks the daemon's REST API over a pluggable socket factory: local unix
socket, TCP, or an SSH-forwarded unix socket living on a TPU-VM worker
(drivers/tpu_vm).  Parity reference: pkg/whail wrapping the moby client
(engine.go:32); the surface below mirrors the ops inventory in SURVEY.md
2.3 (25 container ops, image ops incl. build, volume/network ops, events).

Implements the subset of API v1.43 this framework uses.  All methods return
parsed JSON trees (daemon-shaped); the typed/jailed layer lives above in
``api.Engine``.

Unary calls ride a keep-alive connection pool (pool.ConnectionPool):
checkout an idle persistent connection, send, check it back in on clean
completion.  A request that fails on a *reused* connection (the daemon
reaped the idle socket: BrokenPipeError / ECONNRESET / BadStatusLine) is
retried exactly once on a fresh dial -- but ONLY for idempotent verbs
(urllib3-style allowlist): a connection that dies before the status
line also matches a response lost AFTER the daemon executed the request
(forward drop, daemon restart), and re-sending a kill/exec_create there
would double-execute it.  Suppressed retries are counted
(``engine_retries_suppressed_total``).  A first-dial failure raises
``DriverError`` immediately.  Streams, ``/events`` and hijacked
attach/exec connections use dedicated sockets that are never pooled.
See docs/engine-connection-pool.md and docs/telemetry.md.

The port's copy of ``clawker_tpu/engine/httpapi.py``, whole.  The
image-build methods (``image_build``, ``image_build_buildkit``,
``session_attach``, ``build_cancel``) are driven by
``engine/buildkit.py``'s ``Builder`` and ``engine/bksession.py``.
"""

from __future__ import annotations

import http.client
import io
import json
import socket
import struct
import threading
import time
import urllib.parse
from pathlib import Path
from typing import Any, Callable, Iterator

from .. import telemetry
from ..errors import ClawkerError, DriverError
from ..tracing.context import current as trace_current
from ..tracing.context import record_engine_request
from .errors_map import raise_for
from .pool import ConnectionPool, _SockConnection  # noqa: F401 (re-export)

API_PREFIX = "/v1.43"

# Verbs whose daemon-side handlers are safe to re-send after a reused
# socket died before the status line (urllib3 Retry.DEFAULT_ALLOWED_METHODS
# minus the ones this client never issues).  POST is deliberately absent:
# kill / exec_create / create re-sent after a lost response double-execute.
IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE",
                                "OPTIONS", "TRACE"})

# Per-verb unary latency (dial + send + first-byte + body).  Verb, not
# path: bounded cardinality, and the slow verbs (POST create/start) are
# exactly the ones worth a distribution.
_REQUEST_SECONDS = telemetry.histogram(
    "engine_request_seconds", "Engine-API unary request latency",
    labels=("verb",))

# Unary calls against a hung daemon must fail, not block a scheduler
# lane forever; streams/hijacks clear this (pool.dedicated -> unbounded).
DEFAULT_UNARY_TIMEOUT_S = 30.0

SocketFactory = Callable[[], socket.socket]


def unix_socket_factory(path: str | Path, *,
                        timeout: float | None = DEFAULT_UNARY_TIMEOUT_S) -> SocketFactory:
    def connect() -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(str(path))
        return s

    return connect


def tcp_socket_factory(host: str, port: int) -> SocketFactory:
    def connect() -> socket.socket:
        return socket.create_connection((host, port), timeout=30)

    return connect


class HijackedStream:
    """Bidirectional raw stream from a hijacked attach/exec connection.

    ``tty=True`` streams are raw; ``tty=False`` multiplexes stdout/stderr in
    8-byte-header frames (demux with :meth:`frames`).
    """

    def __init__(self, sock: socket.socket, resp: http.client.HTTPResponse, tty: bool):
        self._sock = sock
        self._resp = resp
        self.tty = tty

    def write(self, data: bytes) -> None:
        self._sock.sendall(data)

    def close_write(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def read(self, n: int = 65536) -> bytes:
        try:
            if self._resp.status == 101:
                # http.client pins 1xx body length to 0, so resp.read()
                # would return b"" forever; after a real daemon's 101
                # the raw stream follows the headers on the response's
                # buffered reader (which may already hold early bytes)
                return self._resp.fp.read1(n) or b""
            return self._resp.read(n) or b""
        except (http.client.IncompleteRead, ConnectionResetError,
                ValueError, OSError):
            return b""

    def frames(self) -> Iterator[tuple[int, bytes]]:
        """Yield (stream_fd, payload): 1=stdout, 2=stderr. TTY streams yield
        everything as fd 1."""
        if self.tty:
            while True:
                chunk = self.read()
                if not chunk:
                    return
                yield 1, chunk
            return
        buf = b""
        while True:
            while len(buf) < 8:
                chunk = self.read()
                if not chunk:
                    return
                buf += chunk
            fd, length = buf[0], struct.unpack(">I", buf[4:8])[0]
            buf = buf[8:]
            while len(buf) < length:
                chunk = self.read()
                if not chunk:
                    return
                buf += chunk
            yield fd, buf[:length]
            buf = buf[length:]

    def close(self) -> None:
        try:
            self._sock.close()
        finally:
            self._resp.close()


class HTTPDockerAPI:
    """The concrete daemon client.  One instance per daemon endpoint."""

    def __init__(self, factory: SocketFactory, *, api_prefix: str = API_PREFIX,
                 pool_max_idle: int | None = None,
                 pool_idle_ttl: float | None = None):
        self._factory = factory
        self._prefix = api_prefix
        pool_kw: dict[str, Any] = {}
        if pool_max_idle is not None:
            pool_kw["max_idle"] = pool_max_idle
        if pool_idle_ttl is not None:
            pool_kw["idle_ttl"] = pool_idle_ttl
        self._pool = ConnectionPool(factory, **pool_kw)
        self._event_conns: set = set()  # live /events connections (close_events)
        self._event_lock = threading.Lock()

    # ------------------------------------------------------------ plumbing

    def _url(self, path: str, query: dict[str, Any] | None = None, *,
             versioned: bool = True) -> str:
        url = (self._prefix if versioned else "") + path
        if query:
            q = {}
            for k, v in query.items():
                if v is None:
                    continue
                if isinstance(v, bool):
                    v = "true" if v else "false"
                elif isinstance(v, (dict, list)):
                    v = json.dumps(v)
                q[k] = v
            if q:
                url += "?" + urllib.parse.urlencode(q)
        return url

    def _request(
        self,
        method: str,
        path: str,
        *,
        query: dict[str, Any] | None = None,
        body: Any = None,
        raw_body: bytes | None = None,
        headers: dict[str, str] | None = None,
        versioned: bool = True,
        dedicated: bool = False,
    ) -> Any:
        """Unary call over a pooled keep-alive connection.

        ``dedicated=True`` dials a never-pooled, read-unbounded socket for
        unary ops whose response legitimately takes arbitrarily long
        (wait / stop / restart); everything else checks a connection out
        of the pool and returns it on clean completion.  A failure on a
        REUSED connection -- the daemon reaped the idle socket between
        requests -- is retried exactly once on a fresh dial IF the verb
        is idempotent; non-idempotent verbs surface the failure (the
        daemon may have executed the request and lost only the
        response), counting the suppressed retry.  First-dial failures
        raise ``DriverError`` unchanged.
        """
        t_req = time.perf_counter()
        hdrs = {"Host": "docker", "Connection": "keep-alive"}
        # Distributed tracing rides ambient context (docs/tracing.md):
        # when a scheduler/workerd wrapped this call in ``use(ctx)``, the
        # daemon sees a W3C traceparent header and the call is recorded
        # as an ``engine.request`` span -- zero cost when no context is
        # active (the common untraced path).
        t_trace = time.time() if trace_current() is not None else 0.0
        if t_trace:
            hdrs["traceparent"] = trace_current().to_header()
        data: bytes | None = None
        if raw_body is not None:
            data = raw_body
            hdrs["Content-Type"] = "application/x-tar"
        elif body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        if headers:
            hdrs.update(headers)
        url = self._url(path, query, versioned=versioned)
        conn: _SockConnection | None = None
        reused = False
        retried = False
        while True:
            try:
                if dedicated:
                    conn, reused = self._pool.dedicated(), False
                elif retried:
                    conn, reused = self._pool.fresh(), False
                else:
                    conn, reused = self._pool.checkout()
                conn.request(method, url, body=data, headers=hdrs)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                if conn is not None:
                    conn.close()
                if reused and not retried and not isinstance(e, TimeoutError):
                    # the daemon reaped the idle socket under us
                    # (BrokenPipe / ECONNRESET / BadStatusLine): one
                    # retry on a guaranteed-fresh dial.  A TimeoutError
                    # is excluded: that is a SLOW daemon still executing
                    # the request, and re-sending would run it twice.
                    # Non-idempotent verbs are excluded too -- a socket
                    # dead before the status line ALSO matches a
                    # response lost after execution (forward drop,
                    # daemon restart), and re-sending a kill or an
                    # exec_create there would run it twice.
                    if method in IDEMPOTENT_METHODS:
                        self._pool.note_stale_retry()
                        retried = True
                        continue
                    self._pool.note_suppressed_retry()
                if t_trace:
                    record_engine_request(method, path, t_trace, ok=False)
                raise DriverError(f"daemon unreachable ({method} {path}): {e}") from e
            try:
                payload = resp.read()
            except (OSError, http.client.HTTPException) as e:
                # a status line arrived, so the daemon definitely executed
                # the request: NEVER retry here -- re-sending a delivered
                # non-idempotent request (create/kill/...) would run it
                # twice.  Stale-socket reaping manifests before the status
                # line, which the block above already handles.
                conn.close()
                if t_trace:
                    record_engine_request(method, path, t_trace, ok=False)
                raise DriverError(f"daemon unreachable ({method} {path}): {e}") from e
            break
        if not dedicated:
            # dedicated ops (wait/stop/put_archive) legitimately block for
            # container lifetimes -- recording them would drown the verb's
            # actual daemon latency distribution
            _REQUEST_SECONDS.labels(method).observe(time.perf_counter() - t_req)
        if dedicated or resp.will_close:
            conn.close()
        else:
            self._pool.checkin(conn)
        if t_trace:
            record_engine_request(method, path, t_trace,
                                  ok=resp.status < 400)
        self._check(resp.status, payload, path)
        if not payload:
            return None
        ct = resp.getheader("Content-Type", "")
        if ct.startswith("application/json"):
            return json.loads(payload)
        return payload

    def _open_stream(
        self,
        method: str,
        url: str,
        *,
        body: Any = None,
        headers: dict[str, str] | None = None,
        label: str = "",
        check_path: str = "",
    ) -> tuple[_SockConnection, http.client.HTTPResponse]:
        """Dial a dedicated (never-pooled, read-unbounded) connection and
        send one request on it, mapping dial/send failures to DriverError
        and HTTP errors through _check.  Shared by streams/logs/build."""
        conn: _SockConnection | None = None
        try:
            conn = self._pool.dedicated()
            conn.request(method, url, body=body, headers=headers or {})
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            if conn is not None:
                conn.close()
            raise DriverError(f"daemon unreachable ({label}): {e}") from e
        if resp.status >= 400:
            payload = resp.read()
            conn.close()
            self._check(resp.status, payload, check_path)
        return conn, resp

    def pool_stats(self) -> dict:
        """Connection-pool telemetry: dials / reuses / stale_retries / idle."""
        return self._pool.stats()

    def close(self) -> None:
        """Drain-on-shutdown: tear down event streams and idle pooled
        connections.  In-flight checkouts finish and are then dropped."""
        self.close_events()
        self._pool.close()

    def _stream(
        self,
        method: str,
        path: str,
        *,
        query: dict[str, Any] | None = None,
        body: Any = None,
        raw_body: bytes | io.BufferedIOBase | None = None,
        headers: dict[str, str] | None = None,
        track_events: bool = False,
    ) -> Iterator[dict]:
        """Request returning a stream of JSON objects (build/pull/events).

        Rides a dedicated, never-pooled connection with no read timeout:
        ``/events`` legitimately sits silent for hours.
        """
        hdrs = {"Host": "docker"}
        data: Any = None
        if raw_body is not None:
            data = raw_body
            hdrs["Content-Type"] = "application/x-tar"
        elif body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        if headers:
            hdrs.update(headers)
        conn, resp = self._open_stream(
            method, self._url(path, query), body=data, headers=hdrs,
            label=f"{method} {path}", check_path=path)
        if track_events:
            with self._event_lock:
                self._event_conns.add(conn)

        def gen() -> Iterator[dict]:
            buf = b""
            try:
                while True:
                    try:
                        chunk = resp.read1(65536)
                    except OSError:
                        break  # close_events tore the socket down
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        line = line.strip()
                        if line:
                            yield json.loads(line)
                if buf.strip():
                    yield json.loads(buf)
            finally:
                with self._event_lock:
                    self._event_conns.discard(conn)
                conn.close()

        return gen()

    def _hijack(
        self,
        path: str,
        *,
        query: dict[str, Any] | None = None,
        body: Any = None,
        tty: bool = False,
        upgrade: str = "tcp",
        extra_headers: list[tuple[str, str]] | None = None,
    ) -> HijackedStream:
        data = json.dumps(body).encode() if body is not None else b""
        conn: _SockConnection | None = None
        try:
            conn = self._pool.dedicated()
            conn.putrequest("POST", self._url(path, query), skip_host=True)
            conn.putheader("Host", "docker")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", str(len(data)))
            conn.putheader("Connection", "Upgrade")
            conn.putheader("Upgrade", upgrade)
            for k, v in extra_headers or []:
                conn.putheader(k, v)
            conn.endheaders()
            if data:
                conn.send(data)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            if conn is not None:
                conn.close()
            raise DriverError(f"daemon unreachable (hijack {path}): {e}") from e
        if resp.status not in (101, 200):
            payload = resp.read()
            conn.close()
            self._check(resp.status, payload, path)
        sock = conn.sock
        assert sock is not None
        sock.settimeout(None)
        return HijackedStream(sock, resp, tty)

    @staticmethod
    def _check(status: int, payload: bytes, path: str) -> None:
        if status < 400:
            return
        msg = ""
        try:
            msg = json.loads(payload).get("message", "")
        except Exception:
            msg = payload.decode("utf-8", "replace")[:400]
        raise_for(status, msg, path)

    # -------------------------------------------------------------- system

    def ping(self) -> bool:
        try:
            self._request("GET", "/_ping", versioned=False)
            return True
        except ClawkerError:  # unreachable (DriverError) or non-200 status
            return False

    def info(self) -> dict:
        return self._request("GET", "/info")

    def version(self) -> dict:
        return self._request("GET", "/version")

    # ---------------------------------------------------------- containers

    def container_create(self, name: str, config: dict) -> dict:
        return self._request("POST", "/containers/create", query={"name": name}, body=config)

    def container_start(self, cid: str) -> None:
        self._request("POST", f"/containers/{cid}/start")

    def container_stop(self, cid: str, timeout: int = 10) -> None:
        # dedicated: the daemon answers only after up to `t` seconds of
        # graceful shutdown -- must not trip the pooled read timeout
        self._request("POST", f"/containers/{cid}/stop", query={"t": timeout},
                      dedicated=True)

    def container_kill(self, cid: str, signal: str = "KILL") -> None:
        self._request("POST", f"/containers/{cid}/kill", query={"signal": signal})

    def container_restart(self, cid: str, timeout: int = 10) -> None:
        self._request("POST", f"/containers/{cid}/restart", query={"t": timeout},
                      dedicated=True)

    def container_pause(self, cid: str) -> None:
        self._request("POST", f"/containers/{cid}/pause")

    def container_unpause(self, cid: str) -> None:
        self._request("POST", f"/containers/{cid}/unpause")

    def container_remove(self, cid: str, *, force: bool = False, volumes: bool = False) -> None:
        # dedicated: removing a container with large volumes can
        # legitimately outlast the pooled unary read timeout
        self._request("DELETE", f"/containers/{cid}",
                      query={"force": force, "v": volumes}, dedicated=True)

    def container_rename(self, cid: str, new_name: str) -> None:
        self._request("POST", f"/containers/{cid}/rename", query={"name": new_name})

    def container_inspect(self, cid: str) -> dict:
        return self._request("GET", f"/containers/{cid}/json")

    def container_list(self, *, all: bool = False, filters: dict | None = None) -> list[dict]:
        return self._request(
            "GET", "/containers/json", query={"all": all, "filters": filters or {}}
        )

    def container_wait(self, cid: str, condition: str = "not-running") -> dict:
        # dedicated: blocks until the container exits (the scheduler's
        # waker threads park here for whole iterations) -- never pooled,
        # never read-bounded
        return self._request(
            "POST", f"/containers/{cid}/wait", query={"condition": condition},
            dedicated=True,
        )

    def container_resize(self, cid: str, height: int, width: int) -> None:
        self._request(
            "POST", f"/containers/{cid}/resize", query={"h": height, "w": width}
        )

    def container_attach(
        self, cid: str, *, tty: bool, stdin: bool = True, logs: bool = False
    ) -> HijackedStream:
        return self._hijack(
            f"/containers/{cid}/attach",
            query={
                "stream": True,
                "stdin": stdin,
                "stdout": True,
                "stderr": True,
                "logs": logs,
            },
            tty=tty,
        )

    def container_logs(
        self, cid: str, *, follow: bool = False, tail: str = "all"
    ) -> Iterator[bytes]:
        q = {"stdout": True, "stderr": True, "follow": follow, "tail": tail}
        conn, resp = self._open_stream(
            "GET", self._url(f"/containers/{cid}/logs", q),
            headers={"Host": "docker"}, label="logs",
            check_path=f"/containers/{cid}/logs")

        def gen() -> Iterator[bytes]:
            try:
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        return
                    yield chunk
            finally:
                conn.close()

        return gen()

    def put_archive(self, cid: str, path: str, tar_bytes: bytes) -> None:
        # dedicated: the daemon extracts the whole tar before replying --
        # a large snapshot-workspace seed can outlast the pooled unary
        # read timeout on a perfectly healthy daemon
        self._request(
            "PUT",
            f"/containers/{cid}/archive",
            query={"path": path},
            raw_body=tar_bytes,
            dedicated=True,
        )

    def get_archive(self, cid: str, path: str) -> bytes:
        return self._request("GET", f"/containers/{cid}/archive", query={"path": path})

    # ---------------------------------------------------------------- exec

    def exec_create(self, cid: str, config: dict) -> dict:
        return self._request("POST", f"/containers/{cid}/exec", body=config)

    def exec_start(self, exec_id: str, *, tty: bool = False, detach: bool = False):
        if detach:
            return self._request(
                "POST", f"/exec/{exec_id}/start", body={"Detach": True, "Tty": tty}
            )
        return self._hijack(
            f"/exec/{exec_id}/start", body={"Detach": False, "Tty": tty}, tty=tty
        )

    def exec_inspect(self, exec_id: str) -> dict:
        return self._request("GET", f"/exec/{exec_id}/json")

    # ------------------------------------------------------------- session

    def session_attach(self, headers: dict[str, str],
                       method_headers: list[tuple[str, str]]) -> HijackedStream:
        """POST /session with the h2c upgrade: the returned duplex stream
        carries the daemon's gRPC calls back into the client
        (engine/bksession.Session.attach bridges it)."""
        return self._hijack(
            "/session", upgrade="h2c", tty=True,
            extra_headers=[*headers.items(), *method_headers])

    # -------------------------------------------------------------- images

    def image_list(self, *, filters: dict | None = None) -> list[dict]:
        return self._request("GET", "/images/json", query={"filters": filters or {}})

    def image_inspect(self, ref: str) -> dict:
        return self._request("GET", f"/images/{urllib.parse.quote(ref, safe='')}/json")

    def image_tag(self, ref: str, repo: str, tag: str) -> None:
        self._request(
            "POST",
            f"/images/{urllib.parse.quote(ref, safe='')}/tag",
            query={"repo": repo, "tag": tag},
        )

    def image_remove(self, ref: str, *, force: bool = False) -> None:
        # dedicated: deleting a multi-GB image's layers can outlast the
        # pooled unary read timeout
        self._request(
            "DELETE", f"/images/{urllib.parse.quote(ref, safe='')}",
            query={"force": force}, dedicated=True,
        )

    def image_build(
        self,
        context_tar: bytes,
        *,
        tags: list[str],
        labels: dict[str, str] | None = None,
        dockerfile: str = "Dockerfile",
        buildargs: dict[str, str] | None = None,
        target: str = "",
        pull: bool = False,
        no_cache: bool = False,
        version: str = "1",
        buildid: str = "",
        session: str = "",
    ) -> Iterator[dict]:
        q: dict[str, Any] = {
            "dockerfile": dockerfile,
            "labels": labels or {},
            "buildargs": buildargs or {},
            "pull": pull,
            "nocache": no_cache,
        }
        if target:
            q["target"] = target
        if version == "2":
            # BuildKit lane: progress arrives as aux trace records
            # (engine/buildkit.py decodes them)
            q["version"] = "2"
            if buildid:
                q["buildid"] = buildid
            if session:
                q["session"] = session
        url = self._url("/build", q)
        # t= repeats per tag; urlencode can't repeat via dict, append manually
        for t in tags:
            url += "&t=" + urllib.parse.quote(t, safe="")
        conn, resp = self._open_stream(
            "POST", url, body=context_tar,
            headers={"Host": "docker", "Content-Type": "application/x-tar"},
            label="build", check_path="/build")

        def gen() -> Iterator[dict]:
            buf = b""
            try:
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if line.strip():
                            yield json.loads(line)
                if buf.strip():
                    yield json.loads(buf)
            finally:
                conn.close()

        return gen()

    def image_build_buildkit(self, context_tar: bytes, **kw) -> Iterator[dict]:
        """BuildKit lane: same request with version=2 (the aux trace
        records are decoded by engine/buildkit.py)."""
        return self.image_build(context_tar, version="2", **kw)

    def build_cancel(self, buildid: str) -> None:
        """Cancel an in-flight BuildKit build by its buildid."""
        self._request("POST", "/build/cancel", query={"id": buildid})

    def image_pull(self, ref: str) -> Iterator[dict]:
        if ":" in ref.rsplit("/", 1)[-1]:
            name, tag = ref.rsplit(":", 1)
        else:
            name, tag = ref, "latest"
        return self._stream(
            "POST", "/images/create", query={"fromImage": name, "tag": tag}
        )

    # ------------------------------------------------------------- volumes

    def volume_create(self, name: str, labels: dict[str, str] | None = None) -> dict:
        return self._request(
            "POST", "/volumes/create", body={"Name": name, "Labels": labels or {}}
        )

    def volume_list(self, *, filters: dict | None = None) -> dict:
        return self._request("GET", "/volumes", query={"filters": filters or {}})

    def volume_inspect(self, name: str) -> dict:
        return self._request("GET", f"/volumes/{name}")

    def volume_remove(self, name: str, *, force: bool = False) -> None:
        # dedicated: same slow-deletion story as container/image remove
        self._request("DELETE", f"/volumes/{name}", query={"force": force},
                      dedicated=True)

    # ------------------------------------------------------------ networks

    def network_create(self, name: str, config: dict) -> dict:
        body = {"Name": name, **config}
        return self._request("POST", "/networks/create", body=body)

    def network_list(self, *, filters: dict | None = None) -> list[dict]:
        return self._request("GET", "/networks", query={"filters": filters or {}})

    def network_inspect(self, ref: str) -> dict:
        return self._request("GET", f"/networks/{ref}")

    def network_remove(self, ref: str) -> None:
        self._request("DELETE", f"/networks/{ref}")

    def network_connect(self, net: str, cid: str, *, ipv4: str = "") -> None:
        body: dict[str, Any] = {"Container": cid}
        if ipv4:
            body["EndpointConfig"] = {"IPAMConfig": {"IPv4Address": ipv4}}
        self._request("POST", f"/networks/{net}/connect", body=body)

    def network_disconnect(self, net: str, cid: str, *, force: bool = False) -> None:
        self._request(
            "POST", f"/networks/{net}/disconnect", body={"Container": cid, "Force": force}
        )

    # -------------------------------------------------------------- events

    def events(self, *, filters: dict | None = None) -> Iterator[dict]:
        return self._stream(
            "GET", "/events", query={"filters": filters or {}}, track_events=True
        )

    def close_events(self) -> None:
        """Tear down live event streams so blocked readers unblock
        (the Feeder's stop path; the fake exposes the same hook).
        Snapshot under the lock: stream generators concurrently discard
        from the set as they wind down."""
        with self._event_lock:
            conns = list(self._event_conns)
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass
