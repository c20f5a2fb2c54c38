"""nsd HTTP server: the Docker Engine REST surface over a unix socket.

A deliberately small, dependency-free HTTP/1.1 server (http.server
cannot hijack connections, which attach/exec require): one thread per
connection, regex routing, JSON responses, raw-stream upgrades.

Surface implemented = exactly what engine/httpapi.py speaks (the
framework's own client); anything else 404s loudly.

The port's copy of ``clawker_tpu/nsd/server.py``, whole.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import secrets
import select
import signal
import socket
import struct
import threading
import time
import urllib.parse
from pathlib import Path

from .runtime import NsContainer, NsRuntime, frame

_REQ_LINE = re.compile(rb"^(\w+) ([^ ]+) HTTP/1\.[01]$")


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Request:
    def __init__(self, method: str, path: str, query: dict, headers: dict,
                 body: bytes, sock: socket.socket):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.sock = sock
        self.hijacked = False

    def json(self):
        return json.loads(self.body) if self.body else {}

    def qbool(self, key: str, default: bool = False) -> bool:
        v = self.query.get(key)
        if v is None:
            return default
        return v not in ("0", "false", "")

    # ------------------------------------------------------------ hijack

    def upgrade(self) -> socket.socket:
        """Answer 101 (dockerd's upgrade form) and hand over the socket.
        The client side reads the raw stream past the headers
        (HijackedStream handles the 1xx zero-length quirk)."""
        self.sock.sendall(
            b"HTTP/1.1 101 UPGRADED\r\n"
            b"Content-Type: application/vnd.docker.raw-stream\r\n"
            b"Connection: Upgrade\r\nUpgrade: tcp\r\n\r\n")
        self.hijacked = True
        return self.sock

    def stream_headers(self, content_type: str = "application/octet-stream") -> None:
        """Answer 200 with no length: body streams until close."""
        self.sock.sendall(
            f"HTTP/1.1 200 OK\r\nContent-Type: {content_type}\r\n"
            f"Connection: close\r\n\r\n".encode())
        self.hijacked = True  # caller owns the socket from here


class NsDaemon:
    """Registry + router.  One instance == one daemon endpoint."""

    def __init__(self, state_dir: str | Path, socket_path: str | Path,
                 *, cgroup_root: str | Path | None = None):
        self.state_dir = Path(state_dir)
        self.socket_path = Path(socket_path)
        cgr = cgroup_root if cgroup_root is not None else self._find_cgroup_root()
        self.runtime = NsRuntime(self.state_dir / "containers",
                                 cgroup_root=Path(cgr) if cgr else None)
        self.containers: dict[str, NsContainer] = {}
        self.volumes: dict[str, dict] = {}
        self.images: dict[str, dict] = {}
        self.networks: dict[str, dict] = {}
        self.execs: dict[str, dict] = {}
        self._subscribers: list = []
        self._lock = threading.RLock()
        self._server_sock: socket.socket | None = None
        self._stop = threading.Event()

    @staticmethod
    def _find_cgroup_root() -> Path | None:
        try:
            from ..firewall.bpfkern import cgroup2_root

            root = cgroup2_root()
        except Exception:  # noqa: BLE001
            return None
        if root is None:
            return None
        d = root / "clawker-nsd"
        try:
            d.mkdir(exist_ok=True)
        except OSError:
            return None
        return d

    # ------------------------------------------------------------- events

    def _event(self, typ: str, action: str, actor_id: str,
               attrs: dict | None = None) -> None:
        ev = {"Type": typ, "Action": action, "status": action,
              "id": actor_id, "time": int(time.time()),
              "Actor": {"ID": actor_id, "Attributes": attrs or {}}}
        data = json.dumps(ev).encode() + b"\n"
        with self._lock:
            subs = list(self._subscribers)
        for s in subs:
            try:
                s.sendall(data)
            except OSError:
                with self._lock:
                    if s in self._subscribers:
                        self._subscribers.remove(s)

    # ------------------------------------------------------------ helpers

    def _find(self, ref: str) -> NsContainer:
        with self._lock:
            c = self.containers.get(ref)
            if c is not None:
                return c
            for c in self.containers.values():
                if c.name == ref or c.id.startswith(ref):
                    return c
        raise HttpError(404, f"No such container: {ref}")

    def _match_filters(self, c: NsContainer, filters: dict) -> bool:
        for key, wants in (filters or {}).items():
            if isinstance(wants, dict):  # docker also allows map form
                wants = [k for k, v in wants.items() if v]
            if key == "label":
                for want in wants:
                    k, _, v = want.partition("=")
                    if k not in c.labels or (v and c.labels[k] != v):
                        return False
            elif key == "name":
                if not any(w in c.name for w in wants):
                    return False
            elif key == "status":
                if c.state not in wants:
                    return False
        return True

    def _resolve_bind(self, bind: str) -> str:
        """Volume-name sources become their mountpoints (auto-created,
        docker semantics); absolute paths pass through."""
        src, sep, rest = bind.partition(":")
        if src.startswith("/") or not sep:
            return bind
        vol = self._ensure_volume(src, {})
        return vol["Mountpoint"] + sep + rest

    def _ensure_volume(self, name: str, labels: dict) -> dict:
        with self._lock:
            vol = self.volumes.get(name)
            if vol is None:
                mp = self.state_dir / "volumes" / name
                mp.mkdir(parents=True, exist_ok=True)
                vol = {"Name": name, "Driver": "local",
                       "Mountpoint": str(mp), "Labels": labels or {},
                       "CreatedAt": _now(), "Scope": "local"}
                self.volumes[name] = vol
            return vol

    # ---------------------------------------------------------- lifecycle

    # shared parent dirs whose modes nsd must never narrow (a socket
    # configured directly under one of these is the operator's call;
    # the DEFAULT layout is a dedicated /run/clawker)
    _SHARED_DIRS = frozenset(
        {"/", "/run", "/var", "/var/run", "/var/lib", "/tmp", "/var/tmp",
         "/dev", "/dev/shm", "/home", "/root"})

    def serve(self) -> None:
        # The socket is ROOT-EQUIVALENT (full container control on a
        # daemon that runs as root with namespaces): it must never
        # inherit a permissive umask.  Bind under umask 0o177 (no
        # group/other bits even for the creation instant), then pin the
        # socket to 0600 and its dedicated parent dir to 0700 --
        # ADVICE round 5.
        parent = self.socket_path.parent
        parent.mkdir(parents=True, exist_ok=True)
        if self.socket_path.exists():
            self.socket_path.unlink()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        old_umask = os.umask(0o177)
        try:
            srv.bind(str(self.socket_path))
        finally:
            os.umask(old_umask)
        os.chmod(self.socket_path, 0o600)
        if str(parent) not in self._SHARED_DIRS:
            try:
                os.chmod(parent, 0o700)
            except OSError:
                pass    # not ours to narrow (ro mount, foreign owner)
        srv.listen(64)
        srv.settimeout(0.5)
        self._server_sock = srv
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()
        srv.close()

    def shutdown(self) -> None:
        self._stop.set()
        # full teardown: overlay mounts must not outlive the daemon (a
        # leftover merged mount makes the state dir un-removable)
        for c in list(self.containers.values()):
            try:
                self.runtime.remove(c)
            except Exception:  # noqa: BLE001 - best-effort teardown
                if c.state == "running":
                    self.runtime.kill(c)
        self.containers.clear()

    # ----------------------------------------------------------- http i/o

    def _handle_conn(self, sock: socket.socket) -> None:
        try:
            req = self._read_request(sock)
            if req is None:
                return
            try:
                self._route(req)
            except HttpError as e:
                if not req.hijacked:
                    self._respond(sock, e.status, {"message": str(e)})
            except Exception as e:  # noqa: BLE001 - daemon must survive
                if not req.hijacked:
                    self._respond(sock, 500, {"message": f"{e.__class__.__name__}: {e}"})
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _read_request(self, sock: socket.socket) -> Request | None:
        sock.settimeout(30)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                return None
            buf += chunk
            if len(buf) > 1 << 20:
                return None
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        m = _REQ_LINE.match(lines[0])
        if m is None:
            return None
        method = m.group(1).decode()
        target = m.group(2).decode()
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or "0")
        body = rest
        while len(body) < length:
            chunk = sock.recv(min(1 << 20, length - len(body)))
            if not chunk:
                break
            body += chunk
        parsed = urllib.parse.urlsplit(target)
        path = re.sub(r"^/v\d+\.\d+", "", parsed.path)
        multi = urllib.parse.parse_qs(parsed.query)
        query = {k: v[-1] for k, v in multi.items()}
        sock.settimeout(None)
        req = Request(method, path, query, headers, body, sock)
        req.query_multi = multi
        return req

    @staticmethod
    def _respond(sock: socket.socket, status: int, body=None, *,
                 raw: bytes | None = None,
                 content_type: str = "application/json") -> None:
        reasons = {200: "OK", 201: "Created", 204: "No Content",
                   304: "Not Modified", 403: "Forbidden",
                   404: "Not Found", 409: "Conflict",
                   500: "Internal Server Error"}
        if raw is not None:
            payload = raw
        elif body is None:
            payload = b""
        else:
            payload = json.dumps(body).encode()
        head = (f"HTTP/1.1 {status} {reasons.get(status, 'X')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        try:
            sock.sendall(head + payload)
        except OSError:
            pass

    # -------------------------------------------------------------- routes

    _ROUTES = []  # populated below

    def _route(self, req: Request) -> None:
        for method, pattern, handler in self._ROUTES:
            if req.method != method:
                continue
            m = pattern.match(req.path)
            if m:
                handler(self, req, *m.groups())
                return
        raise HttpError(404, f"nsd: no route {req.method} {req.path}")

    # system ------------------------------------------------------------

    def h_ping(self, req: Request) -> None:
        self._respond(req.sock, 200, raw=b"OK", content_type="text/plain")

    def h_info(self, req: Request) -> None:
        self._respond(req.sock, 200, {
            "Name": "nsd", "ServerVersion": "nsd-0.1",
            "Containers": len(self.containers), "OperatingSystem": "linux",
            "OSType": "linux", "BuilderVersion": "1"})

    def h_version(self, req: Request) -> None:
        self._respond(req.sock, 200,
                      {"Version": "nsd-0.1", "ApiVersion": "1.43"})

    # containers --------------------------------------------------------

    def h_create(self, req: Request) -> None:
        name = req.query.get("name") or f"nsd-{secrets.token_hex(6)}"
        config = req.json()
        with self._lock:
            for c in self.containers.values():
                if c.name == name:
                    raise HttpError(409, f"container name {name} already in use")
            image = config.get("Image", "")
            if image and image not in self.images:
                raise HttpError(404, f"No such image: {image}")
            cid = secrets.token_hex(32)
            cg_root = self.runtime.cgroup_root
            # volume names resolve to mountpoints NOW so archive ops can
            # map bind-shadowed paths to their sources before start
            hc = config.setdefault("HostConfig", {})
            hc["Binds"] = [self._resolve_bind(b) for b in (hc.get("Binds") or [])]
            c = NsContainer(
                id=cid, name=name, config=config,
                dir=self.runtime.state_dir / cid[:24],
                cgroup_dir=(cg_root / cid[:24]) if cg_root else None)
            self.runtime.prepare(c)
            self.containers[cid] = c
        self._event("container", "create", cid, {"name": name})
        self._respond(req.sock, 201, {"Id": cid, "Warnings": []})

    def h_start(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        if c.state == "running":
            self._respond(req.sock, 304)
            return
        self.runtime.start(c, on_exit=self._die_event)
        self._event("container", "start", c.id, {"name": c.name})
        self._respond(req.sock, 204)

    def _die_event(self, c) -> None:
        self._event("container", "die", c.id,
                    {"name": c.name, "exitCode": str(c.exit_code)})

    def h_stop(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        self.runtime.stop(c, timeout=int(req.query.get("t", "10")))
        self._event("container", "stop", c.id, {"name": c.name})
        self._respond(req.sock, 204)

    def h_kill(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        sig = req.query.get("signal", "KILL")
        if sig.isdigit():
            num = int(sig)
        else:
            name = sig.upper()
            name = name if name.startswith("SIG") else f"SIG{name}"
            num = getattr(signal, name, signal.SIGKILL)
        self.runtime.kill(c, num)
        self._respond(req.sock, 204)

    def h_restart(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        self.runtime.stop(c, timeout=int(req.query.get("t", "10")))
        self.runtime.start(c, on_exit=self._die_event)
        self._event("container", "start", c.id, {"name": c.name})
        self._respond(req.sock, 204)

    def h_remove(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        if c.state == "running" and not req.qbool("force"):
            raise HttpError(409, "container is running (use force)")
        with self._lock:
            self.containers.pop(c.id, None)
        self.runtime.remove(c)
        # ?v=1 is docker's ANONYMOUS-volume cleanup; nsd has none, so it
        # is a no-op here.  Named agent volumes are removed by the engine
        # layer's label-scoped sweep (engine/api.py remove_container).
        self._event("container", "destroy", c.id, {"name": c.name})
        self._respond(req.sock, 204)

    def h_rename(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        new = req.query.get("name", "")
        if not new:
            raise HttpError(400, "rename: name required")
        with self._lock:
            if any(o.name == new for o in self.containers.values()):
                raise HttpError(409, f"name {new} already in use")
            c.name = new
        self._respond(req.sock, 204)

    def h_inspect(self, req: Request, ref: str) -> None:
        self._respond(req.sock, 200, self._find(ref).inspect())

    def h_list(self, req: Request) -> None:
        filters = json.loads(req.query.get("filters") or "{}")
        show_all = req.qbool("all")
        out = []
        with self._lock:
            for c in self.containers.values():
                if not show_all and c.state != "running":
                    continue
                if self._match_filters(c, filters):
                    out.append(c.summary())
        self._respond(req.sock, 200, out)

    def h_wait(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        code = self.runtime.wait(c) if c.state != "created" else 0
        self._respond(req.sock, 200, {"StatusCode": code})

    def h_resize(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        self.runtime.resize(c, int(req.query.get("h", "24")),
                            int(req.query.get("w", "80")))
        self._respond(req.sock, 200)

    def h_attach(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        sock = req.upgrade()
        if req.qbool("logs") and c.hub.log_path.exists():
            try:
                sock.sendall(c.hub.log_path.read_bytes())
            except OSError:
                return
        c.hub.add_client(sock)
        try:
            while True:
                try:
                    data = sock.recv(65536)
                except OSError:
                    break
                if not data:
                    # client finished WRITING (stdin EOF); it still reads
                    # output -- stay attached until the container exits
                    # or is removed (hub.close_clients shuts the socket)
                    while (self.containers.get(c.id) is c
                           and c.state in ("created", "running")):
                        if c.state == "running" and c._exited.wait(0.2):
                            break
                        if c.state == "created":
                            time.sleep(0.05)
                    break
                c.hub.write_stdin(data)
        finally:
            c.hub.remove_client(sock)

    def h_logs(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        req.stream_headers()
        sock = req.sock
        try:
            if c.hub.log_path.exists():
                sock.sendall(c.hub.log_path.read_bytes())
        except OSError:
            return
        if req.qbool("follow") and c.state == "running":
            c.hub.add_client(sock)
            try:
                while c.state == "running":
                    try:
                        if not sock.recv(4096):
                            break
                    except OSError:
                        break
            finally:
                c.hub.remove_client(sock)

    def h_put_archive(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        try:
            self.runtime.put_archive(c, req.query.get("path", "/"),
                                     req.body)
        except PermissionError as e:
            # archive write into a `:ro` bind resolves to the HOST
            # source: refuse like dockerd does (ADVICE r5)
            raise HttpError(403, str(e)) from None
        self._respond(req.sock, 200)

    def h_get_archive(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        try:
            data = self.runtime.get_archive(c, req.query.get("path", "/"))
        except FileNotFoundError as e:
            raise HttpError(404, f"no such path: {e}") from None
        self._respond(req.sock, 200, raw=data,
                      content_type="application/x-tar")

    # exec --------------------------------------------------------------

    def h_exec_create(self, req: Request, ref: str) -> None:
        c = self._find(ref)
        eid = secrets.token_hex(32)
        with self._lock:
            self.execs[eid] = {"container": c.id, "config": req.json(),
                               "exit": None, "running": False}
        self._respond(req.sock, 201, {"Id": eid})

    def h_exec_start(self, req: Request, eid: str) -> None:
        with self._lock:
            e = self.execs.get(eid)
        if e is None:
            raise HttpError(404, f"no such exec: {eid}")
        body = req.json()
        cfg = dict(e["config"])
        cfg["Tty"] = body.get("Tty", cfg.get("Tty", False))
        c = self._find(e["container"])
        if body.get("Detach"):
            p = self.runtime.exec_spawn(c, cfg)
            e["running"] = True

            def reap():
                e["exit"] = p.wait()
                e["running"] = False

            threading.Thread(target=reap, daemon=True).start()
            self._respond(req.sock, 200, {})
            return
        sock = req.upgrade()
        try:
            p = self.runtime.exec_spawn(c, cfg)
        except (RuntimeError, OSError):
            # hijacked already: record the failure so exec_inspect
            # reports it (126 = command cannot execute), then close
            e["exit"] = 126
            return
        e["running"] = True
        self._pump_exec(p, sock, bool(cfg.get("Tty")))
        e["exit"] = p.wait()
        e["running"] = False

    def _pump_exec(self, p, sock: socket.socket, tty: bool) -> None:
        if getattr(p, "nsd_io", None):  # pty mode
            master = p.nsd_io[0]
            fds = {master: 1}
            stdin_fd = master
        else:
            fds = {p.stdout.fileno(): 1, p.stderr.fileno(): 2}
            stdin_fd = p.stdin.fileno()
        # the socket stays BLOCKING: select gates reads (no spurious
        # blocking recv), and sendall on a non-blocking socket could
        # raise mid-frame and corrupt the stdcopy stream
        sfd = sock.fileno()
        while fds:
            ready, _, _ = select.select(list(fds) + [sfd], [], [], 0.5)
            for fd in ready:
                if fd == sfd:
                    try:
                        data = sock.recv(65536)
                    except (BlockingIOError, OSError):
                        continue
                    if not data:
                        # pipe mode: close stdin so the command sees EOF.
                        # tty mode: the master is ALSO the output fd --
                        # never close it here, just stop forwarding.
                        if not tty:
                            try:
                                p.stdin.close()
                            except OSError:
                                pass
                        stdin_fd = -1
                        continue
                    if stdin_fd >= 0:
                        try:
                            os.write(stdin_fd, data)
                        except OSError:
                            pass
                    continue
                try:
                    chunk = os.read(fd, 65536)
                except OSError:
                    chunk = b""
                if not chunk:
                    del fds[fd]
                    continue
                data = chunk if tty else frame(fds[fd], chunk)
                try:
                    sock.sendall(data)
                except OSError:
                    fds.clear()
            if p.poll() is not None and not fds:
                break

    def h_exec_inspect(self, req: Request, eid: str) -> None:
        with self._lock:
            e = self.execs.get(eid)
        if e is None:
            raise HttpError(404, f"no such exec: {eid}")
        self._respond(req.sock, 200,
                      {"ExitCode": e["exit"] if e["exit"] is not None else 0,
                       "Running": e["running"]})

    # images ------------------------------------------------------------

    def _register_image(self, ref: str, labels: dict | None = None) -> dict:
        digest = hashlib.sha256(ref.encode()).hexdigest()
        img = {"Id": f"sha256:{digest}", "RepoTags": [ref],
               "Labels": labels or {}, "Created": _now(),
               "Config": {"Labels": labels or {}}, "Size": 0}
        with self._lock:
            self.images[ref] = img
        return img

    def h_image_list(self, req: Request) -> None:
        filters = json.loads(req.query.get("filters") or "{}")
        wants = filters.get("label") or []
        if isinstance(wants, dict):
            wants = [k for k, v in wants.items() if v]
        out = []
        with self._lock:
            for img in self.images.values():
                ok = True
                for want in wants:
                    k, _, v = want.partition("=")
                    lv = (img.get("Labels") or {}).get(k)
                    if lv is None or (v and lv != v):
                        ok = False
                if ok:
                    out.append(img)
        self._respond(req.sock, 200, out)

    def h_image_inspect(self, req: Request, ref: str) -> None:
        ref = urllib.parse.unquote(ref)
        with self._lock:
            img = self.images.get(ref)
            if img is None:
                for i in self.images.values():
                    if i["Id"] == ref or ref in (i.get("RepoTags") or []):
                        img = i
                        break
        if img is None:
            raise HttpError(404, f"No such image: {ref}")
        self._respond(req.sock, 200, img)

    def h_image_tag(self, req: Request, ref: str) -> None:
        ref = urllib.parse.unquote(ref)
        with self._lock:
            img = self.images.get(ref)
            if img is None:
                raise HttpError(404, f"No such image: {ref}")
            new_ref = f"{req.query.get('repo', '')}:{req.query.get('tag', 'latest')}"
            clone = dict(img)
            clone["RepoTags"] = [new_ref]
            self.images[new_ref] = clone
        self._respond(req.sock, 201)

    def h_image_remove(self, req: Request, ref: str) -> None:
        ref = urllib.parse.unquote(ref)
        with self._lock:
            if ref not in self.images:
                raise HttpError(404, f"No such image: {ref}")
            del self.images[ref]
        self._respond(req.sock, 200, [{"Deleted": ref}])

    def h_image_pull(self, req: Request) -> None:
        """'Pulling' = registering the ref over the host rootfs: every
        image shares the host lower layer in this runtime."""
        name = req.query.get("fromImage", "")
        tag = req.query.get("tag", "latest")
        ref = f"{name}:{tag}" if name else ""
        if not name:
            raise HttpError(400, "fromImage required")
        self._register_image(ref)
        req.stream_headers("application/json")
        try:
            req.sock.sendall(json.dumps(
                {"status": f"Pull complete (host-rootfs): {ref}"}).encode() + b"\n")
        except OSError:
            pass

    def h_build(self, req: Request) -> None:
        """Synthetic build: tags are registered with their labels; the
        Dockerfile is not executed (every nsd image is host-rootfs)."""
        labels = json.loads(req.query.get("labels") or "{}")
        tags = list(getattr(req, "query_multi", {}).get("t") or [])
        for t in tags:
            self._register_image(t, labels)
        req.stream_headers("application/json")
        try:
            for t in tags:
                req.sock.sendall(json.dumps(
                    {"stream": f"nsd: tagged {t} (host-rootfs image)\n"}
                ).encode() + b"\n")
            req.sock.sendall(json.dumps(
                {"aux": {"ID": "sha256:" + hashlib.sha256(
                    ",".join(tags).encode()).hexdigest()}}).encode() + b"\n")
        except OSError:
            pass

    # volumes -----------------------------------------------------------

    def h_volume_create(self, req: Request) -> None:
        body = req.json()
        vol = self._ensure_volume(body.get("Name") or secrets.token_hex(8),
                                  body.get("Labels") or {})
        self._respond(req.sock, 201, vol)

    def h_volume_list(self, req: Request) -> None:
        filters = json.loads(req.query.get("filters") or "{}")
        wants = filters.get("label") or []
        if isinstance(wants, dict):
            wants = [k for k, v in wants.items() if v]
        out = []
        with self._lock:
            for vol in self.volumes.values():
                ok = True
                for want in wants:
                    k, _, v = want.partition("=")
                    lv = (vol.get("Labels") or {}).get(k)
                    if lv is None or (v and lv != v):
                        ok = False
                if ok:
                    out.append(vol)
        self._respond(req.sock, 200, {"Volumes": out, "Warnings": []})

    def h_volume_inspect(self, req: Request, name: str) -> None:
        with self._lock:
            vol = self.volumes.get(name)
        if vol is None:
            raise HttpError(404, f"no such volume: {name}")
        self._respond(req.sock, 200, vol)

    def h_volume_remove(self, req: Request, name: str) -> None:
        with self._lock:
            vol = self.volumes.get(name)
            if vol is None:
                raise HttpError(404, f"no such volume: {name}")
            mp = vol["Mountpoint"]
            for c in self.containers.values():
                if any(b.split(":")[0] == mp for b in c.binds()):
                    raise HttpError(
                        409, f"volume {name} is in use by {c.name}")
            self.volumes.pop(name)
        import shutil

        shutil.rmtree(mp, ignore_errors=True)
        self._respond(req.sock, 204)

    # networks (records only: nsd containers share the host network) ----

    def h_network_create(self, req: Request) -> None:
        body = req.json()
        name = body.get("Name") or secrets.token_hex(8)
        net = {"Name": name, "Id": secrets.token_hex(32),
               "Labels": body.get("Labels") or {}, "Driver": "host-shared",
               "IPAM": body.get("IPAM") or {}, "Containers": {}}
        with self._lock:
            self.networks[name] = net
        self._respond(req.sock, 201, {"Id": net["Id"]})

    def h_network_list(self, req: Request) -> None:
        with self._lock:
            self._respond(req.sock, 200, list(self.networks.values()))

    def h_network_inspect(self, req: Request, ref: str) -> None:
        with self._lock:
            net = self.networks.get(ref)
            if net is None:
                net = next((n for n in self.networks.values()
                            if n["Id"].startswith(ref)), None)
        if net is None:
            raise HttpError(404, f"no such network: {ref}")
        self._respond(req.sock, 200, net)

    def h_network_remove(self, req: Request, ref: str) -> None:
        with self._lock:
            self.networks.pop(ref, None)
        self._respond(req.sock, 204)

    def h_network_connect(self, req: Request, ref: str) -> None:
        self._respond(req.sock, 200)

    def h_network_disconnect(self, req: Request, ref: str) -> None:
        self._respond(req.sock, 200)

    # events ------------------------------------------------------------

    def h_events(self, req: Request) -> None:
        req.stream_headers("application/json")
        with self._lock:
            self._subscribers.append(req.sock)
        # connection stays open; writes happen from _event; reads detect close
        try:
            while True:
                try:
                    if not req.sock.recv(4096):
                        break
                except OSError:
                    break
        finally:
            with self._lock:
                if req.sock in self._subscribers:
                    self._subscribers.remove(req.sock)


def _r(method: str, pattern: str, handler) -> tuple:
    return (method, re.compile(pattern), handler)


NsDaemon._ROUTES = [
    _r("GET", r"^/_ping$", NsDaemon.h_ping),
    _r("GET", r"^/info$", NsDaemon.h_info),
    _r("GET", r"^/version$", NsDaemon.h_version),
    _r("POST", r"^/containers/create$", NsDaemon.h_create),
    _r("GET", r"^/containers/json$", NsDaemon.h_list),
    _r("POST", r"^/containers/([^/]+)/start$", NsDaemon.h_start),
    _r("POST", r"^/containers/([^/]+)/stop$", NsDaemon.h_stop),
    _r("POST", r"^/containers/([^/]+)/kill$", NsDaemon.h_kill),
    _r("POST", r"^/containers/([^/]+)/restart$", NsDaemon.h_restart),
    _r("POST", r"^/containers/([^/]+)/rename$", NsDaemon.h_rename),
    _r("POST", r"^/containers/([^/]+)/wait$", NsDaemon.h_wait),
    _r("POST", r"^/containers/([^/]+)/resize$", NsDaemon.h_resize),
    _r("POST", r"^/containers/([^/]+)/attach$", NsDaemon.h_attach),
    _r("GET", r"^/containers/([^/]+)/logs$", NsDaemon.h_logs),
    _r("GET", r"^/containers/([^/]+)/json$", NsDaemon.h_inspect),
    _r("DELETE", r"^/containers/([^/]+)$", NsDaemon.h_remove),
    _r("PUT", r"^/containers/([^/]+)/archive$", NsDaemon.h_put_archive),
    _r("GET", r"^/containers/([^/]+)/archive$", NsDaemon.h_get_archive),
    _r("POST", r"^/containers/([^/]+)/exec$", NsDaemon.h_exec_create),
    _r("POST", r"^/exec/([^/]+)/start$", NsDaemon.h_exec_start),
    _r("GET", r"^/exec/([^/]+)/json$", NsDaemon.h_exec_inspect),
    _r("GET", r"^/images/json$", NsDaemon.h_image_list),
    _r("GET", r"^/images/([^/]+)/json$", NsDaemon.h_image_inspect),
    _r("POST", r"^/images/([^/]+)/tag$", NsDaemon.h_image_tag),
    _r("DELETE", r"^/images/([^/]+)$", NsDaemon.h_image_remove),
    _r("POST", r"^/images/create$", NsDaemon.h_image_pull),
    _r("POST", r"^/build$", NsDaemon.h_build),
    _r("POST", r"^/volumes/create$", NsDaemon.h_volume_create),
    _r("GET", r"^/volumes$", NsDaemon.h_volume_list),
    _r("GET", r"^/volumes/([^/]+)$", NsDaemon.h_volume_inspect),
    _r("DELETE", r"^/volumes/([^/]+)$", NsDaemon.h_volume_remove),
    _r("POST", r"^/networks/create$", NsDaemon.h_network_create),
    _r("GET", r"^/networks$", NsDaemon.h_network_list),
    _r("GET", r"^/networks/([^/]+)$", NsDaemon.h_network_inspect),
    _r("DELETE", r"^/networks/([^/]+)$", NsDaemon.h_network_remove),
    _r("POST", r"^/networks/([^/]+)/connect$", NsDaemon.h_network_connect),
    _r("POST", r"^/networks/([^/]+)/disconnect$", NsDaemon.h_network_disconnect),
    _r("GET", r"^/events$", NsDaemon.h_events),
]


def serve(state_dir: str, socket_path: str) -> None:
    daemon = NsDaemon(state_dir, socket_path)
    try:
        daemon.serve()
    finally:
        daemon.shutdown()
