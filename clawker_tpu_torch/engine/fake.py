"""In-process fake Docker daemon: the universal unit-test seam.

The port's copy of ``clawker_tpu/engine/fake.py``, whole.

Parity reference: pkg/whail/whailtest FakeAPIClient (SURVEY.md 4) -- the
fake sits at the same method surface as :class:`HTTPDockerAPI`, so all real
middleware (label jail, naming, bootstrap, control plane) runs unmodified
against it.  Adds: semantic container lifecycle with simulated processes,
attach duplex streams, events broadcast, exec handlers, a call recorder, and
failure injection.  Unlike the reference's panic-on-unstubbed discipline,
every method here has working default semantics; tests override behavior
where they care.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from ..errors import ConflictError, NotFoundError
from ..util.ids import short_id


class FakeStreamEnd(Exception):
    pass


class _Pipe:
    """Byte pipe with EOF."""

    def __init__(self):
        self._q: "queue.Queue[bytes | None]" = queue.Queue()
        self._eof = False

    def write(self, data: bytes) -> None:
        if data:
            self._q.put(data)

    def close(self) -> None:
        self._q.put(None)

    def read(self, timeout: float | None = None) -> bytes:
        """One chunk; b"" on EOF."""
        if self._eof:
            return b""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("pipe read timeout")
        if item is None:
            self._eof = True
            return b""
        return item


class FakeProcessIO:
    """Handles given to a simulated container process."""

    def __init__(self, stdin: _Pipe, stdout: _Pipe, kill_event: threading.Event,
                 log_buf: bytearray | None = None):
        self._stdin = stdin
        self._stdout = stdout
        self._log_buf = log_buf
        self.kill_event = kill_event

    def read_stdin(self, timeout: float | None = 5.0) -> bytes:
        return self._stdin.read(timeout)

    def write_stdout(self, data: bytes) -> None:
        # daemons capture container stdout in the log ring whether or not
        # anyone is attached -- so does the fake (container_logs serves it)
        if self._log_buf is not None:
            self._log_buf.extend(data)
        self._stdout.write(data)

    def wait_for_kill(self, timeout: float | None = None) -> bool:
        return self.kill_event.wait(timeout)


Behavior = Callable[[FakeProcessIO], int]


def idle_behavior(io: FakeProcessIO) -> int:
    """Default simulated process: runs until stopped/killed, exits 137."""
    io.wait_for_kill()
    return 137


def exit_behavior(output: bytes = b"", code: int = 0, delay: float = 0.0) -> Behavior:
    def run(io: FakeProcessIO) -> int:
        if delay:
            time.sleep(delay)
        if output:
            io.write_stdout(output)
        return code

    return run


def echo_behavior(io: FakeProcessIO) -> int:
    """Echoes stdin back to stdout until stdin EOF or kill."""
    while not io.kill_event.is_set():
        try:
            data = io.read_stdin(timeout=0.1)
        except TimeoutError:
            continue
        if not data:
            return 0
        io.write_stdout(data)
    return 137


class FakeStream:
    """Duplex attach stream mirroring HijackedStream's interface."""

    def __init__(self, stdin: _Pipe, stdout: _Pipe, tty: bool):
        self._stdin = stdin
        self._stdout = stdout
        self.tty = tty

    def write(self, data: bytes) -> None:
        self._stdin.write(data)

    def close_write(self) -> None:
        self._stdin.close()

    def read(self, n: int = 65536) -> bytes:
        try:
            return self._stdout.read(timeout=10.0)
        except TimeoutError:
            return b""

    def frames(self) -> Iterator[tuple[int, bytes]]:
        while True:
            chunk = self.read()
            if not chunk:
                return
            yield 1, chunk

    def close(self) -> None:
        self._stdin.close()


@dataclass
class FakeContainer:
    id: str
    name: str
    config: dict
    state: str = "created"            # created | running | paused | exited
    exit_code: int = 0
    behavior: Behavior = idle_behavior
    archives: dict[str, bytes] = field(default_factory=dict)  # path -> tar bytes
    stdin: _Pipe = field(default_factory=_Pipe)
    stdout: _Pipe = field(default_factory=_Pipe)
    kill_event: threading.Event = field(default_factory=threading.Event)
    exited: threading.Event = field(default_factory=threading.Event)
    ip: str = ""
    networks: dict[str, str] = field(default_factory=dict)  # net -> ip
    log_buf: bytearray = field(default_factory=bytearray)  # captured stdout

    @property
    def labels(self) -> dict[str, str]:
        return self.config.get("Labels") or {}

    def inspect(self) -> dict:
        nets = {
            n: {"IPAddress": ip} for n, ip in self.networks.items()
        }
        return {
            "Id": self.id,
            "Name": "/" + self.name,
            "Created": "2026-01-01T00:00:00Z",
            "Config": copy.deepcopy(self.config),
            "State": {
                "Status": self.state,
                "Running": self.state == "running",
                "Paused": self.state == "paused",
                "ExitCode": self.exit_code,
                "Pid": 4242 if self.state == "running" else 0,
            },
            "HostConfig": copy.deepcopy(self.config.get("HostConfig", {})),
            "Mounts": [
                _mount_inspect(m) for m in self.config.get("HostConfig", {}).get("Binds", [])
            ],
            "NetworkSettings": {"Networks": nets, "IPAddress": self.ip},
        }

    def summary(self) -> dict:
        return {
            "Id": self.id,
            "Names": ["/" + self.name],
            "Image": self.config.get("Image", ""),
            "Labels": dict(self.labels),
            "State": self.state,
            "Status": self.state,
        }


def _mount_inspect(bind: str) -> dict:
    parts = bind.split(":")
    src, dst = parts[0], parts[1] if len(parts) > 1 else parts[0]
    ro = len(parts) > 2 and "ro" in parts[2]
    return {"Type": "bind", "Source": src, "Destination": dst, "RW": not ro}


class FakeDockerAPI:
    """Drop-in fake for HTTPDockerAPI with semantic state."""

    def __init__(self):
        self.containers: dict[str, FakeContainer] = {}
        self.images: dict[str, dict] = {}       # ref -> {"Id", "Labels", ...}
        self.volumes: dict[str, dict] = {}
        self.networks: dict[str, dict] = {}
        self.execs: dict[str, dict] = {}
        self.calls: list[tuple[str, tuple, dict]] = []
        self.fail_next: dict[str, Exception] = {}
        self.exec_handler: Callable[[FakeContainer, list[str]], tuple[int, bytes]] = (
            lambda c, cmd: (0, b"")
        )
        self.image_behaviors: dict[str, Behavior] = {}
        self.build_hook: Callable[[bytes, list[str]], None] | None = None
        # "1" = legacy-only daemon; "2" = BuildKit default (the engine's
        # Builder probes this via info()["BuilderVersion"])
        self.builder_version = "1"
        self.buildkit_refuse = False  # advertise v2 but reject the lane
        self._event_subs: list[queue.Queue] = []
        self._lock = threading.RLock()
        self._ip_counter = 9

    # ----------------------------------------------------------- test hooks

    def _record(self, name: str, *args, **kw) -> None:
        self.calls.append((name, args, kw))
        if name in self.fail_next:
            raise self.fail_next.pop(name)

    def calls_named(self, name: str) -> list[tuple[tuple, dict]]:
        return [(a, k) for n, a, k in self.calls if n == name]

    def add_image(self, ref: str, labels: dict[str, str] | None = None) -> None:
        self.images[ref] = {
            "Id": "sha256:" + short_id(32),
            "RepoTags": [ref],
            "Labels": labels or {},
        }

    def set_behavior(self, image: str, behavior: Behavior) -> None:
        self.image_behaviors[image] = behavior

    def add_container(self, name: str, *, image: str = "",
                      labels: dict[str, str] | None = None,
                      state: str = "created", exit_code: int = 0,
                      behavior: Behavior | None = None) -> str:
        """Seed a PRE-EXISTING container, bypassing the create/start API
        (and the call recorder): the state a daemon is in when a new CLI
        process arrives -- e.g. loop containers left running by a killed
        scheduler that ``--resume`` must adopt without re-creating.
        ``state`` is created | running | exited; a running container
        gets a live simulated process."""
        if state not in ("created", "running", "exited"):
            raise ValueError(f"add_container: unknown state {state!r}")
        with self._lock:
            for c in self.containers.values():
                if c.name == name:
                    raise ConflictError(f"container name {name} already in use")
            cid = short_id(64)
            config = {"Image": image, "Labels": dict(labels or {})}
            c = FakeContainer(
                id=cid, name=name, config=config,
                behavior=behavior or self.image_behaviors.get(image,
                                                              idle_behavior))
            self.containers[cid] = c
        if state == "running":
            c.state = "running"
            c.ip = c.networks.get("bridge", "") or self._next_ip()
            self._spawn(c)
        elif state == "exited":
            c.state = "exited"
            c.exit_code = exit_code
            c.stdout.close()
            c.exited.set()
        return cid

    def emit_event(self, ev: dict) -> None:
        with self._lock:
            for q in self._event_subs:
                q.put(ev)

    def _event(self, typ: str, action: str, actor_id: str, attrs: dict | None = None) -> None:
        # Real Docker attaches the object's labels to event Actor.Attributes;
        # the managed-label event filter depends on this.
        attributes = dict(attrs or {})
        if typ == "container":
            c = self.containers.get(actor_id)
            if c is not None:
                attributes.update(c.labels)
        self.emit_event(
            {
                "Type": typ,
                "Action": action,
                "Actor": {"ID": actor_id, "Attributes": attributes},
                "time": time.time(),
            }
        )

    def _find(self, ref: str) -> FakeContainer:
        with self._lock:
            if ref in self.containers:
                return self.containers[ref]
            for c in self.containers.values():
                if c.name == ref or c.id.startswith(ref):
                    return c
        raise NotFoundError(f"No such container: {ref}")

    # -------------------------------------------------------------- system

    def ping(self) -> bool:
        self._record("ping")
        return True

    def info(self) -> dict:
        self._record("info")
        return {"Name": "fake-daemon", "ServerVersion": "fake-1.0",
                "Containers": len(self.containers),
                "BuilderVersion": self.builder_version}

    def version(self) -> dict:
        return {"Version": "fake-1.0", "ApiVersion": "1.43"}

    # ---------------------------------------------------------- containers

    def container_create(self, name: str, config: dict) -> dict:
        self._record("container_create", name, config)
        with self._lock:
            for c in self.containers.values():
                if c.name == name:
                    raise ConflictError(f"container name {name} already in use")
            image = config.get("Image", "")
            if image and image not in self.images:
                raise NotFoundError(f"No such image: {image}")
            cid = short_id(64)
            behavior = self.image_behaviors.get(image, idle_behavior)
            c = FakeContainer(id=cid, name=name, config=copy.deepcopy(config), behavior=behavior)
            nc = config.get("NetworkingConfig", {}).get("EndpointsConfig", {})
            for net, epc in nc.items():
                ip = (epc or {}).get("IPAMConfig", {}).get("IPv4Address", "")
                c.networks[net] = ip or self._next_ip()
            self.containers[cid] = c
        self._event("container", "create", cid, {"name": name})
        return {"Id": cid, "Warnings": []}

    def _next_ip(self) -> str:
        self._ip_counter += 1
        return f"172.28.0.{self._ip_counter}"

    def container_start(self, cid: str) -> None:
        self._record("container_start", cid)
        c = self._find(cid)
        if c.state == "running":
            return
        if c.state == "exited":
            # restart: fresh pipes
            c.stdin, c.stdout = _Pipe(), _Pipe()
            c.kill_event = threading.Event()
            c.exited = threading.Event()
        c.state = "running"
        if not c.ip:
            c.ip = c.networks.get("bridge", "") or self._next_ip()

        # start event precedes any possible die (real daemons order it so)
        self._event("container", "start", c.id, {"name": c.name})
        self._spawn(c)

    def _spawn(self, c: FakeContainer) -> None:
        """Run the container's simulated process on a daemon thread."""

        def run() -> None:
            io = FakeProcessIO(c.stdin, c.stdout, c.kill_event, c.log_buf)
            try:
                code = c.behavior(io)
            except Exception:
                code = 1
            with self._lock:
                c.exit_code = code
                c.state = "exited"
            c.stdout.close()
            c.exited.set()
            self._event("container", "die", c.id, {"name": c.name, "exitCode": str(code)})

        threading.Thread(target=run, daemon=True, name=f"fake-{c.name}").start()

    def container_stop(self, cid: str, timeout: int = 10) -> None:
        self._record("container_stop", cid)
        c = self._find(cid)
        if c.state != "running":
            return
        c.kill_event.set()
        c.exited.wait(timeout=5)
        self._event("container", "stop", c.id, {"name": c.name})

    def container_kill(self, cid: str, signal: str = "KILL") -> None:
        self._record("container_kill", cid, signal)
        c = self._find(cid)
        if c.state != "running":
            raise ConflictError(f"container {c.name} is not running")
        c.kill_event.set()
        c.exited.wait(timeout=5)
        self._event("container", "kill", c.id, {"name": c.name, "signal": signal})

    def container_restart(self, cid: str, timeout: int = 10) -> None:
        self.container_stop(cid, timeout)
        self.container_start(cid)

    def container_pause(self, cid: str) -> None:
        self._record("container_pause", cid)
        c = self._find(cid)
        if c.state != "running":
            raise ConflictError("not running")
        c.state = "paused"

    def container_unpause(self, cid: str) -> None:
        self._record("container_unpause", cid)
        c = self._find(cid)
        if c.state != "paused":
            raise ConflictError("not paused")
        c.state = "running"

    def container_remove(self, cid: str, *, force: bool = False, volumes: bool = False) -> None:
        self._record("container_remove", cid, force=force, volumes=volumes)
        c = self._find(cid)
        if c.state == "running":
            if not force:
                raise ConflictError(f"container {c.name} is running; use force")
            c.kill_event.set()
            c.exited.wait(timeout=5)
        with self._lock:
            del self.containers[c.id]
            if volumes:
                for bind in c.config.get("HostConfig", {}).get("Binds", []):
                    src = bind.split(":")[0]
                    self.volumes.pop(src, None)
        # container already deleted from the table: carry labels explicitly
        self._event("container", "destroy", c.id, {"name": c.name, **c.labels})

    def container_rename(self, cid: str, new_name: str) -> None:
        self._record("container_rename", cid, new_name)
        c = self._find(cid)
        with self._lock:
            for other in self.containers.values():
                if other.name == new_name and other is not c:
                    # real daemons 409 here; adoption's replace path
                    # depends on seeing the conflict, not a dup name
                    raise ConflictError(
                        f"container name {new_name} already in use")
            c.name = new_name

    def container_relabel(self, cid: str, labels: dict) -> None:
        """Merge ``labels`` into the container's label set.  Real Docker
        has no relabel endpoint (labels are create-time immutable);
        engines that can do it (this fake; an nsd-style first-party
        daemon could) expose it so warm-pool adoption can finalize the
        agent/epoch labels in place -- Engine.relabel_container degrades
        gracefully where the api lacks the method."""
        self._record("container_relabel", cid, labels)
        c = self._find(cid)
        with self._lock:
            merged = dict(c.config.get("Labels") or {})
            merged.update({str(k): str(v) for k, v in labels.items()})
            c.config["Labels"] = merged

    def container_inspect(self, cid: str) -> dict:
        self._record("container_inspect", cid)
        return self._find(cid).inspect()

    def container_list(self, *, all: bool = False, filters: dict | None = None) -> list[dict]:
        self._record("container_list", all=all, filters=filters)
        out = []
        with self._lock:
            for c in self.containers.values():
                if not all and c.state != "running":
                    continue
                if not _match_filters(c.labels, c.name, filters):
                    continue
                out.append(c.summary())
        return out

    def container_wait(self, cid: str, condition: str = "not-running") -> dict:
        self._record("container_wait", cid)
        c = self._find(cid)
        if c.state == "running":
            c.exited.wait()
        return {"StatusCode": c.exit_code}

    def container_resize(self, cid: str, height: int, width: int) -> None:
        self._record("container_resize", cid, height, width)
        self._find(cid)

    def container_attach(self, cid: str, *, tty: bool, stdin: bool = True, logs: bool = False) -> FakeStream:
        self._record("container_attach", cid, tty=tty)
        c = self._find(cid)
        return FakeStream(c.stdin, c.stdout, tty)

    def container_logs(self, cid: str, *, follow: bool = False, tail: str = "all") -> Iterator[bytes]:
        self._record("container_logs", cid)
        c = self._find(cid)
        if follow:
            # stream-until-exit semantics collapse to: wait, then snapshot
            c.exited.wait(10.0)
        elif c.state == "running" and not c.log_buf:
            # a just-started behavior may not have written yet; give the
            # simulated process one beat, like a daemon's log ring would
            c.exited.wait(0.5)
        body = bytes(c.log_buf)
        if tail != "all":
            try:
                lines = body.splitlines(keepends=True)
                body = b"".join(lines[-int(tail):])
            except ValueError:
                pass
        if not body:
            return iter(())
        if not (c.config.get("Tty") or False):
            # non-TTY log bodies are stdcopy-framed by real daemons;
            # Engine.logs() demuxes, so unframed bytes would corrupt
            import struct as _struct

            body = b"\x01\x00\x00\x00" + _struct.pack(">I", len(body)) + body
        return iter([body])

    def put_archive(self, cid: str, path: str, tar_bytes: bytes) -> None:
        self._record("put_archive", cid, path)
        c = self._find(cid)
        c.archives[path] = tar_bytes

    def get_archive(self, cid: str, path: str) -> bytes:
        self._record("get_archive", cid, path)
        c = self._find(cid)
        if path not in c.archives:
            raise NotFoundError(f"no archive at {path}")
        return c.archives[path]

    # ---------------------------------------------------------------- exec

    def exec_create(self, cid: str, config: dict) -> dict:
        self._record("exec_create", cid, config)
        c = self._find(cid)
        eid = short_id(32)
        self.execs[eid] = {"container": c.id, "config": config, "exit": None}
        return {"Id": eid}

    def exec_start(self, exec_id: str, *, tty: bool = False, detach: bool = False):
        self._record("exec_start", exec_id, tty=tty, detach=detach)
        e = self.execs[exec_id]
        c = self.containers[e["container"]]
        cmd = e["config"].get("Cmd", [])
        code, output = self.exec_handler(c, cmd)
        e["exit"] = code
        if detach:
            return None
        stdin, stdout = _Pipe(), _Pipe()
        stdout.write(output)
        stdout.close()
        return FakeStream(stdin, stdout, tty)

    def exec_inspect(self, exec_id: str) -> dict:
        e = self.execs[exec_id]
        return {"ExitCode": e["exit"] if e["exit"] is not None else 0, "Running": False}

    # -------------------------------------------------------------- images

    def image_list(self, *, filters: dict | None = None) -> list[dict]:
        self._record("image_list", filters=filters)
        out = []
        for ref, img in self.images.items():
            if _match_filters(img.get("Labels") or {}, ref, filters):
                out.append({**img, "RepoTags": [ref]})
        return out

    def image_inspect(self, ref: str) -> dict:
        self._record("image_inspect", ref)
        if ref in self.images:
            return self.images[ref]
        for r, img in self.images.items():
            if img["Id"] == ref or img["Id"].startswith("sha256:" + ref):
                return img
        raise NotFoundError(f"No such image: {ref}")

    def image_tag(self, ref: str, repo: str, tag: str) -> None:
        self._record("image_tag", ref, repo, tag)
        img = self.image_inspect(ref)
        self.images[f"{repo}:{tag}"] = {**img}

    def image_remove(self, ref: str, *, force: bool = False) -> None:
        self._record("image_remove", ref, force=force)
        if ref not in self.images:
            raise NotFoundError(f"No such image: {ref}")
        del self.images[ref]

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
    ) -> Iterator[dict]:
        self._record(
            "image_build", tags=tags, labels=labels, dockerfile=dockerfile, no_cache=no_cache
        )
        if self.build_hook:
            self.build_hook(context_tar, tags)
        for t in tags:
            self.add_image(t, labels=labels or {})

        def gen() -> Iterator[dict]:
            yield {"stream": "Step 1/1 : FROM scratch\n"}
            yield {"aux": {"ID": "sha256:" + short_id(32)}}
            yield {"stream": "Successfully built\n"}

        return gen()

    def image_build_buildkit(self, context_tar: bytes, **kw) -> Iterator[dict]:
        """BuildKit lane over the fake daemon: a recorded version=2
        transcript (aux trace records carrying real protobuf bytes) so
        the whole decode path runs in tests."""
        import base64

        from .bkproto import StatusResponse, Vertex, VertexLog, encode_status
        from ..errors import DriverError

        tags = kw.get("tags") or []
        self._record("image_build_buildkit", tags=tags)
        if self.buildkit_refuse:
            raise DriverError("buildkit session required (fake refusal)")
        if self.build_hook:
            self.build_hook(context_tar, tags)
        for t in tags:
            self.add_image(t, labels=kw.get("labels") or {})

        def aux(resp: StatusResponse) -> dict:
            return {"id": "moby.buildkit.trace",
                    "aux": base64.b64encode(encode_status(resp)).decode()}

        def gen() -> Iterator[dict]:
            d1, d2 = "sha256:aaa1", "sha256:bbb2"
            yield aux(StatusResponse(vertexes=[
                Vertex(digest=d1, name="[internal] load build definition",
                       started=1.0)]))
            yield aux(StatusResponse(
                vertexes=[Vertex(digest=d1, name="[internal] load build definition",
                                 started=1.0, completed=1.2),
                          Vertex(digest=d2, name="[1/1] FROM scratch",
                                 started=1.2)],
                logs=[VertexLog(vertex=d2, msg=b"hello from buildkit\n")]))
            yield aux(StatusResponse(vertexes=[
                Vertex(digest=d2, name="[1/1] FROM scratch",
                       started=1.2, completed=2.0)]))
            yield {"aux": {"ID": "sha256:" + short_id(32)}}

        return gen()

    def image_pull(self, ref: str) -> Iterator[dict]:
        self._record("image_pull", ref)
        self.add_image(ref if ":" in ref.rsplit("/", 1)[-1] else ref + ":latest")

        def gen() -> Iterator[dict]:
            yield {"status": f"Pulling from {ref}"}
            yield {"status": "Download complete"}

        return gen()

    # ------------------------------------------------------------- volumes

    def volume_create(self, name: str, labels: dict[str, str] | None = None) -> dict:
        self._record("volume_create", name, labels)
        if name not in self.volumes:
            self.volumes[name] = {"Name": name, "Labels": labels or {}, "Driver": "local"}
        return self.volumes[name]

    def volume_list(self, *, filters: dict | None = None) -> dict:
        self._record("volume_list", filters=filters)
        vols = [
            v for v in self.volumes.values()
            if _match_filters(v.get("Labels") or {}, v["Name"], filters)
        ]
        return {"Volumes": vols, "Warnings": []}

    def volume_inspect(self, name: str) -> dict:
        self._record("volume_inspect", name)
        if name not in self.volumes:
            raise NotFoundError(f"No such volume: {name}")
        return self.volumes[name]

    def volume_remove(self, name: str, *, force: bool = False) -> None:
        self._record("volume_remove", name, force=force)
        if name not in self.volumes:
            if force:
                return
            raise NotFoundError(f"No such volume: {name}")
        del self.volumes[name]

    # ------------------------------------------------------------ networks

    def network_create(self, name: str, config: dict) -> dict:
        self._record("network_create", name, config)
        for n in self.networks.values():
            if n["Name"] == name:
                raise ConflictError(f"network {name} exists")
        nid = short_id(64)
        subnet = "172.28.0.0/16"
        ipam = config.get("IPAM", {}).get("Config") or []
        if ipam and ipam[0].get("Subnet"):
            subnet = ipam[0]["Subnet"]
        self.networks[nid] = {
            "Id": nid,
            "Name": name,
            "Labels": config.get("Labels") or {},
            "IPAM": {"Config": [{"Subnet": subnet}]},
            "Containers": {},
        }
        return {"Id": nid}

    def network_list(self, *, filters: dict | None = None) -> list[dict]:
        self._record("network_list", filters=filters)
        return [
            n for n in self.networks.values()
            if _match_filters(n.get("Labels") or {}, n["Name"], filters)
        ]

    def network_inspect(self, ref: str) -> dict:
        self._record("network_inspect", ref)
        for n in self.networks.values():
            if n["Id"].startswith(ref) or n["Name"] == ref:
                return n
        raise NotFoundError(f"No such network: {ref}")

    def network_remove(self, ref: str) -> None:
        self._record("network_remove", ref)
        n = self.network_inspect(ref)
        del self.networks[n["Id"]]

    def network_connect(self, net: str, cid: str, *, ipv4: str = "") -> None:
        self._record("network_connect", net, cid, ipv4=ipv4)
        n = self.network_inspect(net)
        c = self._find(cid)
        ip = ipv4 or self._next_ip()
        c.networks[n["Name"]] = ip
        n["Containers"][c.id] = {"IPv4Address": ip}

    def network_disconnect(self, net: str, cid: str, *, force: bool = False) -> None:
        self._record("network_disconnect", net, cid)
        n = self.network_inspect(net)
        c = self._find(cid)
        c.networks.pop(n["Name"], None)
        n["Containers"].pop(c.id, None)

    # -------------------------------------------------------------- events

    def events(self, *, filters: dict | None = None) -> Iterator[dict]:
        self._record("events", filters=filters)
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._event_subs.append(q)

        def gen() -> Iterator[dict]:
            try:
                while True:
                    ev = q.get()
                    if ev is None:
                        return
                    if filters and not _event_matches(ev, filters):
                        continue
                    yield ev
            finally:
                with self._lock:
                    if q in self._event_subs:
                        self._event_subs.remove(q)

        return gen()

    def close_events(self) -> None:
        with self._lock:
            for q in self._event_subs:
                q.put(None)

    def pool_stats(self) -> dict:
        """Surface parity with HTTPDockerAPI: no sockets, all zeros."""
        return {"dials": 0, "reuses": 0, "stale_retries": 0,
                "suppressed_retries": 0, "idle": 0}

    def close(self) -> None:
        """Surface parity with HTTPDockerAPI.close (drain-on-shutdown)."""
        self._record("close")
        self.close_events()


def _match_filters(labels: dict[str, str], name: str, filters: dict | None) -> bool:
    if not filters:
        return True
    for want in filters.get("label", []):
        if "=" in want:
            k, v = want.split("=", 1)
            if labels.get(k) != v:
                return False
        elif want not in labels:
            return False
    for want in filters.get("name", []):
        if want not in name:
            return False
    return True


def _event_matches(ev: dict, filters: dict) -> bool:
    if types := filters.get("type"):
        if ev.get("Type") not in types:
            return False
    if wants := filters.get("label"):
        attrs = ev.get("Actor", {}).get("Attributes", {})
        for want in wants:
            if "=" in want:
                k, v = want.split("=", 1)
                if attrs.get(k) != v:
                    return False
            elif want not in attrs:
                return False
    return True
