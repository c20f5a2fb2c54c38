"""nsd container runtime: overlay rootfs + namespaced processes + IO hub.

One NsContainer per create.  The daemon (server.py) owns the registry;
this module owns everything that touches the kernel: overlay mounts,
the unshare+shim spawn, cgroup placement, signal-based stop semantics,
nsenter execs, archive IO against the merged rootfs and the multi-client
attach hub with Docker stdcopy framing.

Parity reference: the engine-facing behavior mirrors what the docker
middleware expects from dockerd (SURVEY.md 2.3); the runtime mechanics
are first-party (see package docstring).

The port's copy of ``clawker_tpu/nsd/runtime.py``, whole.
"""

from __future__ import annotations

import ctypes
import fcntl
import io
import json
import os
import pty
import select
import shutil
import signal
import struct
import subprocess
import sys
import tarfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

_libc = ctypes.CDLL(None, use_errno=True)

REPO_ROOT = str(Path(__file__).resolve().parent.parent.parent)

STDOUT, STDERR = 1, 2


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _cgroup_preexec(cg: Path | None):
    """Fork-time cgroup migration for container init AND execs.  Failing
    to join is FATAL (the exec aborts): proceeding outside the cgroup
    would silently escape the firewall's enforcement scope."""

    def pre_exec() -> None:
        if cg is not None:
            (cg / "cgroup.procs").write_text(str(os.getpid()))

    return pre_exec


def frame(stream: int, payload: bytes) -> bytes:
    """Docker stdcopy framing: [stream, 0, 0, 0, len_be32, payload]."""
    return bytes([stream, 0, 0, 0]) + struct.pack(">I", len(payload)) + payload


def _inside(p: Path | str, base: str) -> bool:
    """True when p is base or under base (separator-aware: /a/bc is NOT
    inside /a/b)."""
    sp = str(p)
    return sp == base or sp.startswith(base.rstrip("/") + "/")


class Hub:
    """Fan-out for one container's output + fan-in for its stdin.

    Clients attach before or after start; each gets the framed (or raw,
    for tty) byte stream from the moment it attached.  ``logs`` readers
    get the persisted file instead.
    """

    def __init__(self, log_path: Path, tty: bool):
        self.log_path = log_path
        self.tty = tty
        self._clients: list = []            # socket-like objects
        self._stdin = None                  # container stdin fd (master/pipe)
        self._log_f = None                  # persistent append handle
        self._lock = threading.Lock()

    def set_stdin(self, fd: int | None) -> None:
        with self._lock:
            self._stdin = fd

    def add_client(self, sock) -> None:
        with self._lock:
            self._clients.append(sock)

    def remove_client(self, sock) -> None:
        with self._lock:
            if sock in self._clients:
                self._clients.remove(sock)

    def write_stdin(self, data: bytes) -> None:
        with self._lock:
            fd = self._stdin
        if fd is not None:
            try:
                os.write(fd, data)
            except OSError:
                pass

    def broadcast(self, stream: int, payload: bytes) -> None:
        data = payload if self.tty else frame(stream, payload)
        with self._lock:
            if self._log_f is None:
                self._log_f = open(self.log_path, "ab")
            self._log_f.write(data)
            self._log_f.flush()
            clients = list(self._clients)
        for c in clients:
            try:
                c.sendall(data)
            except OSError:
                self.remove_client(c)

    def close_clients(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients), []
            if self._log_f is not None:
                try:
                    self._log_f.close()
                except OSError:
                    pass
                self._log_f = None
        for c in clients:
            try:
                c.shutdown(2)
            except OSError:
                pass


@dataclass
class NsContainer:
    id: str
    name: str
    config: dict                    # docker-shaped create config
    dir: Path                       # state dir: upper/work/merged/...
    cgroup_dir: Path | None
    state: str = "created"          # created|running|exited
    exit_code: int = 0
    created_at: str = field(default_factory=_now)
    started_at: str = ""
    finished_at: str = ""
    proc: subprocess.Popen | None = None
    init_pid: int = 0
    hub: Hub | None = None
    _waiter: threading.Thread | None = None
    _pumper: threading.Thread | None = None
    _exited: threading.Event = field(default_factory=threading.Event)

    # ------------------------------------------------------------- helpers

    @property
    def merged(self) -> Path:
        return self.dir / "merged"

    @property
    def labels(self) -> dict:
        return self.config.get("Labels") or {}

    @property
    def tty(self) -> bool:
        return bool(self.config.get("Tty"))

    def binds(self) -> list[str]:
        return list((self.config.get("HostConfig") or {}).get("Binds") or [])

    # ------------------------------------------------------------- inspect

    def inspect(self) -> dict:
        return {
            "Id": self.id,
            "Name": "/" + self.name,
            # first-party extension: where this container's cgroup lives,
            # so the firewall's CgroupResolver enrolls nsd containers
            # without daemon-specific path guessing
            "NsdCgroupDir": str(self.cgroup_dir) if self.cgroup_dir else "",
            "Created": self.created_at,
            "Config": json.loads(json.dumps(self.config)),
            "State": {
                "Status": self.state,
                "Running": self.state == "running",
                "Paused": False,
                "ExitCode": self.exit_code,
                "Pid": self.init_pid if self.state == "running" else 0,
                "StartedAt": self.started_at,
                "FinishedAt": self.finished_at,
            },
            "HostConfig": json.loads(json.dumps(
                self.config.get("HostConfig") or {})),
            "Mounts": [self._mount_inspect(b) for b in self.binds()],
            "NetworkSettings": {"Networks": {}, "IPAddress": "127.0.0.1"},
        }

    @staticmethod
    def _mount_inspect(bind: str) -> dict:
        parts = bind.split(":")
        src = parts[0]
        dst = parts[1] if len(parts) > 1 else parts[0]
        ro = len(parts) > 2 and "ro" in parts[2].split(",")
        return {"Type": "bind", "Source": src, "Destination": dst, "RW": not ro}

    def summary(self) -> dict:
        return {
            "Id": self.id,
            "Names": ["/" + self.name],
            "Image": self.config.get("Image", ""),
            "Labels": dict(self.labels),
            "State": self.state,
            "Status": self.state,
        }


class NsRuntime:
    """Kernel-facing operations for NsContainer instances."""

    def __init__(self, state_dir: Path, *, cgroup_root: Path | None = None):
        self.state_dir = Path(state_dir)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self.cgroup_root = cgroup_root

    # -------------------------------------------------------------- create

    def prepare(self, c: NsContainer) -> None:
        """Directories + overlay mount; the container gets a live merged
        rootfs at create time so put_archive works before start (the
        identity bootstrap tars material into created containers)."""
        for sub in ("upper", "work", "merged"):
            (c.dir / sub).mkdir(parents=True, exist_ok=True)
        self._mount_overlay(c)
        c.hub = Hub(c.dir / "container.log", c.tty)
        if c.cgroup_dir is not None:
            c.cgroup_dir.mkdir(parents=True, exist_ok=True)

    def _mount_overlay(self, c: NsContainer) -> None:
        if os.path.ismount(c.merged):
            return
        opts = (f"lowerdir=/,upperdir={c.dir / 'upper'},"
                f"workdir={c.dir / 'work'}")
        res = subprocess.run(
            ["mount", "-t", "overlay", "overlay", "-o", opts, str(c.merged)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"overlay mount failed: {res.stderr.strip()}")

    # --------------------------------------------------------------- start

    def start(self, c: NsContainer, on_exit=None) -> None:
        if c.state == "running":
            return
        self._mount_overlay(c)
        shim_cfg = {
            "merged": str(c.merged),
            "binds": c.binds(),
            "hostname": c.config.get("Hostname") or c.name,
            "env": self._env_dict(c),
            "workdir": c.config.get("WorkingDir") or "/",
            "cmd": self._cmd(c),
            "tty": c.tty,
        }
        cfg_path = c.dir / "shim.json"
        cfg_path.write_text(json.dumps(shim_cfg))

        # --cgroup: the namespace captures at unshare time, AFTER the
        # preexec joined the container cgroup -- so the container's
        # cgroup view is rooted at its OWN cgroup and even a fresh
        # cgroup2 mount inside cannot reach (or move processes to) any
        # ancestor, sealing the move-yourself-out firewall escape
        argv = ["unshare", "--fork", "--pid", "--mount", "--uts", "--ipc",
                "--cgroup", "--kill-child",
                sys.executable, "-m", "clawker_tpu_torch.nsd.shim",
                str(cfg_path)]
        spawn_env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                     "PYTHONPATH": REPO_ROOT}
        pre_exec = _cgroup_preexec(c.cgroup_dir)

        if c.tty:
            master, slave = pty.openpty()
            c.proc = subprocess.Popen(
                argv, stdin=slave, stdout=slave, stderr=slave,
                env=spawn_env, start_new_session=True, preexec_fn=pre_exec,
                close_fds=True)
            os.close(slave)
            c.hub.set_stdin(master)
            pump_fds = [(master, STDOUT)]
        else:
            stdin_r, stdin_w = os.pipe()
            out_r, out_w = os.pipe()
            err_r, err_w = os.pipe()
            c.proc = subprocess.Popen(
                argv, stdin=stdin_r, stdout=out_w, stderr=err_w,
                env=spawn_env, start_new_session=True, preexec_fn=pre_exec,
                close_fds=True)
            for fd in (stdin_r, out_w, err_w):
                os.close(fd)
            c.hub.set_stdin(stdin_w)
            pump_fds = [(out_r, STDOUT), (err_r, STDERR)]

        c.state = "running"
        c.started_at = _now()
        c._exited.clear()
        c.init_pid = self._find_init_pid(c.proc.pid)
        c._pumper = threading.Thread(target=self._pump, args=(c, pump_fds),
                                     name=f"nsd-io-{c.id[:8]}", daemon=True)
        c._pumper.start()
        c._waiter = threading.Thread(target=self._wait, args=(c, on_exit),
                                     name=f"nsd-wait-{c.id[:8]}", daemon=True)
        c._waiter.start()

    def _env_dict(self, c: NsContainer) -> dict:
        out: dict[str, str] = {}
        for kv in c.config.get("Env") or []:
            k, _, v = kv.partition("=")
            out[k] = v
        return out

    def _cmd(self, c: NsContainer) -> list[str]:
        entry = c.config.get("Entrypoint") or []
        cmd = c.config.get("Cmd") or []
        argv = list(entry) + list(cmd)
        return argv or ["/bin/sh"]

    @staticmethod
    def _find_init_pid(unshare_pid: int, timeout: float = 3.0) -> int:
        """The container init = unshare's forked child (host-ns view)."""
        deadline = time.monotonic() + timeout
        children = Path(f"/proc/{unshare_pid}/task/{unshare_pid}/children")
        while time.monotonic() < deadline:
            try:
                kids = children.read_text().split()
            except OSError:
                return 0
            if kids:
                return int(kids[0])
            time.sleep(0.005)
        return 0

    def _pump(self, c: NsContainer, fds: list[tuple[int, int]]) -> None:
        open_fds = dict(fds)
        while open_fds:
            try:
                ready, _, _ = select.select(list(open_fds), [], [], 0.5)
            except OSError:
                break
            for fd in ready:
                try:
                    chunk = os.read(fd, 65536)
                except OSError:
                    chunk = b""
                if not chunk:
                    os.close(fd)
                    del open_fds[fd]
                    continue
                c.hub.broadcast(open_fds[fd], chunk)

    def _wait(self, c: NsContainer, on_exit) -> None:
        code = c.proc.wait()
        # dockerd convention: signal deaths report as 128+signum
        c.exit_code = code if code >= 0 else 128 - code
        c.state = "exited"
        c.finished_at = _now()
        stdin = c.hub._stdin
        c.hub.set_stdin(None)
        if stdin is not None:
            try:
                os.close(stdin)
            except OSError:
                pass
        # drain: the pump ends at fd EOF, which the exit guarantees
        if c._pumper is not None:
            c._pumper.join(timeout=2.0)
        c.hub.close_clients()
        c._exited.set()
        if on_exit:
            on_exit(c)

    # ------------------------------------------------------------- signals

    def stop(self, c: NsContainer, timeout: int = 10) -> None:
        """SIGTERM to the container init, SIGKILL after the grace period
        (kernel rule: only KILL/STOP reach a namespace init from outside
        unless it installed handlers -- same grace dance as dockerd)."""
        if c.state != "running":
            return
        if c.init_pid:
            try:
                os.kill(c.init_pid, signal.SIGTERM)
            except OSError:
                pass
        if not c._exited.wait(timeout):
            self.kill(c)
            c._exited.wait(5)

    def kill(self, c: NsContainer, sig: int = signal.SIGKILL) -> None:
        if c.state != "running":
            return
        for pid in (c.init_pid, c.proc.pid if c.proc else 0):
            if pid:
                try:
                    os.kill(pid, sig)
                except OSError:
                    pass

    def wait(self, c: NsContainer, timeout: float | None = None) -> int:
        c._exited.wait(timeout)
        return c.exit_code

    # -------------------------------------------------------------- remove

    def remove(self, c: NsContainer) -> None:
        if c.state == "running":
            self.kill(c)
            c._exited.wait(5)
        subprocess.run(["umount", "-l", str(c.merged)], capture_output=True)
        shutil.rmtree(c.dir, ignore_errors=True)
        if c.cgroup_dir is not None:
            try:
                c.cgroup_dir.rmdir()
            except OSError:
                pass

    # ------------------------------------------------------------- archive

    def put_archive(self, c: NsContainer, path: str, tar_bytes: bytes) -> None:
        self._mount_overlay(c)
        base, dest, ro = self._resolve_in_rootfs(c, path)
        if ro:
            # a `:ro` bind is a promise to the HOST: archive writes
            # resolve to the bind source, so honoring the flag here is
            # what keeps a read-only mount from being writable through
            # the API (ADVICE r5; dockerd 403s the same way)
            raise PermissionError(
                f"bind mounted read-only: {path}")
        dest.mkdir(parents=True, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tf:
            for m in tf.getmembers():
                target = (dest / m.name).resolve()
                if not _inside(target, base):
                    raise RuntimeError(f"archive member escapes rootfs: {m.name}")
            # filter="data" closes the tar-slip TOCTOU the pre-check
            # cannot (symlink member + path THROUGH it resolves clean
            # before extraction creates the link)
            tf.extractall(dest, filter="data")

    def get_archive(self, c: NsContainer, path: str) -> bytes:
        _, src, _ro = self._resolve_in_rootfs(c, path)
        if not src.exists():
            raise FileNotFoundError(path)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            tf.add(src, arcname=src.name)
        return buf.getvalue()

    def _resolve_in_rootfs(self, c: NsContainer, path: str
                           ) -> tuple[str, Path, bool]:
        """-> (guard base, resolved host path, read_only).  Bind
        destinations shadow the overlay inside the container, so archive
        ops under a bind go to the bind SOURCE (dockerd resolves mounts
        the same way -- that is how volume seeding lands in the volume,
        not under the future mount point).  ``read_only`` reports the
        winning bind's ``:ro`` option so writers can refuse instead of
        writing through to the host source."""
        norm = "/" + path.strip("/")
        best: tuple[str, str, bool] | None = None
        for b in c.binds():
            parts = b.split(":")
            if len(parts) < 2 or not parts[0].startswith("/"):
                continue
            src, dst = parts[0], "/" + parts[1].strip("/")
            opts = parts[2] if len(parts) > 2 else ""
            if norm == dst or norm.startswith(dst + "/"):
                if best is None or len(dst) > len(best[1]):
                    best = (src, dst, "ro" in opts.split(","))
        if best is not None:
            base = str(Path(best[0]).resolve())
            p = (Path(base) / norm[len(best[1]):].lstrip("/")).resolve()
            ro = best[2]
        else:
            base = str(c.merged.resolve())
            p = (c.merged / norm.lstrip("/")).resolve()
            ro = False
        if not _inside(p, base):
            raise RuntimeError(f"path escapes rootfs: {path}")
        return base, p, ro

    # ---------------------------------------------------------------- exec

    def exec_spawn(self, c: NsContainer, config: dict) -> subprocess.Popen:
        """nsenter into the container's namespaces; caller pumps IO."""
        if c.state != "running" or not c.init_pid:
            raise RuntimeError("container is not running")
        cmd = config.get("Cmd") or ["/bin/sh"]
        wd = config.get("WorkingDir") or "/"
        env = {}
        for kv in config.get("Env") or []:
            k, _, v = kv.partition("=")
            env[k] = v
        argv = ["nsenter", "-t", str(c.init_pid), "-m", "-u", "-i", "-p",
                f"--wdns={wd}", "env", "-"]
        base_env = self._env_dict(c)
        base_env.setdefault("PATH", "/usr/local/sbin:/usr/local/bin:"
                                    "/usr/sbin:/usr/bin:/sbin:/bin")
        for k, v in {**base_env, **env}.items():
            argv.append(f"{k}={v}")
        argv += list(cmd)
        tty = bool(config.get("Tty"))
        # execs belong to the CONTAINER's cgroup (docker semantics):
        # the egress firewall keys enforcement on it
        pre_exec = _cgroup_preexec(c.cgroup_dir)

        if tty:
            master, slave = pty.openpty()
            p = subprocess.Popen(argv, stdin=slave, stdout=slave,
                                 stderr=slave, start_new_session=True,
                                 preexec_fn=pre_exec, close_fds=True)
            os.close(slave)
            p.nsd_io = (master, None, None)  # type: ignore[attr-defined]
        else:
            p = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE,
                                 preexec_fn=pre_exec, close_fds=True)
            p.nsd_io = None  # type: ignore[attr-defined]
        return p

    # ----------------------------------------------------------------- tty

    def resize(self, c: NsContainer, rows: int, cols: int) -> None:
        fd = c.hub._stdin if c.tty else None
        if fd is None:
            return
        try:
            fcntl.ioctl(fd, 0x5414,  # TIOCSWINSZ
                        struct.pack("HHHH", rows, cols, 0, 0))
        except OSError:
            pass
