"""SSH transport to TPU-VM workers: exec, file push, socket forwarding.

One ``SSHTransport`` per worker host.  All sessions ride a shared
OpenSSH ControlMaster mux (ControlPersist keeps the TCP+auth warm, so
per-command latency is one round trip -- the property the <10s
cold-start budget depends on).  The Docker Engine API is reached by
forwarding the worker's ``/var/run/docker.sock`` to a local unix socket
and pointing ``HTTPDockerAPI``'s socket factory at it: the whole engine
stack (label jail, PTY attach, build streaming) works unchanged against
a remote daemon -- the graft is a transport substitution, exactly as
SURVEY.md 2.13 frames it.

The ``Runner`` seam (subprocess ssh vs ``FakeRunner`` scripted
transcripts) is the fleet's fake-engine analogue: every provisioning and
transport decision is unit-testable with no SSH or TPU in sight
(SURVEY.md 4's "multi-node-without-a-cluster" strategy).

The port's copy of ``clawker_tpu/fleet/transport.py``, whole; the
engine it hands back is the port's ``HTTPDockerAPI``.  A run with no
SSH server puts :func:`clawker_tpu_torch.testenv.install_ssh_shim`'s
loopback ``ssh`` first on ``PATH``: the real :class:`Runner` execs it.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .. import consts, logsetup
from ..config.schema import TPUSettings
from ..errors import DriverError

log = logsetup.get("fleet.transport")

FORWARD_READY_DEADLINE_S = 10.0


class TransportError(DriverError):
    pass


@dataclass
class RunResult:
    rc: int
    out: str
    err: str


class Runner:
    """Executes ssh invocations (seam for tests)."""

    def run(self, argv: list[str], *, input_bytes: bytes | None = None,
            timeout: float = 60.0) -> RunResult:
        try:
            res = subprocess.run(argv, input=input_bytes, capture_output=True,
                                 timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise TransportError(f"{argv[0]}: {e}") from None
        return RunResult(res.returncode, res.stdout.decode(errors="replace"),
                         res.stderr.decode(errors="replace"))

    def spawn(self, argv: list[str]) -> subprocess.Popen:
        return subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

    def spawn_piped(self, argv: list[str]) -> subprocess.Popen:
        """Long-lived stream whose stdout the caller consumes (egress
        tails riding the SSH mux -- fleet/egress_tail.py)."""
        return subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)


class FakeRunner(Runner):
    """Scripted transcripts: remote command string -> (rc, out).

    Keys are matched as substrings of the joined remote command (or the
    local argv for spawns); unmatched commands succeed empty, so scripts
    only state what they care about.  Every invocation is recorded.
    """

    def __init__(self, script: dict[str, tuple[int, str]] | None = None,
                 stream_script: dict[str, list[str]] | None = None):
        self.script = dict(script or {})
        # needle -> lines a spawn_piped stream yields before EOF
        self.stream_script = dict(stream_script or {})
        self.calls: list[list[str]] = []
        self.pushed: dict[str, bytes] = {}   # remote path -> tar bytes
        self.spawned: list[list[str]] = []

    def run(self, argv, *, input_bytes=None, timeout=60.0):
        self.calls.append(list(argv))
        joined = " ".join(argv)
        if input_bytes is not None and "tar" in joined:
            # record pushes by their extraction directory
            dst = argv[-1].split("-C ")[-1].split(" ")[0] if "-C " in argv[-1] else joined
            self.pushed[dst] = input_bytes
        for needle, (rc, out) in self.script.items():
            if needle in joined:
                return RunResult(rc, out, "" if rc == 0 else out)
        return RunResult(0, "", "")

    def spawn(self, argv):
        self.spawned.append(list(argv))

        class _P:
            def poll(self):
                return None

            def terminate(self):
                pass

            def wait(self, timeout=None):
                return 0

        return _P()

    def spawn_piped(self, argv):
        import io as _io

        self.spawned.append(list(argv))
        joined = " ".join(argv)
        lines: list[str] = []
        for needle, out in self.stream_script.items():
            if needle in joined:
                lines = out
        body = "".join(l + "\n" for l in lines).encode()

        class _P:
            stdout = _io.BytesIO(body)

            def poll(self):
                return 0

            def terminate(self):
                pass

            def wait(self, timeout=None):
                return 0

        return _P()


class SSHTransport:
    def __init__(self, tpu: TPUSettings, host: str, index: int,
                 *, mux_dir: Path, runner: Runner | None = None):
        self.tpu = tpu
        self.host = host
        self.index = index
        self.mux_dir = Path(mux_dir)
        self.runner = runner or Runner()
        # injectable per-call RTT (the fake-WAN harness for REAL
        # transports; docs/workerd.md#fake-wan): every mux command pays
        # this before dispatch, so a bench/test can make a local ssh
        # target behave like a cross-continent worker deterministically
        self.rtt_s = 0.0
        self._forwards: list[subprocess.Popen] = []
        self._rev_tags: set[str] = set()
        self._lock = threading.Lock()
        # once, not per ssh invocation: every command used to re-mkdir the
        # mux dir and rebuild the same argv
        self.mux_dir.mkdir(parents=True, exist_ok=True)
        base = [
            "ssh",
            "-o", "BatchMode=yes",
            "-o", "StrictHostKeyChecking=accept-new",
            "-o", "ControlMaster=auto",
            "-o", f"ControlPath={self.mux_dir}/%r@%h:%p",
            "-o", "ControlPersist=300",
            "-o", "ServerAliveInterval=30",
        ]
        if self.tpu.ssh_key:
            base += ["-i", self.tpu.ssh_key]
        user = self.tpu.ssh_user or consts.TPU_SSH_USER_DEFAULT
        self._ssh_base = base + [f"{user}@{self.host}"]

    # ------------------------------------------------------------ command

    def ssh_base(self) -> list[str]:
        return list(self._ssh_base)

    def run(self, remote_cmd: str, *, input_bytes: bytes | None = None,
            timeout: float = 120.0) -> RunResult:
        if self.rtt_s > 0:
            time.sleep(self.rtt_s)      # injected fake-WAN round trip
        return self.runner.run(self.ssh_base() + [remote_cmd],
                               input_bytes=input_bytes, timeout=timeout)

    def probe(self, *, timeout: float = 5.0) -> float:
        """One control-channel round trip (``true`` over the mux);
        returns latency in seconds, raises TransportError on failure.
        The fleet health prober's SSH-level signal: distinguishes a dead
        forwarded daemon (engine probe fails, this succeeds) from a dead
        worker VM (both fail)."""
        t0 = time.monotonic()
        res = self.run("true", timeout=timeout)
        if res.rc != 0:
            raise TransportError(
                f"worker {self.index} ({self.host}): ssh probe rc={res.rc}: "
                f"{res.err.strip() or res.out.strip()}")
        return time.monotonic() - t0

    def check(self, remote_cmd: str, *, timeout: float = 120.0) -> str:
        res = self.run(remote_cmd, timeout=timeout)
        if res.rc != 0:
            raise TransportError(
                f"worker {self.index} ({self.host}): `{remote_cmd}` "
                f"rc={res.rc}: {res.err.strip() or res.out.strip()}"
            )
        return res.out

    # --------------------------------------------------------------- push

    def push_tar(self, tar_bytes: bytes, remote_dir: str, *,
                 sudo: bool = False) -> None:
        """Stream a tarball over stdin and extract it on the worker --
        one round trip, no scp dependency.  ``sudo`` creates root-owned
        target dirs (e.g. /opt) and hands them to the SSH user so later
        unprivileged builds can write there."""
        quoted = shlex.quote(remote_dir)
        if sudo:
            setup = (f"sudo mkdir -p {quoted} && "
                     f"sudo chown \"$(id -u):$(id -g)\" {quoted}")
        else:
            setup = f"mkdir -p {quoted}"
        res = self.run(
            f"{setup} && tar -xzf - -C {quoted}",
            input_bytes=tar_bytes, timeout=300.0,
        )
        if res.rc != 0:
            raise TransportError(
                f"worker {self.index}: push to {remote_dir} failed: {res.err.strip()}"
            )

    def push_paths(self, paths: dict[str, str | Path], remote_dir: str) -> None:
        """{archive-name: local path} -> tar.gz -> remote_dir."""
        import io
        import tarfile

        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            for arcname, local in sorted(paths.items()):
                tf.add(str(local), arcname=arcname)
        self.push_tar(buf.getvalue(), remote_dir)

    # ----------------------------------------------------------- forwards

    def remote_loopd_sock(self) -> str:
        """The worker's canonical loopd control-socket path
        (docs/loopd.md): ``<XDG state>/loopd/loopd.sock`` under the ssh
        user's home.  Absolute on purpose -- sshd does not tilde-expand
        direct-streamlocal forward targets."""
        user = self.tpu.ssh_user or consts.TPU_SSH_USER_DEFAULT
        home = "/root" if user == "root" else f"/home/{user}"
        return (f"{home}/.local/state/{consts.PRODUCT}/"
                "loopd/loopd.sock")

    def forward_loopd(self, remote_sock: str = "") -> Path:
        """Tunnel the worker-resident loopd control socket over the SSH
        mux; returns the local socket path to point ``loopd.socket`` at
        (the JSON-frame protocol is transport agnostic, so a LoopdClient
        on the forwarded path behaves identically to a local one)."""
        return self.forward_unix(remote_sock or self.remote_loopd_sock(),
                                 tag="loopd")

    def remote_workerd_sock(self) -> str:
        """The worker's canonical workerd data-plane socket
        (docs/workerd.md).  Absolute on purpose -- sshd does not
        tilde-expand direct-streamlocal forward targets."""
        user = self.tpu.ssh_user or consts.TPU_SSH_USER_DEFAULT
        home = "/root" if user == "root" else f"/home/{user}"
        return (f"{home}/.local/state/{consts.PRODUCT}/"
                "workerd/workerd.sock")

    def forward_workerd(self, remote_sock: str = "") -> Path:
        """Tunnel the worker-resident workerd intent channel over the
        existing SSH mux; returns the local socket the scheduler's
        WorkerdExecutor dials.  One persistent channel rides this
        forward -- the whole point is that per-engine-call WAN round
        trips collapse onto it (docs/workerd.md)."""
        return self.forward_unix(remote_sock or self.remote_workerd_sock(),
                                 tag="workerd")

    def forward_unix(self, remote_sock: str, tag: str = "docker") -> Path:
        """Forward a remote unix socket to a local one; returns the local
        path once it accepts connections."""
        local = self.mux_dir / f"{tag}-{self.index}.sock"
        with self._lock:
            if local.exists() and self._probe(local):
                return local
            local.unlink(missing_ok=True)
            argv = self.ssh_base()[:-1] + [
                "-N", "-L", f"{local}:{remote_sock}", self.ssh_base()[-1],
            ]
            proc = self.runner.spawn(argv)
            self._forwards.append(proc)
        deadline = time.monotonic() + FORWARD_READY_DEADLINE_S
        while time.monotonic() < deadline:
            if local.exists() and self._probe(local):
                return local
            if proc.poll() is not None:
                break
            time.sleep(0.1)
        raise TransportError(
            f"worker {self.index}: socket forward {remote_sock} -> {local} "
            "did not come up"
        )

    def reverse_forward_tcp(self, remote_bind: str, remote_port: int,
                            local_host: str, local_port: int,
                            tag: str = "rev") -> None:
        """Expose a laptop service on the WORKER: ``ssh -R`` so worker-side
        connections to remote_bind:remote_port land on
        local_host:local_port here.

        This is the side-channel substrate (north star: "tunnel
        monitor/TUI streams back"): the host proxy and the monitor OTLP
        collector run on the laptop, and containers on every worker reach
        them through these forwards.  Binding a non-loopback remote_bind
        (the worker's clawker-net gateway, so containers can reach it)
        requires ``GatewayPorts clientspecified`` on the worker sshd --
        ensured by the provisioning plan.
        """
        key = f"R:{tag}"
        with self._lock:
            if key in self._rev_tags:
                return
            argv = self.ssh_base()[:-1] + [
                # a refused -R bind must kill the process (otherwise ssh
                # only warns and poll() can never detect the failure)
                "-o", "ExitOnForwardFailure=yes",
                "-N", "-R",
                f"{remote_bind}:{remote_port}:{local_host}:{local_port}",
                self.ssh_base()[-1],
            ]
            proc = self.runner.spawn(argv)
            self._forwards.append(proc)
            self._rev_tags.add(key)
        deadline = time.monotonic() + FORWARD_READY_DEADLINE_S
        probe = (f"timeout 2 bash -c 'exec 3<>/dev/tcp/{remote_bind}/"
                 f"{remote_port}' 2>/dev/null")
        while time.monotonic() < deadline:
            if self.run(probe, timeout=5.0).rc == 0:
                return
            if proc is not None and proc.poll() is not None:
                break
            time.sleep(0.2)
        with self._lock:
            self._rev_tags.discard(key)
            if proc in self._forwards:
                self._forwards.remove(proc)
        # reap the dead/stale tunnel so a retry doesn't lose the bind
        # race against a leaked first attempt -- outside the lock: the
        # wait can take seconds and every other transport caller
        # contends this lock
        try:
            proc.terminate()
            proc.wait(timeout=3)
        except Exception:
            pass
        raise TransportError(
            f"worker {self.index}: reverse forward {remote_bind}:{remote_port}"
            f" -> {local_host}:{local_port} did not come up"
        )

    def drop_mux(self) -> None:
        """Tear down the ControlMaster session; the next command redials.
        Needed after remote sshd config changes (GatewayPorts): a reload
        only affects NEW connections, and every session rides the mux."""
        argv = self.ssh_base()[:-1] + ["-O", "exit", self.ssh_base()[-1]]
        try:
            self.runner.run(argv, timeout=10.0)
        except TransportError:
            pass

    @staticmethod
    def _probe(path: Path) -> bool:
        import socket as _s

        try:
            with _s.socket(_s.AF_UNIX, _s.SOCK_STREAM) as s:
                s.settimeout(1.0)
                s.connect(str(path))
                return True
        except OSError:
            return False

    def close(self) -> None:
        # snapshot under the lock, reap outside it: each wait can take
        # up to 3s per tunnel, and holding the lock through that wedges
        # every concurrent run()/forward caller
        with self._lock:
            procs, self._forwards = list(self._forwards), []
            self._rev_tags.clear()
        for p in procs:
            try:
                p.terminate()
                p.wait(timeout=3)
            except Exception:
                pass


def connect_worker_engine(tpu: TPUSettings, host: str, index: int,
                          *, mux_dir: Path | None = None,
                          runner: Runner | None = None):
    """Worker host -> jailed Engine over the forwarded docker socket."""
    from ..engine.api import Engine
    from ..engine.httpapi import HTTPDockerAPI, unix_socket_factory
    from ..util.xdg import state_dir

    mux = mux_dir if mux_dir is not None else state_dir() / consts.TPU_SSH_MUX_DIR
    transport = SSHTransport(tpu, host, index, mux_dir=mux, runner=runner)
    engine = None
    try:
        local_sock = transport.forward_unix("/var/run/docker.sock")
        engine = Engine(HTTPDockerAPI(unix_socket_factory(local_sock)))
        if not engine.ping():
            raise TransportError(
                f"worker {index} ({host}): forwarded docker daemon not answering"
            )
    except Exception:
        if engine is not None:
            engine.close()  # drain any keep-alive socket on the forward
        transport.close()  # never orphan the ssh -N forward process
        raise
    engine.transport = transport  # keep the mux alive with the engine
    return engine
