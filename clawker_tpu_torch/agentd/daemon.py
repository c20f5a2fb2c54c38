"""The agentd session daemon: mTLS listener + session command execution.

Parity reference: clawkerd/ (SURVEY.md 2.9) -- boot reads the bootstrap
files, listens with mutual TLS on :7700 (client cert required, CP CN
pinned, ClientAuth EKU), then serves one ``Session`` bidi stream at a time:
Hello/HelloAck carrying Initialized/CmdRunning so the CP skips completed
plans on reconnect; ShellCommand pipelines with per-stage uid/gid drop;
Stdin/CloseStdin/Signal; AgentReady (spawn the user CMD -- via the native
supervisor when present, else a direct child); AgentInitialized (persist the
init marker); RegisterRequired (the daemon's one outbound call).  Structured
audit events go to stderr as JSON lines; every worker thread is
exception-recovered (reference: recoverGoroutine on every goroutine).

The port's copy of ``clawker_tpu/agentd/daemon.py``, whole.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .. import consts
from . import protocol
from .protocol import ConnectionClosed, ProtocolError, read_msg, write_msg

CP_COMMON_NAME = "clawker-controlplane"


def _audit(event: str, **fields) -> None:
    rec = {"ts": round(time.time(), 3), "event": event}
    rec.update(fields)
    print(json.dumps(rec, separators=(",", ":")), file=sys.stderr, flush=True)


@dataclass
class AgentdConfig:
    bootstrap_dir: Path = Path(consts.BOOTSTRAP_DIR)
    port: int = consts.AGENTD_PORT
    host: str = "0.0.0.0"
    supervisor_socket: str = ""          # empty -> direct-spawn fallback
    ready_file: Path = Path(consts.READY_FILE)
    init_marker: Path = Path(consts.INIT_MARKER)
    require_client_cert: bool = True
    pinned_client_cn: str = CP_COMMON_NAME
    # image CMD captured at ENTRYPOINT time: what AgentReady spawns when the
    # CP sends no explicit argv (reference: clawkerd runs the user CMD from
    # the image config on AgentReady)
    default_cmd: list[str] = field(default_factory=list)
    default_uid: int = 0
    default_gid: int = 0


@dataclass
class _ShellJob:
    id: str
    procs: list[subprocess.Popen] = field(default_factory=list)
    stdin_open: bool = True

    def first_stdin(self):
        return self.procs[0].stdin if self.procs else None


class Agentd:
    """One daemon instance; ``serve_forever`` accepts sequential sessions."""

    def __init__(self, cfg: AgentdConfig):
        self.cfg = cfg
        self._ssl = self._build_ssl_context()
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._jobs: dict[str, _ShellJob] = {}
        self._jobs_lock = threading.Lock()
        self._cmd_running = False
        self._cmd_lock = threading.Lock()
        self._direct_child: subprocess.Popen | None = None
        self.bound_port = 0  # actual port after bind (tests use 0)

    # ------------------------------------------------------------ TLS boot

    def _build_ssl_context(self) -> ssl.SSLContext:
        d = self.cfg.bootstrap_dir
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(d / "agent.crt", d / "agent.key")
        if self.cfg.require_client_cert:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(d / "ca.crt")
        return ctx

    @staticmethod
    def _peer_cn(tls_sock: ssl.SSLSocket) -> str:
        cert = tls_sock.getpeercert() or {}
        for rdn in cert.get("subject", ()):  # ((('commonName','x'),),)
            for key, value in rdn:
                if key == "commonName":
                    return value
        return ""

    # ------------------------------------------------------------- serving

    def serve_forever(self) -> None:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.cfg.host, self.cfg.port))
        ls.listen(4)
        self.bound_port = ls.getsockname()[1]
        self._listener = ls
        self._write_ready()
        _audit("agentd_listening", port=self.bound_port)
        while not self._stop.is_set():
            try:
                raw, addr = ls.accept()
            except OSError:
                break  # listener closed by stop()
            try:
                tls = self._ssl.wrap_socket(raw, server_side=True)
            except (ssl.SSLError, OSError) as e:
                _audit("session_tls_rejected", error=str(e), peer=str(addr))
                raw.close()
                continue
            cn = self._peer_cn(tls)
            if self.cfg.require_client_cert and cn != self.cfg.pinned_client_cn:
                _audit("session_cn_rejected", cn=cn)
                tls.close()
                continue
            _audit("session_started", peer=str(addr), cn=cn)
            try:
                self._serve_session(tls)
            except (ConnectionClosed, ProtocolError) as e:
                _audit("session_ended", reason=str(e))
            except Exception as e:  # recovered: daemon must outlive sessions
                _audit("session_crashed", error=repr(e))
            finally:
                try:
                    tls.close()
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def _write_ready(self) -> None:
        try:
            self.cfg.ready_file.parent.mkdir(parents=True, exist_ok=True)
            self.cfg.ready_file.write_text("ok\n")
        except OSError as e:
            _audit("ready_file_failed", error=str(e))

    # ------------------------------------------------------------- session

    def _serve_session(self, sock: ssl.SSLSocket) -> None:
        wlock = threading.Lock()  # output threads interleave with replies

        def send(msg: dict) -> None:
            with wlock:
                write_msg(sock, msg)

        while True:
            msg = read_msg(sock)
            t = msg["type"]
            if t == "hello":
                send(
                    {
                        "type": "hello_ack",
                        "initialized": self.cfg.init_marker.exists(),
                        "cmd_running": self._is_cmd_running(),
                        "pid": os.getpid(),
                    }
                )
            elif t == "shell":
                self._start_shell(msg, send)
            elif t == "stdin":
                self._feed_stdin(msg)
            elif t == "close_stdin":
                self._close_stdin(msg)
            elif t == "signal":
                self._signal_job(msg, send)
            elif t == "agent_ready":
                self._agent_ready(msg, send)
            elif t == "agent_initialized":
                self.cfg.init_marker.parent.mkdir(parents=True, exist_ok=True)
                self.cfg.init_marker.write_text(str(int(time.time())))
                _audit("agent_initialized")
                send({"type": "init_ack"})
            elif t == "register_required":
                self._register(msg, send)
            elif t == "bye":
                return
            else:
                send({"type": "error", "error": f"unknown command {t!r}"})

    # ---------------------------------------------------------- shell jobs

    def _start_shell(self, msg: dict, send) -> None:
        """Pipeline of stages; stage N stdout feeds stage N+1 stdin.
        Per-stage uid/gid drop happens in the child pre-exec (kernel drop),
        mirroring the reference's per-stage credential switch."""
        job_id = msg.get("id") or f"job-{int(time.time()*1000)}"
        stages = msg.get("stages") or []
        if not stages:
            send({"type": "error", "id": job_id, "error": "shell: no stages"})
            return
        env = dict(os.environ)
        env.update(msg.get("env") or {})
        cwd = msg.get("dir") or None
        job = _ShellJob(id=job_id)
        try:
            prev_out = None
            for i, st in enumerate(stages):
                preexec = self._preexec(int(st.get("uid") or 0), int(st.get("gid") or 0))
                p = subprocess.Popen(
                    st["argv"],
                    stdin=prev_out if prev_out is not None else subprocess.PIPE,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    env=env,
                    cwd=cwd,
                    preexec_fn=preexec,
                    start_new_session=True,
                )
                if prev_out is not None:
                    prev_out.close()  # parent's copy; pipe lives in children
                prev_out = p.stdout if i < len(stages) - 1 else None
                job.procs.append(p)
        except (OSError, ValueError) as e:
            for p in job.procs:
                p.kill()
            send({"type": "error", "id": job_id, "error": f"spawn: {e}"})
            return
        with self._jobs_lock:
            self._jobs[job_id] = job
        send({"type": "started", "id": job_id})
        _audit("shell_command_started", id=job_id, stages=len(stages))

        def pump(stage: int, fd: int, stream) -> None:
            try:
                for chunk in iter(lambda: stream.read(32768), b""):
                    send(
                        {
                            "type": "output",
                            "id": job_id,
                            "stage": stage,
                            "fd": fd,
                            "data": protocol.b64(chunk),
                        }
                    )
            except (OSError, ValueError):
                pass

        pumps: list[threading.Thread] = []

        def wait_all() -> None:
            try:
                codes = []
                for p in job.procs:
                    code = p.wait()
                    if code < 0:  # signal death -> bash convention
                        code = 128 - code
                    codes.append(code)
                # join output pumps BEFORE completion frames: a process can
                # exit while its last pipe chunks are still unread, and the
                # client stops listening at `done`
                for t in pumps:
                    t.join()
                for i, code in enumerate(codes):
                    send({"type": "stage_exit", "id": job_id, "stage": i, "code": code})
                send({"type": "done", "id": job_id, "code": codes[-1]})
                _audit("shell_command_done", id=job_id, code=codes[-1])
            except Exception as e:
                _audit("shell_wait_crashed", id=job_id, error=repr(e))
            finally:
                with self._jobs_lock:
                    self._jobs.pop(job_id, None)

        last = job.procs[-1]
        pumps.append(
            threading.Thread(target=pump, args=(len(stages) - 1, 1, last.stdout), daemon=True)
        )
        for i, p in enumerate(job.procs):
            pumps.append(threading.Thread(target=pump, args=(i, 2, p.stderr), daemon=True))
        for t in pumps:
            t.start()
        threading.Thread(target=wait_all, daemon=True).start()

    @staticmethod
    def _preexec(uid: int, gid: int):
        if uid <= 0 and gid <= 0:
            return None

        def fn() -> None:
            if gid > 0:
                os.setgroups([])
                os.setgid(gid)
            if uid > 0:
                os.setuid(uid)

        return fn

    def _feed_stdin(self, msg: dict) -> None:
        with self._jobs_lock:
            job = self._jobs.get(msg.get("id", ""))
        if job and job.stdin_open and job.first_stdin():
            try:
                job.first_stdin().write(protocol.unb64(msg.get("data", "")))
                job.first_stdin().flush()
            except (OSError, ValueError):
                pass

    def _close_stdin(self, msg: dict) -> None:
        with self._jobs_lock:
            job = self._jobs.get(msg.get("id", ""))
        if job and job.first_stdin():
            job.stdin_open = False
            try:
                job.first_stdin().close()
            except OSError:
                pass

    def _signal_job(self, msg: dict, send) -> None:
        with self._jobs_lock:
            job = self._jobs.get(msg.get("id", ""))
        if not job:
            send({"type": "error", "id": msg.get("id", ""), "error": "no such job"})
            return
        signum = int(msg.get("signum") or signal.SIGTERM)
        for p in job.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signum)
                except (OSError, ProcessLookupError):
                    pass

    # --------------------------------------------------------- user CMD

    def _is_cmd_running(self) -> bool:
        if self.cfg.supervisor_socket:
            try:
                from .supervisor_client import SupervisorClient

                with SupervisorClient(self.cfg.supervisor_socket) as c:
                    kind, _ = c.status()
                return kind == "running"
            except Exception:
                return False
        return self._direct_child is not None and self._direct_child.poll() is None

    def _agent_ready(self, msg: dict, send) -> None:
        """Spawn the user CMD exactly once (CAS).  Through the native
        supervisor when configured; else a direct detached child (tests,
        images without the supervisor)."""
        with self._cmd_lock:
            if self._cmd_running or self._is_cmd_running():
                send({"type": "error", "error": "user command already running"})
                return
            argv = msg.get("argv") or list(self.cfg.default_cmd)
            if not argv:
                send({"type": "error", "error": "agent_ready: empty argv and no image CMD"})
                return
            uid = int(msg.get("uid") or self.cfg.default_uid)
            gid = int(msg.get("gid") or self.cfg.default_gid)
            env = msg.get("env") or {}
            cwd = msg.get("cwd") or consts.WORKSPACE_DIR
            if not Path(cwd).is_dir():
                cwd = ""  # supervisor skips chdir; direct path inherits ours
            try:
                if self.cfg.supervisor_socket:
                    from .supervisor_client import SupervisorClient

                    full_env = dict(os.environ)
                    full_env.update(env)
                    with SupervisorClient(self.cfg.supervisor_socket) as c:
                        pid = c.spawn(argv, uid=uid, gid=gid, cwd=cwd, env=full_env)
                else:
                    child_env = dict(os.environ)
                    child_env.update(env)
                    # grandfathered no-blocking-under-lock finding
                    # (analysis-baseline-torch.json): the spawn-once CAS
                    # must be atomic with _cmd_running, and this in-container
                    # daemon serves ONE session connection -- nothing
                    # contends _cmd_lock while the fork runs.  Splitting the
                    # CAS to move Popen out would trade a real double-spawn
                    # hazard for a theoretical stall.
                    self._direct_child = subprocess.Popen(
                        argv,
                        env=child_env,
                        cwd=cwd or None,
                        preexec_fn=self._preexec(uid, gid),
                        start_new_session=True,
                    )
                    pid = self._direct_child.pid
            except Exception as e:
                send({"type": "error", "error": f"agent_ready: {e}"})
                return
            self._cmd_running = True
            _audit("agent_ready", pid=pid)
            send({"type": "ready_ack", "pid": pid})

    # ----------------------------------------------------------- register

    def _register(self, msg: dict, send) -> None:
        """The daemon's single outbound call: present the assertion JWT to
        the CP AgentService (reference: clawkerd register.go)."""
        from .register import register_with_cp

        try:
            register_with_cp(
                self.cfg.bootstrap_dir,
                host=msg.get("cp_host", ""),
                port=int(msg.get("cp_port") or consts.CP_AGENT_PORT),
            )
            send({"type": "register_done", "ok": True})
            _audit("registered")
        except Exception as e:
            send({"type": "register_done", "ok": False, "error": str(e)})
            _audit("register_failed", error=str(e))


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="clawker-agentd")
    ap.add_argument("--bootstrap-dir", default=consts.BOOTSTRAP_DIR)
    ap.add_argument("--port", type=int, default=consts.AGENTD_PORT)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--supervisor-socket", default="")
    ap.add_argument("--ready-file", default=consts.READY_FILE)
    ap.add_argument("--init-marker", default=consts.INIT_MARKER)
    ap.add_argument("--default-uid", type=int, default=0)
    ap.add_argument("--default-gid", type=int, default=0)
    # everything after --default-cmd is the image CMD Docker appended to the
    # supervisor ENTRYPOINT and the supervisor passed through to us
    ap.add_argument("--default-cmd", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args(argv)
    cfg = AgentdConfig(
        bootstrap_dir=Path(args.bootstrap_dir),
        port=args.port,
        host=args.host,
        supervisor_socket=args.supervisor_socket,
        ready_file=Path(args.ready_file),
        init_marker=Path(args.init_marker),
        default_cmd=list(args.default_cmd),
        default_uid=args.default_uid,
        default_gid=args.default_gid,
    )
    d = Agentd(cfg)
    try:
        d.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
