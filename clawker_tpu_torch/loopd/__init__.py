"""loopd: the host-resident loop-supervisor daemon (docs/loopd.md).

PR-6's placement & admission subsystem enforces per-worker inflight
caps and tenant fairness only *inside one CLI process*: two concurrent
``clawker loop`` invocations on the same pod each bring their own
:class:`~clawker_tpu_torch.placement.AdmissionController` and can jointly
blow the per-worker cap.  loopd moves that state into one resident
process per host -- ONE admission controller, ONE per-worker lane
registry, daemon-owned health breakers -- serving the run lifecycle
(submit / detach / attach / status / event-stream) over a
length-prefixed JSON-frame protocol (the agentd framing) on a unix
socket inside a 0700 runtime dir.  The CLI discovers the socket and
becomes a thin control client; no daemon means everything degrades
transparently to the in-process scheduler.

Layout::

    <state>/loopd/            runtime dir, chmod 0700 (fs perms ARE the
        loopd.sock            auth -- the bksession/nsd socket pattern)
        loopd.pid
    <state>/logs/loopd.log    daemon stdout/stderr

The port's copy of ``clawker_tpu/loopd/__init__.py``: the daemon it
forks is ``python -m clawker_tpu_torch.loopd``.  Its sentinel scores on
the GPU (``CLAWKER_TORCH_DEVICE``, default ``cuda``); without one a
daemon with ``sentinel.enable`` refuses to start.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

from ..errors import ClawkerError

LOOPD_DIR = "loopd"                 # under Config.state_dir
SOCKET_NAME = "loopd.sock"
PIDFILE_NAME = "loopd.pid"
LOGFILE_NAME = "loopd.log"          # under Config.logs_dir


class LoopdError(ClawkerError):
    pass


def runtime_dir(cfg) -> Path:
    """The daemon's 0700 runtime dir (socket + pidfile)."""
    return Path(cfg.state_dir) / LOOPD_DIR


def socket_path(cfg) -> Path:
    """The daemon control socket: settings ``loopd.socket`` override or
    the canonical runtime-dir location."""
    override = cfg.settings.loopd.socket
    if override:
        return Path(override)
    return runtime_dir(cfg) / SOCKET_NAME


def pidfile_path(cfg) -> Path:
    return runtime_dir(cfg) / PIDFILE_NAME


def logfile_path(cfg) -> Path:
    return Path(cfg.logs_dir) / LOGFILE_NAME


def spawn_daemon(cfg, *, cwd: Path | None = None) -> int:
    """Fork ``python -m clawker_tpu_torch.loopd`` detached; wait until its
    socket answers a ping or the settings deadline passes.  Returns the
    daemon pid.  The child loads its own config from ``cwd`` -- the
    daemon is PROJECT-scoped (container names/labels key on the
    project), so it must start from the project it will serve."""
    from .client import LoopdClient

    sock = socket_path(cfg)
    log_path = logfile_path(cfg)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    runtime_dir(cfg).mkdir(parents=True, exist_ok=True)
    os.chmod(runtime_dir(cfg), 0o700)
    with open(log_path, "ab") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "clawker_tpu_torch.loopd"],
            stdout=logf, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL,
            start_new_session=True,         # survive the CLI process
            cwd=str(cwd) if cwd is not None else None,
            env=os.environ.copy(),
        )
    deadline = time.monotonic() + cfg.settings.loopd.start_deadline_s
    while time.monotonic() < deadline:
        try:
            with LoopdClient(sock, timeout=1.0) as client:
                if client.ping():
                    return proc.pid
        except ClawkerError:
            pass
        except OSError:
            pass
        if proc.poll() is not None:
            raise LoopdError(
                f"loopd exited during start (rc={proc.returncode}); "
                f"see {log_path}")
        time.sleep(0.1)
    # half-alive spawn: tear it down so the next attempt starts clean
    try:
        proc.terminate()
        proc.wait(timeout=3)
    except Exception:       # noqa: BLE001 -- best effort by design
        pass
    raise LoopdError(
        f"loopd did not answer on {sock} within "
        f"{cfg.settings.loopd.start_deadline_s:.0f}s; see {log_path}")
