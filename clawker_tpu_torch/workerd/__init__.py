"""workerd: the worker-resident launch-executor daemon (docs/workerd.md).

loopd (docs/loopd.md) centralized admission, fairness, and run
supervision on the CLIENT host -- but every engine mutation still
dials the worker's daemon from there, so on a real ``tpu_vm`` pod each
create/start/wait/logs call crosses the SSH mux and pays a host<->worker
WAN round trip.  An N-iteration loop costs O(calls-per-iteration) RTTs.

workerd moves the launch **data plane** onto the worker host while the
scheduler/loopd keep the **control plane** (placement, admission,
fairness, durable intent):

- the scheduler sends batched *intents* (``launch`` / ``start`` /
  ``create`` (pool fill) / ``adopt`` / ``halt`` / ``resync``), each
  carrying the journaled placement epoch + tenant, over ONE persistent
  channel per worker (the agentd length-prefixed JSON framing --
  ``agentd/protocol.py`` -- on a 0600 unix socket, tunneled over the
  existing SSH mux for ``tpu_vm``, dialed directly on local/fake);
- workerd executes create/start/wait/pool-refill against its LOCAL
  engine socket on a local serial lane and streams batched typed
  events (created/started/exited/pool_ready, exit codes, span timings)
  back on the same channel;
- an iteration therefore costs O(1) WAN round trips (one intent batch
  out, one event batch back) instead of O(4+) blocking RTTs.

workerd is stateless-restartable: the journal write-ahead stays on the
scheduler side, and on reconnect the scheduler re-syncs its intent view
(``resync``) while workerd reports its label-scoped local container
reality -- reconciling exactly like ``--resume`` does.  No daemon (or a
dead one) degrades transparently to the in-process direct executor:
today's behavior, unchanged (the degrade matrix in docs/workerd.md).

Layout (on the WORKER host)::

    <state>/workerd/           runtime dir, chmod 0700 (fs perms ARE
        workerd.sock           the auth -- the loopd/bksession pattern)
        workerd.pid
    <state>/logs/workerd.log   daemon stdout/stderr

The port's copy of ``clawker_tpu/workerd/__init__.py``: the daemon it
forks is ``python -m clawker_tpu_torch.workerd``, spawned under the
port's process-wide spawn lock (``util/daemon.py``) so two callers in
one process never race two daemons onto one socket.  ``liveness``
resolves every driver's worker sockets as the reference does: the
socket a ``tpu_vm`` engine's transport forwards, the local worker's
canonical one.  workerd's host
code runs no kernel: the card's work on its path is the sentinel that
rides the runs it launches.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

from ..errors import ClawkerError

WORKERD_DIR = "workerd"             # under Config.state_dir
SOCKET_NAME = "workerd.sock"
PIDFILE_NAME = "workerd.pid"
LOGFILE_NAME = "workerd.log"        # under Config.logs_dir

# per-worker liveness states rendered by `fleet health` / loopd status
LIVE = "live"           # socket answers the ping
DEGRADED = "degraded"   # socket exists but nothing answers (daemon died;
#                         the data plane silently fell back to the WAN path)
ABSENT = "absent"       # no workerd was ever provisioned here


class WorkerdError(ClawkerError):
    pass


def runtime_dir(cfg) -> Path:
    """The daemon's 0700 runtime dir (socket + pidfile)."""
    return Path(cfg.state_dir) / WORKERD_DIR


def socket_path(cfg) -> Path:
    """The daemon control socket: settings ``workerd.socket`` override
    or the canonical runtime-dir location."""
    override = cfg.settings.workerd.socket
    if override:
        return Path(override)
    return runtime_dir(cfg) / SOCKET_NAME


def pidfile_path(cfg) -> Path:
    return runtime_dir(cfg) / PIDFILE_NAME


def logfile_path(cfg) -> Path:
    return Path(cfg.logs_dir) / LOGFILE_NAME


def spawn_daemon(cfg, *, cwd: Path | None = None,
                 driver_override: str = "") -> int:
    """Fork ``python -m clawker_tpu_torch.workerd`` detached; wait until its
    socket answers a ping or the settings deadline passes.  Returns the
    daemon pid.  Run this ON the worker host that should own the data
    plane (for ``tpu_vm`` the provisioning payload carries the package;
    for the local/laptop engine it serves /var/run/docker.sock)."""
    from ..util.daemon import _SPAWN_LOCK

    with _SPAWN_LOCK:
        return _spawn(cfg, cwd=cwd, driver_override=driver_override)


def _spawn(cfg, *, cwd: Path | None, driver_override: str) -> int:
    from .executor import ping_socket

    sock = socket_path(cfg)
    log_path = logfile_path(cfg)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    runtime_dir(cfg).mkdir(parents=True, exist_ok=True)
    os.chmod(runtime_dir(cfg), 0o700)
    env = os.environ.copy()
    if driver_override:
        env["CLAWKER_TPU_WORKERD_DRIVER"] = driver_override
    # the child's cwd is the project dir, not the repo: make the
    # package importable there (the nsd/bench subprocess pattern)
    pkg_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else pkg_root)
    with open(log_path, "ab") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "clawker_tpu_torch.workerd"],
            stdout=logf, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL,
            start_new_session=True,         # survive the invoking CLI
            cwd=str(cwd) if cwd is not None else None,
            env=env,
        )
    deadline = time.monotonic() + cfg.settings.workerd.start_deadline_s
    while time.monotonic() < deadline:
        if ping_socket(sock):
            return proc.pid
        if proc.poll() is not None:
            raise WorkerdError(
                f"workerd exited during start (rc={proc.returncode}); "
                f"see {log_path}")
        time.sleep(0.1)
    try:
        proc.terminate()
        proc.wait(timeout=3)
    except Exception:       # noqa: BLE001 -- best effort by design
        pass
    raise WorkerdError(
        f"workerd did not answer on {sock} within "
        f"{cfg.settings.workerd.start_deadline_s:.0f}s; see {log_path}")


def liveness(cfg, driver, *, sock_by_worker: dict | None = None) -> dict:
    """Per-worker workerd liveness: worker id -> live|degraded|absent.

    The ``fleet health`` / loopd-status satellite: a worker whose
    workerd died silently degrades every loop on it back to the WAN
    path -- visibly slower but otherwise healthy, exactly the failure
    a fleet view must surface instead of hiding.

    Resolution order per worker: an explicit ``sock_by_worker`` entry
    (tests, loop --workerd wiring, loopd's executors), else the
    transport-forwarded socket a tpu_vm engine carries, else -- for the
    single local worker -- the host's canonical socket path.  Fake
    workers with no mapping read ``absent`` (no daemon was ever
    provisioned)."""
    from .executor import ping_socket

    out: dict[str, str] = {}
    for worker in driver.workers():
        sock = (sock_by_worker or {}).get(worker.id)
        if sock is None:
            transport = getattr(worker.engine, "transport", None)
            if transport is not None:
                local = transport.mux_dir / f"workerd-{transport.index}.sock"
                sock = local if local.exists() else None
            elif getattr(driver, "name", "") == "local":
                sock = socket_path(cfg)
        if sock is None or not Path(sock).exists():
            out[worker.id] = ABSENT
        elif ping_socket(Path(sock)):
            out[worker.id] = LIVE
        else:
            out[worker.id] = DEGRADED
    return out
