"""Shared host-daemon lifecycle: spawn, healthz-grounded liveness, stop.

One state machine for every host-side daemon (control plane, host
proxy): liveness is grounded in an HTTP /healthz probe, never the
pidfile; a stale pidfile never blocks bring-up; a wedged process (pid
alive, healthz dead) is terminated -- SIGTERM, bounded wait, SIGKILL --
before a replacement spawns, so the listen port is actually free; a
spawn that times out is torn down the same way so the next attempt
doesn't inherit a half-alive process.

The port's copy of ``clawker_tpu/util/daemon.py``, with two repairs.
``ensure_running`` spawns under a process-wide lock: the scheduler's
per-worker lanes call it concurrently on their first creates, and two
spawns racing the same pidfile leave the loser's pid there while the
winner keeps the port -- a daemon nothing can stop.  And a process that
stops a daemon it spawned itself reaps it: an exited but unreaped child
still answers ``kill(pid, 0)``, so the liveness check used to wait out
the whole SIGTERM grace before each such stop.  Each
``DaemonSpec`` names the module it forks (``python -m <module>``); the
port's callers name ``clawker_tpu_torch.*`` modules.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from urllib import error as urlerror
from urllib import request as urlrequest

from ..errors import ClawkerError


class DaemonError(ClawkerError):
    pass


# positive health verdicts, keyed by health_url: the create hot path
# probes the host proxy before every agent start, and a live daemon does
# not need re-proving every few milliseconds.  Only positives are cached
# -- a dead daemon must be re-probed so ensure_running can spawn it.
_HEALTH_CACHE: dict[str, tuple[float, dict]] = {}
# one spawn at a time: a second caller waits, then finds the first
# caller's daemon healthy instead of forking a rival
_SPAWN_LOCK = threading.Lock()


def invalidate_health_cache(url: str | None = None) -> None:
    if url is None:
        _HEALTH_CACHE.clear()
    else:
        _HEALTH_CACHE.pop(url, None)


class DaemonSpec:
    def __init__(self, *, name: str, module: str, pidfile: Path, logfile: Path,
                 health_url: str, start_deadline_s: float = 15.0):
        self.name = name
        self.module = module
        self.pidfile = pidfile
        self.logfile = logfile
        self.health_url = health_url
        self.start_deadline_s = start_deadline_s

    # ------------------------------------------------------------ probes

    def health(self, timeout: float = 2.0, *,
               cache_ttl_s: float = 0.0) -> dict | None:
        """The health body, or None when nothing answers.  A 503 is a
        live-but-degraded daemon: the body still comes back so callers
        can see which subsystem is down, instead of kill/respawn loops.

        ``cache_ttl_s`` > 0 reuses a recent POSITIVE verdict for this
        url (hot create paths); negatives always re-probe."""
        if cache_ttl_s > 0:
            hit = _HEALTH_CACHE.get(self.health_url)
            if hit is not None and time.monotonic() - hit[0] < cache_ttl_s:
                return hit[1]
        out: dict | None
        try:
            with urlrequest.urlopen(self.health_url, timeout=timeout) as r:
                out = json.loads(r.read() or b"{}")
        except urlerror.HTTPError as e:
            try:
                out = json.loads(e.read() or b"{}")
            except (OSError, json.JSONDecodeError):
                out = {"degraded": True}
        except (urlerror.URLError, OSError, json.JSONDecodeError):
            out = None
        if out is not None:
            _HEALTH_CACHE[self.health_url] = (time.monotonic(), out)
        else:
            _HEALTH_CACHE.pop(self.health_url, None)
        return out

    def running(self, *, cache_ttl_s: float = 0.0) -> bool:
        return self.health(cache_ttl_s=cache_ttl_s) is not None

    def _read_pid(self) -> int:
        try:
            return int(self.pidfile.read_text().strip())
        except (OSError, ValueError):
            return 0

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        if pid <= 0:
            return False
        try:
            # our own child (a process stopping what it spawned): reap
            # it if it exited -- a zombie still answers kill(pid, 0)
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                return False
        except ChildProcessError:
            pass                # not our child: the signal probe decides
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    @staticmethod
    def _terminate(pid: int, grace_s: float = 5.0) -> None:
        """SIGTERM, bounded wait, SIGKILL -- the port must actually free."""
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            return
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            if not DaemonSpec._pid_alive(pid):
                return
            time.sleep(0.1)
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass

    # --------------------------------------------------------- lifecycle

    def ensure_running(self, *, env: dict | None = None, log=None,
                       probe_ttl_s: float = 0.0) -> None:
        if self.running(cache_ttl_s=probe_ttl_s):
            return
        with _SPAWN_LOCK:
            if self.running(cache_ttl_s=probe_ttl_s):
                return
            self._spawn(env=env, log=log)

    def _spawn(self, *, env: dict | None, log) -> None:
        pid = self._read_pid()
        if self._pid_alive(pid):
            if log:
                log.warning("%s pid %d alive but healthz dead; replacing",
                            self.name, pid)
            self._terminate(pid)
        self.logfile.parent.mkdir(parents=True, exist_ok=True)
        self.pidfile.parent.mkdir(parents=True, exist_ok=True)
        with open(self.logfile, "ab") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", self.module],
                stdout=logf, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                start_new_session=True,     # survive the CLI process
                env=env if env is not None else os.environ.copy(),
            )
        self.pidfile.write_text(str(proc.pid))
        deadline = time.monotonic() + self.start_deadline_s
        while time.monotonic() < deadline:
            if self.running():
                if log:
                    log.info("%s up (pid %d)", self.name, proc.pid)
                return
            if proc.poll() is not None:
                self.pidfile.unlink(missing_ok=True)
                raise DaemonError(
                    f"{self.name} exited during start (rc={proc.returncode}); "
                    f"see {self.logfile}"
                )
            time.sleep(0.2)
        # half-alive spawn: tear it down so the next attempt starts clean
        self._terminate(proc.pid)
        self.pidfile.unlink(missing_ok=True)
        raise DaemonError(
            f"{self.name} did not become healthy within "
            f"{self.start_deadline_s:.0f}s; see {self.logfile}"
        )

    def stop(self) -> bool:
        pid = self._read_pid()
        was = self._pid_alive(pid)
        if was:
            self._terminate(pid)
        self.pidfile.unlink(missing_ok=True)
        # the daemon is gone: a cached positive verdict would make the
        # next ensure_running(probe_ttl_s=...) skip the respawn
        invalidate_health_cache(self.health_url)
        return was
