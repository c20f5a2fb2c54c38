"""nsd runtime driver: the first-party namespace daemon as a backend.

`settings: runtime.driver: nsd` (or CLAWKER_TPU_DRIVER=nsd) points the
stock Docker-API client at a clawker_tpu_torch.nsd daemon, auto-spawning
one on this host when none answers.  Everything above the socket -- engine
jail, orchestration, firewall enrollment -- is byte-identical to the
``local`` driver; only the daemon behind the socket changes.

Requires root (see nsd package docstring); intended for e2e tiers and
TPU-VM workers without Docker.

The port's copy of ``clawker_tpu/engine/drivers/nsdriver.py``, whole.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

from ...errors import DriverError
from .local import LocalDriver

DEFAULT_SOCKET = "/run/clawker/nsd.sock"
ENV_SOCKET = "CLAWKER_TPU_NSD_SOCKET"
ENV_STATE = "CLAWKER_TPU_NSD_STATE"


def nsd_capable() -> bool:
    """Root + the kernel facilities nsd needs (cgroup-v2 checked by the
    daemon itself; unshare/overlay are the hard requirements)."""
    if os.name != "posix" or os.geteuid() != 0:
        return False
    from shutil import which

    return bool(which("unshare") and which("nsenter") and which("mount"))


class NsdDriver(LocalDriver):
    name = "nsd"

    def __init__(self, docker_host: str = ""):
        sock = (docker_host.removeprefix("unix://") if docker_host
                else os.environ.get(ENV_SOCKET, DEFAULT_SOCKET))
        self._sock_path = Path(sock)
        self._proc: subprocess.Popen | None = None
        super().__init__(docker_host=f"unix://{sock}")

    def connect(self):
        if not self._answers():
            self._spawn()
        return super().connect()

    def _answers(self) -> bool:
        if not self._sock_path.exists():
            return False
        try:
            return self._api_unchecked().ping()
        except DriverError:
            return False

    def _api_unchecked(self):
        from ..httpapi import HTTPDockerAPI, unix_socket_factory

        return HTTPDockerAPI(unix_socket_factory(self._sock_path))

    def _spawn(self) -> None:
        if not nsd_capable():
            raise DriverError(
                "nsd driver needs root + unshare/nsenter (namespace runtime)")
        state = os.environ.get(
            ENV_STATE, str(self._sock_path.parent / "nsd-state"))
        self._sock_path.parent.mkdir(parents=True, exist_ok=True)
        log = open(self._sock_path.parent / "nsd.log", "ab")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "clawker_tpu_torch.nsd",
             "--socket", str(self._sock_path), "--state-dir", state],
            stdout=log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, start_new_session=True,
            env={**os.environ,
                 "PYTHONPATH": str(Path(__file__).resolve().parents[3])},
        )
        log.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if self._answers():
                return
            time.sleep(0.05)
        raise DriverError(f"nsd daemon did not answer on {self._sock_path}")
