"""Local Docker daemon driver (driver 0; the reference's only backend).

The port's copy of ``clawker_tpu/engine/drivers/local.py``, whole.
"""

from __future__ import annotations

import os
from pathlib import Path

from ...errors import DriverError
from ..api import Engine
from ..httpapi import HTTPDockerAPI, tcp_socket_factory, unix_socket_factory
from .base import RuntimeDriver, Worker

DEFAULT_SOCKET = "/var/run/docker.sock"


class LocalDriver(RuntimeDriver):
    name = "local"

    def __init__(self, docker_host: str = ""):
        self._docker_host = docker_host or os.environ.get("DOCKER_HOST", "")
        self._workers: list[Worker] | None = None

    def _api(self) -> HTTPDockerAPI:
        host = self._docker_host
        if not host or host.startswith("unix://") or host.startswith("/"):
            path = host.removeprefix("unix://") if host else DEFAULT_SOCKET
            if not Path(path).exists():
                raise DriverError(
                    f"Docker socket {path} not found -- is the Docker daemon running?"
                )
            return HTTPDockerAPI(unix_socket_factory(path))
        if host.startswith("tcp://"):
            hostport = host.removeprefix("tcp://")
            h, _, p = hostport.partition(":")
            return HTTPDockerAPI(tcp_socket_factory(h, int(p or "2375")))
        raise DriverError(f"unsupported DOCKER_HOST {host!r}")

    def connect(self) -> list[Worker]:
        engine = Engine(self._api())
        if not engine.ping():
            raise DriverError("local Docker daemon did not answer ping")
        self._workers = [Worker(id="local-0", index=0, hostname="localhost", engine=engine)]
        return self._workers

    def workers(self) -> list[Worker]:
        if self._workers is None:
            return self.connect()
        return self._workers

    def close(self) -> None:
        """Drain each worker engine's keep-alive pool; a later workers()
        call reconnects from scratch."""
        for w in self._workers or []:
            if w.engine is not None:
                w.engine.close()
        self._workers = None
