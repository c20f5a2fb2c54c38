"""``python -m clawker_tpu_torch.workerd``: run the workerd daemon.

Run ON the worker host whose engine it should serve (``python -m
clawker_tpu_torch workerd start`` forks this detached).  The config
loads from the cwd -- workerd is project-scoped like loopd: container
names and labels key on the project.  The engine comes from the
settings runtime driver's default worker (override with
``CLAWKER_TPU_WORKERD_DRIVER``, else ``CLAWKER_TPU_DRIVER``; ``fake``
builds a fresh ``FakeDriver`` seeded from ``CLAWKER_TPU_FAKE_IMAGES``).

The port's copy of ``clawker_tpu/workerd/__main__.py``, over the
port's ``get_driver``.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from pathlib import Path

from .. import logsetup
from ..config import load_config
from ..engine.drivers import get_driver
from .server import WorkerdServer


def main() -> int:
    cfg = load_config(Path.cwd())
    logsetup.setup(os.environ.get("CLAWKER_TPU_WORKERD_LOG", "info"))
    override = (os.environ.get("CLAWKER_TPU_WORKERD_DRIVER", "")
                or os.environ.get("CLAWKER_TPU_DRIVER", ""))
    driver = get_driver(cfg.settings, override=override)
    workers = driver.connect()
    worker = workers[0] if workers else None
    if worker is None or worker.engine is None:
        print("workerd: no local engine to serve", file=sys.stderr)
        return 1
    server = WorkerdServer(cfg, worker.engine, worker_id=worker.id,
                           driver=driver)
    server.start()
    stop = threading.Event()

    def on_term(signum, frame):
        server.stop()
        stop.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    try:
        while not stop.is_set() and not server._stop.is_set():
            stop.wait(0.5)
    finally:
        server.stop()
        driver.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
