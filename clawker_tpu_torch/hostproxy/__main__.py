"""``python -m clawker_tpu_torch.hostproxy`` -- the host-proxy daemon.

The port's copy of ``clawker_tpu/hostproxy/__main__.py``.  It imports
config, logging and the server only: no torch.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

from .. import logsetup
from ..config import load_config
from .server import HostProxy


def main() -> int:
    logsetup.setup(os.environ.get("CLAWKER_TPU_HOSTPROXY_LOG", "info"))
    cfg = load_config()
    proxy = HostProxy(cfg)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    proxy.start()
    while not stop.is_set():
        stop.wait(1.0)
    proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
