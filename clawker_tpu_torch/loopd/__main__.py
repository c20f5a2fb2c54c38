"""``python -m clawker_tpu_torch.loopd``: run the loop-supervisor daemon.

Spawned detached by ``python -m clawker_tpu_torch loopd start``; loads
config from its working directory -- the daemon is project-scoped --
builds the runtime driver from settings (``CLAWKER_TPU_DRIVER=fake``
builds a fresh ``FakeDriver`` seeded from ``CLAWKER_TPU_FAKE_IMAGES``,
so the daemon's runs see only its own fake workers), serves the control
socket until SIGTERM/SIGINT, then drains every hosted run with a durable
``shutdown`` journal record.

The port's copy of ``clawker_tpu/loopd/__main__.py``.  With settings
``sentinel.enable`` the daemon's sentinel scores on
``CLAWKER_TORCH_DEVICE`` (default ``cuda``): a card or a kernel build
that fails stops the daemon before it serves (exit 1, the reason in
its log).  It closes its driver on the way out, so a ``tpu_vm``
driver's ssh forwards stop with the daemon.
"""

from __future__ import annotations

import os
import signal
import sys

from .. import logsetup
from ..config import load_config
from ..engine.drivers import get_driver
from ..errors import ClawkerError
from .server import LoopdServer

log = logsetup.get("loopd")


def main() -> int:
    logsetup.setup(os.environ.get("CLAWKER_TPU_LOOPD_LOG", "info"))
    cfg = load_config()
    driver = get_driver(cfg.settings,
                        override=os.environ.get("CLAWKER_TPU_DRIVER", ""))
    server = LoopdServer(cfg, driver)

    def _term(signum, frame):
        server.stop()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        try:
            server.start()
        except ClawkerError as e:
            log.error("loopd refused to start: %s", e)
            return 1
        server.serve_forever()
    finally:
        # a tpu_vm driver's ssh forwards go with the daemon
        driver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
