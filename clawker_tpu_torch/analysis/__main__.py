"""``python -m clawker_tpu_torch.analysis`` -- the bare-host entrypoint.

Pure stdlib end to end (no click, no JAX): the analyzer must run in
under two seconds on a host with none of the device libs installed,
which is exactly where CI lint legs live.

The port's copy of ``clawker_tpu/analysis/__main__.py``, whole.
"""

from __future__ import annotations

import sys

from .runner import main

if __name__ == "__main__":
    sys.exit(main())
