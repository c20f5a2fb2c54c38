"""Runtime drivers: where the compute backend becomes pluggable.

The port's copy of ``clawker_tpu/engine/drivers/__init__.py``: the
``local`` driver (the Docker daemon at ``DOCKER_HOST``, one worker),
the ``tpu_vm`` driver (one Docker daemon per pod worker, over SSH) and
the ``fake`` driver (in-process fake daemons, N workers).  The ``nsd``
driver is not ported yet (ROADMAP §1 item 13), and ``get_driver``
names it when asked.
"""

from .base import RuntimeDriver, Worker, get_driver
from .fakedriver import FakeDriver
from .local import LocalDriver
from .tpu_vm import TPUVMDriver

__all__ = ["RuntimeDriver", "Worker", "LocalDriver", "TPUVMDriver",
           "FakeDriver", "get_driver"]
