"""Runtime drivers: where the compute backend becomes pluggable.

The port's copy of ``clawker_tpu/engine/drivers/__init__.py``: the
``local`` driver (the Docker daemon at ``DOCKER_HOST``, one worker) and
the ``fake`` driver (in-process fake daemons, N workers).  The ``nsd``
and ``tpu_vm`` drivers are not ported yet (ROADMAP §1 items 12b and
13), and ``get_driver`` names them when asked.
"""

from .base import RuntimeDriver, Worker, get_driver
from .fakedriver import FakeDriver
from .local import LocalDriver

__all__ = ["RuntimeDriver", "Worker", "LocalDriver", "FakeDriver",
           "get_driver"]
