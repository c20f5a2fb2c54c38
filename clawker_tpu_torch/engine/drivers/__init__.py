"""Runtime drivers: where the compute backend becomes pluggable.

The port's copy of ``clawker_tpu/engine/drivers/__init__.py``: the
``local`` driver (the Docker daemon at ``DOCKER_HOST``, one worker),
the ``tpu_vm`` driver (one Docker daemon per pod worker, over SSH),
the ``fake`` driver (in-process fake daemons, N workers) and the ``nsd``
driver (the first-party namespace daemon, :mod:`clawker_tpu_torch.nsd`,
behind the ``local`` driver's client; ``nsdriver`` is imported when
``get_driver`` is asked for it).
"""

from .base import RuntimeDriver, Worker, get_driver
from .fakedriver import FakeDriver
from .local import LocalDriver
from .tpu_vm import TPUVMDriver

__all__ = ["RuntimeDriver", "Worker", "LocalDriver", "TPUVMDriver",
           "FakeDriver", "get_driver"]
