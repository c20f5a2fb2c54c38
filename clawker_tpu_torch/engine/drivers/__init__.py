"""Runtime drivers: where the compute backend becomes pluggable.

The port's copy of ``clawker_tpu/engine/drivers/__init__.py``.  Only the
``fake`` driver (in-process fake daemons, N workers) is ported; the
``local``, ``nsd`` and ``tpu_vm`` drivers are not yet (ROADMAP §1), and
``get_driver`` names them when asked.
"""

from .base import RuntimeDriver, Worker, get_driver
from .fakedriver import FakeDriver

__all__ = ["RuntimeDriver", "Worker", "FakeDriver", "get_driver"]
