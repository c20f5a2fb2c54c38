"""Engine layer: the only code that talks to container daemons.

The port's copy of ``clawker_tpu/engine/__init__.py``: the label-jailed
``Engine`` and the in-process ``FakeDockerAPI``.  The Docker Engine HTTP
client (``httpapi``, ``pool``, ``errors_map``) is not ported yet; it
comes with the ``local`` driver (ROADMAP §1).
"""

from .api import Engine
from .fake import FakeContainer, FakeDockerAPI

__all__ = ["Engine", "FakeDockerAPI", "FakeContainer"]
