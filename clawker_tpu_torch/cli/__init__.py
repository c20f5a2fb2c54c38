"""Command line of the port: ``python -m clawker_tpu_torch <verb>``.

The port's copy of ``clawker_tpu/cli``, laid out as the reference's:
``root.py`` (the group, alias expansion, error rendering, ``main``),
``factory.py`` (``Factory``) and one ``cmd_*.py`` module per verb group,
each with its ``register(root)``.  Every command receives a
:class:`Factory` through the click context; tests inject one wired to a
``FakeDriver``.  The verbs that compute (``monitor anomalies``, ``fleet
anomaly``, ``loop``'s riders, ``chaos``) take their device from
``CLAWKER_TORCH_DEVICE`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions) and exit 1 without a GPU; the everyday verbs
(``run``, ``ps``, ``init``, ``settings``, ...) compute nothing and load
no torch.
"""

from .factory import DEVICE_ENV, ENV_DRIVER, Factory, _bring_up
from .root import cli, main

__all__ = ["cli", "main", "Factory", "DEVICE_ENV", "ENV_DRIVER", "_bring_up"]
