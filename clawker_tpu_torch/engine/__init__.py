"""Engine layer: the only code that talks to container daemons.

The port's copy of ``clawker_tpu/engine/__init__.py``.  ``HTTPDockerAPI``
speaks the Docker Engine HTTP API directly (unix socket or TCP) over a
keep-alive ``ConnectionPool`` (docs/engine-connection-pool.md), and
``Engine`` enforces the managed-label jail above it.  ``FakeDockerAPI``
is the in-process test seam.
"""

from .api import Engine
from .errors_map import APIError
from .fake import FakeContainer, FakeDockerAPI
from .httpapi import HTTPDockerAPI
from .pool import ConnectionPool

__all__ = ["Engine", "HTTPDockerAPI", "ConnectionPool", "FakeDockerAPI",
           "FakeContainer", "APIError"]
