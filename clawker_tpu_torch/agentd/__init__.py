"""agentd: the in-container daemon (session listener + PID-1 supervision).

Parity reference: clawkerd/ (SURVEY.md 2.9).  Split design: the PID-1
process-supervision core is the native ``clawker-supervisord`` binary
(native/agentsup/supervisor.cpp); this package is the mTLS session daemon
that rides beside it and the client used to drive the supervisor socket.

The port's copy of ``clawker_tpu/agentd/__init__.py``, whole.  Every
module here is stdlib-only: the agentd zipapp (``bundler/payload.py``)
carries them into each image.
"""

from .supervisor_client import SupervisorClient, SupervisorError
