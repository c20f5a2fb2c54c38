"""Fleet: TPU-pod worker discovery, SSH transport, remote provisioning.

The tpu_vm runtime driver's substrate (SURVEY.md 2.13): every worker VM
of a TPU pod runs its own Docker daemon + control plane; the laptop CLI
reaches them over SSH (DCN) with the docker socket and CP ports
forwarded through a ControlMaster mux.  ICI never carries control
traffic -- pod topology only informs loop-scheduler placement.

The port's copy of ``clawker_tpu/fleet/__init__.py``, whole.
"""

from .inventory import discover_workers
from .transport import SSHTransport, connect_worker_engine

__all__ = ["discover_workers", "SSHTransport", "connect_worker_engine"]
