"""clawker fleet analytics on PyTorch and CUDA (NVIDIA H100).

A port of ``clawker_tpu`` -- its accelerator lane, the fleet anomaly
model, and the in-process ``loop`` scheduler that rides it -- that
imports ``torch`` and nothing of JAX or of the reference package.  The fit step and the score are hand-written CUDA kernels for
``sm_90a`` (``kernels/``), built with nvcc at first use; entry points
run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"       # the reference's version it ports
