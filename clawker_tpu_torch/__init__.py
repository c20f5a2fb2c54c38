"""clawker fleet analytics on PyTorch and CUDA (NVIDIA H100).

A port of the accelerator lane of ``clawker_tpu`` -- the fleet anomaly
model -- that imports ``torch`` and nothing of JAX or of the reference
package.  The fit step and the score are hand-written CUDA kernels for
``sm_90a`` (``kernels/``), built with nvcc at first use; entry points
run on the GPU unless the caller passes ``device="cpu"``.
"""
