"""Fleet telemetry analytics on PyTorch and CUDA.

The port of ``clawker_tpu/analytics``: per-agent egress event windows
are scored by a small denoising autoencoder, fitted to the fleet's own
windows on every call.  On an H100 the fit step and the score are
hand-written CUDA kernels (``clawker_tpu_torch/kernels``); on the CPU
they run as plain PyTorch.  Importing this package touches no GPU.
"""

from .anomaly import (
    FEATURES,
    HIDDEN,
    AnomalyParams,
    denoise_step,
    denoise_step_with_noise,
    init_params,
    params_from_numpy,
    params_to_numpy,
    reconstruct,
    score,
    train_step,
)

__all__ = [
    "AnomalyParams",
    "FEATURES",
    "HIDDEN",
    "denoise_step",
    "denoise_step_with_noise",
    "init_params",
    "params_from_numpy",
    "params_to_numpy",
    "reconstruct",
    "score",
    "train_step",
]
