"""Egress-anomaly autoencoder on PyTorch: scoring + training.

Port of ``clawker_tpu/analytics/anomaly.py:20-112``.  Feature vectors
summarize an agent's egress behavior over a sliding window; a two-layer
autoencoder learns the fleet's normal profile and the reconstruction
error is the anomaly score.  bf16 operands on the matmul path, fp32
accumulation and params, exactly the reference's rounding points.

On a CUDA tensor ``score`` runs the K1 kernel and the training steps the
K2 kernel (``kernels/anomaly.py``); on a CPU tensor both run the plain
PyTorch versions.  Params keep the JAX layout and field order, so
``params_from_numpy``/``params_to_numpy`` carry them across unchanged.
The reference's ``fleet_mesh``/``shard_*`` and the sharded steps are in
``analytics/mesh.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import anomaly as K
from ..kernels import reference

FEATURES = 32   # per-window egress feature vector size
HIDDEN = 128    # autoencoder bottleneck width


class AnomalyParams(NamedTuple):
    w_enc: torch.Tensor   # [FEATURES, HIDDEN]
    b_enc: torch.Tensor   # [HIDDEN]
    w_dec: torch.Tensor   # [HIDDEN, FEATURES]
    b_dec: torch.Tensor   # [FEATURES]


def init_params(generator: torch.Generator, feat: int = FEATURES,
                hidden: int = HIDDEN, device=None) -> AnomalyParams:
    """He-scaled normal weights, zero biases, drawn from ``generator``
    (on ``device``, default the generator's)."""
    device = torch.device(device) if device is not None else generator.device
    scale_e = (2.0 / feat) ** 0.5
    scale_d = (2.0 / hidden) ** 0.5
    w_enc = torch.randn((feat, hidden), generator=generator, device=device)
    w_dec = torch.randn((hidden, feat), generator=generator, device=device)
    return AnomalyParams(
        w_enc=w_enc * scale_e,
        b_enc=torch.zeros(hidden, dtype=torch.float32, device=device),
        w_dec=w_dec * scale_d,
        b_dec=torch.zeros(feat, dtype=torch.float32, device=device),
    )


def params_from_numpy(arrays, device="cuda") -> AnomalyParams:
    """Params from four arrays in AnomalyParams order (e.g. the JAX
    reference's, through ``np.asarray``)."""
    return AnomalyParams(*(
        torch.tensor(np.asarray(a, np.float32), device=device)
        for a in arrays))


def params_to_numpy(params: AnomalyParams) -> AnomalyParams:
    return AnomalyParams(*(p.detach().cpu().numpy() for p in params))


def reconstruct(params: AnomalyParams, x: torch.Tensor) -> torch.Tensor:
    """The autoencoder's output r [n, F].  Off the scoring path (K1 fuses
    it into the score), so it is plain tensor code on any device."""
    return reference._forward(*params, x)[2]


def score(params: AnomalyParams, x: torch.Tensor) -> torch.Tensor:
    """Per-agent anomaly score: mean squared reconstruction error.

    x: [batch, FEATURES] window features; returns [batch] scores."""
    return K.score(params, x)


def _step(params, x, noise, lr, sigma):
    new = AnomalyParams(*(p.clone() for p in params))
    loss = torch.empty(1, dtype=torch.float32, device=x.device)
    K.fit_step_(new, x, noise, lr=lr, sigma=sigma, loss_out=loss)
    return new, loss[0]


def train_step(params: AnomalyParams, x: torch.Tensor, lr: float = 1e-3
               ) -> tuple[AnomalyParams, torch.Tensor]:
    """One SGD step on the pooled windows -> (new params, loss)."""
    return _step(params, x, None, lr, 0.0)


def denoise_step(params: AnomalyParams, x: torch.Tensor,
                 generator: torch.Generator, lr: float = 1e-3,
                 sigma: float = 0.25) -> tuple[AnomalyParams, torch.Tensor]:
    """One denoising SGD step: reconstruct the CLEAN window from a noised
    input, with unit noise drawn from ``generator``."""
    noise = torch.randn(x.shape, generator=generator, device=x.device)
    return denoise_step_with_noise(params, x, noise, lr=lr, sigma=sigma)


def denoise_step_with_noise(
    params: AnomalyParams, x: torch.Tensor, noise: torch.Tensor,
    lr: float = 1e-3, sigma: float = 0.25,
) -> tuple[AnomalyParams, torch.Tensor]:
    """Denoising step with CALLER-SUPPLIED unit noise -> (new params,
    loss).  The inputs are left as they were; the runtime's fit updates
    in place through ``kernels.anomaly.fit_`` instead."""
    return _step(params, x, noise, lr, sigma)
