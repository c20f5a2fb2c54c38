"""The fleet mesh: the anomaly fit and score over rows split into shards.

Port of ``clawker_tpu/analytics/anomaly.py:117-156`` (``fleet_mesh``,
``shard_params``, ``shard_batch``, ``shard_noise``).  The reference runs
ONE jitted program over a ``data`` x ``model`` mesh of ``jax.devices()``:
rows over ``data``, the hidden dimension over ``model``, the gradient
psum inserted by XLA.  Here one process drives a list of shards, each a
contiguous block of rows on a device, with no process group:

* ``fleet_mesh`` covers the visible CUDA devices, one shard each;
  ``virtual_mesh`` places n shards round-robin on the devices it is
  given -- n shards on one card, as the reference validates its mesh on
  n forced virtual CPU devices, or n CPU shards;
* the rows (and each step's noise rows) are split over ALL ``data`` x
  ``model`` shards, in shard order (data-major), as evenly as possible;
  the hidden dimension is not split over ``model`` (the function is the
  same, only the layout differs);
* the params are replicated, one copy per distinct device;
* the fit is K5 (``kernels.anomaly.fit_shard_``): phase A per shard,
  phase B once over every shard's slots in shard order, so that each
  device ends with the same bits -- one launch per fit when the shards
  lie on one card, S + 1 launches a step across cards and for the single
  steps below; the score is K1 per shard, concatenated in shard order
  (rows are independent).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import anomaly as K
from . import anomaly


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` shards; ``devices`` holds the device of each
    shard in shard order (data-major: shard d * model + m)."""
    data: int
    model: int
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def desc(self) -> str:
        return f"{self.data}x{self.model}"

    @property
    def distinct(self) -> list[torch.device]:
        """The shards' devices, each once, in order of first shard."""
        return list(dict.fromkeys(self.devices))


def _mesh(devices) -> Mesh:
    """The reference's shape: model = 2 when the count is even, else 1."""
    n = len(devices)
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return Mesh(data=n // model, model=model, devices=tuple(devices))


def _device_list(device) -> list[torch.device]:
    """``device`` (one or a list) as the torch.devices tensors report: a
    CUDA device with its index (the current one where none is given), the
    CPU without one.  A CUDA device without a GPU raises."""
    from .runtime import resolve_device

    out = []
    for d in device if isinstance(device, (list, tuple)) else [device]:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type == "cpu":
            dev = torch.device("cpu")
        out.append(dev)
    return out


def fleet_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """The mesh over the visible CUDA devices ``[:n_devices]`` (all when
    None), one shard each, as the reference covers ``jax.devices()[:n]``.
    ``device`` (a device or a list) stands in for the visible CUDA
    devices."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("fleet_mesh: no CUDA GPU is available; pass "
                               "device= or use virtual_mesh(n, 'cpu')")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = _device_list(device)
    return _mesh(devs[: n_devices or len(devs)])


def virtual_mesh(n: int, device="cuda") -> Mesh:
    """n shards placed round-robin on ``device`` (a device or a list):
    the counterpart of the reference's n forced virtual CPU devices.  A
    CUDA device without a GPU raises."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    devs = _device_list(device)
    return _mesh([devs[i % len(devs)] for i in range(n)])


def shard_bounds(rows: int, mesh: Mesh) -> list[tuple[int, int]]:
    """Each shard's rows [start, stop): contiguous blocks in shard order,
    the first ``rows % S`` of them one row longer."""
    shards = len(mesh.devices)
    base, extra = divmod(rows, shards)
    bounds, start = [], 0
    for s in range(shards):
        stop = start + base + (s < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """x [n, ...] as one block of rows per shard, each on its device (a
    view where it already lies there)."""
    return [x[a:b].to(dev) for (a, b), dev in
            zip(shard_bounds(len(x), mesh), mesh.devices)]


def shard_noise(noises: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """The fit's [steps, n, F] noise with its rows split like the batch it
    perturbs; the steps axis stays whole."""
    return [noises[:, a:b].to(dev) for (a, b), dev in
            zip(shard_bounds(noises.shape[1], mesh), mesh.devices)]


def shard_params(params: anomaly.AnomalyParams, mesh: Mesh
                 ) -> list[anomaly.AnomalyParams]:
    """One copy of the params per distinct device of the mesh, in order of
    first shard (the params themselves where they already lie there)."""
    return [anomaly.AnomalyParams(*(p.to(dev) for p in params))
            for dev in mesh.distinct]


def score_shards(replicas, xs) -> torch.Tensor:
    """K1 on each shard with its device's params, concatenated in shard
    order on the first shard's device."""
    by_dev = {p.w_enc.device: p for p in replicas}
    home = xs[0].device
    return torch.cat([anomaly.score(by_dev[x.device], x).to(home)
                      for x in xs])


def score(params: anomaly.AnomalyParams, x: torch.Tensor,
          mesh: Mesh) -> torch.Tensor:
    """The sharded score of x [n, F]: [n] on the first shard's device."""
    return score_shards(shard_params(params, mesh), shard_rows(x, mesh))


def _step(params, x, noise, mesh: Mesh, lr: float, sigma: float):
    xs = shard_rows(x, mesh)
    replicas = shard_params(
        anomaly.AnomalyParams(*(p.clone() for p in params)), mesh)
    loss = torch.empty(1, dtype=torch.float32, device=xs[0].device)
    K.fit_shard_step_(replicas, xs,
                      None if noise is None else shard_rows(noise, mesh),
                      lr=lr, sigma=sigma, loss_out=loss)
    return replicas[0], loss[0]


def train_step(params: anomaly.AnomalyParams, x: torch.Tensor, mesh: Mesh,
               lr: float = 1e-3):
    """One sharded SGD step on the pooled windows -> (new params on the
    first shard's device, loss).  The inputs are left as they were."""
    return _step(params, x, None, mesh, lr, 0.0)


def denoise_step_with_noise(params: anomaly.AnomalyParams, x: torch.Tensor,
                            noise: torch.Tensor, mesh: Mesh,
                            lr: float = 1e-3, sigma: float = 0.25):
    """One sharded denoising step with caller-supplied unit noise [n, F]
    -> (new params, loss)."""
    return _step(params, x, noise, mesh, lr, sigma)


def denoise_step(params: anomaly.AnomalyParams, x: torch.Tensor,
                 generator: torch.Generator, mesh: Mesh, lr: float = 1e-3,
                 sigma: float = 0.25):
    """One sharded denoising step, its unit noise drawn from
    ``generator`` on x's device before the rows are split."""
    noise = torch.randn(x.shape, generator=generator, device=x.device)
    return denoise_step_with_noise(params, x, noise, mesh, lr, sigma)
