"""The fleet mesh: the anomaly fit and score over a ``data`` x ``model`` mesh.

Port of ``clawker_tpu/analytics/anomaly.py:117-156`` (``fleet_mesh``,
``shard_params``, ``shard_batch``, ``shard_noise``).  The reference runs
ONE jitted program over a ``data`` x ``model`` mesh of ``jax.devices()``:
rows over ``data``, the hidden dimension over ``model``, the sums over
``model`` and the gradient psum over ``data`` inserted by XLA.  Here one
process drives a list of shards (d, m), in shard order (data-major: shard
d * model + m), each on a device, with no process group:

* ``fleet_mesh`` covers the visible CUDA devices, one shard each;
  ``virtual_mesh`` places n shards round-robin on the devices it is
  given -- n shards on one card, as the reference validates its mesh on
  n forced virtual CPU devices, or n CPU shards; both take the
  reference's shape, model = 2 at an even count, else 1;
* the rows (and each step's noise rows) are split into ``data`` blocks,
  contiguous and as even as possible, in data order; every model shard
  of block d takes block d's rows (``P("data", None)``);
* at model = 2 the hidden dimension is split as the reference splits it:
  shard (d, m) holds half m, ``w_enc[:, m H/2:(m+1) H/2]``,
  ``b_enc[m H/2:(m+1) H/2]``, ``w_dec[m H/2:(m+1) H/2, :]`` and the whole
  ``b_dec``, one copy per device and half; the fit is K5b
  (``kernels.anomaly.fit_model_``): each half's forward, the sum of the
  halves' outputs, each half's backward and the update per half over the
  data blocks' slots in data order;
* at model = 1 the params are replicated, one copy per distinct device,
  and the fit is K5 (``kernels.anomaly.fit_shard_``): phase A per shard,
  phase B once over every shard's slots in shard order;
* either fit is one launch when the shards lie on one card, and the
  per-step route across cards and for the single steps below, each device
  ending with the same bits; the score is K1 per data block on the whole
  params (at model = 2 the halves joined on the block's device),
  concatenated in data order (rows are independent).
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


def data_bounds(rows: int, mesh: Mesh) -> list[tuple[int, int]]:
    """Each data block's rows [start, stop): contiguous blocks in data
    order, the first ``rows % data`` of them one row longer."""
    base, extra = divmod(rows, mesh.data)
    bounds, start = [], 0
    for d in range(mesh.data):
        stop = start + base + (d < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_bounds(rows: int, mesh: Mesh) -> list[tuple[int, int]]:
    """Each shard's rows [start, stop), in shard order: shard d * model + m
    takes data block d's (every model shard of a block the same rows)."""
    return [b for b in data_bounds(rows, mesh) for _ in range(mesh.model)]


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


def _check_axis(mesh: Mesh) -> None:
    if mesh.model not in (1, K.MODEL):
        raise ValueError(f"a mesh's model axis is 1 or {K.MODEL}, got "
                         f"{mesh.desc}")


def shard_params(params: anomaly.AnomalyParams, mesh: Mesh
                 ) -> list[anomaly.AnomalyParams]:
    """At model = 1: one copy of the params per distinct device of the
    mesh, in order of first shard (the params themselves where they already
    lie there).  At model = 2: one params set per shard, in shard order,
    shard (d, m) holding half m of the hidden units (and the whole b_dec),
    the reference's arrays; the shards of one device and half share one
    copy, made here."""
    _check_axis(mesh)
    if mesh.model == 1:
        return [anomaly.AnomalyParams(*(p.to(dev) for p in params))
                for dev in mesh.distinct]
    w_enc, b_enc, w_dec, b_dec = params
    half = w_enc.shape[1] // mesh.model
    made = {}
    out = []
    for s, dev in enumerate(mesh.devices):
        m = s % mesh.model
        cols = slice(m * half, (m + 1) * half)
        if (dev, m) not in made:
            made[(dev, m)] = anomaly.AnomalyParams(*(
                t.to(dev, copy=True).contiguous() for t in (
                    w_enc[:, cols], b_enc[cols], w_dec[cols], b_dec)))
        out.append(made[(dev, m)])
    return out


def whole_params(replicas, mesh: Mesh) -> list[anomaly.AnomalyParams]:
    """The whole params of each data block, on its first shard's device,
    from ``shard_params``' layout: at model = 1 that device's copy, at
    model = 2 the block's halves joined there (once per device)."""
    _check_axis(mesh)
    if mesh.model == 1:
        by_dev = {p.w_enc.device: p for p in replicas}
        return [by_dev[dev] for dev in mesh.devices]
    made = {}
    for d in range(mesh.data):
        dev = mesh.devices[d * mesh.model]
        if dev not in made:
            halves = [[t.to(dev) for t in p] for p in
                      replicas[d * mesh.model:(d + 1) * mesh.model]]
            w_enc, b_enc, w_dec, _ = zip(*halves)
            made[dev] = anomaly.AnomalyParams(
                torch.cat(w_enc, dim=1), torch.cat(b_enc),
                torch.cat(w_dec), halves[0][3])
    return [made[mesh.devices[d * mesh.model]] for d in range(mesh.data)]


def score_blocks(wholes, blocks) -> torch.Tensor:
    """K1 on each data block's rows with its whole params, concatenated in
    data order on the first block's device."""
    home = blocks[0].device
    return torch.cat([anomaly.score(p, x).to(home)
                      for p, x in zip(wholes, blocks)])


def score_shards(replicas, xs, mesh: Mesh) -> torch.Tensor:
    """The score of the shards ``xs`` (``shard_rows``) with their params
    ``replicas`` (``shard_params``): [n] on the first shard's device."""
    return score_blocks(whole_params(replicas, mesh), xs[::mesh.model])


def score(params: anomaly.AnomalyParams, x: torch.Tensor,
          mesh: Mesh) -> torch.Tensor:
    """The sharded score of x [n, F]: [n] on the first shard's device."""
    return score_shards(shard_params(params, mesh), shard_rows(x, mesh), mesh)


def fit_(replicas, xs, noises, mesh: Mesh, *, lr: float, sigma: float,
         losses_out: torch.Tensor) -> None:
    """The fit over the mesh's shards, every params set updated in place:
    K5b at model = 2, K5 at model = 1 (``noises`` as ``shard_noise`` gives
    them)."""
    _check_axis(mesh)
    fit = K.fit_model_ if mesh.model == K.MODEL else K.fit_shard_
    fit(replicas, xs, noises, lr=lr, sigma=sigma, losses_out=losses_out)


def _step(params, x, noise, mesh: Mesh, lr: float, sigma: float):
    _check_axis(mesh)
    xs = shard_rows(x, mesh)
    replicas = shard_params(
        anomaly.AnomalyParams(*(p.clone() for p in params)), mesh)
    loss = torch.empty(1, dtype=torch.float32, device=xs[0].device)
    step = K.fit_model_step_ if mesh.model == K.MODEL else K.fit_shard_step_
    step(replicas, xs, None if noise is None else shard_rows(noise, mesh),
         lr=lr, sigma=sigma, loss_out=loss)
    return whole_params(replicas, mesh)[0], loss[0]


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
