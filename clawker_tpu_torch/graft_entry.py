"""Harness entry points of the port, the counterpart of ``__graft_entry__.py``.

``entry`` exposes the anomaly scoring step (K1 on the card) with example
inputs; ``dryrun_multichip`` runs the full training step, a denoising
step and the score over an n-shard ``data`` x ``model`` mesh
(``analytics/mesh.py``): n shards on one card, as the reference runs its
mesh on n virtual CPU devices.  Both run on the card unless the caller
asks for ``device="cpu"``, and raise without a GPU otherwise.  Unlike
the reference they need no platform pin and no backend teardown.

    python -m clawker_tpu_torch.graft_entry

runs both on the card.
"""

from __future__ import annotations

import torch

from .analytics import anomaly
from .analytics import mesh as M
from .analytics.runtime import DEFAULT_DEVICE, resolve_device


def _gen(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def entry(device=DEFAULT_DEVICE):
    """-> (fn, example_args): the single-device anomaly scoring step,
    params from a generator seeded 0 and x [256, FEATURES] from one
    seeded 1."""
    dev = resolve_device(device)
    params = anomaly.init_params(_gen(0, dev))
    x = torch.randn((256, anomaly.FEATURES), generator=_gen(1, dev),
                    device=dev)
    return anomaly.score, (params, x)


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> None:
    """One sharded train step (no noise), one sharded denoising step (its
    noise from a generator seeded 2) and the sharded score, over
    ``virtual_mesh(n_devices, device)`` on tiny shapes: data x 8 rows.
    The steps are K5b's per-step route where the mesh splits the hidden
    dimension (an even count: model = 2), else K5's."""
    mesh = M.virtual_mesh(n_devices, device)
    home = mesh.devices[0]
    params = anomaly.init_params(_gen(0, home))
    batch = mesh.shape["data"] * 8
    x = torch.randn((batch, anomaly.FEATURES), generator=_gen(1, home),
                    device=home)
    new_params, _ = M.train_step(params, x, mesh)
    # the product's training objective (runtime.score_windows fits with
    # the denoising step) must shard identically
    new_params, _ = M.denoise_step(new_params, x, _gen(2, home), mesh)
    scores = M.score(new_params, x, mesh)
    for dev in mesh.distinct:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if tuple(scores.shape) != (batch,):
        raise AssertionError(f"sharded scores of shape {tuple(scores.shape)}"
                             f", want ({batch},)")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape))
    dryrun_multichip(8)
    print("multichip dryrun ok")
