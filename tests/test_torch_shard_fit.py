"""The plan of K5's one-launch fit (``kernels.anomaly.shard_fit_plan``).

On one card the sharded fit is one persistent launch
(``csrc/anomaly_fit_shard.cu``, ``anomaly_fit_shard_fit``) whose work items
are the per-step route's launches A: slot i is shard s's block
b = i - shard_slot_offsets[s], walking tiles b, b + ga_s, ... of shard s,
and block k of the grid (one per SM) takes slots k, k + blocks, ....  Its
bits equal the per-step route's only if every item walks the same tiles in
the same order into the same slot, so those are held here; the kernel's
host code plans the same way in C (``item_of``, ``most_block_tiles``), and
chip_smoke.py holds the two routes bit for bit on the card.  The shared
memory follows K3's rule (``fit_shared_plan``): the x tiles of all a
block's items stay resident while they fit in an H100 block's 227 KB,
else one tile is reloaded at each tile.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from chip_smoke import RELOAD_SHAPE
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import mesh as M
from clawker_tpu_torch.kernels import anomaly as K
from clawker_tpu_torch.kernels import build

torch.set_num_threads(1)

BLOCKS = 132    # an H100's SMs: one block each
CSRC = Path(K.__file__).resolve().parent / "csrc"


def _rows(n: int, shards: int) -> list[int]:
    return [b - a for a, b in M.shard_bounds(n, M.virtual_mesh(shards,
                                                                "cpu"))]


# (rows per shard, F)
CASES = {
    "hour, 1 shard": ([4224], 32),
    "hour, 4 shards": ([1056] * 4, 32),
    "hour, 8 shards: 136 items on 132 blocks": ([528] * 8, 32),
    "shards under one tile": ([17] * 8, 32),
    "129 rows over 8 uneven shards": (_rows(129, 8), 32),
    "256 slots: long runs": ([2048] * 4, 32),
    "reload shape over 2 shards": (_rows(RELOAD_SHAPE[0], 2), RELOAD_SHAPE[1]),
}


def _tiles(n: int) -> int:
    return -(-n // K.FIT_ROWS)


@pytest.fixture(params=list(CASES))
def case(request):
    rows, f = CASES[request.param]
    return rows, f, K.shard_fit_plan(rows, BLOCKS, f)


def test_every_tile_once_and_in_its_own_shard(case):
    rows, _, plan = case
    walked = [(it.shard, t) for block in plan.items for it in block
              for t in it.tiles]
    assert len(walked) == len(set(walked))
    assert set(walked) == {(s, t) for s, n in enumerate(rows)
                           for t in range(_tiles(n))}


def test_items_are_the_per_step_routes_launches_in_slot_order(case):
    rows, _, plan = case
    offsets = K.shard_slot_offsets(rows)
    total = offsets[-1]
    for k, block in enumerate(plan.items):
        assert [it.slot for it in block] == list(range(k, total, BLOCKS))
        for it in block:
            assert it.slot == offsets[it.shard] + it.b
            ga = K.fit_slots(rows[it.shard])
            assert 0 <= it.b < ga
            assert it.tiles == tuple(range(it.b, _tiles(rows[it.shard]), ga))


def test_shared_memory_fits_an_h100_block(case):
    rows, f, plan = case
    most = max(sum(len(it.tiles) for it in block) for block in plan.items)
    base = K.work_bytes(f) + 2 * K.tile_bytes(f)
    assert plan.smem <= K.MAX_SMEM
    if plan.resident_tiles:
        assert plan.resident_tiles == most
        assert plan.smem == base + most * K.tile_bytes(f)
    else:
        assert base + most * K.tile_bytes(f) > K.MAX_SMEM
        assert plan.smem == base + K.tile_bytes(f)


def test_only_the_reload_shape_reloads():
    for name, (rows, f) in CASES.items():
        plan = K.shard_fit_plan(rows, BLOCKS, f)
        assert (plan.resident_tiles == 0) == name.startswith("reload"), name


def test_more_slots_than_blocks_give_some_blocks_two_items():
    plan = K.shard_fit_plan([528] * 8, BLOCKS, 32)
    assert [len(b) for b in plan.items] == [2] * 4 + [1] * (BLOCKS - 4)
    assert plan.resident_tiles == 2


@pytest.mark.parametrize("n, f", [(100, 32), (130, 7), (640, 32),
                                  (4224, 32), (8192, 32), (139392, 32),
                                  (139393, 32), (50689, 61)])
def test_one_shard_is_k3s_plan(n, f):
    """Over one shard, block b walks K3's tiles b, b + ga, ... and the
    shared memory is K3's for ceil(ceil(n / 32) / ga) tiles a block."""
    plan = K.shard_fit_plan([n], BLOCKS, f)
    ga = K.fit_slots(n)
    for b, block in enumerate(plan.items):
        if b < ga:
            assert [it.tiles for it in block] == [
                tuple(range(b, _tiles(n), ga))]
        else:
            assert block == []
    assert (plan.resident_tiles, plan.smem) == K.fit_shared_plan(
        -(-_tiles(n) // ga), f)


@pytest.mark.parametrize("f, n", [(16, 321024), (32, 139392), (48, 80256),
                                  (64, 50688)])
def test_k3_keeps_x_resident_up_to_its_documented_rows(f, n):
    """csrc/anomaly_fit.cu: x stays resident up to n = 321024 / 139392 /
    80256 / 50688 rows at F padded to 16 / 32 / 48 / 64; one more row
    reloads."""
    def per_block(rows):
        return -(-_tiles(rows) // K.fit_slots(rows))

    assert K.fit_shared_plan(per_block(n), f)[0] > 0
    assert K.fit_shared_plan(per_block(n + 1), f)[0] == 0


def test_more_than_max_shards_raise():
    assert len(K.shard_fit_plan([1] * K.MAX_SHARDS, BLOCKS, 32).items) == (
        BLOCKS)
    with pytest.raises(ValueError):
        K.shard_fit_plan([1] * (K.MAX_SHARDS + 1), BLOCKS, 32)
    with pytest.raises(ValueError):
        K.shard_fit_plan([], BLOCKS, 32)


def _fit_inputs(shards: int, steps: int = 2):
    g = torch.Generator().manual_seed(shards)
    params = anomaly.init_params(g, feat=32)
    mesh = M.virtual_mesh(shards, "cpu")
    x = torch.randn((2 * shards, 32), generator=g)
    noises = torch.randn((steps, 2 * shards, 32), generator=g)
    return ([params], M.shard_rows(x, mesh), M.shard_noise(noises, mesh),
            torch.empty(steps))


def test_the_wrapper_takes_max_shards_on_one_device_and_no_more():
    """The limit is the one-launch fit's: the CPU, which stands in for one
    card, keeps it too, and never launches."""
    K.reset_launches()
    replicas, xs, noises, losses = _fit_inputs(K.MAX_SHARDS)
    K.fit_shard_(replicas, xs, noises, lr=1e-2, sigma=0.25,
                 losses_out=losses)
    assert torch.isfinite(losses).all()
    replicas, xs, noises, losses = _fit_inputs(K.MAX_SHARDS + 1)
    with pytest.raises(ValueError):
        K.fit_shard_(replicas, xs, noises, lr=1e-2, sigma=0.25,
                     losses_out=losses)
    assert not any(K.LAUNCHES.values())


def test_stamps_trace_only_the_one_launch_fit_on_a_card():
    replicas, xs, noises, losses = _fit_inputs(2)
    stamps = torch.zeros((2, K.FIT_STAMPS, BLOCKS), dtype=torch.int64)
    with pytest.raises(ValueError):
        K.fit_shard_(replicas, xs, noises, lr=1e-2, sigma=0.25,
                     losses_out=losses, stamps=stamps)


@pytest.mark.parametrize("f", [7, 16, 32, 40, 61, 64])
def test_scratch_is_the_staged_image_then_the_slots(f):
    rows = [1056] * 4
    assert K.shard_scratch_floats(rows, f) == (
        K.staged_floats(f) + K.shard_slot_floats(rows, f))
    assert K.staged_floats(f) * 4 % 16 == 0   # the slots start aligned


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / source)
                  .read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def test_python_and_the_kernels_name_the_same_limits():
    assert _constant("anomaly_fit_shard.cu", "kMaxShards") == K.MAX_SHARDS
    assert _constant("anomaly_fit_persistent.cuh", "kMaxSmem") == K.MAX_SMEM
    assert _constant("anomaly_fit_persistent.cuh", "kStamps") == K.FIT_STAMPS
    assert K.FIT_SHARD in build.entry_points("anomaly_fit_shard")
    assert K.FIT_SHARD in build.SIGNATURES
    assert f'extern "C" int {K.FIT_SHARD}(' in (
        CSRC / "anomaly_fit_shard.cu").read_text()
    assert K.LAUNCHES[K.FIT_SHARD] == 0
