"""The plan of K5b's one-launch fit (``kernels.anomaly.model_fit_plan``).

On one card the split fit is one persistent launch
(``csrc/anomaly_fit_model.cu``, ``anomaly_fit_model_fit``, "the fold")
whose work item is one slot of BOTH halves: data block d's block b of
``fit_slots(n_d)``, walking tiles b, b + ga_d, ... of block d, running
each half's forward and backward over them and writing half 0's and half
1's slot.  Block k of the grid (one per SM) takes slots k, k + blocks,
....  Its bits equal the per-step route's only if every slot of every
half is written once, by an item that walks the same tiles in the same
order, at the place where the per-step route writes it and the reduce of
its half reads it; those are held here.  The kernel's host code plans
the same way in C (``fold_item``, ``fold_block_tiles``, ``shared_plan``),
and chip_smoke.py holds the two routes bit for bit on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import mesh as M
from clawker_tpu_torch.kernels import anomaly as K
from clawker_tpu_torch.kernels import build
from clawker_tpu_torch.kernels import reference as R

torch.set_num_threads(1)

BLOCKS = 132    # an H100's SMs: one block each
CSRC = Path(K.__file__).resolve().parent / "csrc"
# the data-block layouts D x 2 of the split meshes, and the batches
DATA = (2, 4, 8, 32)
BATCHES = [(4224, 16), (4224, 32), (4224, 48), (4224, 64), (98304, 40)]


def _blocks(n: int, data: int) -> list[int]:
    """The rows of each data block of ``virtual_mesh(2 data)`` over n."""
    mesh = M.virtual_mesh(K.MODEL * data, "cpu")
    assert (mesh.data, mesh.model) == (data, K.MODEL)
    return [b - a for a, b in M.data_bounds(n, mesh)]


def _tiles(n: int) -> int:
    return -(-n // K.FIT_ROWS)


@pytest.fixture(params=[(n, f, d) for n, f in BATCHES for d in DATA],
                ids=lambda p: f"{p[0]}x{p[1]}-{p[2]}x2")
def case(request):
    n, f, data = request.param
    rows = _blocks(n, data)
    return rows, f, K.model_fit_plan(rows, BLOCKS, f)


def test_every_half_slot_is_written_by_exactly_one_item(case):
    rows, f, plan = case
    pf = K.half_slot_floats(f)
    total = K.shard_slot_offsets(rows)[-1]
    written = [at for block in plan.items for it in block for at in it.at]
    assert len(written) == len(set(written)) == K.MODEL * total
    assert sorted(written) == [i * pf for i in range(K.MODEL * total)]


def test_slots_lie_where_the_reduce_of_their_half_reads_them(case):
    """``anomaly_fit_model_reduce`` of half m reads ``total`` slots back to
    back from ``half_slot_at(rows, f, 0, m)`` (as ``_model_stepper`` points
    it), and the per-step route writes data block d's block b at
    ``half_slot_at(rows, f, d, m) + b`` slots."""
    rows, f, plan = case
    pf = K.half_slot_floats(f)
    total = K.shard_slot_offsets(rows)[-1]
    for m in range(K.MODEL):
        assert K.half_slot_at(rows, f, 0, m) == m * total * pf
    for block in plan.items:
        for it in block:
            for m, at in enumerate(it.at):
                assert at == K.half_slot_at(rows, f, it.d, m) + it.b * pf
                assert at == (m * total + it.slot) * pf


def test_every_tile_once_in_the_per_step_routes_order(case):
    rows, _, plan = case
    offsets = K.shard_slot_offsets(rows)
    walked = [(it.d, t) for block in plan.items for it in block
              for t in it.tiles]
    assert len(walked) == len(set(walked))
    assert set(walked) == {(d, t) for d, n in enumerate(rows)
                           for t in range(_tiles(n))}
    for k, block in enumerate(plan.items):
        assert [it.slot for it in block] == list(range(k, offsets[-1],
                                                        BLOCKS))
        for it in block:
            ga = K.fit_slots(rows[it.d])
            assert it.slot == offsets[it.d] + it.b and 0 <= it.b < ga
            assert it.tiles == tuple(range(it.b, _tiles(rows[it.d]), ga))


def test_shared_memory_fits_an_h100_block(case):
    rows, f, plan = case
    most = max(sum(len(it.tiles) for it in block) for block in plan.items)
    base = K.fold_work_bytes(f) + 2 * K.tile_bytes(f)
    assert plan.smem <= K.MAX_SMEM
    if plan.resident_tiles:
        assert plan.resident_tiles == most
        assert plan.smem == base + most * K.tile_bytes(f)
    else:
        assert base + most * K.tile_bytes(f) > K.MAX_SMEM
        assert plan.smem == base + K.tile_bytes(f)


def test_the_fold_walks_k5s_items_over_the_data_blocks(case):
    """Slot for slot, the fold's items are the items of K5's one-launch
    fit over shards of the data blocks' rows: the same tiles, so each half
    sums what K5's slot sums, over its half of the hidden units."""
    rows, f, plan = case
    k5 = K.shard_fit_plan(rows, BLOCKS, f)
    assert [[(it.d, it.b, it.slot, it.tiles) for it in block]
            for block in plan.items] == [
        [(it.shard, it.b, it.slot, it.tiles) for it in block]
        for block in k5.items]


@pytest.mark.parametrize("data, items", [(2, [1] * BLOCKS),
                                         (4, [1] * BLOCKS),
                                         (8, [2] * 4 + [1] * (BLOCKS - 4))])
def test_the_timed_meshes_give_one_item_a_block(data, items):
    """The hour at 2x2 and 4x2 is 132 items of one row tile, one a block
    (the per-step route's work items were 264 half tiles there); at 8x2,
    136 items, so four blocks take two."""
    plan = K.model_fit_plan(_blocks(4224, data), BLOCKS, 32)
    assert [len(block) for block in plan.items] == items
    assert all(len(it.tiles) == 1 for block in plan.items for it in block)
    assert plan.resident_tiles == max(items)


@pytest.mark.parametrize("f", [16, 32, 40, 48, 61, 64])
def test_the_fold_s_arrays_stay_16_byte_aligned(f):
    """The x and noise tiles start after the working set, where cp.async
    copies 16 bytes at a time; the slot's room is what its assembly needs
    (2 F (HALF + 8) + HALF + F + 1 floats)."""
    assert K.fold_work_bytes(f) % 16 == 0
    assert K.tile_bytes(f) % 16 == 0
    fp, ldq = -(-f // 16) * 16, K.HALF + 8
    room = 2 * (4 * K.FIT_ROWS * (fp + 8) + K.MODEL * 4 * K.FIT_ROWS * ldq)
    assert room >= 4 * (2 * fp * ldq + K.HALF + fp + 1)
    assert K.fold_work_bytes(f) >= 4 * K.REDUCE_GROUPS * 64   # phase B


@pytest.mark.parametrize("f", [7, 16, 32, 40, 61, 64])
def test_scratch_is_the_images_then_the_per_step_routes_layout(f):
    """The fold's staged images come first, K3's image at the width of a
    half for each (``reference.staged`` of the half), 16-byte aligned so
    that the slots after them are too; the per-step route takes the rest,
    its slots, y [MODEL, N, F] and a float."""
    rows = [1056] * 4
    halves = M.shard_params(anomaly.init_params(
        torch.Generator().manual_seed(f), feat=f), M.virtual_mesh(2, "cpu"))
    assert K.model_image_floats(f) == sum(R.staged(*h).numel()
                                          for h in halves)
    assert K.model_image_floats(f) * 4 % 16 == 0
    total = K.shard_slot_offsets(rows)[-1]
    assert K.model_scratch_floats(rows, f) == (
        K.model_image_floats(f) + K.MODEL * total * K.half_slot_floats(f)
        + K.MODEL * sum(rows) * f + 1)


def test_more_than_max_data_blocks_raise():
    assert len(K.model_fit_plan([1] * K.MAX_DATA, BLOCKS, 32).items) == (
        BLOCKS)
    with pytest.raises(ValueError):
        K.model_fit_plan([1] * (K.MAX_DATA + 1), BLOCKS, 32)
    with pytest.raises(ValueError):
        K.model_fit_plan([], BLOCKS, 32)


def _fit_inputs(data: int = 2, steps: int = 2):
    g = torch.Generator().manual_seed(data)
    params = anomaly.init_params(g, feat=32)
    mesh = M.virtual_mesh(K.MODEL * data, "cpu")
    x = torch.randn((4 * data, 32), generator=g)
    noises = torch.randn((steps, 4 * data, 32), generator=g)
    return (M.shard_params(params, mesh), M.shard_rows(x, mesh),
            M.shard_noise(noises, mesh), torch.empty(steps))


def test_stamps_trace_only_the_one_launch_fit_on_a_card():
    K.reset_launches()
    halves, xs, noises, losses = _fit_inputs()
    stamps = torch.zeros((2, K.FIT_STAMPS, BLOCKS), dtype=torch.int64)
    with pytest.raises(ValueError):
        K.fit_model_(halves, xs, noises, lr=1e-2, sigma=0.25,
                     losses_out=losses, stamps=stamps)
    with pytest.raises(ValueError):   # the trace's points per step
        K.fit_model_(halves, xs, noises, lr=1e-2, sigma=0.25,
                     losses_out=losses,
                     stamps=torch.zeros((2, 3, BLOCKS), dtype=torch.int64))
    assert not any(K.LAUNCHES.values())


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / source)
                  .read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def test_python_and_the_kernel_name_the_same_limits_and_entry_point():
    assert _constant("anomaly_fit_model.cu", "kMaxData") == K.MAX_DATA
    assert _constant("anomaly_fit_model.cu", "kModel") == K.MODEL
    assert _constant("anomaly_fit_persistent.cuh", "kStamps") == K.FIT_STAMPS
    src = (CSRC / "anomaly_fit_model.cu").read_text()
    head = src[src.index(f'extern "C" int {K.FIT_MODEL}('):]
    params = head[:head.index(")")].split(",")
    assert len(params) == len(build.SIGNATURES[K.FIT_MODEL])
    assert "long long* stamps" in head[:head.index(")")]


def test_the_fold_has_two_grid_barriers_a_step_and_the_route_three_kinds():
    """One grid.sync after phase A and one after phase B of each step of
    the fold's kernel (and one in its prologue, after the images are
    built); the per-step route keeps its three launches a step."""
    src = (CSRC / "anomaly_fit_model.cu").read_text()
    body = src[src.index("model_fit_kernel(const __grid_constant__"):]
    body = body[:body.index("\n}\n")]
    prologue, steps = body.split("for (int s = 0; s < steps; ++s) {")
    assert prologue.count("grid.sync()") == 1
    assert steps.count("grid.sync()") == 2
    for entry in (K.FIT_MODEL_FORWARD, K.FIT_MODEL_PARTIALS,
                  K.FIT_MODEL_REDUCE):
        assert f'extern "C" int {entry}(' in src


def test_sass_diff_holds_the_other_kernels_and_asks_for_a_tree(capsys):
    """``python -m clawker_tpu_torch.kernels.sass_diff`` holds K1, K2, K3
    and K5 (every source but K5b's) against another tree's build, and
    without one prints its usage and exits 2."""
    from clawker_tpu_torch.kernels import sass_diff

    assert set(sass_diff.UNCHANGED) == set(build.SOURCES) - {
        "anomaly_fit_model"}
    assert sass_diff.main([]) == 2
    assert "OTHER_CSRC" in capsys.readouterr().err
