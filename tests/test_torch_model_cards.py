"""K5b across cards: the cards route's plan, route choice and scratch.

With the shards on several cards that all reach each other's memory, the
split fit is one persistent launch per card (``csrc/anomaly_fit_model.cu``,
``anomaly_fit_model_cards``): the fold's work items (one slot of BOTH
halves) split over the cards that hold each data block, every item's two
slots stored into every card's slots, one barrier across cards a step
(``csrc/anomaly_cards.cuh``), and the fold's phase B on every card.  Its
bits equal the fold's and the per-step route's only if every slot of
every half is written once, by an item of a card that holds the rows it
walks, at the place the reduce reads it; the C planner (``card_items``,
``card_slot``, ``card_block_tiles``) has a Python twin,
``K.cards_fit_plan``, held here as ``test_torch_model_fold.py`` holds
``model_fit_plan``.  chip_smoke.py holds the routes bit for bit on the
card, with one card and, under ``--cards``, over several.
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


def _fleet(data: int) -> list[int]:
    """The fleet mesh of 2 data cards: shard s on card s."""
    return list(range(K.MODEL * data))


def _rows(n: int, data: int) -> list[int]:
    mesh = M.virtual_mesh(K.MODEL * data, "cpu")
    return [b - a for a, b in M.data_bounds(n, mesh)]


# (rows of each data block, the card of each shard, F): the fleet meshes
# 1x2 .. 4x2 at the hour's shape, uneven data blocks, shards of one card,
# and round-robin layouts where a card holds shards of several blocks
LAYOUTS = {
    "1x2-fleet": (_rows(4224, 1), _fleet(1), 32),
    "2x2-fleet": (_rows(4224, 2), _fleet(2), 32),
    "3x2-fleet": (_rows(4224, 3), _fleet(3), 40),
    "4x2-fleet": (_rows(4224, 4), _fleet(4), 32),
    "4x2-fleet-98304x40": (_rows(98304, 4), _fleet(4), 40),
    "2x2-fleet-uneven": ([1000, 37], _fleet(2), 61),
    "4x2-fleet-uneven": ([5, 2112, 33, 640], _fleet(4), 16),
    "3x2-fleet-tiny": ([1, 31, 65], _fleet(3), 7),
    "2x2-one-card": (_rows(4224, 2), [0, 0, 0, 0], 32),
    "4x2-one-card": (_rows(4224, 4), [0] * 8, 64),
    "2x2-on-2-cards": (_rows(4224, 2), [0, 1, 0, 1], 32),
    "4x2-on-4-cards": (_rows(4225, 4), [0, 1, 2, 3] * 2, 48),
    "3x2-on-3-cards": ([700, 1500, 2900], [0, 1, 2, 0, 1, 2], 32),
}


@pytest.fixture(params=list(LAYOUTS), ids=list(LAYOUTS))
def case(request):
    rows, cards_of, f = LAYOUTS[request.param]
    return rows, cards_of, f, K.cards_fit_plan(rows, cards_of, BLOCKS, f)


def _items(plan):
    """(card, item) over every card's blocks."""
    return [(c, it) for c, blocks in enumerate(plan.items)
            for block in blocks for it in block]


def test_every_half_slot_is_written_by_exactly_one_item_of_one_card(case):
    rows, _, f, plan = case
    pf = K.half_slot_floats(f)
    total = K.shard_slot_offsets(rows)[-1]
    written = [(at, c) for c, it in _items(plan) for at in it.at]
    assert len(written) == len({at for at, _ in written}) == K.MODEL * total
    assert sorted(at for at, _ in written) == [i * pf for i in
                                               range(K.MODEL * total)]


def test_a_card_takes_only_items_of_blocks_whose_rows_it_holds(case):
    _, cards_of, _, plan = case
    for c, it in _items(plan):
        assert c in cards_of[K.MODEL * it.d:K.MODEL * (it.d + 1)]


def test_the_cards_of_a_block_differ_by_at_most_one_item(case):
    rows, cards_of, _, plan = case
    for d, n in enumerate(rows):
        holders = list(dict.fromkeys(cards_of[K.MODEL * d:
                                              K.MODEL * (d + 1)]))
        took = [sum(1 for c, it in _items(plan) if c == h and it.d == d)
                for h in holders]
        assert sum(took) == K.fit_slots(n)
        assert max(took) - min(took) <= 1
        assert [plan.runs[h][d] for h in holders] == [
            (sum(took[:i]), sum(took[:i + 1])) for i in range(len(holders))]


def test_the_union_of_the_cards_items_is_the_folds(case):
    rows, _, f, plan = case
    fold = K.model_fit_plan(rows, BLOCKS, f)
    mine = sorted(it for _, it in _items(plan))
    assert mine == sorted(it for block in fold.items for it in block)


def test_a_cards_blocks_take_its_slots_in_data_order_in_turn(case):
    """Card c's items are its runs of slots, data block by data block
    (``card_slot``); its block k takes items k, k + blocks, ...."""
    rows, _, _, plan = case
    offsets = K.shard_slot_offsets(rows)
    for c, blocks in enumerate(plan.items):
        mine = [offsets[d] + b for d, (lo, hi) in enumerate(plan.runs[c])
                for b in range(lo, hi)]
        for k, block in enumerate(blocks):
            assert [it.slot for it in block] == mine[k::BLOCKS]


def test_shared_memory_fits_an_h100_block_on_every_card(case):
    _, _, f, plan = case
    base = K.fold_work_bytes(f) + 2 * K.tile_bytes(f)
    for c, blocks in enumerate(plan.items):
        most = max(sum(len(it.tiles) for it in block) for block in blocks)
        assert plan.smem[c] <= K.MAX_SMEM
        if plan.resident_tiles[c] or not most:
            assert plan.resident_tiles[c] == most
            assert plan.smem[c] == base + most * K.tile_bytes(f)
        else:
            assert base + most * K.tile_bytes(f) > K.MAX_SMEM
            assert plan.smem[c] == base + K.tile_bytes(f)


@pytest.mark.parametrize("data", [1, 2, 4])
def test_the_hour_over_the_fleet_mesh_gives_each_card_an_even_share(data):
    """The hour at 1x2, 2x2 and 4x2 over 2, 4 and 8 cards: 132 / 2, 66 / 2
    and 33 / 2 items a card of one row tile each, at most one a block."""
    plan = K.cards_fit_plan(_rows(4224, data), _fleet(data), BLOCKS, 32)
    share = K.fit_slots(4224 // data)
    for blocks in plan.items:
        assert sum(map(len, blocks)) in (share // 2, -(-share // 2))
        assert max(map(len, blocks)) == 1
        assert all(len(it.tiles) == 1 for b in blocks for it in b)


def test_the_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):      # a shard's card is missing
        K.cards_fit_plan([64, 64], [0, 2, 2, 0], BLOCKS, 32)
    with pytest.raises(ValueError):      # two shards a data block
        K.cards_fit_plan([64, 64], [0, 1, 0], BLOCKS, 32)
    with pytest.raises(ValueError):
        K.cards_fit_plan([1] * (K.MAX_DATA + 1), [0] * 2 * (K.MAX_DATA + 1),
                         BLOCKS, 32)
    with pytest.raises(ValueError):
        K.cards_fit_plan([64] * 9, _fleet(9), BLOCKS, 32)
    assert len(K.cards_fit_plan([64] * 4, _fleet(4), BLOCKS, 32).items) == (
        K.MAX_CARDS)


# ------------------------------------------------------------- the route


def _cards(n: int) -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(n)]


def _every_pair(a, b) -> bool:
    return True


@pytest.mark.parametrize("devices, peered, route", [
    ([torch.device("cuda", 0)] * 4, _every_pair, K.ROUTE_FOLD),
    ([torch.device("cuda", 3)] * 8, lambda a, b: False, K.ROUTE_FOLD),
    (_cards(2), _every_pair, K.ROUTE_CARDS),
    (_cards(4), _every_pair, K.ROUTE_CARDS),
    (_cards(8), _every_pair, K.ROUTE_CARDS),
    (_cards(2) * 2, _every_pair, K.ROUTE_CARDS),
    (_cards(4), lambda a, b: {a.index, b.index} != {1, 2}, K.ROUTE_STEPS),
    (_cards(4), lambda a, b: (a.index, b.index) != (3, 0), K.ROUTE_STEPS),
    (_cards(2), lambda a, b: False, K.ROUTE_STEPS),
    (_cards(9), lambda a, b: a.index != 8, K.ROUTE_STEPS),
], ids=["one-card", "one-card-unpeered", "1x2", "2x2", "4x2",
        "2x2-on-2-cards", "2x2-a-pair-missing", "2x2-one-way-missing",
        "1x2-unpeered", "9-cards-unpeered"])
def test_the_route_follows_the_layout_and_the_peer_map(devices, peered,
                                                       route):
    assert K.model_route(devices, peered) == route


def test_more_than_max_cards_with_peer_access_raise():
    with pytest.raises(ValueError, match="at most 8 cards"):
        K.model_route(_cards(K.MAX_CARDS + 1), _every_pair)


def test_the_route_asks_every_ordered_pair_once_before_any_launch():
    asked = []

    def peered(a, b):
        asked.append((a.index, b.index))
        return True

    K.reset_launches()
    assert K.model_route(_cards(4) * 2, peered) == K.ROUTE_CARDS
    assert sorted(asked) == [(a, b) for a in range(4) for b in range(4)
                             if a != b]
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("conf, ok", [
    ({}, True),
    ({"PYTORCH_CUDA_ALLOC_CONF": "max_split_size_mb:128"}, True),
    ({"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"}, True),
    ({"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}, False),
    ({"PYTORCH_CUDA_ALLOC_CONF": "max_split_size_mb:64, "
                                 "expandable_segments:true"}, False),
    ({"PYTORCH_ALLOC_CONF": "expandable_segments:True"}, False),
    ({"PYTORCH_CUDA_ALLOC_CONF": "backend:cudaMallocAsync"}, False),
    ({"PYTORCH_CUDA_ALLOC_CONF": "backend:native"}, True),
], ids=["default", "split", "segments-off", "segments-on", "segments-list",
        "new-name", "async", "native"])
def test_the_cards_route_takes_only_memory_peer_access_covers(
        monkeypatch, conf, ok):
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        monkeypatch.delenv(var, raising=False)
    for var, value in conf.items():
        monkeypatch.setenv(var, value)
    assert K.cards_allocator_ok() is ok


# ----------------------------------------------------------- the scratch


@pytest.mark.parametrize("f", [7, 16, 32, 40, 61, 64])
def test_a_cards_scratch_is_the_copy_the_images_two_parities_a_float(f):
    """The copy of the halves a card holds no params of (both halves'
    w_enc, b_enc, w_dec, b_dec back to back) rounded to 16 bytes, then the
    fold's images (16-byte aligned: cp.async copies them 16 bytes at a
    time), then two parities of both halves' slots, then one float."""
    rows = [2112, 2112]
    halves = M.shard_params(anomaly.init_params(
        torch.Generator().manual_seed(f), feat=f), M.virtual_mesh(2, "cpu"))
    copy = sum(p.numel() for h in halves for p in h)
    assert copy == K.MODEL * (K.half_slot_floats(f) - 1)
    assert K.cards_copy_floats(f) == -(-copy // 4) * 4
    assert K.cards_copy_floats(f) * 4 % 16 == 0
    assert K.cards_slots_at(f) == K.cards_copy_floats(f) + sum(
        R.staged(*h).numel() for h in halves)
    assert K.cards_slots_at(f) * 4 % 16 == 0
    total = K.shard_slot_offsets(rows)[-1]
    assert K.cards_slot_floats(rows, f) == (
        2 * K.MODEL * total * K.half_slot_floats(f))
    assert K.cards_scratch_floats(rows, f) == (
        K.cards_slots_at(f) + K.cards_slot_floats(rows, f) + 1)


# ------------------------------------------------------------- the CPU


def _fit_inputs(data: int = 2, steps: int = 3, f: int = 32):
    g = torch.Generator().manual_seed(data + f)
    params = anomaly.init_params(g, feat=f)
    mesh = M.virtual_mesh(K.MODEL * data, "cpu")
    x = torch.randn((8 * data + 3, f), generator=g)
    noises = torch.randn((steps, 8 * data + 3, f), generator=g)
    return params, mesh, x, noises


@pytest.mark.parametrize("route", [None, K.ROUTE_CARDS, K.ROUTE_STEPS])
@pytest.mark.parametrize("data", [1, 2, 4])
def test_a_cpu_layout_runs_the_plain_split_fit_and_launches_nothing(
        route, data):
    params, mesh, x, noises = _fit_inputs(data)
    halves = M.shard_params(params, mesh)
    xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
    start = [tuple(p.clone() for p in h) for h in halves[:K.MODEL]]
    losses = torch.empty(len(noises))
    K.reset_launches()
    K.fit_model_(halves, xs, ns, lr=1e-2, sigma=0.25, losses_out=losses,
                 route=route)
    want, w_losses = R.fit_model_shard(start, xs[::K.MODEL], ns[::K.MODEL],
                                       1e-2, 0.25)
    assert not any(K.LAUNCHES.values())
    for h, w in zip(halves[:K.MODEL], want):
        assert all(torch.equal(p, q) for p, q in zip(h, w))
    assert torch.equal(losses, w_losses)


def test_the_cpu_takes_no_stamps_and_no_unknown_route():
    params, mesh, x, noises = _fit_inputs()
    args = (M.shard_params(params, mesh), M.shard_rows(x, mesh),
            M.shard_noise(noises, mesh))
    K.reset_launches()
    with pytest.raises(ValueError):
        K.fit_model_(*args, lr=1e-2, sigma=0.25,
                     losses_out=torch.empty(len(noises)),
                     route=K.ROUTE_CARDS, stamps=[torch.zeros(
                         (len(noises), K.CARDS_STAMPS, BLOCKS),
                         dtype=torch.int64)])
    for route in ("spmd", K.ROUTE_FOLD):    # the fold is the layout's
        with pytest.raises(ValueError, match="unknown route"):
            K.fit_model_(*args, lr=1e-2, sigma=0.25,
                         losses_out=torch.empty(len(noises)), route=route)
    assert not any(K.LAUNCHES.values())


# ------------------------------------------------ the kernel's own words


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / source)
                  .read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def test_python_and_the_kernel_name_the_same_limits_and_entry_point():
    assert _constant("anomaly_cards.cuh", "kMaxCards") == K.MAX_CARDS
    assert _constant("anomaly_fit_model.cu", "kCardStamps") == (
        K.CARDS_STAMPS)
    assert K.FIT_MODEL_CARDS in build.entry_points("anomaly_fit_model")
    src = (CSRC / "anomaly_fit_model.cu").read_text()
    head = src[src.index(f'extern "C" int {K.FIT_MODEL_CARDS}('):]
    params = head[:head.index(")")].split(",")
    assert len(params) == len(build.SIGNATURES[K.FIT_MODEL_CARDS])
    assert "int launch" in head[:head.index(")")]


def test_the_cards_kernel_has_one_barrier_across_cards_a_step():
    """A barrier across cards before the steps (every card's launch has
    begun), one a step (after phase A's stores), one at the end (no card
    exits while a peer may touch its memory); phase B's slices keep their
    barrier between them (fold_phase_b)."""
    src = (CSRC / "anomaly_fit_model.cu").read_text()
    body = src[src.index("model_cards_kernel(const __grid_constant__"):]
    body = body[:body.index("\n}\n")]
    prologue, rest = body.split("for (int s = 0; s < steps; ++s) {")
    steps, epilogue = rest.rsplit("\n  }\n", 1)
    assert prologue.count("cards_sync(") == 1
    assert steps.count("cards_sync(") == 1
    assert epilogue.count("cards_sync(") == 1
    assert "grid.sync()" in steps
    phase_b = src[src.index("void fold_phase_b("):]
    phase_b = phase_b[:phase_b.index("\n}\n")]
    assert "if (k != block) __syncthreads();" in phase_b
    barrier = (CSRC / "anomaly_cards.cuh").read_text()
    assert "__trap()" in barrier and "%globaltimer" in (
        CSRC / "anomaly_fit_persistent.cuh").read_text()
