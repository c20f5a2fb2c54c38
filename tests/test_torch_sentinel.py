"""The port's sentinel ScoringEngine against the JAX reference engine.

Both engines score the same fused 4-worker fleet (8 loops + one
deny-storm agent) with the same params and noise injected (made with
numpy), tick after tick, so the per-worker baselines evolve on both
sides; the flagged agents and the worker-relative z must agree.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clawker_tpu.analytics import anomaly as ref
from clawker_tpu.analytics import runtime as ref_art
from clawker_tpu.sentinel import ScoringEngine as RefEngine
from clawker_tpu.sentinel import featurize_fused as ref_featurize_fused
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import runtime as art
from clawker_tpu_torch.sentinel import EXT_FEATURES, ScoringEngine, featurize_fused

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

BASE = 1_700_000_000 - 1_700_000_000 % 60  # window-aligned
TRAIN_STEPS = 40
Z_ATOL = 0.05     # robust z of scores that agree to rtol 5e-3 (see
#                   tests/test_torch_runtime.py), scaled by the MAD


def _rec(ts, agent, worker, verdict="ALLOW", reason="ROUTE",
         ip="198.51.100.9", port=443, zone="example.com"):
    return {"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
            "service": "ebpf-egress", "container": agent, "dst_ip": ip,
            "dst_port": port, "proto": 6, "verdict": verdict,
            "reason": reason, "zone": zone, "worker": worker}


def _fleet(*, hot: bool):
    recs = []
    for a in range(8):
        for w in range(6):
            for i in range(12):
                recs.append(_rec(BASE + w * 60 + i * 3, f"clawker.p.loop-{a}",
                                 f"fake-{a % 4}",
                                 ip=f"198.51.100.{a * 20 + i}"))
    if hot:
        recs += [_rec(BASE + 5 * 60 + i % 59, "clawker.p.loop-hot", "fake-1",
                      verdict="DENY", reason="NO_DNS_ENTRY",
                      ip=f"203.0.113.{i}", port=4444 + i, zone="")
                 for i in range(55)]
    return recs


def _param_arrays(feat: int):
    rng = np.random.default_rng(200 + feat)
    return (
        (rng.standard_normal((feat, 128)) * (2.0 / feat) ** 0.5).astype(np.float32),
        np.zeros(128, np.float32),
        (rng.standard_normal((128, feat)) * (2.0 / 128) ** 0.5).astype(np.float32),
        np.zeros(feat, np.float32),
    )


@pytest.fixture
def injected(monkeypatch):
    """Both engines' fits draw the same numpy params and noise; the
    reference engine runs unsharded, as the port does on one GPU."""
    made = {}

    def noise_for(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in made:
            made[shape] = np.random.default_rng(sum(shape)).standard_normal(
                shape).astype(np.float32)
        return made[shape]

    monkeypatch.setattr(
        ref_art, "anomaly_init", lambda seed, feat=None: ref.AnomalyParams(
            *(jnp.asarray(a) for a in _param_arrays(feat or 32))))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            noise_for(shape)))
    monkeypatch.setattr(RefEngine, "_mesh", lambda self: None)
    monkeypatch.setattr(art, "_draw", lambda seed, steps, x: (
        anomaly.params_from_numpy(_param_arrays(x.shape[1]), device=x.device),
        torch.from_numpy(noise_for((steps,) + tuple(x.shape)))))


def _flagged(rep, threshold):
    return {a.agent for a in rep.agents if a.latest >= threshold}


def test_score_tick_twin_flags_the_same_agents(injected):
    eng = ScoringEngine(train_steps=TRAIN_STEPS, device="cpu")
    ref_eng = RefEngine(train_steps=TRAIN_STEPS)
    flagged_any = set()
    for hot in (False, False, True, True):
        recs = _fleet(hot=hot)
        keys, X, worker_of = featurize_fused(recs, None)
        ref_keys, ref_X, ref_worker_of = ref_featurize_fused(recs, None)
        assert X.shape[1] == EXT_FEATURES == 40
        rep = eng.score_tick(keys, X, worker_of)
        want = ref_eng.score_tick(ref_keys, ref_X, ref_worker_of)
        assert rep.windows == want.windows == len(keys)
        np.testing.assert_allclose(rep.raw, want.raw, rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(rep.z, want.z, rtol=0, atol=Z_ATOL)
        np.testing.assert_array_equal(rep.supports, want.supports)
        assert _flagged(rep, eng.threshold) == _flagged(want, ref_eng.threshold)
        flagged_any |= _flagged(rep, eng.threshold)
        assert rep.device == "cpu"
    assert "clawker.p.loop-hot" in flagged_any
    assert eng.baseline_depth() == ref_eng.baseline_depth() > 0
    for worker in ("fake-0", "fake-1", "fake-2", "fake-3"):
        np.testing.assert_allclose(eng.baseline_doc()[worker],
                                   ref_eng.baseline_doc()[worker],
                                   rtol=0, atol=Z_ATOL + 1e-4)


def test_flag_kind_matches_reference_on_the_same_params():
    rng = np.random.default_rng(3)
    # near-zero weights: the error is ~x^2, so the input picks the kind
    arrays = tuple(0.01 * a for a in _param_arrays(EXT_FEATURES))
    x = rng.standard_normal((6, EXT_FEATURES)).astype(np.float32)
    x[2, 32:] *= 25.0              # a behavior-dominated row
    eng = ScoringEngine(device="cpu")
    ref_eng = RefEngine()
    eng._params = anomaly.params_to_numpy(
        anomaly.params_from_numpy(arrays, device="cpu"))
    ref_eng._params = ref.AnomalyParams(*(jnp.asarray(a) for a in arrays))
    eng._x_std = ref_eng._x_std = x
    kinds = [eng.flag_kind(i) for i in range(len(x))]
    assert kinds == [ref_eng.flag_kind(i) for i in range(len(x))]
    assert kinds[2] == "behavior" and "egress" in kinds
    assert ScoringEngine(device="cpu").flag_kind(0) == "egress"   # no tick


def test_flag_kind_after_a_cpu_tick_reads_host_arrays():
    keys, X, worker_of = featurize_fused(_fleet(hot=True), None)
    eng = ScoringEngine(train_steps=3, device="cpu")
    rep = eng.score_tick(keys, X, worker_of)
    assert isinstance(eng._x_std, np.ndarray)
    assert eng._x_std.shape == (len(keys), EXT_FEATURES)
    assert all(isinstance(p, np.ndarray) for p in eng._params)
    assert eng.flag_kind(0) in ("egress", "behavior")
    assert eng.flag_kind(len(keys) + 999) == "egress"
    assert rep.agents and np.isfinite(rep.z).all()


def test_engine_state_roundtrip():
    eng = ScoringEngine(train_steps=TRAIN_STEPS, device="cpu")
    eng.load_baselines({"fake-0": [0.1, -0.2, 0.05, 0.0, 0.3],
                        "fake-1": [1, "junk", 2]})
    assert eng.baseline_depth("fake-0") == 5
    assert eng.baseline_depth("fake-1") == 2
    doc = eng.baseline_doc()
    eng2 = ScoringEngine(train_steps=TRAIN_STEPS, device="cpu")
    eng2.load_baselines(doc)
    assert eng2.baseline_doc() == doc
    ref_eng = RefEngine(train_steps=TRAIN_STEPS)
    ref_eng.load_baselines({"fake-0": [0.1, -0.2, 0.05, 0.0, 0.3],
                            "fake-1": [1, "junk", 2]})
    assert ref_eng.baseline_doc() == doc


def test_empty_tick_is_none():
    assert ScoringEngine(device="cpu").score_tick([], np.zeros((0, 40)),
                                                  {}) is None
