"""The port's anomaly runtime against the JAX reference runtime.

Parity runs inject the same params and noise (made with numpy) into
both sides -- the two frameworks' random generators differ -- and
compare raw scores and the robust-z ordering.  The behavioural twins of
tests/test_analytics_lane.py run the port on the CPU (``device="cpu"``).

Tolerance of fitted scores: the fits agree to ~5e-6 on the params, but
a weight that close to a bf16 rounding midpoint rounds to the other
side, a 2^-8 relative step in one weight, which moves the scores by up
to ~1e-3 relative (measured); rtol 5e-3.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clawker_tpu.analytics import anomaly as ref
from clawker_tpu.analytics import features as ref_F
from clawker_tpu.analytics import runtime as ref_art
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import features as F
from clawker_tpu_torch.analytics import runtime as art
from clawker_tpu_torch.kernels import anomaly as K

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

BASE = 1_700_000_000 - 1_700_000_000 % 60  # window-aligned
FIT_RTOL = 5e-3
FIT_ATOL = 1e-5
FIT_LOSS_RTOL = 1e-3    # measured 3.1e-4: the burst's standardized values
#                         (~10) enlarge what a tipped bf16(g) moves
CPU = "cpu"


def _rec(ts, agent="clawker.loop-0", verdict="ALLOW", reason="ROUTE",
         ip="198.51.100.9", port=443, proto=6, zone="example.com"):
    return {"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
            "service": "ebpf-egress", "container": agent, "dst_ip": ip,
            "dst_port": port, "proto": proto, "verdict": verdict,
            "reason": reason, "zone": zone}


def _records(*, hot_agent=False):
    recs = []
    for a in range(4):
        for w in range(6):
            for i in range(12):
                recs.append(_rec(BASE + w * 60 + i * 3,
                                 agent=f"clawker.loop-{a}",
                                 ip=f"198.51.100.{a * 20 + i}"))
    if hot_agent:
        # one agent suddenly sprays denies at many hosts on odd ports
        for i in range(55):
            recs.append(_rec(BASE + 5 * 60 + i % 59, agent="clawker.loop-3",
                             verdict="DENY", reason="NO_DNS_ENTRY",
                             ip=f"203.0.113.{i}", port=4444 + i, zone=""))
    return recs


def _stream(tmp_path, *, hot_agent=False):
    p = tmp_path / "egress.jsonl"
    p.write_text("".join(json.dumps(r) + "\n"
                         for r in _records(hot_agent=hot_agent)))
    return p


def _param_arrays(feat: int):
    rng = np.random.default_rng(100 + feat)
    return (
        (rng.standard_normal((feat, 128)) * (2.0 / feat) ** 0.5).astype(np.float32),
        np.zeros(128, np.float32),
        (rng.standard_normal((128, feat)) * (2.0 / 128) ** 0.5).astype(np.float32),
        np.zeros(feat, np.float32),
    )


def _noise(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)


def _assert_same_order(got, want, rtol=FIT_RTOL):
    """Every pair the reference separates by more than the tolerance is
    ordered the same way by the port, and the hottest row is the same."""
    assert int(np.argmax(got)) == int(np.argmax(want))
    apart = want[:, None] > want[None, :] * (1 + 2 * rtol) + 2 * FIT_ATOL
    assert (got[:, None] > got[None, :])[apart].all()


@pytest.mark.parametrize("steps", [1, 40, 120])
@pytest.mark.parametrize("hot_agent", [False, True])
def test_fit_and_score_match_reference_jitted(steps, hot_agent):
    _, X = F.featurize(_records(hot_agent=hot_agent))
    Xn = art._pad_rows(X, 32)
    arrays = _param_arrays(32)
    noise = _noise((steps,) + Xn.shape)

    fit, score_fn = ref_art._jitted()
    pj, losses_j = fit(ref.AnomalyParams(*(jnp.asarray(a) for a in arrays)),
                       jnp.asarray(Xn), jnp.asarray(noise), 1e-2)
    want = np.asarray(score_fn(pj, jnp.asarray(Xn)))

    params = anomaly.params_from_numpy(arrays, device=CPU)
    x = torch.from_numpy(Xn)
    losses = art._fit(params, x, torch.from_numpy(noise), 1e-2)
    got = anomaly.score(params, x).numpy()

    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j),
                               rtol=FIT_LOSS_RTOL)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)
    _assert_same_order(art._robust_z(got[:len(X)]),
                       ref_art._robust_z(want[:len(X)]))


@pytest.mark.parametrize("n", [0, 1, 5, 128, 129, 300])
def test_padding_and_standardize_match_reference(n):
    rng = np.random.default_rng(n)
    X = (rng.standard_normal((n, 32)) * 3 + 1).astype(np.float32)
    X[:, 7] = 2.0                     # a constant feature: sd clamps to 1
    np.testing.assert_array_equal(art._standardize(X),
                                  ref_art._standardize(X))
    Xn = art._pad_rows(X, 32)
    assert Xn.shape == (max(128, -(-n // 128) * 128), 32)
    assert Xn.dtype == np.float32
    if n:
        np.testing.assert_array_equal(Xn[:n], ref_art._standardize(X))
        np.testing.assert_array_equal(Xn[n:], Xn[np.arange(len(Xn) - n) % n])


@pytest.mark.parametrize("raw", [
    np.array([], np.float32), np.array([1.0, 1.0, 1.0], np.float32),
    np.array([0.1, 0.2, 0.15, 5.0, 0.12], np.float32),
])
def test_robust_z_matches_reference(raw):
    np.testing.assert_array_equal(art._robust_z(raw), ref_art._robust_z(raw))


@pytest.fixture
def injected(monkeypatch):
    """Both runtimes draw the same numpy params and noise."""
    made = {}

    def noise_for(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in made:
            made[shape] = _noise(shape)
        return made[shape]

    monkeypatch.setattr(
        ref_art, "anomaly_init", lambda seed, feat=None: ref.AnomalyParams(
            *(jnp.asarray(a) for a in _param_arrays(feat or 32))))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            noise_for(shape)))
    monkeypatch.setattr(art, "_draw", lambda seed, steps, x: (
        anomaly.params_from_numpy(_param_arrays(x.shape[1]), device=x.device),
        torch.from_numpy(noise_for((steps,) + tuple(x.shape)))))


@pytest.mark.parametrize("steps", [40, 120])
def test_score_windows_twin_with_injected_draws(injected, steps):
    keys, X = F.featurize(_records(hot_agent=True))
    ref_keys, ref_X = ref_F.featurize(_records(hot_agent=True))
    rep = art.score_windows(X, keys, train_steps=steps, device=CPU)
    want = ref_art.score_windows(ref_X, ref_keys, train_steps=steps)
    np.testing.assert_allclose(rep.raw, want.raw, rtol=FIT_RTOL,
                               atol=FIT_ATOL)
    _assert_same_order(rep.z, want.z)
    assert [a.agent for a in rep.agents] == [a.agent for a in want.agents]
    assert rep.train_steps == want.train_steps == steps
    hot = max(rep.agents, key=lambda a: a.peak)
    assert hot.agent == max(want.agents, key=lambda a: a.peak).agent \
        == "clawker.loop-3"


class TestScorerTwins:
    """Twins of tests/test_analytics_lane.py::TestScorer on the port."""

    def test_score_file_reports_agents_and_device(self, tmp_path):
        rep = art.score_file(_stream(tmp_path), train_steps=40, device=CPU)
        assert rep is not None
        assert {a.agent for a in rep.agents} == {
            f"clawker.loop-{i}" for i in range(4)}
        assert rep.raw.shape == (len(rep.keys),)
        assert rep.device == "cpu" and rep.train_ms > 0

    def test_exfil_burst_scores_hottest(self, tmp_path):
        rep = art.score_file(_stream(tmp_path, hot_agent=True),
                             train_steps=40, device=CPU)
        by = {a.agent: a for a in rep.agents}
        hot = by["clawker.loop-3"]
        cold_peaks = [a.peak for a in rep.agents if a.agent != hot.agent]
        assert hot.peak > max(cold_peaks), (
            f"burst window not hottest: {[(a.agent, a.peak) for a in rep.agents]}")

    def test_empty_file_scores_none(self, tmp_path):
        p = tmp_path / "empty.jsonl"
        p.write_text("")
        assert art.score_file(p, device=CPU) is None

    def test_watch_surfaces_scores_and_flags(self, tmp_path):
        p = _stream(tmp_path, hot_agent=True)
        fired = []
        watch = art.AnomalyWatch(p, train_steps=40, device=CPU,
                                 on_anomaly=lambda a, z: fired.append((a, z)))
        n = watch.refresh_once()
        assert n > 0
        assert watch.score_for("clawker.loop-2") is not None
        assert watch.score_for("loop-2") is not None       # segment match
        assert watch.score_for("nope") is None
        for agent, z in fired:
            assert watch.scores()[agent].latest >= art.ANOMALY_Z

    def test_cpu_lane_launches_no_kernel(self, tmp_path):
        K.reset_launches()
        art.score_file(_stream(tmp_path), train_steps=5, device=CPU)
        assert K.LAUNCHES == {K.SCORE: 0, K.FIT_STEP: 0, K.FIT: 0,
                              K.FIT_SHARD: 0, K.FIT_SHARD_PARTIALS: 0,
                              K.FIT_SHARD_REDUCE: 0,
                              K.FIT_MODEL: 0, K.FIT_MODEL_FORWARD: 0,
                              K.FIT_MODEL_PARTIALS: 0, K.FIT_MODEL_REDUCE: 0,
                              K.FIT_MODEL_CARDS: 0}


class TestWatchTailTwins:
    """Twins of tests/test_analytics_lane.py::TestWatchIncrementalTail."""

    def test_appends_are_picked_up_and_offset_advances(self, tmp_path):
        p = tmp_path / "egress.jsonl"
        p.write_text("".join(json.dumps(_rec(BASE + i)) + "\n"
                             for i in range(20)))
        watch = art.AnomalyWatch(p, train_steps=10, device=CPU)
        assert watch.refresh_once() == 1          # one window
        off = watch._offset
        assert off == p.stat().st_size
        with open(p, "a") as f:
            for i in range(20):
                f.write(json.dumps(_rec(BASE + 120 + i)) + "\n")
        assert watch.refresh_once() == 2          # old + new window
        assert watch._offset > off

    def test_partial_line_is_carried_not_dropped(self, tmp_path):
        p = tmp_path / "egress.jsonl"
        p.write_text(json.dumps(_rec(BASE)) + "\n"
                     + json.dumps(_rec(BASE + 1))[:10])
        watch = art.AnomalyWatch(p, train_steps=10, device=CPU)
        watch.refresh_once()
        assert len(watch._records) == 1
        with open(p, "a") as f:
            f.write(json.dumps(_rec(BASE + 1))[10:] + "\n")
        watch.refresh_once()
        assert len(watch._records) == 2

    def test_truncation_resets(self, tmp_path):
        p = tmp_path / "egress.jsonl"
        p.write_text("".join(json.dumps(_rec(BASE + i)) + "\n"
                             for i in range(30)))
        watch = art.AnomalyWatch(p, train_steps=10, device=CPU)
        watch.refresh_once()
        p.write_text(json.dumps(_rec(BASE + 300)) + "\n")  # rotated
        watch.refresh_once()
        assert len(watch._records) == 1

    def test_score_for_segment_boundaries(self, tmp_path):
        p = tmp_path / "egress.jsonl"
        recs = []
        for agent in ("clawker.p.loop-x-10", "clawker.p.loop-x-1"):
            for i in range(20):
                recs.append(_rec(BASE + i, agent=agent))
        p.write_text("".join(json.dumps(r) + "\n" for r in recs))
        watch = art.AnomalyWatch(p, train_steps=10, device=CPU)
        watch.refresh_once()
        sc = watch.score_for("loop-x-1")
        assert sc is not None and sc.agent == "clawker.p.loop-x-1"
        assert watch.score_for("loop-x-10").agent == "clawker.p.loop-x-10"


class TestDefaultDevice:
    """Without a GPU the default device raises; nothing runs on the CPU
    unless asked."""

    @pytest.fixture(autouse=True)
    def _no_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the default device runs there")

    def test_resolve_device_raises(self):
        assert not art.accelerator_available()
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            art.resolve_device("cuda")
        assert art.resolve_device("cpu") == torch.device("cpu")

    def test_score_windows_default_device_raises(self):
        keys, X = F.featurize(_records())
        K.reset_launches()
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            art.score_windows(X, keys, train_steps=2)
        assert K.LAUNCHES == {K.SCORE: 0, K.FIT_STEP: 0, K.FIT: 0,
                              K.FIT_SHARD: 0, K.FIT_SHARD_PARTIALS: 0,
                              K.FIT_SHARD_REDUCE: 0,
                              K.FIT_MODEL: 0, K.FIT_MODEL_FORWARD: 0,
                              K.FIT_MODEL_PARTIALS: 0, K.FIT_MODEL_REDUCE: 0,
                              K.FIT_MODEL_CARDS: 0}

    def test_watch_reports_the_error_instead_of_scoring(self, tmp_path):
        errors = []
        watch = art.AnomalyWatch(_stream(tmp_path), train_steps=2,
                                 on_error=errors.append)
        assert watch.refresh_once() == 0
        assert len(errors) == 1 and "no CUDA GPU" in errors[0]
        assert watch.scores() == {}
