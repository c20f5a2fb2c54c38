"""The port's graft entry and ``bench_lane`` against the JAX reference.

``entry`` is held against the reference's ``score`` on the same carried
params and x (tests/test_torch_anomaly.py's score tolerance: the sides
differ in summation order and in tanh, a few ulp).  The reference's
``dryrun_multichip`` is never called here: it pins the platform for the
whole process.  The port's runs on CPU shards (``device="cpu"``); its
steps are held against the reference's sharded steps in
tests/test_torch_shard.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from clawker_tpu.analytics import anomaly as ref
from clawker_tpu.analytics import runtime as ref_art
from clawker_tpu_torch import graft_entry
from clawker_tpu_torch.analytics import anomaly
from clawker_tpu_torch.analytics import mesh as M
from clawker_tpu_torch.analytics import runtime as art
from clawker_tpu_torch.kernels import anomaly as K

from test_torch_runtime import _records

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCORE_RTOL = 1e-4
SCORE_ATOL = 1e-6
CPU = "cpu"


def test_entry_returns_the_score_and_seeded_inputs():
    fn, (params, x) = graft_entry.entry(device=CPU)
    assert fn is anomaly.score
    assert tuple(x.shape) == (256, anomaly.FEATURES)
    assert [tuple(p.shape) for p in params] == [
        (anomaly.FEATURES, anomaly.HIDDEN), (anomaly.HIDDEN,),
        (anomaly.HIDDEN, anomaly.FEATURES), (anomaly.FEATURES,)]
    _, (params2, x2) = graft_entry.entry(device=CPU)
    assert torch.equal(x, x2)
    assert all(torch.equal(p, q) for p, q in zip(params, params2))
    out = fn(params, x)
    assert tuple(out.shape) == (256,) and torch.isfinite(out).all()


def _ref_entry():
    """The reference's ``entry()`` (``__graft_entry__.py:13``) without
    importing the harness module: the same params and x."""
    params = ref.init_params(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (256, ref.FEATURES),
                          np.float32)
    return ref.score, (params, x)


def test_entry_matches_reference_score_on_carried_inputs():
    ref_fn, (ref_params, ref_x) = _ref_entry()
    want = np.asarray(jax.jit(ref_fn)(ref_params, ref_x))
    fn, _ = graft_entry.entry(device=CPU)
    got = fn(anomaly.params_from_numpy(ref_params, device=CPU),
             torch.from_numpy(np.array(ref_x))).numpy()
    assert got.shape == want.shape == (256,)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("n", [1, 6, 8])
def test_dryrun_multichip_runs_on_cpu_shards(n):
    K.reset_launches()
    graft_entry.dryrun_multichip(n, device=CPU)
    assert not any(K.LAUNCHES.values())


def test_dryrun_multichip_steps_are_the_sharded_steps():
    """The dryrun's train step over 8 CPU shards equals the unsharded
    step to fp32 summation order (one shard: the same bits)."""
    mesh = M.virtual_mesh(8, CPU)
    _, (params, _) = graft_entry.entry(device=CPU)
    x = torch.randn((mesh.data * 8, anomaly.FEATURES),
                    generator=torch.Generator().manual_seed(1))
    got, loss = M.train_step(params, x, mesh)
    want, want_loss = anomaly.train_step(params, x)
    for p, q in zip(got, want):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    one, one_loss = M.train_step(params, x, M.virtual_mesh(1, CPU))
    assert all(torch.equal(p, q) for p, q in zip(one, want))
    assert torch.equal(one_loss, want_loss)


def test_bench_lane_returns_the_reference_keys_and_windows():
    records = _records(hot_agent=True)
    want = ref_art.bench_lane(records, train_steps=5, reps=2)
    got = art.bench_lane(records, train_steps=5, reps=2, device=CPU)
    assert set(got) == set(want)
    assert got["windows"] == want["windows"] > 0
    assert got["train_steps"] == want["train_steps"] == 5
    assert got["device"] == "cpu"
    assert got["score_step_us"] > 0 and got["train_ms"] > 0


def test_module_main_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the module runs there")
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch.graft_entry"], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA GPU" in proc.stderr
    assert "entry ok" not in proc.stdout
