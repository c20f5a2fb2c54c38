"""The port stands alone: no JAX, nothing of clawker_tpu, no CPU fallback.

tests/conftest.py imports jax into every test process, so the import
checks run in a fresh interpreter with ``sys.modules["jax"] = None``
(any ``import jax`` then raises).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "clawker_tpu_torch"
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run_isolated(code: str) -> dict:
    prelude = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", prelude + code], cwd=ROOT,
                          env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _modules() -> list[str]:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_and_chip_smoke_import_without_jax_or_reference():
    mods = _modules()
    assert "clawker_tpu_torch.kernels.anomaly" in mods
    doc = _run_isolated(
        "import importlib, json\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from clawker_tpu_torch.kernels import build\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "                and (m == 'jax' or m.startswith('jax.')\n"
        "                     or m == 'clawker_tpu' or m.startswith('clawker_tpu.')))\n"
        "print(json.dumps({'leaked': leaked, 'built': sorted(build._libs),\n"
        "                  'loaded': len([m for m in sys.modules\n"
        "                                 if m.startswith('clawker_tpu_torch')])}))\n")
    assert doc["leaked"] == []
    assert doc["built"] == []          # importing builds nothing
    assert doc["loaded"] >= len(mods)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax_and_no_reference_package(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+clawker_tpu(\.|\s|$)", text,
                         re.M)


def test_default_device_raises_instead_of_running_on_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    doc = _run_isolated(
        "import json\n"
        "import numpy as np\n"
        "from clawker_tpu_torch.analytics import runtime as art\n"
        "from clawker_tpu_torch.analytics import features as F\n"
        "from clawker_tpu_torch.kernels import anomaly as K\n"
        "from clawker_tpu_torch.sentinel import FleetSentinel, ScoringEngine\n"
        "from clawker_tpu_torch.sentinel import StreamCollector\n"
        "keys = [F.WindowKey('a', 0), F.WindowKey('b', 0)]\n"
        "X = np.ones((2, 32), np.float32)\n"
        "raised = {}\n"
        "for name, call in {\n"
        "    'score_windows': lambda: art.score_windows(X, keys, train_steps=2),\n"
        "    'score_tick': lambda: ScoringEngine(train_steps=2).score_tick(\n"
        "        keys, np.ones((2, 40), np.float32), {}),\n"
        "    'resolve_device': lambda: art.resolve_device('cuda'),\n"
        "}.items():\n"
        "    try:\n"
        "        call()\n"
        "        raised[name] = None\n"
        "    except RuntimeError as e:\n"
        "        raised[name] = str(e)\n"
        # the sentinel's tick must not raise: the failure reaches on_error
        f"stream = {str(tmp_path / 'egress.jsonl')!r}\n"
        "with open(stream, 'w') as f:\n"
        "    for i in range(20):\n"
        "        f.write(json.dumps({'@timestamp': '2023-11-14T22:13:%02dZ' % i,\n"
        "                            'container': 'a', 'verdict': 'ALLOW'}) + '\\n')\n"
        "col = StreamCollector()\n"
        "col.add_local('w', stream)\n"
        "errors = []\n"
        "s = FleetSentinel(None, train_steps=2, collector=col,\n"
        "                  on_error=errors.append)\n"
        "scored = s.refresh_once()\n"
        "raised['refresh_once'] = errors[0] if scored == 0 and errors else None\n"
        "print(json.dumps({'raised': raised, 'launches': K.LAUNCHES}))\n")
    assert all(msg and "no CUDA GPU" in msg for msg in doc["raised"].values())
    assert set(doc["raised"]) == {"score_windows", "score_tick",
                                  "resolve_device", "refresh_once"}
    assert doc["launches"] == {"anomaly_score": 0, "anomaly_fit_step": 0,
                               "anomaly_fit": 0, "anomaly_fit_shard_fit": 0,
                               "anomaly_fit_shard_partials": 0,
                               "anomaly_fit_shard_reduce": 0}


@pytest.mark.parametrize("module", ["clawker_tpu_torch.graft_entry",
                                    "clawker_tpu_torch.analytics.mesh"])
def test_mesh_and_graft_entry_import_alone_without_jax(module):
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "from clawker_tpu_torch.kernels import build\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "                and (m in ('jax', 'clawker_tpu')\n"
        "                     or m.startswith(('jax.', 'clawker_tpu.'))))\n"
        "print(json.dumps({'leaked': leaked, 'built': sorted(build._libs)}))\n")
    assert doc == {"leaked": [], "built": []}


def test_graft_entry_and_bench_lane_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    doc = _run_isolated(
        "import json\n"
        "from chip_smoke import synth_egress_records\n"
        "from clawker_tpu_torch import graft_entry\n"
        "from clawker_tpu_torch.analytics import mesh as M\n"
        "from clawker_tpu_torch.analytics import runtime as art\n"
        "from clawker_tpu_torch.kernels import anomaly as K\n"
        "recs = synth_egress_records(agents=2, windows=2, per_window=4)\n"
        "raised = {}\n"
        "for name, call in {\n"
        "    'entry': graft_entry.entry,\n"
        "    'dryrun_multichip': lambda: graft_entry.dryrun_multichip(8),\n"
        "    'bench_lane': lambda: art.bench_lane(recs, train_steps=2, reps=1),\n"
        "    'fleet_mesh': M.fleet_mesh,\n"
        "    'virtual_mesh': lambda: M.virtual_mesh(4),\n"
        "}.items():\n"
        "    try:\n"
        "        call()\n"
        "        raised[name] = None\n"
        "    except RuntimeError as e:\n"
        "        raised[name] = str(e)\n"
        "ran = {'entry': graft_entry.entry(device='cpu')[1][1].shape[0],\n"
        "       'dryrun_multichip': graft_entry.dryrun_multichip(8, device='cpu'),\n"
        "       'bench_lane': art.bench_lane(recs, train_steps=2, reps=1,\n"
        "                                    device='cpu')['device']}\n"
        "print(json.dumps({'raised': raised, 'ran': ran,\n"
        "                  'launches': K.LAUNCHES}))\n")
    assert set(doc["raised"]) == {"entry", "dryrun_multichip", "bench_lane",
                                  "fleet_mesh", "virtual_mesh"}
    assert all(msg and "no CUDA GPU" in msg for msg in doc["raised"].values())
    assert doc["ran"] == {"entry": 256, "dryrun_multichip": None,
                          "bench_lane": "cpu"}
    assert not any(doc["launches"].values())


def test_fleet_anomaly_without_a_gpu_exits_1_and_names_the_cpu_device(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    env = {k: v for k, v in ENV.items() if k != "CLAWKER_TORCH_DEVICE"}
    env["CLAWKER_TPU_STATE_DIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "fleet", "anomaly",
         "--no-daemon"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1
    assert "no CUDA GPU" in proc.stderr
    assert "CLAWKER_TORCH_DEVICE=cpu" in proc.stderr
    assert proc.stdout == ""


def test_cpu_tensor_calls_leave_launch_counters_at_zero():
    doc = _run_isolated(
        "import json\n"
        "import torch\n"
        "from clawker_tpu_torch.analytics import anomaly\n"
        "from clawker_tpu_torch.analytics import runtime as art\n"
        "from clawker_tpu_torch.kernels import anomaly as K\n"
        "from clawker_tpu_torch.kernels import build\n"
        "g = torch.Generator().manual_seed(0)\n"
        "p = anomaly.init_params(g, feat=40)\n"
        "x = torch.randn((256, 40), generator=g)\n"
        "anomaly.score(p, x)\n"
        "anomaly.train_step(p, x)\n"
        "anomaly.denoise_step(p, x, g)\n"
        "art._fit(p, x, torch.randn((3, 256, 40), generator=g), 1e-2)\n"
        "K.fit_(p, x, torch.randn((2, 256, 40), generator=g), lr=1e-2,\n"
        "       sigma=0.25, losses_out=torch.empty(2))\n"
        "print(json.dumps({'launches': K.LAUNCHES, 'built': sorted(build._libs)}))\n")
    assert doc == {"launches": {"anomaly_score": 0, "anomaly_fit_step": 0,
                                "anomaly_fit": 0, "anomaly_fit_shard_fit": 0,
                                "anomaly_fit_shard_partials": 0,
                                "anomaly_fit_shard_reduce": 0},
                   "built": []}


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_sources_are_sm90a_cuda_with_plain_c_entry_points():
    from clawker_tpu_torch.kernels import build

    assert "arch=compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    for source in build.SOURCES:
        src = (build.CSRC / f"{source}.cu").read_text()
        assert "__global__" in src and "Replaces:" in src
        assert not re.search(r"cublas|torch/", src)
        for name in build.entry_points(source):
            assert f'extern "C" int {name}(' in src
            assert len(build.SIGNATURES[name]) == len(
                re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
                .split(","))
