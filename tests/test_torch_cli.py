"""``python -m clawker_tpu_torch monitor anomalies``: twins of the
reference verb's tests (tests/test_analytics_lane.py::TestAnomaliesVerb)
on the CPU, with ``CLAWKER_TORCH_DEVICE=cpu``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from click.testing import CliRunner

from clawker_tpu_torch.cli import cli

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

BASE = 1_700_000_000 - 1_700_000_000 % 60  # window-aligned
ROOT = Path(__file__).resolve().parents[1]


def _rec(ts, agent="clawker.loop-0"):
    return {"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
            "service": "ebpf-egress", "container": agent,
            "dst_ip": "198.51.100.9", "dst_port": 443, "proto": 6,
            "verdict": "ALLOW", "reason": "ROUTE", "zone": "example.com"}


def _stream(path: Path) -> Path:
    recs = [_rec(BASE + i * 3, agent=f"clawker.loop-{a}")
            for a in range(3) for i in range(40)]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return path


def _invoke(*args, device="cpu", env=None):
    env = dict(env or {})
    if device is not None:
        env["CLAWKER_TORCH_DEVICE"] = device
    return CliRunner().invoke(
        cli, ["monitor", "anomalies", "--train-steps", "30", *args], env=env)


def test_table_output(tmp_path):
    res = _invoke("--input", str(_stream(tmp_path / "egress.jsonl")))
    assert res.exit_code == 0, res.output
    assert "AGENT" in res.output and "clawker.loop-0" in res.output
    assert "windows scored on cpu" in res.output


def test_json_output(tmp_path):
    res = _invoke("--input", str(_stream(tmp_path / "egress.jsonl")),
                  "--format", "json")
    assert res.exit_code == 0, res.output
    doc = json.loads(res.output)
    assert doc["windows"] > 0 and len(doc["agents"]) == 3
    assert all("latest_z" in a for a in doc["agents"])
    assert doc["device"] == "cpu" and doc["train_steps"] == 30


def test_top_limits_rows(tmp_path):
    res = _invoke("--input", str(_stream(tmp_path / "egress.jsonl")),
                  "--format", "json", "--top", "1")
    assert res.exit_code == 0, res.output
    assert len(json.loads(res.output)["agents"]) == 1


def test_missing_stream_exits_1(tmp_path):
    res = _invoke("--input", str(tmp_path / "nope.jsonl"))
    assert res.exit_code == 1
    assert "no scorable egress windows" in res.output


def test_threshold_exit_code(tmp_path):
    # threshold below every score -> exit 2 (anomaly found)
    res = _invoke("--input", str(_stream(tmp_path / "egress.jsonl")),
                  "--threshold", "-999")
    assert res.exit_code == 2


def test_default_input_is_the_state_logs_stream(tmp_path):
    logs = tmp_path / "state" / "logs"
    logs.mkdir(parents=True)
    _stream(logs / "ebpf-egress.jsonl")
    res = _invoke("--format", "json",
                  env={"CLAWKER_TPU_STATE_DIR": str(tmp_path / "state")})
    assert res.exit_code == 0, res.output
    assert len(json.loads(res.output)["agents"]) == 3


def test_default_device_without_gpu_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    res = _invoke("--input", str(_stream(tmp_path / "egress.jsonl")),
                  device=None, env={"CLAWKER_TORCH_DEVICE": ""})
    assert res.exit_code == 1
    assert "no CUDA GPU" in res.output and "CLAWKER_TORCH_DEVICE" in res.output


def test_module_entry_point_runs(tmp_path):
    stream = _stream(tmp_path / "egress.jsonl")
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "monitor", "anomalies",
         "--input", str(stream), "--train-steps", "5", "--format", "json",
         "--threshold", "-999"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CLAWKER_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1"))
    assert proc.returncode == 2, proc.stderr
    assert json.loads(proc.stdout)["device"] == "cpu"
