"""``python -m clawker_tpu_torch fleet anomaly``: twins of the reference
verb's tests (tests/test_sentinel.py::TestFleetAnomalyCLI) on the CPU,
with ``CLAWKER_TORCH_DEVICE=cpu`` and the state dir under ``tmp_path``
(so the host worker's own streams are empty), and one run of both verbs
on the same streams."""

from __future__ import annotations

import json

import torch
from click.testing import CliRunner
from test_torch_fleet_sentinel import BASE, HOT, _benign_fleet_records, _deny_storm
from test_torch_sentinel import injected  # noqa: F401 -- fixture

from clawker_tpu_torch.cli import cli

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

TRAIN_STEPS = 40


def _invoke(tmp_path, *args):
    env = {"CLAWKER_TORCH_DEVICE": "cpu",
           "CLAWKER_TPU_STATE_DIR": str(tmp_path / "state")}
    return CliRunner().invoke(
        cli, ["fleet", "anomaly", "--no-daemon", "--train-steps",
              str(TRAIN_STEPS), *args], env=env, catch_exceptions=False)


def _streams(tmp_path, *, hot=False):
    recs = _benign_fleet_records(agents=4, workers=2)
    w0, w1 = tmp_path / "s0.jsonl", tmp_path / "s1.jsonl"
    with open(w0, "w") as f0, open(w1, "w") as f1:
        for i, r in enumerate(recs):
            (f0 if i % 2 == 0 else f1).write(json.dumps(r) + "\n")
    if hot:
        with open(w1, "a") as f:
            for r in _deny_storm(HOT, BASE + 5 * 60):
                f.write(json.dumps(r) + "\n")
    return ["--stream", f"fake-0={w0}", "--stream", f"fake-1={w1}"]


def test_one_shot_benign_exit_0_renders_fused_workers(tmp_path):
    res = _invoke(tmp_path, *_streams(tmp_path))
    assert res.exit_code == 0, res.output
    assert "AGENT" in res.output and "LATEST-Z" in res.output
    assert "fake-0" in res.output and "fake-1" in res.output


def test_one_shot_exit_2_on_flag(tmp_path):
    res = _invoke(tmp_path, *_streams(tmp_path, hot=True))
    assert res.exit_code == 2, res.output
    assert "ANOMALOUS" in res.output


def test_json_shape(tmp_path):
    res = _invoke(tmp_path, "--format", "json",
                  *_streams(tmp_path, hot=True))
    assert res.exit_code == 2, res.output
    doc = json.loads(res.output)
    assert doc["enabled"] and doc["rows"]
    assert set(doc) == {"enabled", "run", "ticks", "collector_alive",
                        "threshold", "baseline_samples", "stream_counts",
                        "rows", "flags"}
    assert any(r["flagged"] for r in doc["rows"])
    assert doc["flags"][0]["kind"] == "egress"
    assert doc["flags"][0]["agent"] == HOT


def test_watch_bounded_ticks(tmp_path):
    res = _invoke(tmp_path, "--watch", "--ticks", "2", "--interval", "0.05",
                  *_streams(tmp_path))
    assert res.exit_code == 0, res.output
    assert res.output.count("AGENT") == 2   # re-rendered per tick


def test_no_windows_exit_1(tmp_path):
    res = _invoke(tmp_path)
    assert res.exit_code == 1
    assert "no scorable windows" in res.output


def test_host_worker_streams_are_scored_as_local_0(tmp_path):
    """Without --stream the verb tails the host's worker, ``local-0``:
    its own stream and the shared one under the logs dir."""
    logs = tmp_path / "state" / "logs"
    logs.mkdir(parents=True)
    recs = _benign_fleet_records(agents=4, workers=2)
    for name, part in (("ebpf-egress-local-0.jsonl", recs[0::2]),
                       ("ebpf-egress.jsonl", recs[1::2])):
        (logs / name).write_text("".join(json.dumps(r) + "\n" for r in part))
    res = _invoke(tmp_path, "--format", "json")
    assert res.exit_code == 0, res.output
    doc = json.loads(res.output)
    assert len(doc["rows"]) == 4
    assert doc["stream_counts"] == {"fake-0": len(recs) // 2,
                                    "fake-1": len(recs) // 2}
    # untagged records take the source's worker id
    (logs / "ebpf-egress-local-0.jsonl").unlink()
    (logs / "ebpf-egress.jsonl").write_text("".join(
        json.dumps({k: v for k, v in r.items() if k != "worker"}) + "\n"
        for r in recs))
    doc = json.loads(_invoke(tmp_path, "--format", "json").output)
    assert doc["stream_counts"] == {"local-0": len(recs)}
    assert {r["worker"] for r in doc["rows"]} == {"local-0"}


def test_port_and_reference_verbs_agree_on_the_same_streams(tmp_path,
                                                            injected):
    from clawker_tpu.cli.factory import Factory
    from clawker_tpu.cli.root import cli as ref_cli
    from clawker_tpu.engine.drivers import FakeDriver
    from clawker_tpu.testenv import TestEnv

    streams = _streams(tmp_path, hot=True)
    args = ["--format", "json", *streams]
    res = _invoke(tmp_path, *args)
    with TestEnv() as tenv:
        proj = tenv.base / "proj"
        tenv.make_project(proj, "project: sentcli\n")
        factory = Factory(cwd=proj, driver=FakeDriver(n_workers=2))
        want = CliRunner().invoke(
            ref_cli, ["fleet", "anomaly", "--no-daemon", "--train-steps",
                      str(TRAIN_STEPS), *args],
            obj=factory, catch_exceptions=False)
    assert res.exit_code == want.exit_code == 2, (res.output, want.output)
    doc, ref_doc = json.loads(res.output), json.loads(want.output)
    assert {(f["agent"], f["worker"], f["kind"]) for f in doc["flags"]} == \
           {(f["agent"], f["worker"], f["kind"]) for f in ref_doc["flags"]} \
           == {(HOT, "fake-1", "egress")}
    assert [r["agent"] for r in doc["rows"]] == \
           [r["agent"] for r in ref_doc["rows"]]
