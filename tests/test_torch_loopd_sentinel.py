"""The port's daemon-lifetime sentinel against the reference's.

The reference's ``LoopdServer`` with its JAX ``FleetSentinel`` and the
port's with its PyTorch one (``CLAWKER_TORCH_DEVICE=cpu``) host the same
8-agent run over 4 fake workers, with the same egress streams (a deny
storm on one agent) written beforehand under each daemon's logs dir.
Both fits draw the same numpy params and noise (the ``injected``
fixture), both sentinels' behaviour trackers read one fixed clock, and
both runs take one fixed run id, so the bus tap folds the same run
events into the same windows.  After the run each daemon's sentinel
scores synchronously (its own thread ticks every 999 s), and the status
RPC's sentinel rows, z and flags must agree at the live sentinel's twin
tolerances (tests/test_torch_fleet_sentinel.py): ``latest_z`` / ``peak_z`` and flag z within ``ROW_Z_ATOL``
(0.06: the raw scores' rtol 5e-3 scaled by the MAD, plus the rows'
rounding), windows, workers, record counts and flag kinds exactly.
``fleet anomaly`` renders the daemon's rows on both sides and exits 2.

Without a GPU, a daemon whose sentinel would score on ``cuda`` refuses
to start with a named ``LoopdError`` and leaves nothing behind; the
forked ``loopd start`` exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import logging
from pathlib import Path

import pytest
import torch
from click.testing import CliRunner

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.util.ids as ref_ids
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.util.ids as port_ids
from clawker_tpu_torch.kernels import anomaly as K
from test_torch_fleet_sentinel import ROW_Z_ATOL, _deny_storm, _rec
from test_torch_loopd import (IMAGE, PKGS, PROJECT, _time_limit,  # noqa: F401
                              driver_with, run_to_done, side, wait_for)
from test_torch_sentinel import BASE, TRAIN_STEPS, injected  # noqa: F401

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

RUN_ID = "daemonrun001"
AGENTS, WORKERS, WINDOWS, PER_WINDOW = 8, 4, 6, 12
CLOCK = BASE + 5 * 60 + 30      # the behaviour tracker's fixed "now": the
#                                 last egress window
SENTINEL = (f"sentinel:\n  enable: true\n  interval_s: 999\n"
            f"  train_steps: {TRAIN_STEPS}\n")
IDS = {"ref": ref_ids, "port": port_ids}


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")


def _egress(hot_slot: int) -> dict[str, list[dict]]:
    """worker id -> the records of the loops placed there (spread: agent
    i on fake-(i % 4)), plus a deny storm on the hot agent's worker."""
    agents = [f"loop-{RUN_ID[:6]}-{i}" for i in range(AGENTS)]
    out: dict[str, list[dict]] = {f"fake-{w}": [] for w in range(WORKERS)}
    for a, agent in enumerate(agents):
        wid = f"fake-{a % WORKERS}"
        for w in range(WINDOWS):
            for i in range(PER_WINDOW):
                out[wid].append(_rec(BASE + w * 60 + i * 3,
                                     agent=f"clawker.{PROJECT}.{agent}",
                                     worker=wid,
                                     ip=f"198.51.100.{a * 20 + i}"))
    hot_wid = f"fake-{hot_slot % WORKERS}"
    storm = _deny_storm(f"clawker.{PROJECT}.{agents[hot_slot]}",
                        BASE + 5 * 60)
    for r in storm:
        r["worker"] = hot_wid
    out[hot_wid] += storm
    return out


@contextlib.contextmanager
def _fixed_run_id(s):
    """The daemon names its next run ``RUN_ID``, as both twins must."""
    ids = IDS[s.pkg]
    create = s.m.server.LoopdServer._create_run

    def fixed(self, spec, ident, *, keep):
        real = ids.short_id
        ids.short_id = lambda *a, **k: RUN_ID
        try:
            return create(self, spec, ident, keep=keep)
        finally:
            ids.short_id = real

    s.m.server.LoopdServer._create_run = fixed
    try:
        yield
    finally:
        s.m.server.LoopdServer._create_run = create


def run_daemon(s, hot_slot: int) -> dict:
    """One package's daemon: egress written, run hosted, two synchronous
    sentinel ticks, then the status RPC and ``fleet anomaly``."""
    for wid, recs in _egress(hot_slot).items():
        path = s.cfg.logs_dir / f"ebpf-egress-{wid}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    drv = driver_with(s.m, WORKERS)
    srv = s.m.server.LoopdServer(s.cfg, drv).start()
    try:
        srv.sentinel.behavior.clock = lambda: CLOCK
        client = s.m.client.discover(s.cfg)
        with _fixed_run_id(s):
            ack, final = run_to_done(client, {"parallel": AGENTS,
                                              "iterations": 2})
        client.close()
        scored = [srv.sentinel.refresh_once() for _ in range(2)]
        errors = srv.sentinel.last_error
        client = s.m.client.discover(s.cfg)
        doc = client.status()
        client.close()
        if s.pkg == "ref":
            res = CliRunner().invoke(
                ref_root.cli, ["fleet", "anomaly", "--format", "json"],
                obj=ref_factory.Factory(cwd=s.proj, driver=drv))
        else:
            res = CliRunner().invoke(
                port_cli.cli, ["fleet", "anomaly", "--format", "json"],
                obj=port_cli.Factory(cwd=s.proj, driver=drv))
        flight = (srv.flight.path.read_text().splitlines()
                  if srv.flight is not None else [])
    finally:
        srv.stop()
    return {"run": ack["run"], "ok": final["ok"], "scored": scored,
            "errors": errors, "sentinel": doc["sentinel"], "cli": res,
            "flight": [json.loads(line) for line in flight]}


def _rows_agree(got: list[dict], want: list[dict]) -> None:
    keep = ("agent", "worker", "windows", "flagged", "stream_records")
    assert [{k: r[k] for k in keep} for r in got] == \
        [{k: r[k] for k in keep} for r in want]
    for r, w in zip(got, want):
        assert r["latest_z"] == pytest.approx(w["latest_z"], abs=ROW_Z_ATOL)
        assert r["peak_z"] == pytest.approx(w["peak_z"], abs=ROW_Z_ATOL)


@pytest.mark.parametrize("hot_slot", [1, 6])
def test_daemon_sentinel_rows_and_flags_match_reference(tmp_path, injected,
                                                        cpu, hot_slot):
    results = {}
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, SENTINEL, proxy=False) as s:
            results[pkg] = run_daemon(s, hot_slot)
    want, got = results["ref"], results["port"]
    assert got["run"] == want["run"] == RUN_ID
    assert got["ok"] and want["ok"]
    assert got["errors"] == want["errors"] == ""
    # the first tick scores the streams and the run's events; the second
    # has no news and is idle
    assert got["scored"] == want["scored"] and got["scored"][0] > 0
    assert got["scored"][1] == 0
    sent, ref_sent = got["sentinel"], want["sentinel"]
    assert sent["enabled"] and sent["ticks"] == ref_sent["ticks"]
    assert sent["stream_counts"] == ref_sent["stream_counts"]
    _rows_agree(sent["rows"], ref_sent["rows"])
    flags = sorted((f["agent"], f["worker"], f["kind"]) for f in sent["flags"])
    assert flags == sorted((f["agent"], f["worker"], f["kind"])
                           for f in ref_sent["flags"])
    zs = {f["agent"]: f["z"] for f in ref_sent["flags"]}
    for f in sent["flags"]:
        assert f["z"] == pytest.approx(zs[f["agent"]], abs=ROW_Z_ATOL)
    hot = f"clawker.{PROJECT}.loop-{RUN_ID[:6]}-{hot_slot}"
    assert hot in {f[0] for f in flags}
    z = {r["agent"]: r["peak_z"] for r in sent["rows"]}
    assert max(z, key=z.get) == hot
    # fleet anomaly renders the daemon's live rows and exits 2 on a flag
    for res in (got["cli"], want["cli"]):
        assert res.exit_code == 2, res.output
    doc, ref_doc = (json.loads(r.stdout) for r in (got["cli"], want["cli"]))
    assert doc["source"].startswith("loopd:")
    assert ref_doc["source"].startswith("loopd:")
    _rows_agree(doc["rows"], ref_doc["rows"])
    # the port's daemon records its scored tick in its flight record
    ticks = [r for r in got["flight"] if r.get("name") == "sentinel.tick"]
    assert len(ticks) == 1 and ticks[0]["attrs"]["device"] == "cpu"


def test_cpu_daemon_sentinel_leaves_launch_counters_at_zero(tmp_path,
                                                            injected, cpu):
    before = dict(K.LAUNCHES)
    with side("port", tmp_path, SENTINEL, proxy=False) as s:
        run_daemon(s, 3)
    assert K.LAUNCHES == before


def test_a_failing_tick_goes_to_the_daemon_log(tmp_path, cpu):
    seen: list[str] = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda rec: seen.append(rec.getMessage())
    with side("port", tmp_path, SENTINEL, proxy=False) as s:
        for wid, recs in _egress(0).items():
            path = s.cfg.logs_dir / f"ebpf-egress-{wid}.jsonl"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        srv = s.m.server.LoopdServer(s.cfg, driver_with(s.m, WORKERS)).start()
        try:
            def broken(*a, **k):
                raise RuntimeError("scorer down")

            srv.sentinel.engine.score_tick = broken
            s.m.server.log.addHandler(handler)
            try:
                assert srv.sentinel.refresh_once() == 0
            finally:
                s.m.server.log.removeHandler(handler)
        finally:
            srv.stop()
    assert seen == ["loopd sentinel tick failed: RuntimeError: scorer down"]


# ------------------------------------------------------------- no GPU


@pytest.mark.parametrize("how", ["keyword", "default"])
def test_sentinel_on_cuda_refuses_to_start_without_a_gpu(tmp_path,
                                                         monkeypatch, how):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the daemon's sentinel scores there")
    monkeypatch.delenv(port_cli.DEVICE_ENV, raising=False)
    with side("port", tmp_path, SENTINEL, proxy=False) as s:
        kw = {"device": "cuda"} if how == "keyword" else {}
        srv = s.m.server.LoopdServer(s.cfg, driver_with(s.m, 1), **kw)
        assert srv.device == "cuda"
        with pytest.raises(s.m.loopd.LoopdError,
                           match="sentinel.*cannot score on 'cuda'.*no CUDA"):
            srv.start()
        assert srv.sentinel is None
        assert not srv.sock_path.exists()
        assert not s.m.loopd.pidfile_path(s.cfg).exists()
        assert s.m.client.discover(s.cfg) is None


def test_forked_loopd_start_exits_nonzero_without_a_gpu(tmp_path,
                                                        monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the daemon's sentinel scores there")
    monkeypatch.delenv(port_cli.DEVICE_ENV, raising=False)
    monkeypatch.setenv("CLAWKER_TPU_DRIVER", "fake")
    monkeypatch.setenv("CLAWKER_TPU_FAKE_IMAGES", IMAGE)
    monkeypatch.setenv("PYTHONPATH", str(Path(__file__).resolve().parents[1]))
    with side("port", tmp_path, SENTINEL, proxy=False) as s:
        res = CliRunner().invoke(port_cli.cli, ["loopd", "start"],
                                 obj=port_cli.Factory(cwd=s.proj))
        assert res.exit_code == 1
        assert "loopd exited during start (rc=1)" in res.output
        log = s.m.loopd.logfile_path(s.cfg).read_text()
        assert "loopd refused to start" in log and "no CUDA GPU" in log
        assert not s.m.loopd.socket_path(s.cfg).exists()
        assert wait_for(lambda: not s.m.loopd.pidfile_path(s.cfg).exists(),
                        1.0)
