"""The port's ``loop`` with its anomaly riders against the reference's.

The reference's ``LoopScheduler`` with a JAX ``FleetSentinel`` (or
``AnomalyWatch``) and the port's with its PyTorch one run the same
8-agent fleet over 4 fake workers, while the same egress streams (a
deny storm on one agent) sit in the run's logs dir.  Both fits draw the
same numpy params and noise (the ``injected`` fixture), and both
sentinels' behaviour trackers read one fixed clock, so the bus tap folds
the run's events into the same windows.  After the run each rider
scores synchronously; the twins must give the same ``anomaly_z`` in
every status row (``ROW_Z_ATOL``), ``anomaly`` scheduler events for the
same agents, equal behaviour snapshots, a zero ``audit()``, and
``sentinel.tick`` spans in each run's flight recorder.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

import clawker_tpu.analytics.runtime as ref_art
import clawker_tpu.sentinel as ref_sentinel
import clawker_tpu_torch.analytics.runtime as art
import clawker_tpu_torch.sentinel as port_sentinel
from clawker_tpu_torch.kernels import anomaly as K
from test_torch_fleet_sentinel import ROW_Z_ATOL, _deny_storm, _rec
from test_torch_loop import PKGS, RUN_ID, _driver, _env
from test_torch_sentinel import BASE, TRAIN_STEPS, injected  # noqa: F401

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

AGENTS, WORKERS, WINDOWS, PER_WINDOW = 8, 4, 6, 12
CLOCK = BASE + 5 * 60 + 30      # the behaviour tracker's fixed "now": the
#                                 last egress window

RIDERS = {
    "ref": dict(sentinel=ref_sentinel.FleetSentinel,
                watch=ref_art.AnomalyWatch, device={},
                anomaly_z=ref_art.ANOMALY_Z),
    "port": dict(sentinel=port_sentinel.FleetSentinel,
                 watch=art.AnomalyWatch, device={"device": "cpu"},
                 anomaly_z=art.ANOMALY_Z),
}


def _egress(agents: list[str], hot: str) -> dict[str, list[dict]]:
    """worker id -> the records of the loops placed there (spread: agent
    i on fake-(i % 4)), plus a deny storm on ``hot``'s worker."""
    out: dict[str, list[dict]] = {f"fake-{w}": [] for w in range(WORKERS)}
    for a, agent in enumerate(agents):
        wid = f"fake-{a % WORKERS}"
        for w in range(WINDOWS):
            for i in range(PER_WINDOW):
                out[wid].append(_rec(BASE + w * 60 + i * 3,
                                     agent=f"clawker.twin.{agent}",
                                     worker=wid,
                                     ip=f"198.51.100.{a * 20 + i}"))
    hot_wid = f"fake-{agents.index(hot) % WORKERS}"
    storm = _deny_storm(f"clawker.twin.{hot}", BASE + 5 * 60)
    for r in storm:
        r["worker"] = hot_wid
    out[hot_wid] += storm
    return out


def _write(path, recs):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _snapshot(tracker) -> dict:
    return {agent: {start: dataclasses.asdict(w) for start, w in ws.items()}
            for agent, ws in tracker.snapshot().items()}


def run_with_rider(pkg: str, tmp_path, *, rider: str, hot_slot: int,
                   ticks: int = 2, pod=None) -> dict:
    """One package's run with its rider.  ``pod(pkg, cfg, driver, tenv)``
    -> (workerd servers, executor set) puts the run over workerd; both
    are torn down with the run."""
    m, r = PKGS[pkg], RIDERS[pkg]
    tenv, proj = _env(tmp_path, pkg)
    servers, execset = [], None
    try:
        cfg = m.load_config(proj)
        drv = _driver(m, WORKERS)
        if pod is not None:
            servers, execset = pod(pkg, cfg, drv, tenv)
        events: list = []
        sched = m.loop.LoopScheduler(
            cfg, drv, m.loop.LoopSpec(parallel=AGENTS, iterations=2),
            on_event=lambda a, e, d="": events.append((a, e, d)),
            run_id=RUN_ID, executors=execset)
        agents = [sched._agent_name(i) for i in range(AGENTS)]
        streams = _egress(agents, agents[hot_slot])
        if rider == "sentinel":
            for wid, recs in streams.items():
                _write(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
            watch = r["sentinel"](cfg, drv, run_id=sched.loop_id,
                                  interval_s=999, train_steps=TRAIN_STEPS,
                                  **r["device"])
            watch.behavior.clock = lambda: CLOCK
            sched.attach_sentinel(watch)
            assert watch.flight is sched.flight
        else:
            _write(cfg.logs_dir / "ebpf-egress.jsonl",
                   [x for recs in streams.values() for x in recs])
            watch = r["watch"](cfg.logs_dir / "ebpf-egress.jsonl",
                               train_steps=30, **r["device"])
            sched.attach_anomaly_watch(watch)
        sched.start()
        sched.run(poll_s=0.02)
        scored = [watch.refresh_once() for _ in range(ticks)]
        sched.events.flush()
        out = {
            "agents": agents, "scored": scored, "status": sched.status(),
            "flagged": sorted({a for a, e, _ in events if e == "anomaly"}),
            "errors": [d for a, e, d in events
                       if e == "anomaly_watch_error"],
            "anomaly_z": r["anomaly_z"],
        }
        if rider == "sentinel":
            out["snapshot"] = _snapshot(watch.behavior)
            out["audit"] = watch.audit()
            out["flags"] = sorted((f["agent"], f["worker"], f["kind"])
                                  for f in watch.flags())
        watch.stop()
        sched.cleanup(remove_containers=True)
        if rider == "sentinel":
            spans = m.telemetry.load_spans(
                sched.flight.path.read_text().splitlines())
            out["tick_spans"] = sum(1 for s in spans
                                    if s.name == "sentinel.tick")
        return out
    finally:
        if execset is not None:
            execset.close_all()
        for srv in servers:
            srv.stop()
        tenv.__exit__(None, None, None)


def _assert_rows_agree(got: dict, want: dict) -> None:
    assert [{k: v for k, v in row.items() if k != "anomaly_z"}
            for row in got["status"]] == \
        [{k: v for k, v in row.items() if k != "anomaly_z"}
         for row in want["status"]]
    for row, ref_row in zip(got["status"], want["status"]):
        assert "anomaly_z" in row and "anomaly_z" in ref_row, row
        assert row["anomaly_z"] == pytest.approx(ref_row["anomaly_z"],
                                                 abs=ROW_Z_ATOL)


@pytest.mark.parametrize("hot_slot", [1, 6])
def test_loop_with_sentinel_matches_reference(tmp_path, injected, hot_slot):
    want = run_with_rider("ref", tmp_path, rider="sentinel",
                          hot_slot=hot_slot)
    got = run_with_rider("port", tmp_path, rider="sentinel",
                         hot_slot=hot_slot)
    hot = got["agents"][hot_slot]
    assert got["errors"] == want["errors"] == []
    assert got["scored"] == want["scored"] and got["scored"][0] > 0
    _assert_rows_agree(got, want)
    # the storm agent flags, on both sides, and scores hottest
    assert got["flagged"] == want["flagged"]
    assert hot in got["flagged"]
    assert got["flags"] == want["flags"]
    z = {row["agent"]: row["anomaly_z"] for row in got["status"]}
    assert max(z, key=z.get) == hot
    # the bus tap fed the behaviour tracker the same run events
    assert got["snapshot"] == want["snapshot"]
    assert set(got["snapshot"]) == set(got["agents"])
    assert all(v == 0 for v in got["audit"].values())
    assert got["audit"] == want["audit"]
    # one span per scored tick; the second tick has no news and is idle
    assert got["tick_spans"] == want["tick_spans"] == 1
    assert got["scored"][1] == 0


def test_loop_with_anomaly_watch_matches_reference(tmp_path, injected):
    want = run_with_rider("ref", tmp_path, rider="watch", hot_slot=3,
                          ticks=1)
    got = run_with_rider("port", tmp_path, rider="watch", hot_slot=3,
                         ticks=1)
    assert got["errors"] == want["errors"] == []
    assert got["scored"] == want["scored"] and got["scored"][0] > 0
    _assert_rows_agree(got, want)
    assert got["flagged"] == want["flagged"]
    hot = got["agents"][3]
    z = {row["agent"]: row["anomaly_z"] for row in got["status"]}
    assert max(z, key=z.get) == hot
    assert (hot in got["flagged"]) == (z[hot] >= got["anomaly_z"])


def test_cpu_loop_riders_leave_launch_counters_at_zero(tmp_path, injected):
    before = dict(K.LAUNCHES)
    run_with_rider("port", tmp_path, rider="sentinel", hot_slot=2, ticks=1)
    run_with_rider("port", tmp_path / "w", rider="watch", hot_slot=2,
                   ticks=1)
    assert K.LAUNCHES == before


def test_gpu_rider_without_a_gpu_reports_through_the_scheduler(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the rider scores there")
    m = PKGS["port"]
    tenv, proj = _env(tmp_path, "port")
    try:
        cfg = m.load_config(proj)
        drv = _driver(m, 2)
        events: list = []
        sched = m.loop.LoopScheduler(
            cfg, drv, m.loop.LoopSpec(parallel=2, iterations=1),
            on_event=lambda a, e, d="": events.append((a, e, d)),
            run_id=RUN_ID)
        agents = [sched._agent_name(i) for i in range(2)]
        for wid, recs in _egress(agents, agents[0]).items():
            _write(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
        sentinel = port_sentinel.FleetSentinel(cfg, drv, run_id=sched.loop_id,
                                               interval_s=999,
                                               train_steps=TRAIN_STEPS)
        sched.attach_sentinel(sentinel)
        sched.start()
        sched.run(poll_s=0.02)
        assert sentinel.refresh_once() == 0
        sched.events.flush()
        sentinel.stop()
        sched.cleanup(remove_containers=True)
    finally:
        tenv.__exit__(None, None, None)
    errors = [d for a, e, d in events if e == "anomaly_watch_error"]
    assert len(errors) == 1 and "no CUDA GPU" in errors[0]
    assert all("anomaly_z" not in row for row in sched.status())
