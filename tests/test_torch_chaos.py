"""The port's chaos plans, crash seams, invariants and soak runner against
the reference's.

Twins of tests/test_chaos.py and tests/test_workerd.py:481-535 (the
observe-only twin check, tests/test_sentinel.py:362, is held in
tests/test_torch_fleet_sentinel.py; the gitguard rider in
tests/test_torch_gitguard.py).  Each twin feeds both packages the same
inputs and compares only what is deterministic: generated plans and
their JSON, the ``_validate`` refusals, the seams a healthy fleet fires
and the journal prefix an armed kill leaves, the violation strings of
the doctored runs, ``scheduling_outcome`` of the twin fleet, and the
verdict of each live scenario.  The port's sentinel scores with
``device="cpu"``; the reference's on JAX's CPU backend.

Every live scenario runs under a ``TestEnv`` whose settings turn the
host proxy off and set the soft disk watermark below any real disk, as
the other twins do: on a nearly full disk the scheduler sheds its flight
spans (the pressure ladder) while workerd's recorders keep theirs, and
the span audits then read the shedding, not the run.  That case has its
own twin (``test_shedding_makes_workerd_segments_bare_roots_in_both``).

A live scenario's kill count depends on when its seams fire, so only the
verdicts and the kill/generation pairing are compared, except where an
armed seam cannot miss (``at_s=0.0`` on a seam every run reaches).
"""

from __future__ import annotations

import contextlib
import json
import time
from types import SimpleNamespace

import pytest
import torch
from hypothesis import HealthCheck, given
from hypothesis import settings as hsettings
from hypothesis import strategies as st

import clawker_tpu.capacity as ref_capacity
import clawker_tpu.chaos.invariants as ref_inv
import clawker_tpu.chaos.plan as ref_plan
import clawker_tpu.chaos.runner as ref_runner
import clawker_tpu.chaos.seams as ref_seams
import clawker_tpu.config as ref_config
import clawker_tpu.config.schema as ref_schema
import clawker_tpu.consts as ref_consts
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.loop as ref_loop
import clawker_tpu.loop.journal as ref_journal
import clawker_tpu.loopd.client as ref_client
import clawker_tpu.loopd.server as ref_server
import clawker_tpu.monitor.events as ref_events
import clawker_tpu.monitor.shipper as ref_shipper
import clawker_tpu.placement as ref_placement
import clawker_tpu.runtime.names as ref_names
import clawker_tpu.telemetry as ref_telemetry
import clawker_tpu.testenv as ref_testenv
import clawker_tpu_torch.capacity as port_capacity
import clawker_tpu_torch.chaos.invariants as port_inv
import clawker_tpu_torch.chaos.plan as port_plan
import clawker_tpu_torch.chaos.runner as port_runner
import clawker_tpu_torch.chaos.seams as port_seams
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.loop.journal as port_journal
import clawker_tpu_torch.loopd.client as port_client
import clawker_tpu_torch.loopd.server as port_server
import clawker_tpu_torch.monitor.events as port_events
import clawker_tpu_torch.monitor.shipper as port_shipper
import clawker_tpu_torch.placement as port_placement
import clawker_tpu_torch.runtime.names as port_names
import clawker_tpu_torch.telemetry as port_telemetry
import clawker_tpu_torch.testenv as port_testenv

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

PROJECT = "chaosproj"
IMAGE = f"clawker-{PROJECT}:default"
RUN_ID = "chaostwin001"
SEED = 20260803
# the host proxy is off and the soft watermark sits below any real disk
# (the module docstring says why)
SETTINGS = """host_proxy:
  enable: false
loop:
  storage_pressure:
    soft_free_pct: 0.001
    hard_free_pct: 0.0005
"""
SHED_SETTINGS = """host_proxy:
  enable: false
loop:
  storage_pressure:
    soft_free_pct: 100.0
    hard_free_pct: 0.0005
"""

PKGS = {
    "ref": SimpleNamespace(
        name="ref", plan=ref_plan, inv=ref_inv, runner=ref_runner,
        seams=ref_seams, config=ref_config, schema=ref_schema,
        consts=ref_consts, drivers=ref_drivers, fake=ref_fake,
        errors=ref_errors, loop=ref_loop, journal=ref_journal,
        names=ref_names, testenv=ref_testenv, capacity=ref_capacity,
        shipper=ref_shipper, events=ref_events, telemetry=ref_telemetry,
        placement=ref_placement, server=ref_server, client=ref_client),
    "port": SimpleNamespace(
        name="port", plan=port_plan, inv=port_inv, runner=port_runner,
        seams=port_seams, config=port_config, schema=port_schema,
        consts=port_consts, drivers=port_drivers, fake=port_fake,
        errors=port_errors, loop=port_loop, journal=port_journal,
        names=port_names, testenv=port_testenv, capacity=port_capacity,
        shipper=port_shipper, events=port_events, telemetry=port_telemetry,
        placement=port_placement, server=port_server, client=port_client),
}


@contextlib.contextmanager
def side(pkg: str, tmp_path, settings: str = SETTINGS):
    """One package's isolated environment: its own ``TestEnv`` (the
    port's copy for the port) under ``tmp_path/pkg``, a project named
    ``chaosproj``, and its config."""
    m = PKGS[pkg]
    tenv = m.testenv.TestEnv(base=tmp_path / pkg)
    with tenv:
        tenv.write_settings(settings)
        proj = tenv.base / "proj"
        proj.mkdir(exist_ok=True)
        (proj / m.consts.PROJECT_FLAT_FORM).write_text(
            f"project: {PROJECT}\n")
        yield SimpleNamespace(m=m, tenv=tenv, proj=proj,
                              cfg=m.config.load_config(proj))


def twin(tmp_path, scenario, settings: str = SETTINGS):
    """``scenario(s)`` on the reference, then on the port."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, settings) as s:
            out.append(scenario(s))
    return out[0], out[1]


def device_kw(m) -> dict:
    """The port's sentinel scores on the CPU here; the reference's has
    no device argument."""
    return {"device": "cpu"} if m.name == "port" else {}


def driver_with(m, n_workers: int, behavior=None):
    drv = m.drivers.FakeDriver(n_workers=n_workers)
    for api in drv.apis:
        api.add_image(IMAGE)
        api.set_behavior(IMAGE, behavior or m.fake.exit_behavior(b"", 0))
    return drv


def wait_for(pred, timeout=10.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def names(violations) -> list[str]:
    """The invariant names a violation list carries."""
    return sorted({v.split(":", 1)[0] for v in violations})


def run_plan_twin(tmp_path, make_plan, settings: str = SETTINGS):
    """One hand-written plan through each package's ``ChaosRunner``."""
    def scenario(s):
        runner = s.m.runner.ChaosRunner(s.cfg, make_plan(s.m),
                                        **device_kw(s.m))
        return runner, runner.run_scenario()

    return twin(tmp_path, scenario, settings)


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("seed", [1, 1234, SEED])
def test_generated_plans_match_reference(seed):
    for i in range(40):
        want = ref_plan.generate_plan(seed, i)
        got = port_plan.generate_plan(seed, i)
        assert got.to_doc() == want.to_doc(), (seed, i)
        assert got.to_json() == want.to_json()
        assert got.name == want.name


@hsettings(max_examples=60, deadline=None,
           suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**40), scenario=st.integers(0, 10_000),
       n_workers=st.integers(1, 8), n_loops=st.integers(1, 12),
       iterations=st.integers(1, 4),
       horizon_s=st.floats(0.2, 3.0, allow_nan=False))
def test_generated_plans_match_reference_for_any_shape(
        seed, scenario, n_workers, n_loops, iterations, horizon_s):
    kw = dict(n_workers=n_workers, n_loops=n_loops, iterations=iterations,
              horizon_s=horizon_s)
    assert (port_plan.generate_plan(seed, scenario, **kw).to_doc()
            == ref_plan.generate_plan(seed, scenario, **kw).to_doc())


def test_plan_json_crosses_between_packages(tmp_path):
    for seed, i in ((99, 3), (SEED, 2), (7, 11)):
        ref = ref_plan.generate_plan(seed, i)
        port = port_plan.generate_plan(seed, i)
        assert (port_plan.FaultPlan.load(ref.save(tmp_path / "r.json"))
                .to_doc() == ref.to_doc())
        assert (ref_plan.FaultPlan.load(port.save(tmp_path / "p.json"))
                .to_doc() == port.to_doc())
        assert (tmp_path / "r.json").read_text() == \
            (tmp_path / "p.json").read_text()


@pytest.mark.parametrize("doc", [
    {"seed": 1, "events": [{"at_s": 0.1, "kind": "meteor_strike",
                            "worker": 0}]},
    {"seed": 1, "events": [{"at_s": 0.1, "kind": "cli_sigkill",
                            "arg": "no.such.seam"}]},
    {"seed": 1, "n_workers": 2, "events": [
        {"at_s": 0.1, "kind": "workerd_partition", "worker": 9}]},
    {"seed": 1, "failover": "panic", "events": []},
], ids=["unknown-kind", "unknown-seam", "worker-outside-fleet",
        "unknown-failover"])
def test_plan_refusals_match_reference(tmp_path, doc):
    msgs = []
    for m in (PKGS["ref"], PKGS["port"]):
        p = tmp_path / f"{m.name}.json"
        p.write_text(json.dumps(doc))
        with pytest.raises(m.errors.ClawkerError) as e:
            m.plan.FaultPlan.load(p)
        msgs.append(str(e.value).replace(str(p), "PLAN"))
    assert msgs[1] == msgs[0]


def test_rider_kinds_validate_and_round_trip_as_reference():
    """tests/test_sentinel.py's, test_workerd.py:481's and
    test_gitguard.py:521's rider plans load and round-trip alike."""
    for doc in (
            {"seed": 1, "n_workers": 2, "sentinel": True, "events": [
                {"at_s": 0.1, "kind": "egress_silent", "worker": 0},
                {"at_s": 0.2, "kind": "egress_flood", "worker": 1,
                 "arg": 80},
                {"at_s": 0.3, "kind": "sentinel_kill", "worker": -1}]},
            {"seed": 1, "workerd": True, "events": [
                {"at_s": 0.1, "kind": "workerd_partition", "worker": 1},
                {"at_s": 0.2, "kind": "workerd_kill", "worker": 0}]},
            {"seed": 7, "scenario": 3, "gitguard": True, "events": [
                {"at_s": 0.3, "kind": "gitguard_down", "worker": -1}]},
            {"seed": 2, "capacity": True, "shipper": True, "events": [
                {"at_s": 0.1, "kind": "traffic_burst", "worker": 1,
                 "arg": 9},
                {"at_s": 0.2, "kind": "scale_down", "worker": 2},
                {"at_s": 0.3, "kind": "index_down", "worker": -1,
                 "arg": "stall"}]}):
        want = ref_plan.FaultPlan.from_doc(doc).to_doc()
        got = port_plan.FaultPlan.from_doc(doc).to_doc()
        assert got == want
        assert port_plan.FaultPlan.from_doc(got).to_doc() == got


# ------------------------------------------------------------------ seams


class _Recording:
    """A registry of either package that logs EVERY fire, armed or not."""

    @staticmethod
    def make(m):
        class Rec(m.seams.SeamRegistry):
            def __init__(self):
                super().__init__()
                self.log: list[str] = []

            def fire(self, name):
                self.log.append(name)
                super().fire(name)

        return Rec()


def test_scheduler_fires_lifecycle_seams_as_reference(tmp_path):
    """tests/test_chaos.py's ``test_scheduler_fires_lifecycle_seams``:
    hooks armed on the six launch/exit seams all fire, in the order the
    fire log shows, and benign hooks do not perturb the run."""
    six = ("run.post_placement", "launch.pre_create", "launch.post_create",
           "launch.pre_start", "launch.post_start", "iteration.post_exit")

    def scenario(s):
        drv = driver_with(s.m, 2)
        seams = s.m.seams.SeamRegistry()
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=2, iterations=1,
                                          image=IMAGE),
            seams=seams, run_id=RUN_ID)
        hits: list[str] = []
        for seam in six:
            seams.arm(seam, lambda seam=seam: hits.append(seam))
        sched.start()
        sched.run(poll_s=0.05)
        sched.cleanup(remove_containers=True)
        drv.close()
        return (sorted(set(hits)), seams.fired == hits,
                [l.status for l in sched.loops])

    want, got = twin(tmp_path, scenario)
    assert got == want == (sorted(six), True, ["done", "done"])


@pytest.mark.parametrize("iterations", [1, 2])
def test_one_loop_fires_the_reference_seams_in_its_order(tmp_path,
                                                         iterations):
    """Every fire of one loop on one worker, armed or not, in order."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        seams = _Recording.make(s.m)
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=1, iterations=iterations,
                                          image=IMAGE),
            seams=seams, run_id=RUN_ID)
        sched.start()
        sched.run(poll_s=0.05)
        sched.cleanup(remove_containers=True)
        drv.close()
        return seams.log

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[:6] == ["run.post_placement", "launch.pre_create",
                       "launch.post_create", "launch.pre_start",
                       "launch.post_start", "iteration.post_exit"]
    assert got.count("iteration.post_exit") == iterations


def test_scheduler_null_seams_cannot_be_armed(tmp_path):
    def scenario(s):
        sched = s.m.loop.LoopScheduler(
            s.cfg, driver_with(s.m, 1),
            s.m.loop.LoopSpec(parallel=1, iterations=1, image=IMAGE))
        with pytest.raises(RuntimeError, match="null seam registry"):
            sched.seams.arm("launch.pre_create", lambda: None)
        sched.cleanup()
        return sched.seams is s.m.seams.NULL_SEAMS

    assert twin(tmp_path, scenario) == (True, True)


@pytest.mark.parametrize("n", [1, 2])
def test_armed_pre_create_kill_leaves_the_reference_journal_prefix(
        tmp_path, n):
    """tests/test_chaos.py's ``test_armed_seam_kills_scheduler_mid_create``:
    the kill at ``launch.pre_create`` leaves the journal the placement
    WAL wrote before it (the placements, their admission records and the
    workspace seed) and nothing of the killed launch.  One loop on one
    worker is deterministic record for record; with two lanes the other
    lane's create may race the kill, so only the placements are held."""
    def scenario(s):
        drv = driver_with(s.m, n)
        seams = s.m.seams.SeamRegistry()
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=n, iterations=1,
                                          image=IMAGE),
            seams=seams, run_id=RUN_ID)

        def die():
            sched.kill()
            raise s.m.seams.SeamAbort("twin kill at pre_create")

        seams.arm("launch.pre_create", die)
        sched.start()
        sched.run(poll_s=0.05)
        recs = [json.loads(line) for line in
                s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id)
                .read_text().splitlines()]
        creates = sum(len(api.calls_named("container_create"))
                      for api in drv.apis)
        drv.close()
        prefix = [(r["kind"], r.get("agent", ""), r.get("worker", ""))
                  for r in recs]
        if n > 1:
            prefix = [p for p in prefix if p[0] in ("run", "placement")]
            creates = None      # the other lane races the kill
        return seams.fired, prefix, creates

    want, got = twin(tmp_path, scenario)
    assert got == want
    fired, prefix, creates = got
    assert fired == ["launch.pre_create"]
    if n == 1:
        assert [k for k, _a, _w in prefix] == [
            "run", "placement", "admission_queued", "seed_tar"]
        assert creates == 0
    else:
        assert [k for k, _a, _w in prefix] == ["run", "placement",
                                               "placement"]


# ------------------------------------------------------------- invariants


def _clean_run(s, n_loops=2, n_workers=2):
    drv = driver_with(s.m, n_workers)
    sched = s.m.loop.LoopScheduler(
        s.cfg, drv, s.m.loop.LoopSpec(parallel=n_loops, iterations=1,
                                      image=IMAGE), run_id=RUN_ID)
    sched.start()
    sched.run(poll_s=0.05)
    sched.cleanup(remove_containers=True)
    return drv, sched


def _double_exit(s, drv, sched):
    jpath = s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id)
    with open(jpath, "a") as fh:
        fh.write(json.dumps({"kind": "exited", "seq": 9999, "ts": 0,
                             "agent": sched.loops[0].agent,
                             "iteration": 0, "code": 0}) + "\n")


def _unjournaled_create(s, drv, sched):
    agent = sched.loops[0].agent
    wid = sched.loops[0].worker.id
    api = drv.apis[[w.id for w in drv.workers()].index(wid)]
    name = s.m.names.container_name(s.cfg.project_name(), agent)
    api.container_create(name + "-x", {"Image": IMAGE})
    api._record("container_create", name, {})


def _leaked_container(s, drv, sched):
    drv.apis[0].add_container("leftover", image=IMAGE,
                              labels={s.m.consts.LABEL_LOOP: sched.loop_id})


@pytest.mark.parametrize("doctor,cap", [
    (None, 4), (_double_exit, 0), (_unjournaled_create, 0),
    (_leaked_container, 0)],
    ids=["clean", "double-exit", "unjournaled-create", "leaked-container"])
def test_doctored_runs_give_the_reference_violations(tmp_path, doctor, cap):
    def scenario(s):
        drv, sched = _clean_run(s)
        if doctor is not None:
            doctor(s, drv, sched)
        out = s.m.inv.check_invariants(drv, s.cfg, sched.loop_id,
                                       loops=sched.loops, cap=cap)
        drv.close()
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert bool(got) == (doctor is not None)


def test_stranded_by_drain_and_shipper_audits_give_the_reference_strings(
        tmp_path, monkeypatch):
    """tests/test_capacity.py's stranded-by-drain detectors and
    tests/test_shipper.py's unaccounted-loss audit over both checkers:
    a journaled drain while a placement is live, a gated one, and a
    shipper audit that lost docs without counting them."""
    bad = [{"kind": "run", "run": "r1", "spec": {}},
           {"kind": "placement", "agent": "a0", "worker": "w1"},
           {"kind": "capacity_scale", "action": "drain", "worker": "w1",
            "phase": "done"}]
    gated = [bad[0], bad[1],
             {"kind": "loop_end", "agent": "a0", "status": "done"}, bad[2]]
    good = {"ingested_docs": 10, "flushed_docs": 6, "dropped_docs": 4,
            "pending_docs": 0, "open_docs": 0, "pending_batches": 0,
            "max_batches": 4, "failed_flushes": 1, "indexed_docs": 6,
            "down_injected": True}

    class _NoDriver:
        apis: list = []

        def workers(self):
            return []

    def scenario(s):
        out = []
        for recs in (bad, gated):
            monkeypatch.setattr(s.m.journal.RunJournal, "read",
                                staticmethod(lambda path, recs=recs: recs))
            out.append(s.m.inv.check_invariants(_NoDriver(), s.cfg, "r1",
                                                 loops=[]))
        monkeypatch.undo()
        for audit in (good, dict(good, dropped_docs=0),
                      dict(good, pending_batches=9),
                      dict(good, flushed_docs=0, dropped_docs=0,
                           failed_flushes=0, indexed_docs=0,
                           pending_docs=10)):
            out.append(s.m.inv.check_invariants(_NoDriver(), s.cfg, "norun",
                                                shipper=audit))
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert any(v.startswith("stranded-by-drain") and "a0" in v
               for v in got[0])
    assert not any(v.startswith("stranded-by-drain") for v in got[1])
    assert names(got[2]) == []
    assert names(got[3]) == ["shipper-accounting"]
    assert names(got[4]) == ["shipper-bounded"]
    assert names(got[5]) == ["shipper-backpressure"]


def test_storage_audit_strings_match_reference(tmp_path):
    """The no-silent-drop / replay-integrity half of the checker over the
    same doctored audit dicts."""
    audits = [
        {"fired": 2, "faults": 0, "events": 0, "dropped": 1,
         "durability": "ok", "verify": {"corrupt": 1},
         "torn_injected": False, "folded_run_id": "other"},
        {"fired": 2, "faults": 2, "events": 2, "dropped": 0,
         "durability": "degraded", "verify": {"corrupt": 1},
         "torn_injected": True, "folded_run_id": None},
    ]

    def scenario(s):
        drv, sched = _clean_run(s, n_loops=1, n_workers=1)
        out = [s.m.inv.check_invariants(drv, s.cfg, sched.loop_id,
                                        loops=sched.loops, storage=a)
               for a in audits]
        drv.close()
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert names(got[0]) == ["no-silent-drop", "replay-integrity"]
    assert got[1] == []


def test_scheduling_outcome_of_the_twin_fleet_matches_reference(tmp_path):
    """``scheduling_outcome`` of run_observe_only_check's benign fleet
    (4 workers, 6 loops, one iteration, no faults) is the same in both
    packages."""
    def scenario(s):
        drv = driver_with(s.m, 4, s.m.fake.exit_behavior(b"", 0,
                                                         delay=0.02))
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=6, iterations=1,
                                          image=IMAGE, agent_prefix="twin",
                                          orphan_grace_s=20.0),
            run_id=RUN_ID)
        sched.start()
        loops = sched.run(poll_s=0.05)
        sched.cleanup(remove_containers=True)
        out = s.m.inv.scheduling_outcome(drv, s.cfg, sched.loop_id, loops)
        drv.close()
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert set(got["statuses"].values()) == {"done"}
    assert len(got["placements"]) == 6
    assert port_inv.observe_only_violations(got, want) == []
    assert ref_inv.observe_only_violations(want, got) == []


def test_observe_only_violations_strings_match_reference():
    base = {"placements": {"a": ["w0"], "b": ["w1"]},
            "creates": {"w0": {"a": 1}}, "statuses": {"a": "done"}}
    moved = {"placements": {"a": ["w1"], "b": ["w1"]},
             "creates": {"w0": {"a": 2}}, "statuses": {"a": "failed"}}
    assert (port_inv.observe_only_violations(base, moved)
            == ref_inv.observe_only_violations(base, moved))
    assert len(port_inv.observe_only_violations(base, moved)) == 3


# --------------------------------------------------------------- no card


needs_no_card = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="this host has a GPU: the "
                                          "default device runs there")


@needs_no_card
def test_without_a_card_the_sentinel_paths_fail_before_any_scenario(
        tmp_path, monkeypatch):
    """Without a card and without ``device="cpu"``: a sentinel plan, the
    observe-only check and the soak raise the device error before a pod
    is built, a config is made or a scenario runs."""
    built = []
    monkeypatch.setattr(port_drivers, "FakeDriver",
                        lambda *a, **k: built.append(1))
    monkeypatch.setattr(port_runner, "_fresh_cfg",
                        lambda: built.append(2))
    plan = port_plan.FaultPlan(seed=1, n_workers=2, n_loops=2,
                               sentinel=True)
    progress = []
    for call in (
            lambda: port_runner.ChaosRunner(object(), plan),
            lambda: port_runner.run_plan(plan),
            lambda: port_runner.run_observe_only_check(),
            lambda: port_runner.run_soak(
                2, SEED, on_progress=progress.append)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    assert built == [] and progress == []


def test_plans_without_the_sentinel_run_without_a_device(tmp_path):
    """A plan with no sentinel never asks for its device: on a host
    without a card it runs with the default."""
    with side("port", tmp_path) as s:
        res = port_runner.run_plan(
            port_plan.FaultPlan(seed=1, n_workers=2, n_loops=2,
                                iterations=1), cfg=s.cfg)
    assert res.ok, res.violations


# -------------------------------------------------------------- scenarios


def _storage_plan(kind, arg):
    return lambda m: m.plan.FaultPlan(
        seed=7, scenario=0, n_workers=2, n_loops=3, iterations=2,
        events=[m.plan.FaultEvent(at_s=0.05, kind=kind, worker=-1, arg=arg)])


@pytest.mark.parametrize("kind,arg", [
    ("disk_full", 2), ("io_error", 1), ("fsync_fail", 2),
    ("torn_record", "flip"), ("torn_record", "cut")])
def test_storage_fault_scenarios_hold_invariants_as_reference(
        tmp_path, kind, arg):
    (_r, want), (port, got) = run_plan_twin(tmp_path,
                                            _storage_plan(kind, arg))
    assert got.ok, got.violations
    assert want.ok, want.violations
    assert got.injected == want.injected == 1
    assert port._storage_injected == [kind]
    if kind == "torn_record":
        assert port._torn_injected


def test_sigkill_with_torn_tail_always_kills_once(tmp_path):
    """The reference's ``test_scenario_with_sigkill_and_torn_tail_holds_
    invariants`` with its seam armed at ``at_s=0.0``: every run reaches
    ``launch.post_start`` after the arm, so the kill always fires --
    one kill, two generations, the torn tail healed by the resume."""
    def make(m):
        return m.plan.FaultPlan(
            seed=1, scenario=0, n_workers=4, n_loops=4, iterations=2,
            events=[
                m.plan.FaultEvent(at_s=0.0, kind="cli_sigkill", worker=-1,
                                  arg="launch.post_start", torn_tail=20),
                m.plan.FaultEvent(at_s=0.2, kind="worker_kill", worker=1),
                m.plan.FaultEvent(at_s=0.5, kind="worker_revive",
                                  worker=1)])

    (_r, want), (_p, got) = run_plan_twin(tmp_path, make)
    for res in (want, got):
        assert res.ok, res.violations
        assert (res.kills, res.generations) == (1, 2)


@pytest.mark.parametrize("scenario", [0, 1, 2, 3])
def test_fixed_soak_scenario_matches_reference(tmp_path, scenario):
    """tests/test_chaos.py's fixed soak (seed 20260803), scenario by
    scenario: the same generated plan holds every invariant in both
    packages (scenario 0 the capacity rider, 1 the sentinel, 2 workerd +
    the shipper + gitguard + disk_full, 3 the sentinel + the shipper)."""
    (_r, want), (port, got) = run_plan_twin(
        tmp_path, lambda m: m.plan.generate_plan(SEED, scenario))
    assert got.ok, got.violations
    assert want.ok, want.violations
    for res in (want, got):
        assert res.generations == res.kills + 1
    assert got.plan_doc == want.plan_doc
    if scenario in (1, 3):
        assert port.sentinel is not None and port.sentinel.ticks >= 0
        assert port.sentinel.audit() == {
            "engine_calls": 0, "breaker_reports": 0, "placement_calls": 0}


def test_shedding_makes_workerd_segments_bare_roots_in_both(tmp_path):
    """The cause of the reference's red fixed soak (scenario 2) and of
    tests/test_workerd.py's red partition scenario: below the soft disk
    watermark the scheduler sheds its flight spans (its iteration roots)
    while each workerd's recorder keeps its ``workerd.*`` spans, so the
    merge finds remote segments with no upstream root.  With the
    watermark above any disk, both packages report the same
    ``trace-completeness`` bare roots; the port keeps the reference's
    behaviour."""
    def make(m):
        return m.plan.FaultPlan(
            seed=99, scenario=0, n_workers=2, n_loops=4, iterations=2,
            workerd=True, events=[
                m.plan.FaultEvent(at_s=0.05, kind="workerd_partition",
                                  worker=0),
                m.plan.FaultEvent(at_s=0.25, kind="workerd_partition",
                                  worker=1)])

    (_r, want), (_p, got) = run_plan_twin(tmp_path, make,
                                          settings=SHED_SETTINGS)
    for res in (want, got):
        assert not res.ok
        assert "trace-completeness" in names(res.violations)
        assert set(names(res.violations)) <= {"span-tree",
                                              "trace-completeness"}
        bare = [v for v in res.violations
                if v.startswith("trace-completeness")]
        # spans written before the first pressure tick may stand bare
        # too; workerd's always do
        assert all("bare root" in v for v in bare)
        assert any("'workerd." in v for v in bare)


def test_workerd_partition_scenario_reconciles_as_reference(tmp_path):
    """tests/test_workerd.py's ``test_chaos_workerd_partition_scenario_
    reconciles`` with the watermark below the disk: both packages hold
    every invariant, and each channel healed with nothing undelivered."""
    def make(m):
        return m.plan.FaultPlan(
            seed=99, scenario=0, n_workers=2, n_loops=4, iterations=2,
            workerd=True, events=[
                m.plan.FaultEvent(at_s=0.05, kind="workerd_partition",
                                  worker=0),
                m.plan.FaultEvent(at_s=0.25, kind="workerd_partition",
                                  worker=1)])

    (ref, want), (port, got) = run_plan_twin(tmp_path, make)
    assert got.ok, got.violations
    assert want.ok, want.violations
    assert got.injected == want.injected == 2
    rows = port._workerd_audit()
    assert [r["undelivered"] for r in rows] == [0, 0]


def ref_fresh_cfg_without_proxy():
    """The reference's ``_fresh_cfg`` with the port's one setting: the
    host proxy off.  The reference's spawns a proxy on the fixed default
    port and leaves it running, so on a host where another proxy holds
    that port one loop of its observe-only fleet fails to start and the
    twin read that race, not the sentinel."""
    env = ref_testenv.TestEnv()
    env.__enter__()
    env.write_settings("host_proxy:\n  enable: false\n")
    proj = env.base / "proj"
    proj.mkdir()
    (proj / ref_consts.PROJECT_FLAT_FORM).write_text(f"project: {PROJECT}\n")
    return env, ref_config.load_config(proj)


def test_fresh_cfg_turns_the_host_proxy_off_where_the_reference_spawns():
    """The one difference of the port's ``_fresh_cfg``: its throwaway
    project runs without the host proxy; the reference's runs with it."""
    got = []
    for fresh in (ref_runner._fresh_cfg, port_runner._fresh_cfg,
                  ref_fresh_cfg_without_proxy):
        env, cfg = fresh()
        try:
            got.append(cfg.settings.host_proxy.enable)
        finally:
            env.__exit__(None, None, None)
    assert got == [True, False, False]


def test_soak_report_keeps_the_reference_keys(tmp_path, monkeypatch):
    """``run_soak`` over two scenarios: the report's keys are the
    reference's, ``observe_only.ok`` is a verdict (True), never null.
    Both observe-only fleets run without the host proxy, as every other
    live twin does (``ref_fresh_cfg_without_proxy`` says why)."""
    monkeypatch.setattr(ref_runner, "_fresh_cfg",
                        ref_fresh_cfg_without_proxy)

    def scenario(s):
        return s.m.runner.run_soak(2, SEED, cfg=s.cfg, shrink=False,
                                   **device_kw(s.m))

    want, got = twin(tmp_path, scenario)
    assert sorted(got) == sorted(want)
    assert sorted(got["observe_only"]) == sorted(want["observe_only"])
    assert got["observe_only"] == want["observe_only"] == {
        "ok": True, "violations": []}
    assert got["ok"] and want["ok"]
    assert got["passed"] == want["passed"] == 2


def test_shrink_reduces_a_failing_plan_as_reference(monkeypatch):
    """``shrink_plan`` on a plan whose failure is event-independent
    converges to an empty schedule, through each package's run_plan."""
    out = []
    for m in (PKGS["ref"], PKGS["port"]):
        calls = []

        def fake_run_plan(p, m=m, calls=calls, **kw):
            calls.append(len(p.events))
            return m.runner.ScenarioResult(
                seed=p.seed, scenario=p.scenario, ok=False,
                violations=["synthetic: always fails"])

        monkeypatch.setattr(m.runner, "run_plan", fake_run_plan)
        minimal, res = m.runner.shrink_plan(m.plan.generate_plan(5, 0))
        out.append((minimal.events, res.ok, calls))
    assert out[1] == out[0]
    assert out[1][0] == [] and out[1][1] is False


# -------------------------------------------------------------------- CLI


def _chaos_cli(s, args, monkeypatch, device="cpu"):
    """``chaos ...`` through each package's CLI in-process."""
    from click.testing import CliRunner

    import clawker_tpu.cli.factory as ref_factory
    import clawker_tpu.cli.root as ref_root
    import clawker_tpu_torch.cli as port_cli

    if s.m.name == "ref":
        return CliRunner().invoke(ref_root.cli, ["chaos", *args],
                                  obj=ref_factory.Factory(cwd=s.proj),
                                  catch_exceptions=False)
    if device is None:
        monkeypatch.delenv(port_cli.DEVICE_ENV, raising=False)
    else:
        monkeypatch.setenv(port_cli.DEVICE_ENV, device)
    return CliRunner().invoke(port_cli.cli, ["chaos", *args],
                              obj=port_cli.Factory(cwd=s.proj),
                              catch_exceptions=False)


@pytest.mark.parametrize("args", [
    ["--seed", str(SEED), "--scenario", "2"],
    ["-s", "99", "-i", "7", "--workers", "3", "--parallel", "5",
     "--iterations", "1"]], ids=["soak-shape", "custom-shape"])
def test_cli_chaos_plan_prints_the_reference_plan(tmp_path, monkeypatch,
                                                  args):
    def scenario(s):
        res = _chaos_cli(s, ["plan", *args], monkeypatch)
        out = s.proj / "plan.json"
        saved = _chaos_cli(s, ["plan", *args, "--out", str(out)],
                           monkeypatch)
        return res.exit_code, res.stdout, saved.exit_code, out.read_text()

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 0 and json.loads(got[1])["seed"] in (SEED, 99)


def test_cli_chaos_run_and_replay_match_reference(tmp_path, monkeypatch):
    """``chaos run --scenarios 2 --json`` and ``chaos replay --seed
    --scenario 1 --json`` (the sentinel scenario): the same exit codes,
    the report's and the result's keys, and the verdicts."""
    def scenario(s):
        run = _chaos_cli(s, ["run", "--scenarios", "2", "--seed", str(SEED),
                             "--json"], monkeypatch)
        replay = _chaos_cli(s, ["replay", "--seed", str(SEED), "--scenario",
                                "1", "--json"], monkeypatch)
        table = _chaos_cli(s, ["run", "-n", "1", "-s", str(SEED)],
                           monkeypatch)
        report, result = json.loads(run.stdout), json.loads(replay.stdout)
        return (run.exit_code, sorted(report), report["ok"],
                report["passed"], report["observe_only"],
                replay.exit_code, sorted(result), result["ok"],
                result["plan"], table.exit_code,
                table.stdout.split(" scenario(s)")[0])

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 0 and got[2] is True and got[3] == 2
    assert got[4] == {"ok": True, "violations": []}
    assert got[5] == 0 and got[7] is True and got[8]["sentinel"] is True
    assert got[10] == "chaos: 1/1"


@needs_no_card
def test_cli_chaos_run_without_a_card_exits_1_before_any_scenario(
        tmp_path, monkeypatch):
    with side("port", tmp_path) as s:
        res = _chaos_cli(s, ["run", "--scenarios", "1", "--json"],
                         monkeypatch, device=None)
        replay = _chaos_cli(s, ["replay", "--seed", str(SEED), "--scenario",
                                "1"], monkeypatch, device=None)
        journals = list(s.cfg.logs_dir.rglob("*.journal"))
    assert res.exit_code == replay.exit_code == 1
    assert "no CUDA GPU" in res.output and "CLAWKER_TORCH_DEVICE=cpu" \
        in res.output
    assert res.stdout == ""
    assert journals == []


def test_loop_chaos_plan_applies_the_schedule_as_reference(tmp_path,
                                                           monkeypatch):
    """``loop --chaos-plan`` in process: the live controller applies a
    plan's worker faults, a traffic burst and a scale-down with no
    controller attached (skipped, named), and the run still drains."""
    from click.testing import CliRunner

    import clawker_tpu.cli.factory as ref_factory
    import clawker_tpu.cli.root as ref_root
    import clawker_tpu_torch.cli as port_cli

    def scenario(s):
        plan = s.m.plan.FaultPlan(seed=3, n_workers=2, events=[
            s.m.plan.FaultEvent(at_s=0.0, kind="worker_slow", worker=1,
                                arg=0.01),
            s.m.plan.FaultEvent(at_s=0.0, kind="traffic_burst", worker=0,
                                arg=3),
            s.m.plan.FaultEvent(at_s=0.0, kind="scale_down", worker=1),
            s.m.plan.FaultEvent(at_s=0.0, kind="seed_cache_evict",
                                worker=0),
            s.m.plan.FaultEvent(at_s=0.0, kind="worker_revive", worker=1)])
        path = plan.save(s.proj / "plan.json")
        drv = driver_with(s.m, 2, s.m.fake.exit_behavior(b"", 0,
                                                         delay=0.05))
        args = ["loop", "-p", "4", "-n", "2", "--json", "--image", IMAGE,
                "--chaos-plan", str(path)]
        if s.m.name == "ref":
            res = CliRunner().invoke(
                ref_root.cli, [*args, "--no-daemon", "--no-workerd"],
                obj=ref_factory.Factory(cwd=s.proj, driver=drv),
                catch_exceptions=False)
        else:
            monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
            res = CliRunner().invoke(
                port_cli.cli, args,
                obj=port_cli.Factory(cwd=s.proj, driver=drv),
                catch_exceptions=False)
        drv.close()
        chaos = sorted(line for line in res.stderr.splitlines()
                       if line.startswith("[chaos]")
                       or line.startswith("chaos:"))
        # the port names its verb ``chaos run``, the reference's CLI
        # ``clawker chaos run``
        chaos = [line.replace(str(path), "PLAN").replace("`clawker chaos",
                                                         "`chaos")
                 for line in chaos]
        return (res.exit_code, [r["status"] for r in
                                json.loads(res.stdout)["agents"]], chaos)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 0 and got[1] == ["done"] * 4
    assert "chaos: applying 5 event(s) from PLAN (seed 3)" in got[2]
    assert any("scale_down: no capacity controller attached" in line
               for line in got[2])
