"""The port's in-process ``loop`` against the reference's.

Every twin runs the reference (``clawker_tpu``) and the port
(``clawker_tpu_torch``) on their own ``FakeDriver`` with the same worker
count, image behaviour and ``LoopSpec``, under an isolated ``TestEnv``
whose settings turn the host proxy off: on a fake with several workers
the reference's lanes race two proxy spawns and a loop's start can fail
(tests/test_torch_hostproxy.py runs the twin on default settings, the
proxy up, over one worker).  Both runs
share one run id, so agent and container names agree.  They must give
the same final ``status()`` rows, the same per-agent sequence of
scheduler event kinds and the same per-agent sequence of journal record
kinds.  The journal and the flight recorder cross between the packages
both ways, the refused options and drivers raise their named errors,
and the start-time services take the reference's lanes (the control
plane's through a stubbed manager).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import io
import re
import socket
import tarfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml
from click.testing import CliRunner

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.controlplane.bootstrap as ref_bootstrap
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.fleet.channels as ref_channels
import clawker_tpu.fleet.transport as ref_transport
import clawker_tpu.health as ref_health
import clawker_tpu.loop as ref_loop
import clawker_tpu.loop.scheduler as ref_scheduler
import clawker_tpu.monitor.ledger as ref_ledger
import clawker_tpu.telemetry as ref_telemetry
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.controlplane.bootstrap as port_bootstrap
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.fleet.channels as port_channels
import clawker_tpu_torch.fleet.transport as port_transport
import clawker_tpu_torch.health as port_health
import clawker_tpu_torch.hostproxy.manager as port_manager
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.loop.scheduler as port_scheduler
import clawker_tpu_torch.monitor.ledger as port_ledger
import clawker_tpu_torch.telemetry as port_telemetry
from clawker_tpu.testenv import TestEnv

PROJECT = "twin"
IMAGE = f"clawker-{PROJECT}:default"
RUN_ID = "twinrun00001"
# the host proxy is off (see the module docstring); the soft watermark
# sits below any real disk so the flight recorder keeps every span
SETTINGS = """host_proxy:
  enable: false
loop:
  storage_pressure:
    soft_free_pct: 0.001
    hard_free_pct: 0.0005
"""

PKGS = {
    "ref": SimpleNamespace(
        load_config=ref_config.load_config, FakeDriver=ref_drivers.FakeDriver,
        exit_behavior=ref_fake.exit_behavior, loop=ref_loop,
        scheduler=ref_scheduler, health=ref_health, ledger=ref_ledger,
        telemetry=ref_telemetry, errors=ref_errors),
    "port": SimpleNamespace(
        load_config=port_config.load_config,
        FakeDriver=port_drivers.FakeDriver,
        exit_behavior=port_fake.exit_behavior, loop=port_loop,
        scheduler=port_scheduler, health=port_health, ledger=port_ledger,
        telemetry=port_telemetry, errors=port_errors),
}

# probes rarely, and a tripped breaker stays open for the whole run
SLOW_HEALTH = dict(probe_interval_s=30.0, probe_deadline_s=0.5,
                   failure_threshold=2, backoff_base_s=60.0,
                   backoff_max_s=60.0)


def _health(m):
    return m.health.HealthConfig(
        probe_interval_s=SLOW_HEALTH["probe_interval_s"],
        probe_deadline_s=SLOW_HEALTH["probe_deadline_s"],
        breaker=m.health.BreakerConfig(
            failure_threshold=SLOW_HEALTH["failure_threshold"],
            backoff_base_s=SLOW_HEALTH["backoff_base_s"],
            backoff_max_s=SLOW_HEALTH["backoff_max_s"],
            backoff_jitter=0.0, half_open_successes=2))


@dataclasses.dataclass
class Run:
    """What one package's run left behind."""

    sched: object
    driver: object
    events: list
    status: list
    names: dict         # worker id -> sorted container names

    def event_kinds(self, agent: str) -> list[str]:
        return [e for a, e, _ in self.events if a == agent]

    def journal(self) -> list[dict]:
        # through the class: a reference test restores ``RunJournal.read``
        # as a plain function, which an instance would bind
        return type(self.sched.journal).read(self.sched.journal.path)

    def journal_kinds(self, agent: str) -> list[str]:
        return [r["kind"] for r in self.journal() if r.get("agent") == agent]

    def agents(self) -> list[str]:
        return [row["agent"] for row in self.status]


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _settings(extra: str = "") -> str:
    """SETTINGS with ``extra`` (YAML) merged over it."""
    return yaml.safe_dump(_merge(yaml.safe_load(SETTINGS),
                                 yaml.safe_load(extra) or {}))


def _env(tmp_path: Path, tag: str, settings: str = ""):
    tenv = TestEnv(base=tmp_path / tag)
    tenv.__enter__()
    tenv.write_settings(_settings(settings))
    proj = tenv.base / "proj"
    proj.mkdir()
    (proj / ".clawker.yaml").write_text(f"project: {PROJECT}\n")
    return tenv, proj


def _driver(m, n_workers: int, code: int = 0, behavior=None):
    drv = m.FakeDriver(n_workers=n_workers)
    for api in drv.apis:
        api.add_image(IMAGE)
        api.set_behavior(IMAGE, behavior
                         or m.exit_behavior(b"iter done\n", code))
    return drv


def run_loop(pkg: str, tmp_path: Path, *, n_workers: int = 2, code: int = 0,
             settings: str = "", between=None,
             cleanup: bool = True, behavior=None, **spec) -> Run:
    """One package's run to completion.  ``between(sched, driver)`` runs
    after ``start()`` and before ``run()``; ``behavior`` replaces the
    image's exit behaviour."""
    m = PKGS[pkg]
    tenv, proj = _env(tmp_path, pkg, settings)
    try:
        cfg = m.load_config(proj)
        drv = _driver(m, n_workers, code, behavior)
        events: list = []
        sched = m.loop.LoopScheduler(
            cfg, drv, m.loop.LoopSpec(**spec),
            on_event=lambda a, e, d="": events.append((a, e, d)),
            run_id=RUN_ID, health_config=_health(m))
        sched.start()
        if between is not None:
            between(sched, drv)
        sched.run(poll_s=0.02)
        names = {w.id: sorted(c["Names"][0] for c in
                              api.container_list(all=True))
                 for w, api in zip(drv.workers(), drv.apis)}
        status = sched.status()
        if cleanup:
            sched.cleanup(remove_containers=True)
        return Run(sched, drv, events, status, names)
    finally:
        tenv.__exit__(None, None, None)


def twins(tmp_path: Path, **kw) -> tuple[Run, Run]:
    return run_loop("ref", tmp_path, **kw), run_loop("port", tmp_path, **kw)


def assert_twins(ref: Run, port: Run) -> None:
    assert port.status == ref.status
    for agent in ref.agents():
        assert port.event_kinds(agent) == ref.event_kinds(agent), agent
        if ref.sched.journal is not None:
            assert port.journal_kinds(agent) == ref.journal_kinds(agent), agent
    if ref.sched.journal is not None:
        assert sorted(r["kind"] for r in port.journal() if not r.get("agent")) \
            == sorted(r["kind"] for r in ref.journal() if not r.get("agent"))
    else:
        assert port.sched.journal is None
    assert port.names == ref.names


# ----------------------------------------------------------------- placement


@pytest.mark.parametrize("policy,n,workers", [
    ("spread", 8, 3), ("spread", 5, 4), ("pack", 3, 2), ("pack", 1, 1),
    ("topology", 8, 4), ("topology", 3, 1)])
def test_place_matches_reference(policy, n, workers):
    got = port_scheduler.place(
        port_drivers.FakeDriver(n_workers=workers).workers(), n, policy)
    want = ref_scheduler.place(
        ref_drivers.FakeDriver(n_workers=workers).workers(), n, policy)
    assert [w.id for w in got] == [w.id for w in want]


@pytest.mark.parametrize("case", ["unknown policy", "no workers"])
def test_place_errors_match_reference(case):
    def call(m, drivers):
        workers = drivers.FakeDriver(n_workers=2).workers()
        if case == "no workers":
            return m.place([], 1, "spread")
        return m.place(workers, 2, "best-fit")

    with pytest.raises(ref_errors.ClawkerError) as want:
        call(ref_scheduler, ref_drivers)
    with pytest.raises(port_errors.ClawkerError) as got:
        call(port_scheduler, port_drivers)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- iteration


@pytest.mark.parametrize("case", [
    dict(n_workers=1, parallel=1, iterations=3),
    dict(n_workers=4, parallel=4, iterations=1),
    dict(n_workers=3, parallel=5, iterations=2),
    dict(n_workers=2, parallel=3, iterations=2, placement="pack"),
    dict(n_workers=4, parallel=4, iterations=1, placement="topology"),
    dict(n_workers=2, parallel=4, iterations=2, max_inflight_per_worker=1),
    dict(n_workers=2, parallel=2, iterations=1, tenant="batch",
         tenant_weight=2.0),
    dict(n_workers=2, parallel=2, iterations=2, code=1),
    dict(n_workers=1, parallel=1, iterations=10, code=2),
    dict(n_workers=2, parallel=2, iterations=2, journal=False),
    dict(n_workers=2, parallel=2, iterations=1, telemetry=False),
    dict(n_workers=2, parallel=2, iterations=1, prompt="fix the bug",
         env={"FOO": "bar"}),
], ids=["budget", "spread4", "spread5on3", "pack", "topology",
        "admission1", "tenant", "exit1", "ceiling", "nojournal",
        "notelemetry", "promptenv"])
def test_scheduler_run_matches_reference(tmp_path, case):
    ref, port = twins(tmp_path, **case)
    assert_twins(ref, port)
    assert all(row["status"] in ("done", "failed") for row in port.status)
    if case.get("code") == 2:
        assert port.status[0]["status"] == "failed"
        assert port.status[0]["exit_codes"] == \
            [2] * port_scheduler.FAILURE_CEILING


def test_containers_carry_the_run_id_on_their_workers(tmp_path):
    ref, port = twins(tmp_path, n_workers=4, parallel=4, iterations=1,
                      cleanup=False)
    assert_twins(ref, port)
    tag = RUN_ID[:6]
    assert port.names == {f"fake-{i}": [f"/clawker.{PROJECT}.loop-{tag}-{i}"]
                          for i in range(4)}


@pytest.mark.parametrize("remove", [True, False])
def test_cleanup_matches_reference(tmp_path, remove):
    runs = []
    for pkg in ("ref", "port"):
        run = run_loop(pkg, tmp_path, parallel=2, iterations=1,
                       cleanup=False)
        run.sched.cleanup(remove_containers=remove)
        runs.append({w.id: sorted(c["Names"][0] for c in
                                  api.container_list(all=True))
                     for w, api in zip(run.driver.workers(),
                                       run.driver.apis)})
    assert runs[1] == runs[0]
    assert any(runs[1].values()) == (not remove)


def _state_archives(run: Run) -> tuple[int, list[str]]:
    """(state-file writes, the last state file of each container)."""
    writes, last = 0, []
    for api in run.driver.apis:
        writes += sum(1 for args, _ in api.calls_named("put_archive")
                      if args[1] == port_scheduler.LOOP_STATE_DIR)
        for row in api.container_list(all=True):
            tar = api._find(row["Id"]).archives[port_scheduler.LOOP_STATE_DIR]
            tf = tarfile.open(fileobj=io.BytesIO(tar))
            last.append(tf.extractfile("loop-state").read().decode())
    return writes, last


def test_state_file_written_per_iteration_as_the_reference(tmp_path):
    ref, port = twins(tmp_path, n_workers=1, parallel=1, iterations=3,
                      cleanup=False)
    assert _state_archives(port) == _state_archives(ref)
    assert _state_archives(port) == (3, [
        f"loop_id={RUN_ID}\nagent=loop-{RUN_ID[:6]}-0\niteration=2\n"])


def _hold_third(held: threading.Event):
    """Two iterations exit 0 at once; the third sets ``held`` and runs
    until its container is stopped."""
    starts = iter(range(1 << 30))

    def run(io) -> int:
        if next(starts) < 2:
            return 0
        held.set()
        io.wait_for_kill()
        return 137

    return run


@pytest.mark.parametrize("how", ["stop", "request_shutdown"])
def test_stop_halts_unbounded_loops_as_the_reference(tmp_path, how):
    """The stop lands while the third iteration's container runs: the
    state is the same on both sides however long each step takes."""
    def stopper(held):
        def between(sched, drv):
            def go():
                held.wait(10)
                # the container now runs until stopped; the third
                # iteration's wait span opens once its start returned (the
                # loop reads "running" between iterations too, and a stop
                # landing inside the start raced its "running" commit)
                loop = sched.loops[0]
                deadline = time.monotonic() + 10
                while ((loop.agent, 2) not in sched._iter_started
                       and time.monotonic() < deadline):
                    time.sleep(0.002)
                getattr(sched, how)()

            threading.Thread(target=go, daemon=True).start()

        return between

    got = {}
    for pkg in ("ref", "port"):
        held = threading.Event()
        run = run_loop(pkg, tmp_path, n_workers=1, parallel=1, iterations=0,
                       behavior=_hold_third(held), between=stopper(held))
        agent = run.agents()[0]
        got[pkg] = (run.status[0]["status"], run.status[0]["iteration"],
                    "stopped" in run.event_kinds(agent),
                    [r["kind"] for r in run.journal()
                     if r["kind"] in ("shutdown", "loop_end")])
    assert got["port"] == got["ref"]
    assert got["port"][:3] == ("stopped", 2, True)


# ----------------------------------------------------------------- failover


@pytest.mark.parametrize("failover", ["migrate", "wait", "fail"])
def test_failover_policy_matches_reference(tmp_path, failover):
    """Worker 1's daemon is wedged and its breaker opened once its first
    launch holds the lane (the first call to reach the wedged daemon,
    signalled from the fake's gate; the second launch waits behind it):
    the first tick orphans both loops into the failover policy.  The
    breaker then stays open for the whole run (``SLOW_HEALTH``), so the
    0.2 s orphan grace under ``wait`` ends in the same failure however
    long the run's ticks take."""
    runs = []
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        tenv, proj = _env(tmp_path, pkg)
        try:
            cfg = m.load_config(proj)
            drv = _driver(m, 2)
            drv.inject_fault(1, "wedge")
            entered = threading.Event()
            gate = drv.gates[1]
            wedged = gate._gate

            def signalling_gate(name, *, local=False, wedged=wedged,
                                entered=entered):
                entered.set()
                return wedged(name, local=local)

            gate._gate = signalling_gate
            events: list = []
            sched = m.loop.LoopScheduler(
                cfg, drv, m.loop.LoopSpec(parallel=4, iterations=1,
                                          failover=failover,
                                          orphan_grace_s=0.2),
                on_event=lambda a, e, d="": events.append((a, e, d)),
                run_id=RUN_ID, health_config=_health(m))
            sched.start()
            # the health probes start with run(): until then only the
            # launches on worker 1's lane reach its daemon
            assert entered.wait(10), "no launch reached worker 1"
            sched.health.breakers["fake-1"].trip("test: worker dead")
            sched.run(poll_s=0.02)
            # the stale create on the wedged daemon completes once the
            # fault clears: journaled, then left for cleanup (its loop
            # moved on)
            drv.clear_fault(1)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not any(
                    r["kind"] == "created" and r.get("worker") == "fake-1"
                    and r.get("epoch") == 0
                    for r in type(sched.journal).read(sched.journal.path)):
                time.sleep(0.005)
            status = sched.status()
            sched.cleanup(remove_containers=True)
            runs.append(Run(sched, drv, events, status, {}))
        finally:
            tenv.__exit__(None, None, None)
    ref, port = runs
    assert_twins(ref, port)
    moved = [r for r in port.status if r["migrations"]]
    if failover == "migrate":
        assert len(moved) == 2 and all(r["worker"] == "fake-0"
                                       and r["status"] == "done"
                                       for r in moved)
    else:
        assert sorted(r["status"] for r in port.status) == \
            ["done", "done", "failed", "failed"]


def test_pretripped_worker_gets_no_placement_as_the_reference(tmp_path):
    def place_only(pkg):
        m = PKGS[pkg]
        tenv, proj = _env(tmp_path, pkg)
        try:
            drv = _driver(m, 3)
            sched = m.loop.LoopScheduler(
                m.load_config(proj), drv,
                m.loop.LoopSpec(parallel=4, iterations=1), run_id=RUN_ID,
                health_config=_health(m))
            sched._ensure_health().breakers["fake-1"].trip("dead")
            sched.start()
            sched.run(poll_s=0.02)
            status = sched.status()
            sched.cleanup(remove_containers=True)
            return status
        finally:
            tenv.__exit__(None, None, None)

    got, want = place_only("port"), place_only("ref")
    assert got == want
    assert "fake-1" not in {r["worker"] for r in got}


# --------------------------------------------------------- disk pressure


def test_soft_watermark_sheds_flight_spans_as_the_reference(tmp_path):
    shed = "loop:\n  storage_pressure:\n    soft_free_pct: 100.0\n" \
           "    hard_free_pct: 0.0\n"
    got = {}
    for pkg in ("ref", "port"):
        run = run_loop(pkg, tmp_path, parallel=2, iterations=1,
                       settings=shed)
        pressure = run.sched.storage_summary()["pressure"]
        spans = PKGS[pkg].telemetry.load_spans(
            run.sched.flight.path.read_text().splitlines())
        got[pkg] = (pressure["level"], pressure["shedding"],
                    [e for a, e, _ in run.events if a == "scheduler"],
                    {s.name for s in spans} <= {"iteration", "create",
                                                "start", "wait", "exit"})
    assert got["port"] == got["ref"]
    level, shedding, scheduler_events, only_iteration_spans = got["port"]
    assert level == 1 and "flight" in shedding and only_iteration_spans
    assert scheduler_events == ["storage.fault"]


# ------------------------------------------------------------ cross-reading


def _image_doc(img) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(img), default=str))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_journal_replays_the_same_in_both_packages(tmp_path, writer):
    run = run_loop(writer, tmp_path, n_workers=2, parallel=3, iterations=2,
                   code=1)
    path = run.sched.journal.path
    want = ref_loop.replay(ref_loop.RunJournal.read(path))
    got = port_loop.replay(port_loop.RunJournal.read(path))
    assert _image_doc(got) == _image_doc(want)
    assert want.run_id == RUN_ID and len(want.loops) == 3
    assert {a: li.status for a, li in got.loops.items()} == \
        {r["agent"]: r["status"] for r in run.status}
    # the verified readers agree on the framing too
    recs, rep = port_loop.RunJournal.read_verified(path)
    ref_recs, ref_rep = ref_loop.RunJournal.read_verified(path)
    assert recs == ref_recs and rep.to_doc() == ref_rep.to_doc()
    assert rep.ok and rep.verified == rep.total > 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_flight_spans_read_the_same_in_both_packages(tmp_path, writer):
    run = run_loop(writer, tmp_path, n_workers=2, parallel=2, iterations=2)
    lines = run.sched.flight.path.read_text().splitlines()
    got = port_telemetry.load_spans(lines)
    want = ref_telemetry.load_spans(lines)
    assert [s.to_json() for s in got] == [s.to_json() for s in want]
    trees = port_telemetry.build_trees(got)
    ref_trees = ref_telemetry.build_trees(want)
    assert [port_telemetry.tree_to_dict(t) for t in trees] == \
        [ref_telemetry.tree_to_dict(t) for t in ref_trees]
    assert sum(1 for t in trees if t.record.name == "iteration") == 4


def test_flight_spans_of_twin_runs_have_the_same_shape(tmp_path):
    ref, port = twins(tmp_path, n_workers=2, parallel=2, iterations=2)

    def shape(run, telemetry):
        spans = telemetry.load_spans(
            run.sched.flight.path.read_text().splitlines())
        return sorted((s.agent, s.name, s.attrs.get("iteration"), s.status,
                       s.worker) for s in spans)

    assert shape(port, port_telemetry) == shape(ref, ref_telemetry)


@pytest.mark.parametrize("record", [
    {}, {"kind": "run", "seq": 1, "spec": {"parallel": 2}},
    {"kind": "exited", "agent": "loop-a-0", "iteration": 3, "code": 1},
    {"t": 1.5, "nested": {"a": [1, 2, {"b": "é"}]}}])
def test_record_framing_matches_reference(record):
    line = port_ledger.encode_record(record)
    assert line == ref_ledger.encode_record(record)
    assert port_ledger.classify_line(line) == ref_ledger.classify_line(line)
    flipped = line.replace('"c":"', '"c":"0', 1)[:-2] + '"}'
    assert port_ledger.classify_line(flipped) == \
        ref_ledger.classify_line(flipped)


@pytest.mark.parametrize("section", ["sentinel", "loop", "telemetry"])
def test_load_config_reads_the_same_sections(tmp_path, section):
    settings = _settings("loop:\n  parallel: 6\n  failover: wait\n") + """sentinel:
  enable: true
  interval_s: 0.5
  threshold: 4.0
telemetry:
  flight_recorder:
    max_bytes: 123456
"""
    tenv = TestEnv(base=tmp_path / "cfg")
    with tenv:
        tenv.write_settings(settings)
        proj = tenv.base / "proj"
        tenv.make_project(proj, f"project: {PROJECT}\n")
        got = getattr(port_config.load_config(proj).settings, section)
        want = getattr(ref_config.load_config(proj).settings, section)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -------------------------------------------------------------------- CLI


def _cli(pkg: str, tmp_path: Path, args: list[str], monkeypatch,
         settings: str = "", n_workers: int = 2):
    m = PKGS[pkg]
    tenv, proj = _env(tmp_path, pkg, settings)
    try:
        drv = _driver(m, n_workers)
        if pkg == "ref":
            res = CliRunner().invoke(
                ref_root.cli, ["loop", *args, "--no-daemon", "--no-workerd"],
                obj=ref_factory.Factory(cwd=proj, driver=drv),
                catch_exceptions=False)
        else:
            monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
            res = CliRunner().invoke(
                port_cli.cli, ["loop", *args],
                obj=port_cli.Factory(cwd=proj, driver=drv),
                catch_exceptions=False)
        left = [c["Names"][0] for api in drv.apis
                for c in api.container_list(all=True)]
        return res, left
    finally:
        tenv.__exit__(None, None, None)


def _rows(res) -> list[dict]:
    doc = json.loads(res.stdout)
    run = doc["loop_id"][:6]
    return [{k: (v.replace(run, "RUN") if isinstance(v, str) else v)
             for k, v in row.items() if k != "anomaly_z"}
            for row in doc["agents"]]


@pytest.mark.parametrize("args", [
    ["--parallel", "2", "--iterations", "1"],
    ["-p", "3", "-n", "2", "--placement", "pack"],
    ["-p", "2", "-n", "1", "--sentinel"],
    ["-p", "2", "-n", "1", "--failover", "fail", "--env", "A=b"],
], ids=["basic", "pack", "sentinel", "failover-env"])
def test_cli_loop_json_matches_reference(tmp_path, monkeypatch, args):
    want, ref_left = _cli("ref", tmp_path, [*args, "--json"], monkeypatch)
    got, left = _cli("port", tmp_path, [*args, "--json"], monkeypatch)
    assert want.exit_code == got.exit_code == 0, (want.output, got.output)
    assert _rows(got) == _rows(want)
    assert all(r["status"] == "done" for r in _rows(got))
    assert left == ref_left == []
    storage = json.loads(got.stdout)["storage"]
    assert storage["durability"] == "ok" and storage["journal"]["healthy"]


def test_cli_loop_table_matches_reference(tmp_path, monkeypatch):
    want, _ = _cli("ref", tmp_path, ["-p", "2", "-n", "1"], monkeypatch)
    got, _ = _cli("port", tmp_path, ["-p", "2", "-n", "1"], monkeypatch)
    assert want.exit_code == got.exit_code == 0

    def table(res):
        return [line.split("\t")[2:] for line in res.stdout.splitlines()]

    assert table(got) == table(want) == [["done", "iters=1", "exits=0"]] * 2


def _screen(text: str) -> list[str]:
    """The rows a terminal shows after ``text``: the painter's
    cursor-up, cursor-down and erase-line escapes applied (its rows
    never wrap), colour escapes kept."""
    rows, cur = [""], 0
    for tok in re.split(r"(\x1b\[\d*[ABK]|\n)", text):
        esc = re.fullmatch(r"\x1b\[(\d*)([ABK])", tok)
        if tok == "\n" or (esc and esc[2] == "B"):
            cur += 1 if tok == "\n" else int(esc[1] or 1)
            rows += [""] * (cur + 1 - len(rows))
        elif esc and esc[2] == "A":
            cur -= int(esc[1] or 1)
        elif esc:
            rows[cur] = ""
        else:
            rows[cur] += tok
    return rows


# the sentinel's scores, injected: agent index -> latest z (None: no row)
INJECTED_Z = {0: 0.25, 1: 1.5, 2: None, 3: 4.25}


def _tty_cli(pkg: str, tmp_path: Path, monkeypatch, colour: str,
             args: list[str]):
    """``loop -p 4 -n 1 --sentinel ARGS`` with the package's Factory on
    a stdout whose ``isatty()`` is true and a sentinel whose scores are
    :data:`INJECTED_Z`: -> (CliRunner result, the screen's rows)."""
    from test_torch_ui import COLOUR, FixedTime

    m = PKGS[pkg]
    if pkg == "ref":
        import clawker_tpu.sentinel as sentinel
        import clawker_tpu.ui.dashboard as dashboard
        from clawker_tpu.ui.iostreams import IOStreams
    else:
        import clawker_tpu_torch.sentinel as sentinel
        import clawker_tpu_torch.ui.dashboard as dashboard
        from clawker_tpu_torch.ui.iostreams import IOStreams

        monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")

    def score_for(self, agent):
        z = INJECTED_Z.get(int(agent.rsplit("-", 1)[1]))
        return None if z is None else SimpleNamespace(latest=z)

    cls = sentinel.FleetSentinel
    monkeypatch.setattr(cls, "start", lambda self: None)
    monkeypatch.setattr(cls, "stop", lambda self: None)
    monkeypatch.setattr(cls, "score_for", score_for)
    monkeypatch.setattr(dashboard, "time", FixedTime())
    streams, _, out, _ = IOStreams.test()
    streams.env = dict(COLOUR[colour])
    streams.stdout.isatty = lambda: True
    tenv, proj = _env(tmp_path, pkg)
    try:
        drv = _driver(m, 2)
        if pkg == "ref":
            f = ref_factory.Factory(cwd=proj, driver=drv)
            argv = ["loop", *args, "--no-daemon", "--no-workerd"]
            cli = ref_root.cli
        else:
            f = port_cli.Factory(cwd=proj, driver=drv)
            argv = ["loop", *args]
            cli = port_cli.cli
        f.streams = streams
        res = CliRunner().invoke(cli, argv, obj=f, catch_exceptions=False)
    finally:
        tenv.__exit__(None, None, None)
    return res, _screen(out.getvalue())


@pytest.mark.parametrize("colour", ["on", "off"])
def test_cli_loop_on_a_tty_paints_the_dashboard_with_anom_z(
        tmp_path, monkeypatch, colour):
    """On a terminal ``loop`` paints the reference's dashboard: the same
    final table with its ANOM-Z column and the same status bar, events
    to the dashboard's ticker and not to stderr, and the same plain
    lines on stdout after it."""
    args = ["-p", "4", "-n", "1", "--sentinel"]
    frames, outs = {}, {}
    for pkg in ("ref", "port"):
        res, rows = _tty_cli(pkg, tmp_path, monkeypatch, colour, args)
        assert res.exit_code == 0, res.output
        assert not re.search(r"^\[loop-", res.stderr, re.M), res.stderr
        run = re.search(r"loop ([0-9a-f]{12})", rows[0])[1]
        start = next(i for i, r in enumerate(rows) if "AGENT" in r)
        table = rows[start:rows.index("", start)]
        bar = [r for r in rows if "ctrl-c stops" in r]
        frames[pkg] = [r.replace(run, "RUN").replace(run[:6], "RUN")
                       for r in table + bar]
        outs[pkg] = [line.split("\t")[2:] for line in res.stdout.splitlines()]
    assert frames["port"] == frames["ref"]
    assert outs["port"] == outs["ref"] == [["done", "iters=1", "exits=0"]] * 4
    plain = [re.sub(r"\x1b\[[\d;]*m", "", r) for r in frames["port"]]
    assert plain[0].split() == ["AGENT", "WORKER", "STATUS", "ITER",
                                "EXITS", "ANOM-Z"]
    assert [r.split()[-1] for r in plain[1:5]] == ["0.2", "1.5", "-", "4.2"]
    assert "anom-max:4.2" in plain[-1] and "done:4" in plain[-1]
    if colour == "on":
        assert frames["port"][4].rstrip().endswith("\x1b[31m4.2\x1b[0m")


def test_cli_loop_json_on_a_tty_paints_no_frame(tmp_path, monkeypatch):
    for pkg in ("ref", "port"):
        res, rows = _tty_cli(pkg, tmp_path, monkeypatch, "on",
                             ["-p", "2", "-n", "1", "--sentinel", "--json"])
        assert res.exit_code == 0, res.output
        assert rows == [""], (pkg, rows)
        assert json.loads(res.stdout)["agents"][1]["anomaly_z"] == 1.5


def test_bring_up_on_the_cpu_builds_and_launches_nothing():
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import build

    K.reset_launches()
    libs = dict(build._libs)
    port_cli._bring_up("loop", "cpu")
    assert build._libs == libs
    assert not any(K.LAUNCHES.values())


# ----------------------------------------------------------------- refusals


@pytest.mark.parametrize("args,settings,needle", [
    # ported: with no workerd answering, --workerd fails as the
    # reference's does (tests/test_torch_workerd.py holds the twin)
    (["--workerd"], "", "no workerd answering"),
    # ported: with no pod registered and no loopd answering, --pods
    # fails with the reference's message (tests/test_torch_federation.py
    # holds the twins)
    (["--pods"], "", "--pods: no federation configured and no loopd "
                     "answering"),
], ids=["workerd", "pods"])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, args,
                                        settings, needle):
    monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
    tenv, proj = _env(tmp_path, "port", settings)
    try:
        drv = _driver(PKGS["port"], 1)
        res = CliRunner().invoke(port_cli.cli, ["loop", "-p", "1", "-n", "1",
                                                *args],
                                 obj=port_cli.Factory(cwd=proj, driver=drv))
    finally:
        tenv.__exit__(None, None, None)
    assert res.exit_code == 1, res.output
    assert needle in res.output
    # nothing was launched
    assert not drv.api.calls_named("container_create")


@pytest.mark.parametrize("name", ["nsd"])
def test_cli_names_an_unported_driver(tmp_path, monkeypatch, name):
    monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
    monkeypatch.setenv(port_cli.ENV_DRIVER, name)
    tenv, proj = _env(tmp_path, "port")
    try:
        res = CliRunner().invoke(port_cli.cli, ["loop", "-p", "1"],
                                 obj=port_cli.Factory(cwd=proj))
    finally:
        tenv.__exit__(None, None, None)
    assert res.exit_code == 1
    assert f"runtime driver {name!r} is not yet ported" in res.output


@pytest.mark.parametrize("flag", ["--daemon", "--detach"])
def test_cli_daemon_flags_need_an_answering_loopd(tmp_path, monkeypatch,
                                                  flag):
    """With no loopd answering, ``--daemon`` and ``--detach`` fail as the
    reference's do, naming the daemon, and launch nothing."""
    results = []
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        tenv, proj = _env(tmp_path, pkg)
        try:
            drv = _driver(m, 1)
            if pkg == "ref":
                res = CliRunner().invoke(
                    ref_root.cli, ["loop", "-p", "1", "-n", "1", flag],
                    obj=ref_factory.Factory(cwd=proj, driver=drv))
            else:
                monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
                res = CliRunner().invoke(
                    port_cli.cli, ["loop", "-p", "1", "-n", "1", flag],
                    obj=port_cli.Factory(cwd=proj, driver=drv))
        finally:
            tenv.__exit__(None, None, None)
        results.append((res.exit_code, "loopd" in res.output,
                        len(drv.api.calls_named("container_create"))))
    assert results[1] == results[0] == (1, True, 0)


def test_cli_loop_attach_names_the_missing_daemon(tmp_path):
    tenv, proj = _env(tmp_path, "port")
    try:
        res = CliRunner().invoke(port_cli.cli, ["loop", "attach", "run1"],
                                 obj=port_cli.Factory(cwd=proj))
    finally:
        tenv.__exit__(None, None, None)
    assert res.exit_code == 1
    assert "no loopd daemon answering" in res.output


@pytest.mark.parametrize("name", ["nsd"])
def test_unported_drivers_are_named(name):
    settings = port_config.Settings()
    with pytest.raises(port_errors.ConfigError,
                       match=f"{name!r} is not yet ported"):
        port_drivers.get_driver(settings, override=name)


def test_seeded_fake_driver_matches_reference(monkeypatch):
    monkeypatch.setenv("CLAWKER_TPU_FAKE_IMAGES", f"{IMAGE}, other:1")
    got = port_drivers.get_driver(port_config.Settings(), override="fake")
    want = ref_drivers.get_driver(ref_config.Settings(), override="fake")
    assert [w.id for w in got.workers()] == [w.id for w in want.workers()]
    assert sorted(got.api.images) == sorted(want.api.images)
    with pytest.raises(port_errors.ConfigError, match="unknown runtime"):
        port_drivers.get_driver(port_config.Settings(), override="k8s")


@pytest.mark.parametrize("section", ["control_plane", "firewall"])
def test_pre_start_services_name_each_unported_service(section, monkeypatch):
    """``control_plane.enable`` makes sure the control plane runs.
    ``firewall.enable`` with pinned programs present (patched) hands the
    pre-start hook's ``FirewallInit`` to it: found down, it is started,
    and the call rides ``admin_client(ensure_material=True)``.  Each
    package's manager is stubbed and its calls recorded."""
    import clawker_tpu.controlplane.manager as ref_manager
    import clawker_tpu.firewall.runtime as ref_fw_runtime
    import clawker_tpu_torch.controlplane.manager as port_manager
    import clawker_tpu_torch.firewall.runtime as port_fw_runtime

    def run(bootstrap, config, manager, fw_runtime):
        calls = []

        class Client:
            def call(self, method, payload):
                calls.append(["call", method, payload])
                return {"initialized": True}

        monkeypatch.setattr(fw_runtime, "kernel_available", lambda *a: True)
        monkeypatch.setattr(manager, "health",
                            lambda cfg: calls.append(["health"]))
        monkeypatch.setattr(manager, "ensure_running",
                            lambda cfg: calls.append(["ensure_running"]))
        monkeypatch.setattr(manager, "admin_client", lambda cfg, **kw: (
            calls.append(["admin_client", kw]) or Client()))
        settings = config.Settings()
        for other in ("control_plane", "firewall", "host_proxy"):
            getattr(settings, other).enable = other == section
        bootstrap.pre_start_services(SimpleNamespace(settings=settings),
                                     None, "cid")
        return calls

    want = run(ref_bootstrap, ref_config, ref_manager, ref_fw_runtime)
    got = run(port_bootstrap, port_config, port_manager, port_fw_runtime)
    assert got == want
    assert got == ([["ensure_running"]] if section == "control_plane" else
                   [["health"], ["ensure_running"],
                    ["admin_client", {"ensure_material": True}],
                    ["call", "FirewallInit", {}]])


def test_pre_start_services_start_the_ports_host_proxy(tmp_path):
    """``host_proxy.enable`` (the default) starts the port's proxy, and a
    second start finds it up."""
    tenv, proj = _env(tmp_path, "port")
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free = s.getsockname()[1]
        tenv.write_settings(_settings(
            f"host_proxy:\n  enable: true\n  port: {free}\n"))
        cfg = port_config.load_config(proj)
        try:
            port_bootstrap.pre_start_services(cfg, None, "cid")
            pid = int((cfg.state_dir / "hostproxy.pid").read_text())
            port_bootstrap.pre_start_services(cfg, None, "cid")
            assert int((cfg.state_dir / "hostproxy.pid").read_text()) == pid
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            assert cmd.endswith(b"-m\0clawker_tpu_torch.hostproxy\0")
        finally:
            assert port_manager.stop(cfg)
    finally:
        tenv.__exit__(None, None, None)


def test_post_start_takes_the_degraded_socket_bridge_path():
    """An engine the bridge cannot reach takes the reference's degraded
    path: the same ``socketbridge_unavailable`` warning, no raise."""
    seen: list[list[str]] = []
    for bootstrap, config in ((ref_bootstrap, ref_config),
                              (port_bootstrap, port_config)):
        settings = config.Settings()
        settings.host_proxy.enable = False
        cfg = SimpleNamespace(settings=settings)
        bootstrap.pre_start_services(cfg, None, "cid")
        lines: list[str] = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = lambda rec, lines=lines: lines.append(rec.getMessage())
        bootstrap.log.addHandler(handler)
        try:
            bootstrap.post_start_services(cfg, None, "cid-1")
        finally:
            bootstrap.log.removeHandler(handler)
        seen.append(lines)
    assert seen[1] == seen[0] == [
        "event=socketbridge_unavailable container=cid-1 error='NoneType' "
        "object has no attribute 'engine'"]


@pytest.mark.parametrize("hostproxy,monitoring", [(True, False),
                                                  (False, True)])
def test_local_side_channels_match_reference(hostproxy, monitoring,
                                             tmp_path):
    def channels(m, cfgmod):
        settings = cfgmod.Settings()
        settings.host_proxy.enable = hostproxy
        settings.monitoring.enable = monitoring
        engine = SimpleNamespace()
        return dataclasses.asdict(m.open_side_channels(
            engine, SimpleNamespace(settings=settings)))

    assert channels(port_channels, port_config) == \
        channels(ref_channels, ref_config)

    def remote(m, cfgmod, drivers, transport):
        """A fake engine dressed as a remote worker (an SSH transport
        over the scripted runner); the proxy stays off, so nothing
        spawns it here."""
        settings = cfgmod.Settings()
        settings.host_proxy.enable = False
        settings.monitoring.enable = monitoring
        engine = drivers.FakeDriver().engine()
        runner = transport.FakeRunner()
        engine.transport = transport.SSHTransport(
            settings.runtime.tpu, "10.0.0.7", 0, mux_dir=tmp_path / "mux",
            runner=runner)
        ch = m.open_side_channels(engine, SimpleNamespace(settings=settings))
        return dataclasses.asdict(ch), [a[-2] for a in runner.spawned]

    got = remote(port_channels, port_config, port_drivers, port_transport)
    assert got == remote(ref_channels, ref_config, ref_drivers, ref_transport)
    assert got[0]["remote"]
    assert len(got[1]) == (2 if monitoring else 0)
