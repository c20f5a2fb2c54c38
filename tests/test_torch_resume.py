"""The port's ``--resume`` path against the reference's.

Twins of tests/test_loop_resume.py: the run journal's replay, the
crash-resume torture cases (kill the scheduler post-journal/pre-create,
post-create/pre-start and mid-wait, then ``LoopScheduler.resume`` +
``reconcile``), the warm-pool crash seams, the wedged-lane retirement,
the two-stage Ctrl-C and ``loop --resume``.  Each twin runs the
reference test's scenario through ``clawker_tpu`` and then through
``clawker_tpu_torch`` (tests/test_torch_warmpool.py's ``twin``: one run
id, each package its own fake pod and ``TestEnv``, the host proxy off)
and holds the two to the same statuses, exit codes, reconcile
summaries, journal record kinds and counts and engine call counts; each
side must hold the reference test's own assertions.

Besides: ``journal verify [--repair]`` on clean, torn and bit-flipped
journals against the reference verb; and ``loop --resume`` with ``CLAWKER_TORCH_DEVICE=cuda`` and no GPU exits 1
before it reconciles (the journal gains no record).
"""

from __future__ import annotations

import json
import shutil
import threading
import time

import pytest
from click.testing import CliRunner

import clawker_tpu.cli.cmd_loop as ref_cmd_loop
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu_torch.cli as port_cli
from test_torch_warmpool import (
    PKGS,
    PROJECT,
    IMAGE,
    RUN_ID,
    driver_with,
    journal_of,
    kind_counts,
    scheduler,
    side,
    total_creates,
    twin,
    wait_for,
)

CLI = {"ref": (ref_root.cli, ref_factory.Factory, ["--no-daemon",
                                                   "--no-workerd"]),
       "port": (port_cli.cli, port_cli.Factory, [])}


def fast_health(m):
    return m.health.HealthConfig(
        probe_interval_s=0.05, probe_deadline_s=0.5,
        breaker=m.health.BreakerConfig(failure_threshold=2,
                                       backoff_base_s=0.05,
                                       backoff_max_s=0.2))


def hold_behavior(hold: threading.Event):
    """Container process that blocks until ``hold`` is set, then exits
    0; once released, later iterations exit immediately."""
    def run(io) -> int:
        if not hold.is_set():
            hold.wait(20.0)
        return 0

    return run


def resume_from(s, drv, sched1, **kw):
    image = s.m.journal.replay(journal_of(s, sched1))
    return s.m.loop.LoopScheduler.resume(s.cfg, drv, image, **kw)


def total_starts(drv) -> int:
    return sum(len(api.calls_named("container_start")) for api in drv.apis)


def run_thread(sched) -> threading.Thread:
    t = threading.Thread(target=sched.run, kwargs={"poll_s": 0.05},
                         daemon=True)
    t.start()
    return t


def loop_rows(loops) -> list[tuple]:
    return [(l.agent, l.status, l.iteration, list(l.exit_codes))
            for l in loops]


def pool_container_labels(m, loop_id: str, pool_agent: str) -> dict:
    return {m.consts.LABEL_MANAGED: m.consts.MANAGED_VALUE,
            m.consts.LABEL_LOOP: loop_id,
            m.consts.LABEL_LOOP_EPOCH: m.consts.POOL_EPOCH,
            m.consts.LABEL_WARMPOOL: pool_agent}


def header(s, sched1, drv) -> None:
    """The run header ``start()`` would journal, written by hand."""
    sched1._journal("run", run=sched1.loop_id, project=PROJECT,
                    spec=sched1._spec_doc(),
                    workers=[w.id for w in drv.workers()])


# ------------------------------------------------------------------ journal


def test_journal_records_and_replay_roundtrip(tmp_path):
    def scenario(s):
        drv = driver_with(s.m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=2)
        sched.start()
        sched.run(poll_s=0.05)
        recs = journal_of(s, sched)
        head = next(r for r in recs if r["kind"] == "run")
        img = s.m.journal.replay(recs)
        li = img.loops[sched.loops[0].agent]
        sched.cleanup(remove_containers=True)
        return ([r["kind"] for r in recs],
                [r["seq"] for r in recs] == sorted(r["seq"] for r in recs),
                head["project"], head["spec"]["parallel"],
                head["spec"]["iterations"], img.run_id == sched.loop_id,
                (li.status, li.iteration, li.exit_codes),
                img.clean_shutdown)

    want, got = twin(tmp_path, scenario)
    assert got == want
    for kind in ("run", "placement", "created", "started", "exited",
                 "loop_end"):
        assert kind in got[0]
    assert got[1:] == (True, PROJECT, 1, 2, True, ("done", 2, [0, 0]),
                       False)


def test_journal_truncated_tail_and_garbage_tolerated(tmp_path):
    """A journal whose writer died mid-line replays everything before the
    torn record, in both packages."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1)
        sched.start()
        sched.run(poll_s=0.05)
        sched.cleanup(remove_containers=True)
        path = s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id)
        J = s.m.journal
        base = J.replay(J.RunJournal.read(path))
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('not json at all\n')
            fh.write('{"kind":"exited","agent":"loop-x","iteration":9,"co')
        img = J.replay(J.RunJournal.read(path))
        return (img.run_id == base.run_id,
                {a: l.status for a, l in img.loops.items()},
                {a: l.status for a, l in base.loops.items()})

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] and got[1] == got[2]


def _reopen(m, path):
    j1 = m.journal.RunJournal(path)
    j1.append("run", run="r")
    j1.append("placement", agent="a", worker="w0", epoch=0)
    j1.append("started", agent="a", worker="w0", iteration=4)
    j1.close()
    j2 = m.journal.RunJournal(path)      # generation 1 picks the run up
    j2.append("resume", generation=1)
    j2.append("exited", agent="a", iteration=4, code=0)
    j2.close()
    recs = m.journal.RunJournal.read(path)
    img = m.journal.replay(recs)
    return ([r["seq"] for r in recs], img.loops["a"].iteration,
            img.loops["a"].started, img.loops["a"].exit_codes)


def test_journal_seq_continues_across_reopen(tmp_path):
    want = _reopen(PKGS["ref"], tmp_path / "ref.journal")
    got = _reopen(PKGS["port"], tmp_path / "port.journal")
    assert got == want
    seqs = got[0]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert got[1:] == (5, False, [0])


def test_journal_degrades_to_noop_on_unwritable_dir(tmp_path):
    out = []
    for pkg, m in PKGS.items():
        blocker = tmp_path / f"blocker-{pkg}"
        blocker.write_text("a file where the runs dir should be")
        j = m.journal.RunJournal(blocker / "sub" / "x.journal")
        j.append("run", run="x")         # must not raise
        out.append(j.dropped)
        j.close()
    assert out == [1, 1]


def test_double_resume_no_double_accounting(tmp_path):
    """Resume-of-a-resume: generation 1 dies too (right after its
    reconcile journaled adoptions); generation 2 still accounts every
    exit exactly once."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
        sched1 = scheduler(s, drv, parallel=2, iterations=2)
        sched1.start()
        t = run_thread(sched1)
        assert wait_for(lambda: all(l.status == "running"
                                    for l in sched1.loops))
        sched1.kill()
        t.join(10.0)
        sched2 = resume_from(s, drv, sched1)
        first = sched2.reconcile()
        sched2.kill()
        hold.set()
        assert wait_for(lambda: all(
            c.state == "exited"
            for api in drv.apis for c in api.containers.values()))
        sched3 = resume_from(s, drv, sched1)
        second = sched3.reconcile()
        loops = sched3.run(poll_s=0.05)
        recs = journal_of(s, sched3)
        out = (first, second, loop_rows(loops), total_creates(drv),
               kind_counts(recs))
        sched3.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    first, second, rows, creates, kinds = got
    assert first["adopted"] == 2 and second["exits_accounted"] == 2
    assert all(r[1:] == ("done", 2, [0, 0]) for r in rows)
    assert creates == 2 and kinds["resume"] == 2


def test_resume_does_not_bill_drain_halted_iteration(tmp_path):
    """An iteration the drain itself halted (docker-stop kill code) is
    RE-RUN on resume, not accounted as a failed exit."""
    def scenario(s):
        hold = threading.Event()

        def beh(io) -> int:
            while not hold.is_set():
                if io.kill_event.wait(0.05):
                    return 137      # what a docker stop looks like
            return 0

        drv = driver_with(s.m, 1, behavior=beh)
        sched1 = scheduler(s, drv, parallel=1, iterations=2)
        sched1.start()
        t = run_thread(sched1)
        assert wait_for(lambda: sched1.loops
                        and sched1.loops[0].status == "running")
        sched1.request_shutdown("sigint")
        t.join(10.0)
        status1 = sched1.loops[0].status
        sched1.cleanup()
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        hold.set()
        loops = sched2.run(poll_s=0.05)
        out = (status1, summary, loop_rows(loops),
               loops[0].consecutive_failures)
        sched2.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    status1, summary, rows, failures = got
    assert status1 == "stopped" and summary["exits_accounted"] == 0
    assert rows[0][1:] == ("done", 2, [0, 0]) and failures == 0


# --------------------------------------------------- crash-resume torture


def test_resume_adopts_running_containers_mid_wait_kill(tmp_path):
    """kill -9 mid-wait on the 8-loop/4-worker pod: resume adopts all
    still-running containers (no restart, no duplicate create) and every
    loop completes its budget."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 4, behavior=hold_behavior(hold))
        sched1 = scheduler(s, drv, parallel=8, iterations=2)
        sched1.start()
        t = run_thread(sched1)
        assert wait_for(lambda: all(l.status == "running"
                                    for l in sched1.loops))
        creates_at_kill, starts_at_kill = total_creates(drv), total_starts(drv)
        sched1.kill()
        t.join(10.0)
        running = sum(1 for api in drv.apis for c in api.containers.values()
                      if c.state == "running")
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        after = (total_creates(drv) - creates_at_kill,
                 total_starts(drv) - starts_at_kill,
                 [l.status for l in sched2.loops])
        t2 = run_thread(sched2)
        time.sleep(0.2)
        hold.set()
        t2.join(15.0)
        recs = journal_of(s, sched2)
        out = (creates_at_kill, running, sched2.loop_id == sched1.loop_id,
               summary, after, loop_rows(sched2.loops), total_creates(drv),
               kind_counts(recs)["adopted"], kind_counts(recs)["resume"])
        sched2.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    creates, running, same_id, summary, after, rows = got[:6]
    assert creates == 8 and running == 8 and same_id
    assert summary["adopted"] == 8
    assert after == (0, 0, ["running"] * 8)
    assert all(r[1:] == ("done", 2, [0, 0]) for r in rows)
    assert got[6:] == (8, 8, 1)


def test_resume_relaunches_journaled_but_never_created(tmp_path):
    """crash point: post-journal / pre-create.  Resume re-launches every
    slot with exactly one create per agent."""
    def scenario(s):
        drv = driver_with(s.m, 4)
        sched1 = scheduler(s, drv, parallel=8, iterations=1)
        originals = [api.container_create for api in drv.apis]

        def crash_create(name, config):
            sched1.kill()
            raise s.m.errors.DriverError(
                "injected: killed before create reached daemon")

        for api in drv.apis:
            api.container_create = crash_create
        sched1.start()
        assert wait_for(sched1._stop.is_set)
        time.sleep(0.1)     # the lanes drain their guarded no-op tasks
        for api, orig in zip(drv.apis, originals):
            api.container_create = orig
        before = total_creates(drv)
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        loops = sched2.run(poll_s=0.05)
        names = sorted(a[0] for api in drv.apis
                       for a, _k in api.calls_named("container_create"))
        sched2.cleanup(remove_containers=True)
        return before, summary, loop_rows(loops), names

    want, got = twin(tmp_path, scenario)
    assert got == want
    before, summary, rows, names = got
    assert before == 0 and summary["relaunched"] == 8
    assert all(r[1:] == ("done", 1, [0]) for r in rows)
    assert len(names) == 8 and len(set(names)) == 8


def test_resume_finishes_created_but_never_started(tmp_path):
    """crash point: post-create / pre-start.  Resume starts the created
    containers WITHOUT a second create."""
    def scenario(s):
        drv = driver_with(s.m, 4)
        sched1 = scheduler(s, drv, parallel=8, iterations=1)

        def crash_start(cid):
            sched1.kill()
            raise s.m.errors.DriverError(
                "injected: killed before start reached daemon")

        for api in drv.apis:
            api.container_start = crash_start
        sched1.start()
        assert wait_for(sched1._stop.is_set)
        time.sleep(0.1)
        for api in drv.apis:
            del api.container_start      # restore the class method
        creates_before = total_creates(drv)
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        loops = sched2.run(poll_s=0.05)
        names = [a[0] for api in drv.apis
                 for a, _k in api.calls_named("container_create")]
        sched2.cleanup(remove_containers=True)
        return (creates_before, summary, [l[1:] for l in loop_rows(loops)],
                len(names), len(set(names)))

    want, got = twin(tmp_path, scenario)
    creates_before, summary, rows, n, distinct = got
    # how many lanes reached their create before the kill is a race of
    # each run's own lanes: the reconcile must account exactly those
    assert creates_before >= 1 and want[0] >= 1
    for side_ in (want, got):
        assert side_[1]["continued"] == side_[0]
        assert side_[1]["continued"] + side_[1]["relaunched"] == 8
        assert side_[1]["adopted"] == side_[1]["ghosts"] == 0
        assert side_[2] == [("done", 1, [0])] * 8
        assert side_[3] == side_[4] == 8


def test_resume_accounts_missed_exits_exactly_once(tmp_path):
    """crash point: mid-wait, with the exits landing while the scheduler
    is dead.  Resume accounts each started iteration exactly once."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 4, behavior=hold_behavior(hold))
        sched1 = scheduler(s, drv, parallel=8, iterations=2)
        sched1.start()
        t = run_thread(sched1)
        assert wait_for(lambda: all(l.status == "running"
                                    for l in sched1.loops))
        sched1.kill()
        t.join(10.0)
        hold.set()
        assert wait_for(lambda: all(
            c.state == "exited"
            for api in drv.apis for c in api.containers.values()))
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        loops = sched2.run(poll_s=0.05)
        out = (summary, loop_rows(loops), total_creates(drv),
               kind_counts(journal_of(s, sched2)))
        sched2.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    summary, rows, creates, kinds = got
    assert summary["exits_accounted"] == 8
    assert all(r[1:] == ("done", 2, [0, 0]) for r in rows)
    assert creates == 8 and kinds["exited"] == 16


def test_resume_sweeps_unjournaled_ghosts(tmp_path):
    """A container carrying this run's loop label that no journaled
    placement claims is swept."""
    def scenario(s):
        m = s.m
        hold = threading.Event()
        drv = driver_with(m, 2, behavior=hold_behavior(hold))
        sched1 = scheduler(s, drv, parallel=2, iterations=1)
        sched1.start()
        t = run_thread(sched1)
        assert wait_for(lambda: all(l.status == "running"
                                    for l in sched1.loops))
        sched1.kill()
        t.join(10.0)
        ghost_id = drv.apis[0].add_container(
            f"clawker.{PROJECT}.intruder",
            labels={m.consts.LABEL_MANAGED: m.consts.MANAGED_VALUE,
                    m.consts.LABEL_LOOP: sched1.loop_id}, state="exited")
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        swept = ghost_id not in drv.apis[0].containers
        journaled = any(r["kind"] == "ghost" and r["cid"] == ghost_id
                        for r in journal_of(s, sched2))
        hold.set()
        loops = sched2.run(poll_s=0.05)
        sched2.cleanup(remove_containers=True)
        return summary, swept, journaled, [l.status for l in loops]

    want, got = twin(tmp_path, scenario)
    assert got == want
    summary, swept, journaled, statuses = got
    assert summary["adopted"] == 2 and summary["ghosts"] == 1
    assert swept and journaled and statuses == ["done", "done"]


def test_resume_stale_epoch_copy_not_adopted(tmp_path):
    """A same-name container whose loop-epoch label predates the
    journaled placement is a superseded copy: swept and relaunched."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 1)
        sched1 = scheduler(s, drv, parallel=1, iterations=1)
        agent = f"loop-{sched1.loop_id[:6]}-0"
        sched1.loops.append(m.scheduler.AgentLoop(
            agent=agent, worker=drv.workers()[0], epoch=2))
        header(s, sched1, drv)
        sched1._journal("placement", agent=agent, worker="fake-0", epoch=2)
        sched1.journal.sync()
        stale = drv.apis[0].add_container(
            f"clawker.{PROJECT}.{agent}",
            labels={m.consts.LABEL_MANAGED: m.consts.MANAGED_VALUE,
                    m.consts.LABEL_LOOP: sched1.loop_id,
                    m.consts.LABEL_LOOP_EPOCH: "0"},
            state="running")
        sched1.kill()
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        gone = stale not in drv.apis[0].containers
        loops = sched2.run(poll_s=0.05)
        sched2.cleanup(remove_containers=True)
        return summary, gone, loop_rows(loops)

    want, got = twin(tmp_path, scenario)
    assert got == want
    summary, gone, rows = got
    assert summary["relaunched"] == 1 and summary["ghosts"] == 1 and gone
    assert rows[0][1:] == ("done", 1, [0])


def test_resume_dead_worker_flows_into_failover(tmp_path):
    """Loops journaled onto a worker the current fleet no longer has
    flow through the breaker/failover machinery onto a live worker."""
    records = [
        {"kind": "run", "seq": 1, "run": "deadbeefcafe",
         "project": PROJECT,
         "spec": {"parallel": 1, "iterations": 2, "failover": "migrate",
                  "image": "@", "agent_prefix": "loop"},
         "workers": ["gone-0"]},
        {"kind": "placement", "seq": 2, "agent": "loop-deadbe-0",
         "worker": "gone-0", "epoch": 0},
    ]

    def scenario(s):
        drv = driver_with(s.m, 1)
        image = s.m.journal.replay(records)
        sched = s.m.loop.LoopScheduler.resume(
            s.cfg, drv, image, health_config=fast_health(s.m))
        sched.orphan_grace_s = 10.0
        summary = sched.reconcile()
        loops = sched.run(poll_s=0.05)
        out = (summary, loop_rows(loops), loops[0].worker.id,
               loops[0].migrations >= 1)
        sched.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == {"adopted": 0, "continued": 0, "relaunched": 0,
                      "exits_accounted": 0, "ghosts": 0, "orphaned": 0,
                      "pool_restored": 0}
    assert got[1][0][1:3] == ("done", 2)
    assert got[2:] == ("fake-0", True)


def test_resume_after_clean_drain_continues_budget(tmp_path):
    """request_shutdown journals a durable shutdown record; resume picks
    the stopped loops back up and drives them to their budget."""
    def scenario(s):
        drv = driver_with(s.m, 2, behavior=s.m.fake.exit_behavior(
            b"", 0, delay=0.05))
        sched1 = scheduler(s, drv, parallel=2, iterations=3)
        sched1.start()
        t = run_thread(sched1)
        assert wait_for(lambda: all(l.iteration >= 1 for l in sched1.loops))
        sched1.request_shutdown("sigint")
        t.join(10.0)
        drained = all(l.status in ("stopped", "done") for l in sched1.loops)
        sched1.cleanup()
        image = s.m.journal.replay(journal_of(s, sched1))
        sched2 = s.m.loop.LoopScheduler.resume(s.cfg, drv, image)
        sched2.reconcile()
        loops = sched2.run(poll_s=0.05)
        out = (drained, image.clean_shutdown,
               [(l.status, l.iteration, len(l.exit_codes)) for l in loops])
        sched2.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, True, [("done", 3, 3)] * 2)


# ----------------------------------------------- warm-pool crash seams


def test_resume_restores_pool_members_after_kill(tmp_path):
    """kill mid-run with filled pools: resume restores every
    journaled-ready member still ``created`` -- zero engine mutations --
    and drains them all at cleanup."""
    def scenario(s):
        m = s.m
        hold = threading.Event()
        drv = driver_with(m, 2, behavior=hold_behavior(hold))
        sched1 = scheduler(s, drv, parallel=2, iterations=1,
                           warm_pool_depth=1)
        sched1.start()
        t = run_thread(sched1)
        assert wait_for(lambda: all(l.status == "running"
                                    for l in sched1.loops))
        assert wait_for(lambda: all(sched1.warmpool.depth_of(w.id) == 1
                                    for w in drv.workers()))
        sched1.kill()
        t.join(10.0)
        image = m.journal.replay(journal_of(s, sched1))
        ready = sorted(a for a, p in image.pool.items()
                       if p.state == "ready")
        creates_at_kill = total_creates(drv)
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        after = (total_creates(drv) - creates_at_kill,
                 [sched2.warmpool.depth_of(w.id) for w in drv.workers()],
                 sched2.warmpool.stats())
        t2 = run_thread(sched2)
        time.sleep(0.2)
        hold.set()
        t2.join(15.0)
        statuses = [l.status for l in sched2.loops]
        sched2.cleanup(remove_containers=True)
        leaked = [c for api in drv.apis for c in api.containers.values()
                  if (c.config.get("Labels") or {}).get(m.consts.LABEL_LOOP)
                  == sched1.loop_id]
        return ready, summary, after, statuses, leaked

    want, got = twin(tmp_path, scenario)
    assert got == want
    ready, summary, after, statuses, leaked = got
    assert len(ready) == 2
    assert summary["adopted"] == 2 and summary["pool_restored"] == 2
    assert summary["ghosts"] == 0
    assert after[:2] == (0, [1, 1])
    assert statuses == ["done", "done"] and leaked == []


def test_resume_restores_member_from_midrefill_kill(tmp_path):
    """crash point: mid-refill -- the create reached the daemon, the
    scheduler died before journaling pool_ready.  The member is
    restored and the relaunched placement ADOPTS it."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 1)
        sched1 = scheduler(s, drv, parallel=1, iterations=1,
                           warm_pool_depth=1)
        agent = f"loop-{sched1.loop_id[:6]}-0"
        pool_agent = f"pool-{sched1.loop_id[:6]}-p1"
        header(s, sched1, drv)
        sched1._journal("placement", agent=agent, worker="fake-0", epoch=0)
        sched1._journal("pool_add", agent=pool_agent, worker="fake-0")
        cid = drv.apis[0].add_container(
            f"clawker.{PROJECT}.{pool_agent}", image=IMAGE,
            labels=pool_container_labels(m, sched1.loop_id, pool_agent),
            state="created")
        sched1.journal.sync()
        sched1.kill()
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        loops = sched2.run(poll_s=0.05)
        names = [a[0] for a, _k in drv.apis[0].calls_named(
            "container_create")]
        out = (summary, loop_rows(loops),
               names.count(f"clawker.{PROJECT}.{agent}"),
               names.count(f"clawker.{PROJECT}.{pool_agent}"),
               drv.apis[0].containers[cid].name
               == f"clawker.{PROJECT}.{agent}",
               sched2.warmpool.stats()["hits"])
        sched2.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    summary, rows = got[:2]
    assert summary["pool_restored"] == 1 and summary["relaunched"] == 1
    assert summary["ghosts"] == 0
    assert rows[0][1:] == ("done", 1, [0])
    assert got[2:] == (0, 0, True, 1)


def test_resume_sweeps_half_adopted_pool_member(tmp_path):
    """crash point: mid-adoption -- pool_adopt journaled, the finalize
    died before the rename.  The member is consumed, its container swept
    as a ghost exactly once (counted in loop_ghosts_swept_total), and the
    placement relaunches cold with one create."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 1)
        sched1 = scheduler(s, drv, parallel=1, iterations=1,
                           warm_pool_depth=1)
        agent = f"loop-{sched1.loop_id[:6]}-0"
        pool_agent = f"pool-{sched1.loop_id[:6]}-p1"
        header(s, sched1, drv)
        sched1._journal("placement", agent=agent, worker="fake-0", epoch=0)
        sched1._journal("pool_add", agent=pool_agent, worker="fake-0")
        cid = drv.apis[0].add_container(
            f"clawker.{PROJECT}.{pool_agent}", image=IMAGE,
            labels=pool_container_labels(m, sched1.loop_id, pool_agent),
            state="created")
        sched1._journal("pool_ready", agent=pool_agent, worker="fake-0",
                        cid=cid)
        sched1._journal("pool_adopt", agent=pool_agent, worker="fake-0",
                        cid=cid, by=agent, epoch=0)
        sched1.journal.sync()
        sched1.kill()
        n_at_kill = len(journal_of(s, sched1))
        ghosts_before = m.scheduler._GHOSTS.labels("fake-0").peek()
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        swept = (cid not in drv.apis[0].containers,
                 m.scheduler._GHOSTS.labels("fake-0").peek()
                 - ghosts_before)
        loops = sched2.run(poll_s=0.05)
        names = [a[0] for a, _k in drv.apis[0].calls_named(
            "container_create")]
        reused = any(r["kind"] == "pool_ready" and r.get("cid") == cid
                     for r in journal_of(s, sched2)[n_at_kill:])
        sched2.cleanup(remove_containers=True)
        return (summary, swept, loop_rows(loops),
                names.count(f"clawker.{PROJECT}.{agent}"), reused)

    want, got = twin(tmp_path, scenario)
    assert got == want
    summary, swept, rows, creates, reused = got
    assert summary["ghosts"] == 1 and summary["pool_restored"] == 0
    assert summary["relaunched"] == 1
    assert swept == (True, 1)
    assert rows[0][1:] == ("done", 1, [0])
    assert creates == 1 and not reused


def test_resume_sweeps_stale_pool_member_started(tmp_path):
    """A journaled-ready member no longer ``created`` is stale: never
    restored, journaled pool_remove, swept as a ghost."""
    def scenario(s):
        m = s.m
        hold = threading.Event()
        drv = driver_with(m, 1, behavior=hold_behavior(hold))
        sched1 = scheduler(s, drv, parallel=1, iterations=1,
                           warm_pool_depth=1)
        pool_agent = f"pool-{sched1.loop_id[:6]}-p1"
        header(s, sched1, drv)
        sched1._journal("pool_add", agent=pool_agent, worker="fake-0")
        cid = drv.apis[0].add_container(
            f"clawker.{PROJECT}.{pool_agent}", image=IMAGE,
            labels=pool_container_labels(m, sched1.loop_id, pool_agent),
            state="running")
        sched1._journal("pool_ready", agent=pool_agent, worker="fake-0",
                        cid=cid)
        sched1.journal.sync()
        sched1.kill()
        hold.set()
        ghosts_before = m.scheduler._GHOSTS.labels("fake-0").peek()
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        out = (summary, cid not in drv.apis[0].containers,
               m.scheduler._GHOSTS.labels("fake-0").peek() - ghosts_before,
               any(r["kind"] == "pool_remove"
                   and r.get("reason") == "stale at resume"
                   for r in journal_of(s, sched2)))
        loops = sched2.run(poll_s=0.05)
        sched2.cleanup(remove_containers=True)
        return out + (loop_rows(loops),)

    want, got = twin(tmp_path, scenario)
    assert got == want
    summary = got[0]
    assert summary["pool_restored"] == 0 and summary["ghosts"] == 1
    assert got[1:4] == (True, 1, True)


def test_resume_pending_pool_member_never_created_is_noop(tmp_path):
    """crash point: post-pool_add / pre-create: resume neither restores
    nor sweeps anything for the reservation."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        sched1 = scheduler(s, drv, parallel=1, iterations=1,
                           warm_pool_depth=1)
        header(s, sched1, drv)
        sched1._journal("pool_add", agent=f"pool-{sched1.loop_id[:6]}-p1",
                        worker="fake-0")
        sched1.journal.sync()
        sched1.kill()
        sched2 = resume_from(s, drv, sched1)
        summary = sched2.reconcile()
        loops = sched2.run(poll_s=0.05)
        sched2.cleanup(remove_containers=True)
        return summary, loop_rows(loops)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0]["pool_restored"] == 0 and got[0]["ghosts"] == 0


# ------------------------------------------------- satellites: lane + CLI


def test_lane_retired_at_breaker_close(tmp_path):
    """A lane wedged inside a call is RETIRED at breaker close, so
    resumed launches run on a fresh thread."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1)
        worker = drv.workers()[0]
        blocked, release = threading.Event(), threading.Event()

        def wedge():
            blocked.set()
            release.wait(10.0)

        old_lane = sched._lane(worker)
        old_lane.submit(wedge)
        assert blocked.wait(2.0)
        sched._verdicts.put((worker.id, m.health.BREAKER_OPEN,
                             m.health.BREAKER_CLOSED, "recovered"))
        sched._drain_verdicts()
        retired = sched._lanes.get(worker.id) is not old_lane
        ran = threading.Event()
        sched._lane(worker).submit(ran.set)
        out = (retired, ran.wait(2.0), release.is_set())
        release.set()
        sched.cleanup()
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, True, False)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_two_stage_sigint_drains_then_hard_exits(monkeypatch, pkg, capsys):
    mod = ref_cmd_loop if pkg == "ref" else port_cli.cmd_loop
    exits = []
    monkeypatch.setattr(mod, "_hard_exit", exits.append)

    class SchedStub:
        loop_id = "abc123def"

        def __init__(self):
            self.requests = []

        def request_shutdown(self, reason):
            self.requests.append(reason)

    stub = SchedStub()
    handler = mod._TwoStageInterrupt(stub)
    handler()
    assert stub.requests == ["sigint"] and not exits
    # the first interrupt names the resume of this run
    assert "--resume abc123def" in capsys.readouterr().err
    handler()
    assert exits == [130]
    assert stub.requests == ["sigint"]   # the drain fired exactly once


def _cli(pkg, s, drv, args, monkeypatch, device="cpu"):
    root, factory, extra = CLI[pkg]
    if pkg == "port":
        monkeypatch.setenv(port_cli.DEVICE_ENV, device)
    return CliRunner().invoke(root, [*args, *extra] if args[0] == "loop"
                              else args,
                              obj=factory(cwd=s.proj, driver=drv),
                              catch_exceptions=False)


def _killed_run(s, drv):
    """A 2-loop run killed while both containers run: -> its scheduler."""
    sched1 = scheduler(s, drv, parallel=2, iterations=1)
    sched1.start()
    t = run_thread(sched1)
    assert wait_for(lambda: all(l.status == "running"
                                for l in sched1.loops))
    sched1.kill()
    t.join(10.0)
    return sched1


def test_cli_loop_resume_end_to_end(tmp_path, monkeypatch):
    """``loop --resume <prefix> --json`` adopts a killed run's containers
    and exits 0 with every loop done, with no second create."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path) as s:
            hold = threading.Event()
            drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
            sched1 = _killed_run(s, drv)
            hold.set()
            res = _cli(pkg, s, drv, ["loop", "--resume", sched1.loop_id[:6],
                                     "--json"], monkeypatch)
            doc = json.loads(res.stdout)
            summary = next(line for line in res.stderr.splitlines()
                           if line.startswith("resume:"))
            out.append((res.exit_code, doc["loop_id"] == sched1.loop_id,
                        [(a["status"], a["exit_codes"])
                         for a in doc["agents"]],
                        total_creates(drv), summary,
                        "(resumed)" in res.stderr))
    want, got = out
    assert got == want
    assert got[0] == 0 and got[1]
    assert got[2] == [("done", [0])] * 2 and got[3] == 2 and got[5]


@pytest.mark.parametrize("args,needle", [
    (["--resume", "nosuchrun"], "no run journal"),
    (["--resume", "abc", "--daemon"], "--daemon cannot combine"),
], ids=["unknown", "daemon"])
def test_cli_loop_resume_errors_as_the_reference(tmp_path, monkeypatch,
                                                 args, needle):
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path) as s:
            drv = driver_with(s.m, 1)
            root, factory, _ = CLI[pkg]
            if pkg == "port":
                monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
            res = CliRunner().invoke(root, ["loop", *args],
                                     obj=factory(cwd=s.proj, driver=drv))
            out.append((res.exit_code, needle in res.output,
                        total_creates(drv)))
    assert out[1] == out[0] == (1, True, 0)


def test_cli_loop_resume_without_a_gpu_exits_before_reconcile(
        tmp_path, monkeypatch):
    """The resumed run's rider asks for the card: with none, ``loop
    --resume`` exits 1 before it reconciles -- no record lands in the
    journal and the engine sees no call."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with side("port", tmp_path) as s:
        hold = threading.Event()
        drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
        sched1 = _killed_run(s, drv)
        n_records = len(journal_of(s, sched1))
        calls = sum(len(api.calls) for api in drv.apis)
        res = _cli("port", s, drv, ["loop", "--resume", sched1.loop_id],
                   monkeypatch, device="cuda")
        hold.set()
        assert res.exit_code == 1, res.output
        assert "loop:" in res.output and "cpu" in res.output
        assert len(journal_of(s, sched1)) == n_records
        assert sum(len(api.calls) for api in drv.apis) == calls


# ------------------------------------------------------ journal verify


def _verify(pkg, s, run, monkeypatch, *extra):
    return _cli(pkg, s, None, ["journal", "verify", run, *extra],
                monkeypatch)


def _finished_run(s):
    drv = driver_with(s.m, 1)
    sched = scheduler(s, drv, parallel=1, iterations=2)
    sched.start()
    sched.run(poll_s=0.05)
    sched.cleanup(remove_containers=True)
    return s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id)


def _damage(path, how: str) -> None:
    data = bytearray(path.read_bytes())
    if how == "torn":
        path.write_bytes(bytes(data) + b'{"kind":"exited","agent":"lo')
    elif how == "bitflip":
        # one byte inside the third record's body: its checksum fails
        starts = [0] + [i + 1 for i, b in enumerate(data) if b == 0x0A]
        i = starts[2] + 3
        data[i] ^= 0x01
        path.write_bytes(bytes(data))


@pytest.mark.parametrize("how,code", [("clean", 0), ("torn", 0),
                                      ("bitflip", 2)])
def test_journal_verify_matches_reference(tmp_path, monkeypatch, how, code):
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path) as s:
            path = _finished_run(s)
            _damage(path, how)
            res = _verify(pkg, s, RUN_ID[:6], monkeypatch, "--json")
            doc = json.loads(res.stdout)
            out.append((res.exit_code,
                        {k: v for k, v in doc.items() if k != "path"}))
    assert out[1] == out[0]
    assert out[1][0] == code
    assert out[1][1]["torn_tail"] == (how == "torn")
    assert (out[1][1]["corrupt"] > 0) == (how == "bitflip")


def test_journal_verify_repair_makes_a_flipped_journal_resumable(
        tmp_path, monkeypatch):
    """``--repair`` quarantines the damaged line to a sidecar and
    rewrites the journal: the verdict turns clean, the text report
    matches the reference's, and the run resumes (``loop --resume``)."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path) as s:
            path = _finished_run(s)
            _damage(path, "bitflip")
            copy = path.with_name("copy.journal")
            shutil.copy(path, copy)
            res = _verify(pkg, s, str(copy), monkeypatch, "--repair")
            again = _verify(pkg, s, str(copy), monkeypatch)
            sidecar = copy.with_name(copy.name + ".quarantine")
            # the repaired journal is resumable; the damaged one resumes
            # from its verified prefix with a warning naming the verb
            warned = _cli(pkg, s, driver_with(s.m, 1),
                          ["loop", "--resume", str(path), "--json"],
                          monkeypatch)
            out.append((res.exit_code, res.stdout, again.exit_code,
                        len(sidecar.read_text().splitlines()),
                        warned.exit_code,
                        "journal verify" in warned.stderr))
    assert out[1] == out[0]
    assert out[1][0] == 0 and "repaired: kept" in out[1][1]
    assert out[1][2:] == (0, 1, 0, True)
