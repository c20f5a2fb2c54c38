"""The port's warm pool against the reference's.

Twins of tests/test_warmpool.py (all but the two ``fleet warmpool`` CLI
cases, whose verb waits for the fleet views: ROADMAP §1 item 13).  Each
twin runs the reference test's scenario through ``clawker_tpu`` and then
through ``clawker_tpu_torch``, each package on its own ``FakeDriver``
under its own ``TestEnv``, with one run id on both sides so pool member,
agent and container names agree.  They must give the same statuses,
``warmpool.stats()``, journal record kinds and counts, and engine call
counts, and each side must hold the reference test's own assertions.
The host proxy is off, as in tests/test_torch_loop.py: on a fake with
several workers the reference's lanes race two proxy spawns.

The pool's bookkeeping cases drive both ``WarmPool`` classes with the
same calls.  ``--warm-pool`` and settings ``loop.warm_pool`` run the CLI
of each package on the same fake pod.
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.consts as ref_consts
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.health as ref_health
import clawker_tpu.loop as ref_loop
import clawker_tpu.loop.journal as ref_journal
import clawker_tpu.loop.scheduler as ref_scheduler
import clawker_tpu.loop.warmpool as ref_warmpool
import clawker_tpu.placement.admission as ref_admission
import clawker_tpu.runtime.names as ref_names
import clawker_tpu.runtime.orchestrate as ref_orchestrate
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.health as port_health
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.loop.journal as port_journal
import clawker_tpu_torch.loop.scheduler as port_scheduler
import clawker_tpu_torch.loop.warmpool as port_warmpool
import clawker_tpu_torch.placement.admission as port_admission
import clawker_tpu_torch.runtime.names as port_names
import clawker_tpu_torch.runtime.orchestrate as port_orchestrate
from clawker_tpu.testenv import TestEnv

PROJECT = "loopproj"
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
        config=ref_config, consts=ref_consts, drivers=ref_drivers,
        fake=ref_fake, errors=ref_errors, health=ref_health, loop=ref_loop,
        journal=ref_journal, scheduler=ref_scheduler, warmpool=ref_warmpool,
        admission=ref_admission, names=ref_names,
        orchestrate=ref_orchestrate),
    "port": SimpleNamespace(
        config=port_config, consts=port_consts, drivers=port_drivers,
        fake=port_fake, errors=port_errors, health=port_health,
        loop=port_loop, journal=port_journal, scheduler=port_scheduler,
        warmpool=port_warmpool, admission=port_admission, names=port_names,
        orchestrate=port_orchestrate),
}


@contextlib.contextmanager
def side(pkg: str, tmp_path: Path, settings: str = ""):
    """One package's environment: -> namespace with ``m`` (the
    package's modules), ``cfg``, ``proj`` and ``pkg``."""
    with TestEnv(base=tmp_path / pkg) as tenv:
        tenv.write_settings(SETTINGS + settings)
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text(f"project: {PROJECT}\n")
        m = PKGS[pkg]
        yield SimpleNamespace(m=m, cfg=m.config.load_config(proj),
                              proj=proj, pkg=pkg)


def twin(tmp_path: Path, scenario, settings: str = ""):
    """``scenario(side)`` on the reference, then on the port: ->
    (reference's result, port's)."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, settings) as s:
            out.append(scenario(s))
    return tuple(out)


def driver_with(m, n_workers: int, behavior=None):
    drv = m.drivers.FakeDriver(n_workers=n_workers)
    for api in drv.apis:
        api.add_image(IMAGE)
        api.set_behavior(IMAGE, behavior
                         or m.fake.exit_behavior(b"iter done\n", 0))
    return drv


def wait_for(pred, timeout=10.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def total_creates(drv) -> int:
    return sum(len(api.calls_named("container_create")) for api in drv.apis)


def run_containers(m, drv, loop_id):
    return [c for api in drv.apis for c in api.containers.values()
            if (c.config.get("Labels") or {}).get(m.consts.LABEL_LOOP)
            == loop_id]


def journal_of(s, sched) -> list[dict]:
    # through the class: a reference test restores ``RunJournal.read``
    # as a plain function, which an instance would bind
    return s.m.journal.RunJournal.read(
        s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id))


def kind_counts(records: list[dict]) -> dict:
    return dict(collections.Counter(r["kind"] for r in records))


def scheduler(s, drv, **spec):
    return s.m.loop.LoopScheduler(s.cfg, drv, s.m.loop.LoopSpec(**spec),
                                  run_id=RUN_ID)


# ------------------------------------------------------------ bookkeeping


def _bookkeeping(m):
    journaled = []
    pool = m.warmpool.WarmPool(
        "abcdef123", depth=2,
        journal=lambda kind, **f: journaled.append((kind, f)))
    w = m.drivers.FakeDriver().workers()[0]
    a1 = pool.begin_refill(w)
    a2 = pool.begin_refill(w)
    out = [a1, a2, pool.begin_refill(w), pool.want(w.id),
           pool.fill_done(w, a1, "cid-1"), pool.fill_done(w, a2, "cid-2"),
           pool.depth_of(w.id)]
    e = pool.checkout(w.id, by="loop-x-0", epoch=0)
    out += [e.cid, pool.depth_of(w.id),
            pool.checkout(w.id, by="loop-x-1", epoch=0).cid,
            pool.checkout(w.id, by="loop-x-2", epoch=0)]
    return out, journaled, pool.stats()


def test_pool_bookkeeping_roundtrip():
    want, got = _bookkeeping(PKGS["ref"]), _bookkeeping(PKGS["port"])
    assert got == want
    out, journaled, stats = got
    assert out == ["pool-abcdef-p1", "pool-abcdef-p2", None, 0, True, True,
                   2, "cid-1", 1, "cid-2", None]
    J = port_journal
    assert [k for k, _f in journaled] == [
        J.REC_POOL_ADD, J.REC_POOL_ADD, J.REC_POOL_READY, J.REC_POOL_READY,
        J.REC_POOL_ADOPT, J.REC_POOL_ADOPT]
    assert stats["hits"] == 2 and stats["misses"] == 1
    assert stats["refills"] == 2


def _drain_then_fill(m):
    pool = m.warmpool.WarmPool("abcdef123", depth=1)
    w = m.drivers.FakeDriver().workers()[0]
    agent = pool.begin_refill(w)
    pool.begin_drain()
    return (pool.fill_done(w, agent, "cid-late"), pool.depth_of(w.id),
            pool.begin_refill(w), pool.stats())


def test_fill_completing_after_drain_is_discarded():
    want, got = _drain_then_fill(PKGS["ref"]), _drain_then_fill(PKGS["port"])
    assert got == want
    assert got[:3] == (False, 0, None)


def _failed_fill(m):
    pool = m.warmpool.WarmPool("abcdef123", depth=1)
    w = m.drivers.FakeDriver().workers()[0]
    agent = pool.begin_refill(w)
    return (pool.fill_done(w, agent, None, "engine exploded"),
            pool.depth_of(w.id), pool.want(w.id), pool.stats())


def test_failed_fill_releases_reservation():
    want, got = _failed_fill(PKGS["ref"]), _failed_fill(PKGS["port"])
    assert got == want
    assert got[:3] == (True, 0, 1)


def _restore_past_depth(m):
    pool = m.warmpool.WarmPool("abcdef123", depth=1)
    w = m.drivers.FakeDriver().workers()[0]
    return (pool.restore(w, "pool-abc-p1", "cid-1"),
            pool.restore(w, "pool-abc-p2", "cid-2"), pool.depth_of(w.id))


def test_restore_refuses_past_target_depth():
    want = _restore_past_depth(PKGS["ref"])
    got = _restore_past_depth(PKGS["port"])
    assert got == want == (True, False, 1)


def _expiry(m):
    now = [100.0]
    pool = m.warmpool.WarmPool("abcdef123", depth=2, max_age_s=10.0,
                               clock=lambda: now[0])
    w = m.drivers.FakeDriver().workers()[0]
    for cid in ("cid-1", "cid-2"):
        agent = pool.begin_refill(w)
        pool.fill_done(w, agent, cid)
    now[0] += 5.0
    early = pool.take_expired()
    now[0] += 6.0
    expired = sorted(e.cid for e in pool.take_expired())
    return early, expired, pool.depth_of(w.id), pool.stats()


def test_take_expired_recycles_members():
    want, got = _expiry(PKGS["ref"]), _expiry(PKGS["port"])
    assert got == want
    early, expired, depth, stats = got
    assert early == [] and expired == ["cid-1", "cid-2"] and depth == 0
    assert stats["recycled"] == 2


# ------------------------------------------------------- scheduler adoption


def test_scheduler_pool_hit_adopts_and_finalizes(tmp_path):
    """Prefilled pool: every placement adopts (hits == loops, zero
    misses), adopted containers end up under the REAL agent name with
    the agent's labels plus the pool-origin marker, and got the env
    fixup archive instead of create-time env."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 1)
        sched = scheduler(s, drv, parallel=2, iterations=1,
                          warm_pool_depth=2)
        prefilled = sched.prefill_pool(timeout=5.0)
        api = drv.apis[0]
        creates_prefill = len(api.calls_named("container_create"))
        sched.start()
        loops = sched.run(poll_s=0.05)
        stats = sched.warmpool.stats()
        adopted = []
        for l in sched.loops:
            c = api.containers[l.container_id]
            labels = c.config["Labels"]
            adopted.append((c.name == m.names.container_name(PROJECT,
                                                             l.agent),
                            labels[m.consts.LABEL_AGENT] == l.agent,
                            labels[m.consts.LABEL_WARMPOOL],
                            labels[m.consts.LABEL_LOOP_EPOCH]))
        fixups = [a for a, _k in api.calls_named("put_archive")
                  if a[1] == m.consts.RUN_STATE_DIR]
        kinds = kind_counts(journal_of(s, sched))
        sched.cleanup(remove_containers=True)
        return (prefilled, creates_prefill,
                [(l.status, l.iteration) for l in loops], stats,
                sorted(adopted), len(fixups), kinds,
                run_containers(m, drv, sched.loop_id),
                len(api.calls_named("container_create")))

    want, got = twin(tmp_path, scenario)
    assert got == want
    prefilled, creates, loops, stats, adopted, fixups = got[:6]
    assert prefilled == 2 and creates == 2
    assert loops == [("done", 1)] * 2
    assert stats["hits"] == 2 and stats["misses"] == 0
    assert all(a[:2] == (True, True) and a[2].startswith("pool-")
               and a[3] == "0" for a in adopted)
    assert fixups >= 2
    assert got[7] == []


def test_scheduler_refills_back_to_depth_during_run(tmp_path):
    """Checked-out members are replaced by the run-thread tick; drain
    at cleanup leaves zero pool containers even under --keep."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 2)
        sched = scheduler(s, drv, parallel=4, iterations=1,
                          warm_pool_depth=1)
        sched.start()
        loops = sched.run(poll_s=0.05)
        depths = [sched.warmpool.depth_of(w.id) for w in drv.workers()]
        sched.cleanup()                   # --keep shape: containers stay
        leftover = [c for c in run_containers(m, drv, sched.loop_id)
                    if m.consts.LABEL_WARMPOOL in (c.config.get("Labels")
                                                   or {})
                    and c.state == "created"]
        return ([l.status for l in loops], depths, leftover,
                sched.warmpool.draining)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[1] == [1, 1] and got[2] == [] and got[3] is True


def test_adoption_failure_falls_back_to_cold_create(tmp_path, monkeypatch):
    def failing(errors):
        def boom(self, cid, opts):
            raise errors.ClawkerError("injected: adoption fixup failed")
        return boom

    for m in PKGS.values():
        monkeypatch.setattr(m.orchestrate.AgentRuntime, "adopt_pooled",
                            failing(m.errors))

    def scenario(s):
        m = s.m
        drv = driver_with(m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1,
                          warm_pool_depth=1)
        prefilled = sched.prefill_pool(timeout=5.0)
        sched.start()
        loops = sched.run(poll_s=0.05)
        stats = sched.warmpool.stats()
        agent_name = m.names.container_name(PROJECT, sched.loops[0].agent)
        names = [a[0] for a, _k in drv.apis[0].calls_named(
            "container_create")]
        sched.cleanup(remove_containers=True)
        return (prefilled, loops[0].status, loops[0].iteration,
                stats["hits"], stats["recycled"] >= 1,
                names.count(agent_name),
                run_containers(m, drv, sched.loop_id))

    want, got = twin(tmp_path, scenario)
    assert got == want == (1, "done", 1, 1, True, 1, [])


def test_refill_skips_open_breaker_worker(tmp_path):
    """The tick never fills a quarantined worker's pool: a dead daemon
    must not eat refill creates (probes own the recovery signal)."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 2)
        sched = scheduler(s, drv, parallel=1, iterations=1,
                          warm_pool_depth=1)

        class HealthStub:
            def state(self, worker_id):
                return (m.health.BREAKER_OPEN if worker_id == "fake-1"
                        else m.health.BREAKER_CLOSED)

        sched.health = HealthStub()
        sched._pool_tick()
        filled = wait_for(lambda: sched.warmpool.depth_of("fake-0") == 1)
        time.sleep(0.1)
        out = (filled, sched.warmpool.depth_of("fake-1"),
               [len(api.calls_named("container_create"))
                for api in drv.apis])
        sched.cleanup(remove_containers=True)
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, 0, [1, 0])


def test_refill_admission_rejection_stops_tick(tmp_path):
    """A saturated admission pending queue rejects refills
    synchronously: one reservation attempted and released, not depth (3)
    or a spin of durable journal records."""
    def scenario(s):
        m = s.m
        drv = driver_with(m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1,
                          warm_pool_depth=3)
        rejections = []

        class SaturatedAdmission:
            def submit(self, worker_id, tenant, dispatch, *,
                       cancelled=None, on_cancel=None):
                rejections.append(worker_id)
                return m.admission.ADMISSION_REJECTED

        sched.admission = SaturatedAdmission()
        sched._pool_tick()
        adds = [r for r in journal_of(s, sched)
                if r.get("kind") == m.journal.REC_POOL_ADD]
        return (rejections, sched.warmpool.depth_of("fake-0"),
                sched.warmpool.stats()["workers"]["fake-0"]["inflight"],
                len(adds))

    want, got = twin(tmp_path, scenario)
    assert got == want == (["fake-0"], 0, 0, 1)


def test_pool_disabled_with_worktrees(tmp_path):
    """A pool member's mounts are staged before the adopting agent's
    worktree exists, so the reference keeps --worktrees runs cold (no
    pool).  The port refuses worktrees by name (ROADMAP §1 item 6) --
    the worktrees refusal, not a warm-pool one."""
    with side("ref", tmp_path) as s:
        sched = scheduler(s, driver_with(s.m, 1), parallel=1, iterations=1,
                          warm_pool_depth=2, worktrees=True)
        assert sched.warmpool is None
        sched.cleanup()
    with side("port", tmp_path) as s:
        with pytest.raises(port_errors.ConfigError,
                           match="worktrees.*not yet ported"):
            scheduler(s, driver_with(s.m, 1), parallel=1, iterations=1,
                      warm_pool_depth=2, worktrees=True)


# ------------------------------------------------------------- journal fold


def _fold(m, path: Path):
    j = m.journal.RunJournal(path)
    J = m.journal
    j.append("run", run="r1", project="p", spec={}, workers=["w0"])
    j.append(J.REC_POOL_ADD, agent="pool-r1-p1", worker="w0")
    j.append(J.REC_POOL_ADD, agent="pool-r1-p2", worker="w0")
    j.append(J.REC_POOL_ADD, agent="pool-r1-p3", worker="w0")
    j.append(J.REC_POOL_READY, agent="pool-r1-p1", worker="w0", cid="c1")
    j.append(J.REC_POOL_READY, agent="pool-r1-p2", worker="w0", cid="c2")
    j.append(J.REC_POOL_ADOPT, agent="pool-r1-p2", worker="w0", cid="c2",
             by="loop-r1-0", epoch=0)
    j.append(J.REC_POOL_REMOVE, agent="pool-r1-p1", worker="w0", cid="c1",
             reason="expired")
    j.close()
    img = J.replay(J.RunJournal.read(j.path))
    return ({a: (p.state, p.cid, p.adopted_by) for a, p in img.pool.items()},
            sorted(img.loops))


def test_journal_pool_records_fold_into_pool_image(tmp_path):
    want = _fold(PKGS["ref"], tmp_path / "ref.journal")
    got = _fold(PKGS["port"], tmp_path / "port.journal")
    assert got == want
    pool, loops = got
    assert pool["pool-r1-p1"][0] == "removed"
    assert pool["pool-r1-p2"][0] == "adopted"
    assert pool["pool-r1-p2"][2] == "loop-r1-0"
    assert pool["pool-r1-p3"][:2] == ("pending", "")
    # placeholder agents never materialize as loops
    assert not any(a.startswith("pool-") for a in loops)


# -------------------------------------------------------------- admission


def test_pool_tenant_registered_low_weight(tmp_path):
    """Refills bill the dedicated low-weight admission tenant, so the
    WFQ hands real placements a contended worker's tokens first."""
    def scenario(s):
        sched = scheduler(s, driver_with(s.m, 1), parallel=1, iterations=1,
                          warm_pool_depth=1)
        tenants = sched.admission.stats()["tenants"]
        out = (sched.warmpool.tenant, sched.warmpool.tenant
               == s.m.warmpool.POOL_TENANT,
               tenants[s.m.warmpool.POOL_TENANT]["weight"])
        sched.cleanup()
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[1] is True and got[2] < 1.0


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("args,settings", [
    (["--warm-pool", "1"], ""),
    ([], "loop:\n  warm_pool:\n    enable: true\n    depth: 2\n"),
], ids=["flag", "setting"])
def test_cli_loop_warm_pool_matches_reference(tmp_path, monkeypatch, args,
                                              settings):
    """``loop --warm-pool N`` and settings ``loop.warm_pool`` run pooled
    in both packages: the same rows, the journaled depth, refills and
    a drain in the journal, and no container left after the run."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, settings) as s:
            drv = driver_with(s.m, 2)
            argv = ["loop", "-p", "2", "-n", "2", *args, "--json"]
            if pkg == "ref":
                res = CliRunner().invoke(
                    ref_root.cli, [*argv, "--no-daemon", "--no-workerd"],
                    obj=ref_factory.Factory(cwd=s.proj, driver=drv),
                    catch_exceptions=False)
            else:
                monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
                res = CliRunner().invoke(
                    port_cli.cli, argv,
                    obj=port_cli.Factory(cwd=s.proj, driver=drv),
                    catch_exceptions=False)
            assert res.exit_code == 0, res.output
            doc = json.loads(res.stdout)
            records = s.m.journal.RunJournal.read(s.m.journal.journal_path(
                s.cfg.logs_dir, doc["loop_id"]))
            depth = next(r for r in records
                         if r["kind"] == "run")["spec"]["warm_pool_depth"]
            pool_kinds = sorted(r["kind"] for r in records
                                if r["kind"].startswith("pool_"))
            out.append(([(a["status"], a["iteration"], a["exit_codes"])
                         for a in doc["agents"]], depth,
                        # refills filled the pool; cleanup drained it
                        {"pool_add", "pool_remove"} <= set(pool_kinds),
                        [c["Names"][0] for api in drv.apis
                         for c in api.container_list(all=True)],
                        "warm-pool" in res.stderr))
    want, got = out
    assert got == want
    assert got[0] == [("done", 2, [0, 0])] * 2
    assert got[1] == (1 if args else 2)
    assert got[2:] == (True, [], True)
