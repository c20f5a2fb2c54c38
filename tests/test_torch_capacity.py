"""The port's elastic-capacity controller against the reference's.

Twins of tests/test_capacity.py.  The pure parts -- ``EwmaRate``,
``tokens_for`` and a controller driven by a fake clock over its own
metrics registry and fake admission rows -- are held to the reference
decision for decision (pool targets, token caps, shed modes, the
journal records and ``state()``), with hypothesis drawing the traffic.
The wired parts run in both packages on their own fake pod under the
chaos twins' ``TestEnv`` (tests/test_torch_chaos.py): the journal-gated
drain, a controller restored from a resumed run's journal,
``attach_capacity`` on a depth-0 run, ``make_scaler``, ``loop`` with
settings ``capacity.enable``, loopd's daemon-lifetime controller and
the chaos capacity scenario.
"""

from __future__ import annotations

import json

import pytest
from click.testing import CliRunner
from hypothesis import HealthCheck, given
from hypothesis import settings as hsettings
from hypothesis import strategies as st
from test_torch_chaos import (
    IMAGE,
    PKGS,
    RUN_ID,
    SETTINGS,
    driver_with,
    run_plan_twin,
    twin,
    wait_for,
)

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu_torch.cli as port_cli

WORKERS = ("w0", "w1")


# ---------------------------------------------------------- pure functions


@hsettings(max_examples=80, deadline=None)
@given(alpha_up=st.floats(0.0, 1.0), alpha_down=st.floats(0.0, 1.0),
       samples=st.lists(st.tuples(st.integers(0, 500),
                                  st.floats(-0.5, 5.0, allow_nan=False)),
                        max_size=30))
def test_ewma_rate_matches_reference(alpha_up, alpha_down, samples):
    ref = PKGS["ref"].capacity.EwmaRate(alpha_up, alpha_down)
    port = PKGS["port"].capacity.EwmaRate(alpha_up, alpha_down)
    for count, dt in samples:
        # repr: a zero-alpha blend of an overflowing rate is nan in both
        assert repr(port.observe(count, dt)) == repr(ref.observe(count, dt))
    assert repr(port.value) == repr(ref.value)


@hsettings(max_examples=200, deadline=None)
@given(queued=st.integers(-2, 200), inflight=st.integers(-2, 50),
       launch_s=st.floats(-0.1, 3.0, allow_nan=False),
       slo_s=st.floats(-0.5, 10.0, allow_nan=False),
       lo=st.integers(-1, 8), hi=st.integers(-1, 40))
def test_tokens_for_matches_reference(queued, inflight, launch_s, slo_s,
                                      lo, hi):
    def outcome(m):
        # a tiny positive SLO overflows ``math.ceil`` alike in both
        try:
            return m.capacity.tokens_for(queued, inflight, launch_s, slo_s,
                                         lo, hi)
        except OverflowError as e:
            return repr(e)

    assert outcome(PKGS["port"]) == outcome(PKGS["ref"])


def test_tokens_for_is_monotone_as_the_reference_sweeps():
    tokens_for = PKGS["port"].capacity.tokens_for
    queues = [0, 1, 4, 16, 64]
    latencies = [0.005, 0.02, 0.1, 0.5]
    slos = [0.05, 0.25, 1.0, 4.0]
    for lat in latencies:
        for slo in slos:
            caps = [tokens_for(q, 0, lat, slo, 2, 16)[0] for q in queues]
            assert caps == sorted(caps) and all(2 <= c <= 16 for c in caps)
    assert tokens_for(100, 4, 0.1, 0.0, 3, 16) == (3, 0.0)
    assert tokens_for(100, 4, 0.0, 1.0, 3, 16) == (3, 0.0)


class _Fleet:
    """A controller of one package over a fake clock, its own registry
    and fake admission rows; every hook call is logged."""

    def __init__(self, m, settings):
        self.m = m
        self.clock = [0.0]
        self.reg = m.telemetry.MetricsRegistry()
        self.hits = self.reg.counter("warm_pool_hits_total", "",
                                     labels=("worker",))
        self.misses = self.reg.counter("warm_pool_misses_total", "",
                                       labels=("worker",))
        self.wait = self.reg.histogram("placement_admission_wait_seconds",
                                       "", labels=("worker",))
        self.rows = {w: {"pending": 0, "inflight": 0, "capacity": 2,
                         "launch_ewma_ms": 0.0} for w in WORKERS}
        self.calls: list = []
        hooks = m.capacity.CapacityHooks(
            workers=lambda: list(WORKERS),
            admission_stats=lambda: {"workers": self.rows,
                                     "max_inflight_per_worker": 2},
            set_token_cap=lambda w, c: self.calls.append(("cap", w, c)),
            set_shed=lambda w, r: self.calls.append(("shed", w, round(r, 6))),
            pool_stats=lambda: {"workers": {}},
            set_pool_target=lambda w, t: self.calls.append(("pool", w, t)),
            live_placements=lambda w: 0,
            journal=lambda kind, **f: self.calls.append(
                ("journal", kind, sorted(f.items()))),
            emit=lambda ev: self.calls.append(("emit", ev.detail())))
        self.ctrl = m.capacity.CapacityController(
            settings, hooks=hooks, scaler=m.capacity.NullScaler(),
            clock=lambda: self.clock[0], registry=self.reg)

    def step(self, dt, traffic):
        self.clock[0] += dt
        for w, (hits, misses, pending, inflight, launch_ms, waits) in zip(
                WORKERS, traffic):
            if hits:
                self.hits.labels(w).inc(hits)
            if misses:
                self.misses.labels(w).inc(misses)
            for v in waits:
                self.wait.labels(w).observe(v)
            self.rows[w].update(pending=pending, inflight=inflight,
                                launch_ewma_ms=launch_ms)
        return self.ctrl.maybe_tick()


def _settings(m, **kw):
    slo = kw.pop("slo", 0.0)
    return m.schema.CapacitySettings(
        enable=True, interval_s=0.05, pool_min_depth=kw.pop("lo", 0),
        pool_max_depth=kw.pop("hi", 4), token_max=kw.pop("token_max", 8),
        slo=m.schema.CapacitySloSettings(default_s=slo,
                                         tenants={"gold": slo / 2}
                                         if slo else {}), **kw)


_worker_tick = st.tuples(
    st.integers(0, 6), st.integers(0, 4), st.integers(0, 40),
    st.integers(0, 4), st.floats(0.0, 400.0, allow_nan=False),
    st.lists(st.floats(0.0, 2.0, allow_nan=False), max_size=3))


@hsettings(max_examples=40, deadline=None,
           suppress_health_check=[HealthCheck.too_slow])
@given(ticks=st.lists(st.tuples(st.sampled_from([0.01, 0.05, 0.2, 1.0]),
                                st.tuples(_worker_tick, _worker_tick)),
                      min_size=1, max_size=12),
       slo=st.sampled_from([0.0, 0.2, 1.0]), lo=st.integers(0, 2),
       hi=st.integers(2, 6))
def test_controller_decisions_match_reference(ticks, slo, lo, hi):
    """The same registry deltas and admission rows, tick by tick under
    one fake clock: the same hook calls in the same order (pool targets,
    token caps, shed modes, journal records, decision events), the same
    ``state()``."""
    fleets = [_Fleet(m, _settings(m, slo=slo, lo=lo, hi=hi))
              for m in (PKGS["ref"], PKGS["port"])]
    for dt, traffic in ticks:
        ticked = [f.step(dt, traffic) for f in fleets]
        assert ticked[1] == ticked[0]
    ref, port = fleets
    assert port.calls == ref.calls
    assert port.ctrl.pool_targets == ref.ctrl.pool_targets
    assert port.ctrl.token_caps == ref.ctrl.token_caps
    assert port.ctrl.shedding == ref.ctrl.shedding
    assert port.ctrl.state() == ref.ctrl.state()


def test_controller_sheds_when_slo_unattainable_and_restores():
    """tests/test_capacity.py's shed/restore case over both packages'
    admission controllers, with one fake clock each."""
    def run(m):
        clock = [0.0]
        adm = m.placement.AdmissionController(max_inflight_per_worker=1,
                                              clock=lambda: clock[0])
        held: list = []
        for _ in range(40):
            adm.submit("w0", "t", lambda release: held.append(release))
        clock[0] = 1.0
        held.pop(0)()
        journaled: list = []
        ctrl = m.capacity.CapacityController(
            m.schema.CapacitySettings(
                enable=True, interval_s=0.01, token_max=2,
                slo=m.schema.CapacitySloSettings(default_s=0.2)),
            hooks=m.capacity.CapacityHooks(
                workers=lambda: ["w0"], admission_stats=adm.stats,
                set_token_cap=adm.set_worker_capacity,
                set_shed=adm.set_shed,
                journal=lambda kind, **f: journaled.append(
                    (kind, sorted(f.items())))),
            clock=lambda: clock[0], registry=m.telemetry.MetricsRegistry())
        ctrl.tick()
        shed = dict(ctrl.shedding)
        st_ = adm.submit("w0", "t", lambda release: None)
        rejected = (str(st_), round(st_.retry_after_s, 6))
        while held:
            held.pop(0)()
        clock[0] = 2.0
        ctrl.tick()
        return shed, rejected, dict(ctrl.shedding), journaled

    want, got = run(PKGS["ref"]), run(PKGS["port"])
    assert got == want
    assert got[0]["w0"] > 0 and got[2] == {}
    assert [f for k, f in got[3] if k == "capacity_queue"][-1][0] == (
        "mode", "queue")


# ------------------------------------------------------------ wired parts


def _controller_for(m, sched, drv, **kw):
    settings = m.schema.CapacitySettings(
        enable=True, interval_s=0.01, pool_max_depth=4,
        autoscale=m.schema.CapacityAutoscaleSettings(
            enable=True, min_workers=1, max_workers=len(drv.workers()),
            queue_high=10_000, idle_low=0.0, sustain_s=3600.0), **kw)
    ctrl = m.capacity.CapacityController(
        settings, scaler=m.capacity.FakeFleetScaler(drv))
    sched.attach_capacity(ctrl)
    return ctrl


def test_drain_gate_matches_reference(tmp_path):
    """tests/test_capacity.py's ``test_drain_blocked_by_live_placement_
    then_fires``: blocked while the journal shows the run live on the
    victim, fired once it finished, the durable intent before the done."""
    def scenario(s):
        drv = driver_with(s.m, 2, s.m.fake.exit_behavior(b"", 0,
                                                         delay=0.05))
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=2, iterations=1,
                                          placement="spread", image=IMAGE),
            run_id=RUN_ID)
        ctrl = _controller_for(s.m, sched, drv)
        ctrl.request_drain("fake-1")
        sched.start()
        ctrl.tick()
        blocked = ("fake-1" in ctrl._pending_drain, list(ctrl.drained))
        loops = sched.run(poll_s=0.05)
        ctrl.tick()
        fleet = [w.id for w in drv.workers()]
        sched.cleanup(remove_containers=True)
        records = s.m.journal.RunJournal.read(
            s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id))
        phases = [r.get("phase") for r in records
                  if r.get("kind") == "capacity_scale"]
        drv.close()
        return (blocked, [l.status for l in loops], list(ctrl.drained),
                fleet, phases)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == (True, [])
    assert got[2] == ["fake-1"] and got[3] == ["fake-0"]
    assert got[4].index("intent") < got[4].index("done")
    assert "blocked" in got[4]


def test_resume_restores_controller_state_as_reference(tmp_path):
    """tests/test_capacity.py's ``test_resume_restores_controller_state``
    without its run thread (the generation dies right after ``start()``):
    journaled ``REC_CAPACITY_*`` records of the killed generation restore the pool targets, token caps and pending
    drains of a fresh controller on the resumed scheduler."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=2, iterations=2,
                                          warm_pool_depth=1, image=IMAGE),
            run_id=RUN_ID)
        _controller_for(s.m, sched, drv)
        sched.start()
        sched._journal("capacity_pool", worker="fake-0", target=3, rate=9.0)
        sched._journal("capacity_tokens", worker="fake-1", cap=7,
                       launch_ms=20.0)
        sched._journal("capacity_scale", action="drain", worker="fake-1",
                       phase="blocked", live=1)
        sched._journal("capacity_queue", worker="fake-0", mode="reject",
                       retry_after_s=0.4)
        sched.journal.sync()
        sched.kill()
        image = s.m.journal.replay(s.m.journal.RunJournal.read(
            s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id)))
        resumed = s.m.loop.LoopScheduler.resume(s.cfg, drv, image)
        ctrl = s.m.capacity.CapacityController(
            s.m.schema.CapacitySettings(enable=True, interval_s=0.01,
                                        pool_max_depth=4),
            scaler=s.m.capacity.NullScaler())
        resumed.attach_capacity(ctrl)
        out = (image.capacity, dict(ctrl.pool_targets),
               dict(ctrl.token_caps), dict(ctrl.shedding),
               list(ctrl._pending_drain),
               resumed.warmpool.target_of("fake-0"),
               resumed.admission.stats()["workers"]["fake-1"]["capacity"])
        resumed.kill()
        drv.close()
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[1] == {"fake-0": 3} and got[2] == {"fake-1": 7}
    assert got[4] == ["fake-1"] and got[5] == 3 and got[6] == 7


def test_attach_capacity_on_a_depth0_run_builds_the_lazy_pool(tmp_path):
    def scenario(s):
        drv = driver_with(s.m, 2)
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=1, iterations=1,
                                          image=IMAGE), run_id=RUN_ID)
        before = sched.warmpool
        ctrl = s.m.capacity.CapacityController(
            s.m.schema.CapacitySettings(enable=True))
        sched.attach_capacity(ctrl)
        out = (before, sched.capacity is ctrl,
               sched.warmpool is not None and sched.warmpool.depth,
               sorted(sched.admission.stats().get("tenants", {})))
        sched.cleanup()
        drv.close()
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] is None and got[1] is True and got[2] == 0


def test_make_scaler_and_fake_fleet_scaler_match_reference():
    out = []
    for m in (PKGS["ref"], PKGS["port"]):
        drv = m.drivers.FakeDriver(n_workers=2)
        scaler = m.capacity.make_scaler(drv, None, max_workers=3)
        added = scaler.provision(3)
        drained = scaler.drain("fake-0")
        null = m.capacity.make_scaler(object(), None, max_workers=3)
        out.append((type(scaler).__name__, added, drained,
                    [w.id for w in drv.workers()], type(null).__name__,
                    null.provision(2), null.drain("x"), null.provisioned))
        drv.close()
    assert out[1] == out[0]
    assert out[1][0] == "FakeFleetScaler" and out[1][4] == "NullScaler"


def test_tpu_vm_scaler_is_refused_by_name():
    """``make_scaler`` builds the ``tpu_vm`` provisioner as the
    reference's does, its control-plane default included."""
    from types import SimpleNamespace

    def scaler(m):
        sc = m.capacity.make_scaler(SimpleNamespace(name="tpu_vm"), None,
                                    max_workers=2)
        return [type(sc).__name__, sc.with_firewall, sc.with_cp,
                list(sc.provisioned), list(sc.drained), sc.drain("h9"),
                sc.drained]

    want, got = [scaler(PKGS[k]) for k in ("ref", "port")]
    assert got == want
    assert got == ["TPUVMScaler", True, True, [], [], True, ["h9"]]


def test_loop_with_capacity_enable_matches_reference(tmp_path, monkeypatch):
    """``loop -p 6 -n 2 --warm-pool 1`` with settings ``capacity.enable``
    in process: the controller is attached (its stderr line) and its
    journaled pool targets replay into ``RunImage.capacity``."""
    settings = SETTINGS + ("capacity:\n  enable: true\n  interval_s: 0.01\n"
                           "  pool_max_depth: 3\n")

    def scenario(s):
        drv = driver_with(s.m, 2, s.m.fake.exit_behavior(b"", 0,
                                                         delay=0.02))
        args = ["loop", "-p", "6", "-n", "2", "--warm-pool", "1",
                "--json", "--image", IMAGE]
        if s.m.name == "ref":
            res = CliRunner().invoke(
                ref_root.cli, [*args, "--no-daemon", "--no-workerd"],
                obj=ref_factory.Factory(cwd=s.proj, driver=drv),
                catch_exceptions=False)
        else:
            monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
            res = CliRunner().invoke(
                port_cli.cli, [*args, "--no-daemon"],
                obj=port_cli.Factory(cwd=s.proj, driver=drv),
                catch_exceptions=False)
        run = json.loads(res.stdout)["loop_id"]
        image = s.m.journal.replay(s.m.journal.RunJournal.read(
            s.m.journal.journal_path(s.cfg.logs_dir, run)))
        drv.close()
        return (res.exit_code, "capacity: elastic controller attached"
                in res.stderr, sorted(image.capacity),
                bool(image.capacity.get("pool_targets")))

    want, got = twin(tmp_path, scenario, settings)
    assert got[:3] == want[:3]
    assert got[0] == 0 and got[1] is True
    assert got[3] is True


def test_loopd_hosts_the_capacity_controller_as_reference(tmp_path):
    """tests/test_capacity.py's ``test_loopd_hosts_capacity_controller``:
    the daemon ticks one controller, its own ``loopd-capacity`` WAL, and
    the status RPC's ``capacity`` and ``storage`` rows carry it."""
    settings = SETTINGS + ("capacity:\n  enable: true\n  interval_s: 0.02\n"
                           "  pool_max_depth: 3\n")

    def scenario(s):
        drv = driver_with(s.m, 2, s.m.fake.exit_behavior(b"", 0,
                                                         delay=0.02))
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        try:
            client = s.m.client.LoopdClient(srv.sock_path)
            ack = client.submit_run({"parallel": 2, "iterations": 1,
                                     "image": IMAGE, "warm_pool_depth": 1},
                                    stream=False)
            client.close()
            ticked = wait_for(lambda: srv.capacity.ticks >= 3)
            done = wait_for(lambda: srv.runs[ack["run"]].done.is_set())
            with s.m.client.LoopdClient(srv.sock_path) as c:
                doc = c.status()
            wal = s.m.journal.journal_path(s.cfg.logs_dir, "loopd-capacity")
        finally:
            srv.stop()
            drv.close()
        cap = doc["capacity"]
        return (ticked, done, cap["enabled"], cap["ticks"] >= 3,
                sorted(cap), sorted(cap["autoscale"]),
                sorted(doc["storage"]), wal.exists())

    want, got = twin(tmp_path, scenario, settings)
    assert got == want
    assert got[:4] == (True, True, True, True)
    assert "capacity_wal" in got[6] and got[7] is True


def test_chaos_capacity_scenario_holds_invariants_as_reference(tmp_path):
    """tests/test_capacity.py's ``test_chaos_capacity_scenario_green``: a
    traffic burst and a scale-down under load; the drain never strands
    the run and every standard invariant holds."""
    def make(m):
        return m.plan.FaultPlan(
            seed=7, scenario=0, n_workers=3, n_loops=4, iterations=1,
            warm_pool_depth=1, capacity=True, events=[
                m.plan.FaultEvent(at_s=0.05, kind="traffic_burst", worker=0,
                                  arg=8),
                m.plan.FaultEvent(at_s=0.1, kind="scale_down", worker=2)])

    (_r, want), (port, got) = run_plan_twin(tmp_path, make)
    assert got.ok, got.violations
    assert want.ok, want.violations
    assert got.injected == want.injected >= 2
    assert port.capacity_ctrl is not None and port.capacity_ctrl.ticks >= 1
