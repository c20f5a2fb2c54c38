"""The port's adversarial corpus and test harness helpers against the
reference's.

Twins of tests/test_adversarial.py's five cases and of
tests/test_chaos.py::test_adversarial_suite_under_fleet_load (the
BASELINE config #5 shape: the corpus in a loop beside an 8-loop fleet on
the 4-worker fake pod).  Each case runs on the reference's package, then
on the port's, over the same inputs: every attempt row (payload,
technique, detail, outcome) and every ``CaptureDB`` row, its time
masked, must agree.  The fleet twin runs inside each package's own
``testenv.lock_tracing()`` (never one inside the other) with a live
sentinel on the run's bus, the port's scoring with ``device="cpu"``; it
is compared by what the reference's test pins.  Also the twin of
``testenv.inject_wan_rtt``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import clawker_tpu.adversarial as ref_adv
import clawker_tpu.adversarial.harness as ref_harness
import clawker_tpu.adversarial.payloads as ref_payloads
import clawker_tpu.analysis.lockgraph as ref_lockgraph
import clawker_tpu.chaos.invariants as ref_inv
import clawker_tpu.config as ref_config
import clawker_tpu.consts as ref_consts
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.firewall.model as ref_model
import clawker_tpu.loop as ref_loop
import clawker_tpu.sentinel as ref_sentinel
import clawker_tpu.testenv as ref_testenv
import clawker_tpu_torch.adversarial as port_adv
import clawker_tpu_torch.adversarial.harness as port_harness
import clawker_tpu_torch.adversarial.payloads as port_payloads
import clawker_tpu_torch.analysis.lockgraph as port_lockgraph
import clawker_tpu_torch.chaos.invariants as port_inv
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.firewall.model as port_model
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.sentinel as port_sentinel
import clawker_tpu_torch.testenv as port_testenv

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

PKGS = {
    "ref": SimpleNamespace(
        name="ref", adv=ref_adv, harness=ref_harness, payloads=ref_payloads,
        model=ref_model, lockgraph=ref_lockgraph, inv=ref_inv,
        config=ref_config, consts=ref_consts, drivers=ref_drivers,
        fake=ref_fake, loop=ref_loop, sentinel=ref_sentinel,
        testenv=ref_testenv, device={}),
    "port": SimpleNamespace(
        name="port", adv=port_adv, harness=port_harness,
        payloads=port_payloads, model=port_model, lockgraph=port_lockgraph,
        inv=port_inv, config=port_config, consts=port_consts,
        drivers=port_drivers, fake=port_fake, loop=port_loop,
        sentinel=port_sentinel, testenv=port_testenv,
        device={"device": "cpu"}),
}

PROJECT = "chaosproj"
IMAGE = f"clawker-{PROJECT}:default"
# the host proxy is off and the soft watermark sits below any real disk,
# as in tests/test_torch_chaos.py: on a nearly full disk the scheduler
# sheds its flight spans and the span audit reads the shedding
SETTINGS = """host_proxy:
  enable: false
loop:
  storage_pressure:
    soft_free_pct: 0.001
    hard_free_pct: 0.0005
"""


def twin(case, *args):
    """``case(m, *args)`` on the reference, then on the port: the
    outcomes agree; -> the reference's."""
    got = {tag: case(m, *args) for tag, m in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["ref"]


def attempt_rows(m, surface=None) -> list[tuple]:
    """Every payload class run over ``surface`` (a fresh one by
    default): -> (payload, technique, detail, outcome) rows."""
    p = m.payloads
    surface = surface or m.harness.EgressSurface(
        p.default_rules(), resolutions=p.default_resolutions())
    return [(a.payload, a.technique, a.detail, a.outcome.value)
            for fn in p.CORPUS for a in fn(surface)]


def weaken(m, surface) -> None:
    """Monitor mode: the agent's cgroup re-enrolled without
    ``FLAG_ENFORCE`` (tests/test_adversarial.py:70's shape)."""
    h = m.harness
    surface.maps.enroll(h.CG, m.model.ContainerPolicy(
        envoy_ip=h.ENVOY_IP, dns_ip=h.DNS_IP, hostproxy_ip=h.HOSTPROXY_IP,
        hostproxy_port=h.HOSTPROXY_PORT, flags=m.model.FLAG_HOSTPROXY))


# ---------------------------------------------- test_adversarial.py

def test_corpus_runs_the_same_thirty_classes():
    names = twin(lambda m: [fn.__name__ for fn in m.payloads.CORPUS])
    assert len(names) == 30 and len(set(names)) == 30


def test_zero_escapes_and_equal_capture_rows(tmp_path):
    def case(m):
        db = m.harness.CaptureDB(tmp_path / f"{m.name}.db")
        try:
            rep = m.adv.run_corpus(db)
            stored = [(type(ts).__name__, *rest) for ts, *rest in
                      db.conn.execute("SELECT * FROM attempts ORDER BY rowid")]
            return {"report": (rep.total, rep.captured, rep.contained,
                               rep.escaped, rep.ok, rep.escapes),
                    "rows": stored, "counts": db.counts(),
                    "attempts": attempt_rows(m)}
        finally:
            db.close()

    got = twin(case)
    total, captured, contained, escaped, ok, escapes = got["report"]
    assert total >= 30 and escaped == 0 and ok and escapes == []
    assert sum(got["counts"].values()) == total
    assert "escaped" not in got["counts"]
    assert [("float", *row) for row in got["attempts"]] == got["rows"]


def test_report_is_json_gradeable():
    doc = twin(lambda m: json.loads(m.adv.run_corpus().to_json()))
    assert doc["pass"] is True
    assert doc["captured"] + doc["contained"] == doc["total"]


def test_surface_grades_direct_allow_as_escape():
    def case(m):
        p, model = m.payloads, m.model
        s = m.harness.EgressSurface(p.default_rules(),
                                    resolutions=p.default_resolutions())
        out = []
        for v in (model.Verdict(model.Action.ALLOW, model.Reason.ROUTE),
                  model.Verdict(model.Action.REDIRECT, model.Reason.ROUTE,
                                redirect_ip=p.ATTACKER_IP,
                                redirect_port=443),
                  model.Verdict(model.Action.REDIRECT, model.Reason.ROUTE,
                                redirect_ip=m.harness.ENVOY_IP,
                                redirect_port=10000),
                  model.Verdict(model.Action.DENY, model.Reason.NO_ROUTE)):
            outcome, why = s.grade_verdict(v, p.ATTACKER_IP)
            out.append((outcome.value, why))
        for ip in ("127.0.0.1", m.harness.HOSTPROXY_IP):
            outcome, why = s.grade_verdict(
                model.Verdict(model.Action.ALLOW, model.Reason.ROUTE), ip)
            out.append((outcome.value, why))
        return out

    got = twin(case)
    assert [o for o, _ in got] == ["escaped", "escaped", "contained",
                                   "captured", "contained", "contained"]


def test_weakened_policy_is_detected():
    def case(m):
        p = m.payloads
        s = m.harness.EgressSurface(p.default_rules(),
                                    resolutions=p.default_resolutions())
        weaken(m, s)
        v = s.connect(p.ATTACKER_IP, 443)
        outcome, why = s.grade_verdict(v, p.ATTACKER_IP)
        return outcome.value, why, v.action.name, v.reason.name

    got = twin(case)
    assert got[0] == "escaped"


def test_weakened_corpus_grades_escapes():
    """The whole corpus over a monitor-mode surface: the same rows in
    both packages, and the grader reads escapes (the suite cannot rot
    into always-green)."""
    def case(m):
        p = m.payloads
        s = m.harness.EgressSurface(p.default_rules(),
                                    resolutions=p.default_resolutions())
        weaken(m, s)
        return attempt_rows(m, s)

    got = twin(case)
    assert sum(row[3] == "escaped" for row in got) >= 1


# ------------------------------------------------- testenv helpers

def test_inject_wan_rtt_matches_the_reference():
    """``inject_wan_rtt`` on a fake pod (``set_rtt_all``), on a driver
    of engine transports (the tpu_vm shape) and on one with neither."""
    def case(m):
        drv = m.drivers.FakeDriver(n_workers=2)
        m.testenv.inject_wan_rtt(drv, 0.05)
        fake = [g.rtt_s for g in drv.gates]
        api = drv.apis[0]
        api.add_image(IMAGE)
        t0 = time.perf_counter()
        drv.workers()[0].engine.image_exists(IMAGE)
        paid = time.perf_counter() - t0 >= 0.05
        m.testenv.inject_wan_rtt(drv, -1.0)
        cleared = [g.rtt_s for g in drv.gates]
        transports = [SimpleNamespace(rtt_s=0.0) for _ in range(3)]
        ssh = SimpleNamespace(workers=lambda: [
            SimpleNamespace(engine=SimpleNamespace(transport=t))
            for t in transports] + [SimpleNamespace(engine=None)])
        m.testenv.inject_wan_rtt(ssh, 0.25)
        over_ssh = [t.rtt_s for t in transports]
        m.testenv.inject_wan_rtt(ssh, -3)
        clamped = [t.rtt_s for t in transports]
        m.testenv.inject_wan_rtt(SimpleNamespace(workers=lambda: []), 1.0)
        return fake, paid, cleared, over_ssh, clamped

    got = twin(case)
    assert got == ([0.05, 0.05], True, [0.0, 0.0], [0.25] * 3, [0.0] * 3)


# --------------------------------------- adversarial under load (#5)

@contextlib.contextmanager
def side(m, tmp_path):
    tenv = m.testenv.TestEnv(base=tmp_path / m.name)
    with tenv:
        tenv.write_settings(SETTINGS)
        proj = tenv.base / "proj"
        proj.mkdir(exist_ok=True)
        (proj / m.consts.PROJECT_FLAT_FORM).write_text(
            f"project: {PROJECT}\n")
        yield m.config.load_config(proj)


def under_load(m, cfg) -> dict:
    """The corpus in a loop while 8 loops x 2 iterations run on the
    4-worker fake pod with a live sentinel on the run's bus, all inside
    the package's ``testenv.lock_tracing()``."""
    base = m.adv.run_corpus()
    with m.testenv.lock_tracing() as graph:
        drv = m.drivers.FakeDriver(n_workers=4)
        for api in drv.apis:
            api.add_image(IMAGE)
            api.set_behavior(IMAGE, m.fake.exit_behavior(b"", 0, delay=0.01))
        sched = m.loop.LoopScheduler(cfg, drv, m.loop.LoopSpec(
            parallel=8, iterations=2, image=IMAGE))
        sentinel = m.sentinel.FleetSentinel(
            cfg, drv, run_id=sched.loop_id, interval_s=0.05,
            train_steps=20, **m.device)
        sched.attach_sentinel(sentinel)
        sentinel.start()
        sched.start()
        runner = threading.Thread(target=sched.run,
                                  kwargs={"poll_s": 0.05}, daemon=True)
        runner.start()
        reports = []
        while runner.is_alive():
            reports.append(m.adv.run_corpus())
        runner.join(30.0)
        if not reports:     # the fleet drained before one pass: rerun
            reports.append(m.adv.run_corpus())
        sentinel.stop()
        sched.cleanup(remove_containers=True)
    return {
        "baseline": (base.total, base.captured, base.contained,
                     base.escaped),
        "passes agree": all(
            (r.total, r.captured, r.contained, r.escaped)
            == (base.total, base.captured, base.contained, 0)
            for r in reports),
        "loops": sorted((lp.status, lp.iteration) for lp in sched.loops),
        "violations": m.inv.check_invariants(
            drv, cfg, sched.loop_id, loops=sched.loops, cap=4),
        "sentinel error": sentinel.last_error,
        "cycles": graph.cycles(),
        "traced": graph.acquires > 0 and graph.report()["edges"] > 0,
        "restored": type(threading.Lock()).__module__,
    }


def test_adversarial_suite_under_fleet_load_matches_the_reference(
        tmp_path):
    for m in PKGS.values():
        if m.lockgraph.installed_graph() is not None:
            pytest.skip("a lock tracer is installed process-wide "
                        "(CLAWKER_TPU_LOCKGRAPH=1): the twin installs "
                        "each package's own")
    got = {}
    for tag, m in PKGS.items():
        with side(m, tmp_path) as cfg:
            got[tag] = under_load(m, cfg)
    assert got["port"] == got["ref"]
    want = got["ref"]
    assert want["baseline"][3] == 0 and want["passes agree"]
    assert want["loops"] == [("done", 2)] * 8
    assert want["violations"] == [] and want["cycles"] == []
    assert not want["sentinel error"] and want["traced"]
    assert want["restored"] == "_thread"
