"""The port's telemetry shipper against the reference's.

Twins of tests/test_shipper.py.  The doc builders (``event_doc``,
``span_doc``, ``metric_docs``) give equal docs and ``bulk_payload``
equal bytes for the same records; the bounded buffer drops the oldest
batches against a down ``FakeBulkIndex`` with the same accounting; a
run's typed events and spans reach the index through
``attach_shipper``, ``loop --ship-telemetry`` and loopd's
daemon-lifetime shipper in both packages; and the chaos ``index_down``
scenarios hold every invariant.  Each package ships into its own copy
of ``FakeBulkIndex`` (the port's from ``clawker_tpu_torch.testenv``).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import pytest
from click.testing import CliRunner
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

BOTH = (PKGS["ref"], PKGS["port"])


def _records(m):
    E = m.events
    return [
        E.EventRecord(1, 1, "agent-0", E.PLACEMENT_DECISION,
                      "placed w2 [spread/teamA]: rescued"),
        E.EventRecord(2, 1, "w0", E.WORKER_HEALTH, "closed->open: timeout"),
        E.EventRecord(3, 1, "agent-1", E.ANOMALY_FLAG,
                      "egress z=4.20 worker=w3"),
        E.EventRecord(4, 2, "agent-1", E.ANOMALY_FLAG,
                      "behavior z=-1.234567 worker=w0"),
        E.EventRecord(5, 1, "a", "iteration_done", "0"),
        E.EventRecord(6, 1, "a", E.TRACE_SPAN, "iteration 0 ok"),
    ]


def test_event_docs_match_reference():
    got, want = ([m.shipper.event_doc(r, run="r1", source="s", ts=12.5)
                  for r in _records(m)] for m in (PKGS["port"], PKGS["ref"]))
    got, want = list(got), list(want)
    assert got == want
    assert [d and d["type"] for d in got] == [
        "placement", "health", "anomaly", "anomaly", None, None]


def _span(m, **kw):
    base = dict(trace_id="r1", span_id="s1", parent_id="", name="iteration",
                agent="a0", worker="w0", t_start=10.0, t_end=10.25,
                attrs={"iteration": 2, "path": Path("/x")})
    base.update(kw)
    return m.telemetry.SpanRecord(**base)


@pytest.mark.parametrize("kw", [
    {}, {"status": "failed", "t_end": 1e9 + 0.9999},
    {"trace_id": "", "name": "sentinel.tick", "attrs": {}}],
    ids=["iteration", "failed", "standalone"])
def test_span_docs_match_reference(kw):
    got = PKGS["port"].shipper.span_doc(_span(PKGS["port"], **kw), run="",
                                        source="s")
    want = PKGS["ref"].shipper.span_doc(_span(PKGS["ref"], **kw), run="",
                                        source="s")
    assert got == want


def test_metric_docs_match_reference():
    out = []
    for m in BOTH:
        reg = m.telemetry.MetricsRegistry()
        reg.counter("ship_test_total", "t", labels=("worker",)).labels(
            "w0").inc(3)
        reg.gauge("ship_test_gauge", "g").set(-2.5)
        h = reg.histogram("ship_test_seconds", "h", labels=("worker",))
        for v in (0.001, 0.2, 7.0):
            h.labels("w1").observe(v)
        out.append(m.shipper.metric_docs(reg.snapshot(), source="s",
                                         ts=0.0))
    assert out[1] == out[0]
    assert {d["kind"] for d in out[1]} == {"counter", "gauge", "histogram"}


@pytest.mark.parametrize("items", [
    [],
    [("i1", {"a": 1}), ("i2", {"b": [2, 3], "c": None})],
    [("clawker-fleet-spans", {"p": Path("/tmp/x"), "u": "é\n\"q\""})],
], ids=["empty", "pairs", "non-json-values"])
def test_bulk_payload_bytes_match_reference(items):
    got = PKGS["port"].shipper.bulk_payload(items)
    assert got == PKGS["ref"].shipper.bulk_payload(items)
    idx = PKGS["port"].testenv.FakeBulkIndex()
    assert idx.bulk(got)
    assert sum(len(v) for v in idx.docs.values()) == len(items)


def _drop_oldest(m):
    idx = m.testenv.FakeBulkIndex()
    idx.down = True
    shipper = m.shipper.TelemetryShipper(
        idx, registry=m.telemetry.MetricsRegistry(), interval_s=0.05,
        batch_docs=2, max_batches=3)
    trail = []
    for i in range(20):
        shipper.ingest("i", {"n": i})
        shipper.flush_once()
        trail.append(shipper.stats())
    idx.down = False
    shipper.flush_once()
    kept = sorted(d["n"] for d in idx.docs.get("i", []))
    return trail, shipper.stats(), kept, idx.refused, idx.bulk_calls


def test_drop_oldest_accounting_matches_reference_against_a_down_index():
    want, got = _drop_oldest(PKGS["ref"]), _drop_oldest(PKGS["port"])
    assert got == want
    trail, final, kept, _refused, _calls = got
    st = trail[-1]
    assert st["dropped_docs"] > 0 and st["failed_flushes"] > 0
    assert st["pending_batches"] <= st["max_batches"]
    assert st["ingested_docs"] == (st["flushed_docs"] + st["dropped_docs"]
                                   + st["pending_docs"] + st["open_docs"])
    assert kept == list(range(20 - len(kept), 20)) and kept[-1] == 19
    assert final["flushed_docs"] == len(kept)


def test_fake_bulk_index_matches_reference():
    out = []
    for m in BOTH:
        idx = m.testenv.FakeBulkIndex(stall_timeout_s=0.05)
        payload = m.shipper.bulk_payload([("a", {"k": 1}), ("b", {"k": 2}),
                                          ("a", {"k": 3})])
        ok = [idx.bulk(payload), idx.bulk(b"not json\nat all\n")]
        idx.stall()
        ok.append(idx.bulk(payload))
        idx.unstall()
        idx.down = True
        ok.append(idx.bulk(payload))
        out.append((ok, idx.bulk_calls, idx.refused, idx.count("a"),
                    idx.search("a", k=3), sorted(idx.docs)))
    assert out[1] == out[0]
    assert out[1][0] == [True, True, False, False]


def test_stalled_index_never_blocks_the_event_bus():
    """tests/test_shipper.py's acceptance shape on the port: a wedged
    index while 400 typed events pour in; emits return promptly, the bus
    drains, the drops are counted and conserved."""
    m = PKGS["port"]
    idx = m.testenv.FakeBulkIndex(stall_timeout_s=0.3)
    idx.stall()
    shipper = m.shipper.TelemetryShipper(
        idx, registry=m.telemetry.MetricsRegistry(), interval_s=0.05,
        batch_docs=8, max_batches=2).start()
    delivered = []
    bus = m.events.EventBus(lambda agent, event, detail:
                            delivered.append(agent))
    bus.add_tap(shipper.bus_tap_for("run-stall"))
    t0 = time.monotonic()
    for i in range(400):
        bus.emit(f"agent-{i % 8}", m.events.PLACEMENT_DECISION,
                 f"placed w{i % 4} [spread/default]")
    assert time.monotonic() - t0 < 5.0
    assert bus.flush(10.0)
    assert len(delivered) == 400
    shipper.kill()
    idx.unstall()
    st = shipper.stats()
    assert st["ingested_docs"] >= 400 and st["dropped_docs"] > 0
    assert st["pending_batches"] <= st["max_batches"]
    assert st["ingested_docs"] == (st["flushed_docs"] + st["dropped_docs"]
                                   + st["pending_docs"] + st["open_docs"])
    bus.close()


def test_stop_skips_the_final_flush_while_the_pump_is_wedged():
    """tests/test_shipper.py's ``test_stop_skips_final_flush_while_pump_
    is_wedged`` through both packages: the same kill/stop verdicts and
    the same counters once the sink drains."""
    def run(m):
        class _WedgedSink:
            def __init__(self):
                self.release = threading.Event()
                self.calls = 0

            def bulk(self, payload: bytes) -> bool:
                self.calls += 1
                self.release.wait(30.0)
                return False

        sink = _WedgedSink()
        shipper = m.shipper.TelemetryShipper(
            sink, registry=m.telemetry.MetricsRegistry(), interval_s=0.01,
            batch_docs=1).start()
        shipper.ingest("i", {"n": 1})
        assert wait_for(lambda: sink.calls > 0, timeout=5.0)
        first = shipper.kill()
        before = shipper.stats()["failed_flushes"]
        shipper.stop()
        after = shipper.stats()["failed_flushes"]
        sink.release.set()
        second = shipper.kill()
        st = shipper.stats()
        return (first, before == after, second,
                st["ingested_docs"] == (st["flushed_docs"]
                                        + st["dropped_docs"]
                                        + st["pending_docs"]
                                        + st["open_docs"]))

    assert run(PKGS["port"]) == run(PKGS["ref"]) == (False, True, True,
                                                     True)


# ------------------------------------------------------------ run plumbing


def _shipped(m, idx, run):
    events = sorted((d["type"], d.get("action", ""), d["agent"].replace(
        run[:6], "RUN")) for d in idx.docs.get(
            m.shipper.FLEET_EVENTS_INDEX, []) if d["run"] == run)
    spans = sorted((d["name"], d["status"]) for d in idx.docs.get(
        m.shipper.FLEET_SPANS_INDEX, []) if d["run"] == run)
    return events, spans


def test_attach_shipper_ships_the_reference_docs(tmp_path):
    """tests/test_shipper.py's ``test_scheduler_attach_shipper_ships_
    events_and_spans``: the same placement docs and span names reach the
    index, one iteration root per loop."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        idx = s.m.testenv.FakeBulkIndex()
        shipper = s.m.shipper.TelemetryShipper(
            idx, registry=s.m.telemetry.MetricsRegistry(), interval_s=0.05,
            batch_docs=10_000)
        sched = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=2, iterations=1,
                                          image=IMAGE), run_id=RUN_ID)
        sched.attach_shipper(shipper)
        sched.start()
        sched.run(poll_s=0.02)
        sched.cleanup(remove_containers=True)
        sched.events.flush(5.0)
        shipper.flush_once()
        drv.close()
        return _shipped(s.m, idx, sched.loop_id)

    want, got = twin(tmp_path, scenario)
    assert got == want
    events, spans = got
    assert sum(1 for t, _a, _g in events if t == "placement") >= 2
    assert spans.count(("iteration", "ok")) == 2


def test_loop_ship_telemetry_flag_matches_reference(tmp_path, monkeypatch):
    """``loop --ship-telemetry`` in process: the CLI builds the shipper
    from settings (its sink from ``resolve_sink``, here a fake index),
    and the run's events and spans reach it."""
    def scenario(s):
        idx = s.m.testenv.FakeBulkIndex()
        monkeypatch.setattr(s.m.shipper, "resolve_sink", lambda _cfg: idx)
        drv = driver_with(s.m, 2)
        args = ["loop", "-p", "2", "-n", "1", "--ship-telemetry", "--json",
                "--image", IMAGE]
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
        drv.close()
        run = json.loads(res.stdout)["loop_id"]
        events, spans = _shipped(s.m, idx, run)
        return (res.exit_code, "telemetry: shipping into the monitor stack"
                in res.stderr, events, spans,
                idx.count(s.m.shipper.FLEET_METRICS_INDEX) > 0)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 0 and got[1] is True and got[4] is True
    assert got[2] and got[3]


def test_loopd_hosts_the_shipper_as_reference(tmp_path, monkeypatch):
    """tests/test_shipper.py's ``test_loopd_hosts_shipper_and_status_
    reports_it``: the daemon's shipper takes every hosted run's events,
    and the status RPC's ``shipper`` row has the reference's keys."""
    settings = SETTINGS + ("monitoring:\n  shipper:\n    enable: true\n"
                           "    interval_s: 0.05\n")

    def scenario(s):
        idx = s.m.testenv.FakeBulkIndex()
        monkeypatch.setattr(s.m.shipper, "resolve_sink", lambda _cfg: idx)
        drv = driver_with(s.m, 2)
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        try:
            up = srv.shipper is not None
            with s.m.client.LoopdClient(srv.sock_path) as client:
                ack = client.submit_run({"parallel": 2, "iterations": 1,
                                         "image": IMAGE})
                final = None
                for frame in client.events():
                    if frame.get("type") == "run_done":
                        final = frame
            with s.m.client.LoopdClient(srv.sock_path) as c2:
                doc = c2.status()
            run = str(ack["run"])
            landed = wait_for(lambda: idx.search(
                s.m.shipper.FLEET_EVENTS_INDEX, run=run, type="placement"),
                timeout=5.0)
        finally:
            srv.stop()
            drv.close()
        row = doc["shipper"]
        return (up, bool(final and final["ok"]), row["enabled"],
                row["ingested_docs"] > 0, sorted(row), landed,
                idx.count(s.m.shipper.FLEET_METRICS_INDEX) > 0)

    want, got = twin(tmp_path, scenario, settings)
    assert got == want
    assert got[:4] == (True, True, True, True) and got[5:] == (True, True)


@pytest.mark.parametrize("arg", [None, "stall"], ids=["down", "stall"])
def test_chaos_index_fault_scenarios_hold_invariants_as_reference(
        tmp_path, arg):
    """tests/test_shipper.py's ``index_down`` scenarios (a down index; a
    stalled one with a worker kill beside it)."""
    def make(m):
        events = [m.plan.FaultEvent(at_s=0.05, kind="index_down", worker=-1,
                                    arg=arg)]
        if arg == "stall":
            events += [m.plan.FaultEvent(at_s=0.1, kind="worker_kill",
                                         worker=1),
                       m.plan.FaultEvent(at_s=0.3, kind="worker_revive",
                                         worker=1)]
        return m.plan.FaultPlan(seed=7 if arg is None else 8, scenario=0,
                                n_workers=2, n_loops=3, iterations=1,
                                shipper=True, events=events)

    (_r, want), (port, got) = run_plan_twin(tmp_path, make)
    assert got.ok, got.violations
    assert want.ok, want.violations
    audit = port._shipper_audit()
    assert audit["down_injected"] is True
    assert audit["ingested_docs"] == (audit["flushed_docs"]
                                      + audit["dropped_docs"]
                                      + audit["pending_docs"]
                                      + audit["open_docs"])
