"""The port's live fleet sentinel against the JAX reference sentinel.

Port twins of tests/test_sentinel.py's ``TestCollector`` and
``TestScoring``: each drives the port's ``FleetSentinel(device="cpu")``
and the reference ``FleetSentinel`` over the same stream files, with
the same params and noise injected (made with numpy), and holds the
windows, the flags (agent, worker, kind), the worker-relative z and the
baselines together.  The state file crosses between the two packages in
both directions.  The reference's chaos twin check (``chaos.runner``)
is not ported; ``audit()`` stands in for it here.
"""

from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest
import torch
from test_torch_sentinel import Z_ATOL, injected  # noqa: F401 -- fixture

from clawker_tpu.sentinel import FleetSentinel as RefSentinel
from clawker_tpu.sentinel import StreamCollector as RefCollector
from clawker_tpu_torch import telemetry
from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, AnomalyFlagEvent, EventBus
from clawker_tpu_torch.sentinel import STATE_DIR, FleetSentinel, StreamCollector, state_path

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

BASE = 1_700_000_000 - 1_700_000_000 % 60  # window-aligned
TRAIN_STEPS = 40
HOT = "clawker.p.loop-hot"
RAW_RTOL, RAW_ATOL = 5e-3, 1e-5   # tests/test_torch_sentinel.py's
ROW_Z_ATOL = Z_ATOL + 0.01        # rows and flags carry z rounded to 0.01


def _rec(ts, agent="clawker.p.loop-0", worker=None, verdict="ALLOW",
         reason="ROUTE", ip="198.51.100.9", port=443, proto=6,
         zone="example.com"):
    r = {"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
         "service": "ebpf-egress", "container": agent, "dst_ip": ip,
         "dst_port": port, "proto": proto, "verdict": verdict,
         "reason": reason, "zone": zone}
    if worker:
        r["worker"] = worker
    return r


def _benign_fleet_records(agents=8, workers=4, windows=6, per_window=12):
    recs = []
    for a in range(agents):
        wid = f"fake-{a % workers}"
        for w in range(windows):
            for i in range(per_window):
                recs.append(_rec(BASE + w * 60 + i * 3,
                                 agent=f"clawker.p.loop-{a}", worker=wid,
                                 ip=f"198.51.100.{a * 20 + i}"))
    return recs


def _deny_storm(agent, window_start, n=55):
    return [_rec(window_start + i % 59, agent=agent, worker="fake-1",
                 verdict="DENY", reason="NO_DNS_ENTRY",
                 ip=f"203.0.113.{i}", port=4444 + i, zone="")
            for i in range(n)]


class _Cfg:
    def __init__(self, logs_dir):
        self.logs_dir = logs_dir


def _append(path, recs):
    with open(path, "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _write_benign(tmp_path):
    recs = _benign_fleet_records()
    _append(tmp_path / "w0.jsonl", recs[0::2])
    _append(tmp_path / "w1.jsonl", recs[1::2])


def _sentinels(tmp_path, run_id="", *, port_logs=None, ref_logs=None):
    """The port's and the reference's sentinel over the same two stream
    files, each with its own logs dir (state file) unless told."""
    def make(cls, collector_cls, logs, **extra):
        col = collector_cls()
        col.add_local("fake-0", tmp_path / "w0.jsonl")
        col.add_local("fake-1", tmp_path / "w1.jsonl")
        return cls(_Cfg(logs), run_id=run_id, interval_s=999,
                   train_steps=TRAIN_STEPS, window_s=60, collector=col,
                   **extra)

    return (make(FleetSentinel, StreamCollector,
                 port_logs or tmp_path / "port", device="cpu"),
            make(RefSentinel, RefCollector, ref_logs or tmp_path / "ref"))


def _flag_set(s):
    return {(f["agent"], f["worker"], f["kind"]) for f in s.flags()}


def _tick(port, ref) -> int:
    """One tick of each; the two must agree.  -> windows scored."""
    n, want = port.refresh_once(), ref.refresh_once()
    assert port.last_error == ref.last_error == ""
    assert n == want
    if n:
        rep, ref_rep = port.last_tick, ref.last_tick
        assert [(k.agent, k.start_unix) for k in rep.keys] == \
               [(k.agent, k.start_unix) for k in ref_rep.keys]
        np.testing.assert_allclose(rep.raw, ref_rep.raw, rtol=RAW_RTOL,
                                   atol=RAW_ATOL)
        np.testing.assert_allclose(rep.z, ref_rep.z, rtol=0, atol=Z_ATOL)
        np.testing.assert_array_equal(rep.supports, ref_rep.supports)
        assert rep.device == "cpu"
    assert _flag_set(port) == _flag_set(ref)
    got = {f["agent"]: f["z"] for f in port.flags()}
    for f in ref.flags():
        assert got[f["agent"]] == pytest.approx(f["z"], abs=ROW_Z_ATOL)
    rows, ref_rows = port.rows(), ref.rows()
    assert [(r["agent"], r["worker"], r["windows"], r["flagged"],
             r["stream_records"]) for r in rows] == \
           [(r["agent"], r["worker"], r["windows"], r["flagged"],
             r["stream_records"]) for r in ref_rows]
    for r, w in zip(rows, ref_rows):
        assert r["latest_z"] == pytest.approx(w["latest_z"], abs=ROW_Z_ATOL)
    assert port.ticks == ref.ticks
    return n


def _baselines_agree(port, ref):
    assert port.engine.baseline_depth() == ref.engine.baseline_depth() > 0
    doc, ref_doc = port.engine.baseline_doc(), ref.engine.baseline_doc()
    assert doc.keys() == ref_doc.keys()
    for worker, vals in ref_doc.items():
        np.testing.assert_allclose(doc[worker], vals, rtol=0,
                                   atol=Z_ATOL + 1e-4)


# -------------------------------------------------------------- collector


def _both_collectors(scenario):
    """Run ``scenario(collector, tag)`` on the port's collector and the
    reference's; both must give the same result."""
    got = scenario(StreamCollector(), "port")
    want = scenario(RefCollector(), "ref")
    assert got == want
    return got


def test_collector_torn_tail_skipped_not_fatal(tmp_path):
    def scenario(col, tag):
        p = tmp_path / f"{tag}.jsonl"
        full, torn = json.dumps(_rec(BASE)), json.dumps(_rec(BASE + 1))
        p.write_text(full + "\n" + torn[:12])
        col.add_local("fake-0", p)
        first = col.poll()
        with open(p, "a") as f:
            f.write(torn[12:] + "\n")
        return first, col.poll(), col.records(), col.counts()

    first, second, recs, counts = _both_collectors(scenario)
    assert (first, second) == (1, 1)      # the completed line parsed ONCE
    assert len(recs) == 2 and counts == {"fake-0": 2}


def test_collector_shared_path_deduped_across_workers(tmp_path):
    p = tmp_path / "shared.jsonl"
    p.write_text(json.dumps(_rec(BASE, worker="fake-1")) + "\n")

    def scenario(col, tag):
        col.add_local("fake-0", p)
        col.add_local("fake-1", p)        # fake pod: one host file
        return col.poll(), col.records(), col.total()

    n, recs, total = _both_collectors(scenario)
    assert n == total == len(recs) == 1   # never multiplied per worker
    assert recs[0]["worker"] == "fake-1"  # the record's own tag wins


def test_collector_kill_serves_stale_buffer(tmp_path):
    def scenario(col, tag):
        p = tmp_path / f"{tag}.jsonl"
        p.write_text(json.dumps(_rec(BASE)) + "\n")
        col.add_local("fake-0", p)
        col.poll()
        col.kill()
        _append(p, [_rec(BASE + 1)])
        return col.poll(), len(col.records()), col.alive

    assert _both_collectors(scenario) == (0, 1, False)


def test_collector_revive_rewires_from_scratch(tmp_path):
    def scenario(col, tag):
        p = tmp_path / f"{tag}.jsonl"
        p.write_text(json.dumps(_rec(BASE)) + "\n")
        col.add_local("fake-0", p)
        col.poll()
        col.kill()
        _append(p, [_rec(BASE + 1)])
        col.revive()
        return col.poll(), len(col.records()), col.alive

    # the revived tail replays the file from the top: 2 more records
    assert _both_collectors(scenario) == (2, 3, True)


# ---------------------------------------------------------------- scoring


def test_seeded_anomaly_flagged_within_two_ticks_as_the_reference(
        tmp_path, injected):
    _write_benign(tmp_path)
    port, ref = _sentinels(tmp_path)
    bus_records = []
    bus = EventBus()
    bus.add_tap(bus_records.append)
    port.bind_run(events=bus)
    assert _tick(port, ref) > 0
    for _ in range(2):
        assert _tick(port, ref) == 0      # idle: nothing new anywhere
    assert port.flags() == [] and not any(r["flagged"] for r in port.rows())
    _append(tmp_path / "w1.jsonl", _deny_storm(HOT, BASE + 5 * 60))
    flagged_at = None
    for tick in range(1, 3):              # flags within TWO ticks
        _tick(port, ref)
        if any(f["agent"] == HOT for f in port.flags()):
            flagged_at = tick
            break
    assert flagged_at is not None
    assert (HOT, "fake-1", "egress") in _flag_set(port)
    ev = next(r for r in bus_records if r.event == ANOMALY_FLAG)
    parsed = AnomalyFlagEvent.parse(ev.agent, ev.detail)
    assert (parsed.agent, parsed.worker, parsed.kind) == (HOT, "fake-1",
                                                          "egress")
    assert parsed.z >= port.engine.threshold
    text = telemetry.REGISTRY.exposition()
    assert "anomaly_flags_total" in text
    assert f'anomaly_score{{agent="{HOT}"}}' in text
    _baselines_agree(port, ref)


def test_baselines_persist_across_resume_as_the_reference(tmp_path,
                                                          injected):
    _write_benign(tmp_path)
    port, ref = _sentinels(tmp_path, run_id="runA")
    _tick(port, ref)
    _tick(port, ref)
    _baselines_agree(port, ref)
    depth, ticks = port.engine.baseline_depth(), port.ticks
    port.stop()
    ref.stop()
    # a resume rebuilds the sentinels under the same run id
    port, ref = _sentinels(tmp_path, run_id="runA")
    assert port.engine.baseline_depth() == ref.engine.baseline_depth() == depth
    assert port.ticks == ref.ticks == ticks
    _append(tmp_path / "w1.jsonl", _deny_storm(HOT, BASE + 5 * 60))
    _tick(port, ref)
    assert (HOT, "fake-1", "egress") in _flag_set(port)
    port.stop()
    ref.stop()
    # already-flagged windows stay flagged-once across the resume
    port, ref = _sentinels(tmp_path, run_id="runA")
    _tick(port, ref)
    _tick(port, ref)
    assert port.flags() == ref.flags() == []


def test_low_support_window_scored_but_not_flagged(tmp_path, injected):
    _write_benign(tmp_path)
    tiny = "clawker.p.loop-tiny"
    _append(tmp_path / "w1.jsonl", _deny_storm(tiny, BASE + 5 * 60, n=3))
    port, ref = _sentinels(tmp_path)
    _tick(port, ref)
    _tick(port, ref)
    assert tiny in {r["agent"] for r in port.rows()}     # scored, shown
    assert not any(f["agent"] == tiny for f in port.flags())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_file_crosses_between_the_packages(tmp_path, injected, writer):
    """A state file written by one package resumes the other's sentinel
    with the same baselines, ticks and flagged windows."""
    _write_benign(tmp_path)
    _append(tmp_path / "w1.jsonl", _deny_storm(HOT, BASE + 5 * 60))
    port, ref = _sentinels(tmp_path, run_id="runX")
    _tick(port, ref)
    _tick(port, ref)
    src, dst = ("ref", "port") if writer == "reference" else ("port", "ref")
    shutil.copytree(tmp_path / src / STATE_DIR, tmp_path / "cross" / STATE_DIR)
    shutil.rmtree(tmp_path / dst / STATE_DIR)
    wrote = ref if writer == "reference" else port
    doc = json.loads(state_path(tmp_path / "cross", "runX").read_text())
    assert set(doc) == {"run", "ticks", "baselines", "flagged"}
    assert doc["flagged"]                  # the hot window is in it
    logs = {"port_logs" if writer == "reference" else "ref_logs":
            tmp_path / "cross"}
    port2, ref2 = _sentinels(tmp_path, run_id="runX", **logs)
    read = port2 if writer == "reference" else ref2
    assert read.engine.baseline_depth() == wrote.engine.baseline_depth() > 0
    assert read.engine.baseline_doc() == wrote.engine.baseline_doc()
    assert read.ticks == wrote.ticks
    assert read._flagged == wrote._flagged
    # the resumed sentinel never re-flags the windows flagged before
    read.refresh_once()
    assert read.last_error == "" and read.flags() == []


def test_audit_stays_zero_after_flagging_ticks(tmp_path, injected):
    _write_benign(tmp_path)
    _append(tmp_path / "w1.jsonl", _deny_storm(HOT, BASE + 5 * 60))
    port, ref = _sentinels(tmp_path)
    _tick(port, ref)
    _tick(port, ref)
    assert port.flags()
    assert port.audit() == ref.audit() == {
        "engine_calls": 0, "breaker_reports": 0, "placement_calls": 0}


def test_tick_span_lands_in_the_flight_recorder(tmp_path, injected):
    _write_benign(tmp_path)
    _append(tmp_path / "w1.jsonl", _deny_storm(HOT, BASE + 5 * 60))
    port, ref = _sentinels(tmp_path, run_id="runS")
    port.flight, ref.flight = [], []
    n = _tick(port, ref)
    _tick(port, ref)                       # idle: no span
    assert len(port.flight) == len(ref.flight) == 1
    spans = telemetry.load_spans(json.dumps(d) for d in port.flight)
    assert len(spans) == 1
    span, want = spans[0], ref.flight[0]
    assert span.name == want["name"] == telemetry.SPAN_SENTINEL_TICK
    assert span.trace_id == want["trace_id"] == "runS"
    assert set(span.attrs) == set(want["attrs"]) == {
        "windows", "flags", "device", "train_ms"}
    assert span.attrs["windows"] == want["attrs"]["windows"] == n
    assert span.attrs["flags"] == want["attrs"]["flags"] >= 1
    assert span.attrs["device"] == "cpu"
    assert span.t_end >= span.t_start


def test_ticking_thread_flags_a_live_storm_and_stops(tmp_path, injected):
    _write_benign(tmp_path)
    col = StreamCollector()
    col.add_local("fake-0", tmp_path / "w0.jsonl")
    col.add_local("fake-1", tmp_path / "w1.jsonl")
    errors = []
    s = FleetSentinel(_Cfg(tmp_path), interval_s=0.05,
                      train_steps=TRAIN_STEPS, collector=col,
                      on_error=errors.append, device="cpu")
    flagged = []
    bus = EventBus()
    bus.add_tap(lambda rec: rec.event == ANOMALY_FLAG
                and flagged.append(rec.agent))
    s.bind_run(events=bus)
    s.refresh_once()
    s.start()
    try:
        _append(tmp_path / "w1.jsonl", _deny_storm(HOT, BASE + 5 * 60))
        deadline = time.monotonic() + 30.0
        while HOT not in flagged and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        s.stop()
    assert HOT in flagged and errors == []
    assert not s._thread.is_alive()
    assert not col.alive                   # stop() stops the collector


# ------------------------------------------------------ a resumed run


SCORE_RTOL = 1e-3      # ROADMAP §3 item 5: fitted scores across packages


def _resumed_run(pkg: str, tmp_path):
    """A 4-loop run over 2 fake workers with the sentinel riding it,
    killed while its loops run, then resumed (``LoopScheduler.resume`` +
    ``reconcile``) with a fresh sentinel on the same run id: -> what each
    generation's sentinel saw and scored."""
    import threading

    from test_torch_warmpool import driver_with, side, wait_for
    from clawker_tpu.sentinel import FleetSentinel as RefFleetSentinel

    cls, extra = ((RefFleetSentinel, {}) if pkg == "ref"
                  else (FleetSentinel, {"device": "cpu"}))
    with side(pkg, tmp_path) as s:
        hold = threading.Event()

        def held(io) -> int:
            if not hold.is_set():
                hold.wait(20.0)
            return 0

        drv = driver_with(s.m, 2, behavior=held)
        sched1 = s.m.loop.LoopScheduler(
            s.cfg, drv, s.m.loop.LoopSpec(parallel=4, iterations=2),
            run_id="resumerun001")
        agents = [sched1._agent_name(i) for i in range(4)]
        for w in range(2):
            _append(s.cfg.logs_dir / f"ebpf-egress-fake-{w}.jsonl", [
                _rec(BASE + win * 60 + i * 3,
                     agent=f"clawker.loopproj.{a}", worker=f"fake-{w}",
                     ip=f"198.51.100.{k * 20 + i}")
                for k, a in enumerate(agents) if k % 2 == w
                for win in range(6) for i in range(12)])

        def sentinel():
            sen = cls(s.cfg, drv, run_id=sched1.loop_id, interval_s=999,
                      train_steps=TRAIN_STEPS, **extra)
            sen.behavior.clock = lambda: BASE + 5 * 60 + 30
            return sen

        sen1 = sentinel()
        sched1.attach_sentinel(sen1)
        sched1.start()
        t = threading.Thread(target=sched1.run, kwargs={"poll_s": 0.05},
                             daemon=True)
        t.start()
        assert wait_for(lambda: all(l.status == "running"
                                    for l in sched1.loops))
        first = sen1.refresh_once()
        depth1, flags1 = sen1.engine.baseline_depth(), _flag_set(sen1)
        sched1.kill()
        t.join(10.0)
        sen1.stop()
        # the storm lands while the scheduler is dead
        _append(s.cfg.logs_dir / "ebpf-egress-fake-1.jsonl",
                _deny_storm(f"clawker.loopproj.{agents[1]}", BASE + 5 * 60))
        image = s.m.journal.replay(s.m.journal.RunJournal.read(
            s.m.journal.journal_path(s.cfg.logs_dir, sched1.loop_id)))
        sched2 = s.m.loop.LoopScheduler.resume(s.cfg, drv, image)
        sen2 = sentinel()
        restored = sen2.engine.baseline_depth()
        sched2.attach_sentinel(sen2)
        summary = sched2.reconcile()
        hold.set()
        loops = sched2.run(poll_s=0.05)
        second = sen2.refresh_once()
        rep = sen2.last_tick
        out = {"first": first, "depth1": depth1, "flags1": flags1,
               "restored": restored, "summary": summary,
               "loops": [(l.status, l.iteration) for l in loops],
               "second": second, "flags2": _flag_set(sen2),
               "keys": [(k.agent, k.start_unix) for k in rep.keys],
               "raw": np.asarray(rep.raw), "z": np.asarray(rep.z),
               "ticks": sen2.ticks, "error": sen2.last_error}
        sen2.stop()
        sched2.cleanup(remove_containers=True)
        return out


def test_resumed_run_scores_with_restored_baselines_as_the_reference(
        tmp_path, injected):
    """The sentinel riding a resumed scheduler restores the first
    generation's baselines and scores the resumed generation as the
    reference's does: the same windows, raw scores within SCORE_RTOL,
    z within Z_ATOL, the same flags, and no window flagged in the first
    generation flagged again."""
    want = _resumed_run("ref", tmp_path)
    got = _resumed_run("port", tmp_path)
    for k in ("first", "depth1", "flags1", "restored", "summary", "loops",
              "second", "flags2", "keys", "ticks", "error"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["raw"], want["raw"], rtol=SCORE_RTOL)
    np.testing.assert_allclose(got["z"], want["z"], rtol=0, atol=Z_ATOL)
    assert got["first"] > 0 and got["second"] > 0
    assert got["restored"] == got["depth1"] > 0
    assert got["summary"]["adopted"] == 4
    assert got["loops"] == [("done", 2)] * 4
    assert got["error"] == ""
    assert not (got["flags1"] & got["flags2"])
