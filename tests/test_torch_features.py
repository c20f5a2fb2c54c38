"""The port's numpy copies against the reference package.

clawker_tpu_torch keeps its own copies of the featurizers, the JSONL tail
reader and the synthetic stream of ``chip_smoke.py``; the same records
must give byte-equal arrays, equal keys and the same tail behavior.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

import chip_smoke
from bench import synth_egress_records
from clawker_tpu.analytics import features as ref_F
from clawker_tpu.monitor import ledger as ref_ledger
from clawker_tpu.sentinel import features as ref_SF
from clawker_tpu_torch.analytics import features as F
from clawker_tpu_torch.monitor import ledger
from clawker_tpu_torch.sentinel import features as SF

BASE = 1_700_000_000 - 1_700_000_000 % 60  # window-aligned


def _rec(ts, agent="clawker.loop-0", verdict="ALLOW", reason="ROUTE",
         ip="198.51.100.9", port=443, proto=6, zone="example.com",
         worker=None):
    r = {"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
         "service": "ebpf-egress", "container": agent, "dst_ip": ip,
         "dst_port": port, "proto": proto, "verdict": verdict,
         "reason": reason, "zone": zone}
    if worker:
        r["worker"] = worker
    return r


def _lane_stream():
    """tests/test_analytics_lane.py's scorer stream with the hot agent."""
    recs = []
    for a in range(4):
        for w in range(6):
            for i in range(12):
                recs.append(_rec(BASE + w * 60 + i * 3,
                                 agent=f"clawker.loop-{a}",
                                 ip=f"198.51.100.{a * 20 + i}"))
    for i in range(55):
        recs.append(_rec(BASE + 5 * 60 + i % 59, agent="clawker.loop-3",
                         verdict="DENY", reason="NO_DNS_ENTRY",
                         ip=f"203.0.113.{i}", port=4444 + i, zone=""))
    return recs


def _semantics_stream():
    return [_rec(BASE, verdict="DENY", reason="NO_DNS_ENTRY"),
            _rec(BASE + 1), _rec(BASE + 1, port=53, proto=17),
            {"no": "timestamp"}, {"@timestamp": "garbage"}]


def _sentinel_fleet():
    """tests/test_sentinel.py's benign 8-loop/4-worker fleet + deny storm."""
    recs = []
    for a in range(8):
        for w in range(6):
            for i in range(12):
                recs.append(_rec(BASE + w * 60 + i * 3,
                                 agent=f"clawker.p.loop-{a}",
                                 worker=f"fake-{a % 4}",
                                 ip=f"198.51.100.{a * 20 + i}"))
    recs += [_rec(BASE + 300 + i % 59, agent="clawker.p.loop-hot",
                  worker="fake-1", verdict="DENY", reason="NO_DNS_ENTRY",
                  ip=f"203.0.113.{i}", port=4444 + i, zone="")
             for i in range(55)]
    return recs


STREAMS = {
    "bench_synth": lambda: synth_egress_records(agents=4, windows=8,
                                                per_window=20),
    "lane_hot_agent": _lane_stream,
    "feature_semantics": _semantics_stream,
    "sentinel_fleet": _sentinel_fleet,
}


def _key_list(keys):
    return [(k.agent, k.start_unix) for k in keys]


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("window_s", [60, 30])
def test_featurize_copy_equals_reference(stream, window_s):
    recs = STREAMS[stream]()
    keys, X = F.featurize(recs, window_s=window_s)
    ref_keys, ref_X = ref_F.featurize(recs, window_s=window_s)
    assert _key_list(keys) == _key_list(ref_keys)
    assert X.dtype == ref_X.dtype and np.array_equal(X, ref_X)
    z = np.linspace(-1.0, 4.0, len(keys)).astype(np.float32)
    assert [vars(a) for a in F.summarize(keys, z)] == \
        [vars(a) for a in ref_F.summarize(ref_keys, z)]


def _tracker(mod):
    tracker = mod.BehaviorTracker(window_s=60, clock=lambda: BASE + 10)
    for _ in range(3):
        tracker.observe("loop-0", "iteration_start")
        tracker.observe("loop-0", "iteration_done", "0:1")
    tracker.observe("loop-quiet", "orphaned", "fake-1: dead")
    tracker.observe("loop-quiet", "migrated", "fake-1->fake-2")
    return tracker


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("with_behavior", [False, True])
def test_featurize_fused_copy_equals_reference(stream, with_behavior):
    recs = STREAMS[stream]()
    keys, X, worker_of = SF.featurize_fused(
        recs, _tracker(SF) if with_behavior else None)
    ref_keys, ref_X, ref_worker_of = ref_SF.featurize_fused(
        recs, _tracker(ref_SF) if with_behavior else None)
    assert SF.EXT_FEATURES == ref_SF.EXT_FEATURES == 40
    assert _key_list(keys) == _key_list(ref_keys)
    assert np.array_equal(X, ref_X) and X.dtype == ref_X.dtype
    assert worker_of == ref_worker_of


@pytest.mark.parametrize("kwargs", [{}, {"agents": 3, "windows": 5,
                                         "per_window": 7}])
def test_chip_smoke_synth_copy_equals_bench(kwargs):
    assert chip_smoke.synth_egress_records(**kwargs) == \
        synth_egress_records(**kwargs)


def test_load_jsonl_copy_tolerates_partial_lines(tmp_path):
    p = tmp_path / "egress.jsonl"
    p.write_text(json.dumps(_rec(BASE)) + "\n{broken\n"
                 + json.dumps(_rec(BASE + 1)) + "\n")
    assert F.load_jsonl(p) == ref_F.load_jsonl(p)
    assert len(F.load_jsonl(p)) == 2


def _tail_both(path, states):
    return (ledger.tail_jsonl(path, states[0]),
            ref_ledger.tail_jsonl(path, states[1]))


def test_tail_jsonl_copy_matches_reference(tmp_path):
    p = tmp_path / "egress.jsonl"
    states = (ledger.TailState(), ref_ledger.TailState())
    checksummed = ref_ledger.encode_record(_rec(BASE + 5))
    bad_crc = checksummed[:-3] + ('0' if checksummed[-3] != '0' else '1') \
        + checksummed[-2:]
    p.write_text(json.dumps(_rec(BASE)) + "\n{garbage\n" + checksummed
                 + "\n" + bad_crc + "\n" + json.dumps(_rec(BASE + 2))[:9])
    got, want = _tail_both(p, states)
    assert got == want and len(got) == 2
    assert states[0].offset == states[1].offset == p.stat().st_size
    # the torn tail is carried and completed by the next append
    with open(p, "a") as f:
        f.write(json.dumps(_rec(BASE + 2))[9:] + "\n")
    got, want = _tail_both(p, states)
    assert got == want and len(got) == 1
    # truncation resets both cursors the same way
    p.write_text(json.dumps(_rec(BASE + 300)) + "\n")
    got, want = _tail_both(p, states)
    assert got == want and len(got) == 1
    assert states[0].resets == states[1].resets == 1
    assert states[0].offset == states[1].offset


@pytest.mark.parametrize("line", [
    "", "   ", "{broken", "[1, 2]", json.dumps({"a": 1}),
    '{"a":1,"c":"00000000"}',
])
def test_classify_line_copy_matches_reference(line):
    assert ledger.classify_line(line) == ref_ledger.classify_line(line)


def test_classify_line_verifies_checksums_like_reference():
    line = ref_ledger.encode_record({"agent": "a", "n": 3})
    assert ledger.classify_line(line) == ref_ledger.classify_line(line) \
        == ("ok", {"agent": "a", "n": 3})
