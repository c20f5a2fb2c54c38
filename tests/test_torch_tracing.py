"""The port's trace context, clock-skew estimator and cross-process
merge against the reference's: twins of the tests/test_tracing.py cases
for ``tracing.context``, ``tracing.skew`` and ``tracing.merge``.  Each
case runs on both packages' classes with the same inputs and holds the
port's result to the reference's: the merge's as the dict form of each
tree (``tree_to_dict``), the ids the merge draws for its gap spans
replaced.  The ``trace`` verb's twin renders one workerd-backed run's
flight records through both CLIs.
"""

from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import pytest

import clawker_tpu.telemetry.spans as ref_spans
import clawker_tpu.tracing.context as ref_context
import clawker_tpu.tracing.merge as ref_merge
import clawker_tpu.tracing.names as ref_names
import clawker_tpu.tracing.skew as ref_skew
import clawker_tpu_torch.telemetry.spans as port_spans
import clawker_tpu_torch.tracing.context as port_context
import clawker_tpu_torch.tracing.merge as port_merge
import clawker_tpu_torch.tracing.names as port_names
import clawker_tpu_torch.tracing.skew as port_skew

RUN = "run0000trace"
PKGS = {
    "ref": SimpleNamespace(context=ref_context, skew=ref_skew,
                           merge=ref_merge, spans=ref_spans),
    "port": SimpleNamespace(context=port_context, skew=port_skew,
                            merge=port_merge, spans=port_spans),
}


def each(fn):
    """``fn`` on both packages: -> (reference's result, port's)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


# ---------------------------------------------------------------- context


def test_traceparent_round_trip_and_child():
    def run(m):
        ctx = m.context.TraceContext(RUN, "a1b2c3d4e5f60718", agent="loop-0")
        back = m.context.TraceContext.from_header(ctx.to_header())
        kid = back.child(agent="loop-1")
        return (ctx.to_header(), back.trace_id, back.span_id, back.flags,
                kid.trace_id, kid.span_id != back.span_id, kid.agent)

    want, got = each(run)
    assert got == want
    assert got[:3] == (f"00-{RUN}-a1b2c3d4e5f60718-01", RUN,
                       "a1b2c3d4e5f60718")


@pytest.mark.parametrize("header", [
    "", "garbage", "00-onlythree-parts", "00--abc-01", "00-abc-def-zz",
    None, "xx" * 200,
])
def test_malformed_traceparent_degrades_to_none(header):
    assert each(lambda m: m.context.TraceContext.from_header(header)) == (
        None, None)


def test_rootless_header_parses_with_empty_span_id():
    def run(m):
        ctx = m.context.TraceContext.from_header(f"00-{RUN}--01")
        return ctx.trace_id, ctx.span_id, ctx.flags

    want, got = each(run)
    assert got == want == (RUN, "", 1)


def test_ambient_context_and_sinkless_record():
    def run(m):
        seen = [m.context.current()]
        got = []
        ctx = m.context.TraceContext(RUN, "feedfacefeedface",
                                     sink=got.append)
        with m.context.use(ctx):
            seen.append(m.context.current() is ctx)
            m.context.current().record("iteration", 1.0, 2.0, iteration=0)
        seen.append(m.context.current())
        rec = got[0]
        seen.append((len(got), rec.trace_id, rec.parent_id, rec.name,
                     rec.t_start, rec.t_end, rec.attrs))
        # a sink-less context records nothing and never raises
        seen.append(m.context.TraceContext(RUN, "00ddba11c0ffee00").record(
            "iteration", 1.0, 2.0))
        return seen

    want, got = each(run)
    assert got == want
    assert got[1] and got[3][:3] == (1, RUN, "feedfacefeedface")


def test_span_catalogue_matches_reference():
    assert port_names.SPAN_CATALOGUE == ref_names.SPAN_CATALOGUE
    assert port_names.SPAN_LOOPD_SUBMIT == ref_names.SPAN_LOOPD_SUBMIT


# ------------------------------------------------------------------- skew


def test_channel_clock_midpoint_ewma_and_min_rtt():
    def run(m):
        clock = m.skew.ChannelClock(alpha=0.5)
        # server 10.0 at client midpoint 5.0 -> offset +5.0 (first = direct)
        first = clock.observe(4.0, 10.0, 6.0)
        # next raw sample is +7.0 -> EWMA pulls halfway to 6.0
        second = clock.observe(4.0, 12.0, 6.0)
        return first, second, clock.stats()

    want, got = each(run)
    assert got == want
    assert got[:2] == (pytest.approx(5.0), pytest.approx(6.0))
    assert got[2]["samples"] == 2 and got[2]["rtt_s"] == pytest.approx(2.0)


def test_channel_clock_negative_skew_and_degenerate_samples():
    def run(m):
        clock = m.skew.ChannelClock()
        # remote clock BEHIND the client: offset estimates go negative
        clock.observe(100.0, 98.0, 100.2)
        before = clock.stats()
        # degenerate frames must never un-learn the estimate
        clock.observe(5.0, 0.0, 6.0)        # zero server ts
        clock.observe(6.0, 10.0, 5.0)       # t1 < t0
        return clock.offset_s, before, clock.stats()

    want, got = each(run)
    assert got == want
    assert got[0] < 0 and got[1] == got[2]


def test_channel_clock_cumulative_chains_offsets():
    def run(m):
        hop1, hop2 = m.skew.ChannelClock(), m.skew.ChannelClock()
        hop1.observe(100.0, 101.0, 100.0)   # +1s router->loopd
        hop2.observe(100.0, 99.75, 100.0)   # -0.25s loopd->workerd
        return hop2.cumulative(hop1.cumulative())

    want, got = each(run)
    assert got == want == pytest.approx(0.75)


# ------------------------------------------------------------------ merge


def _rec(m, span_id, name, t0, t1, *, parent="", agent="", worker="",
         **attrs):
    return m.spans.SpanRecord(trace_id=RUN, span_id=span_id,
                              parent_id=parent, name=name, agent=agent,
                              worker=worker, t_start=t0, t_end=t1,
                              attrs=attrs)


def _federated_sources(m, t=1000.0, *, with_workerd=True):
    """tests/test_tracing.py's minimal 4-recorder set: router + loopd
    hops, one agent with two iterations, worker-side segments for
    iteration 0 only when asked."""
    sched = []
    workerd = []
    for it in range(2):
        base = t + 0.1 + it
        root = f"it000x{it}"
        sched.append(_rec(m, root, "iteration", base, base + 0.5,
                          agent="a-0", worker="w0", iteration=it,
                          ctx_parent="lpd0"))
        sched.append(_rec(m, f"{root}c", "create", base, base + 0.1,
                          parent=root, agent="a-0", worker="w0",
                          iteration=it, workerd=True, wan_ms=25.0))
        if with_workerd or it == 0:
            workerd.append(_rec(m, f"{root}w", "workerd.create",
                                base + 0.01, base + 0.09, agent="a-0",
                                worker="w0", iteration=it, skew_s=0.002))
    return {
        "router:router-front": [_rec(
            m, "rtr0", "router.submit", t, t + 0.05, worker="front",
            pod="podA", wan_ms=50.0)],
        "loopd:loopd-podA": [_rec(
            m, "lpd0", "loopd.submit", t + 0.02, t + 0.04, worker="podA",
            ctx_parent="rtr0", skew_s=0.001)],
        "scheduler": sched,
        "workerd:workerd-w0": workerd,
    }


def _skewed(recs, *skews):
    return [dataclasses.replace(r, attrs={**r.attrs, "skew_s": k})
            if k is not None else r for r, k in zip(recs, skews)]


def _case_four(m):
    return _federated_sources(m)


def _case_dead_workerd(m):
    return _federated_sources(m, with_workerd=False)


def _case_torn_upstream(m):
    src = _federated_sources(m)
    del src["router:router-front"]      # upstream recorder lost whole
    return src


def _case_duplicate(m):
    src = _federated_sources(m)
    stale = _rec(m, "rtr0", "router.submit", 999.0, 999.1, worker="front",
                 stale=True)
    src["router:router-front"] = [stale] + src["router:router-front"]
    return src


def _case_other_runs(m):
    src = _federated_sources(m)
    src["scheduler"] = src["scheduler"] + [m.spans.SpanRecord(
        trace_id="otherrun", span_id="zzz", parent_id="",
        name="iteration", agent="x", worker="w0", t_start=1.0, t_end=2.0)]
    return src


def _case_skew_suspect(m):
    src = _federated_sources(m)
    src["workerd:workerd-w0"] = _skewed(src["workerd:workerd-w0"], 5.0, None)
    return src


def _case_negative_skew(m):
    src = _federated_sources(m)
    src["workerd:workerd-w0"] = _skewed(src["workerd:workerd-w0"],
                                        -0.004, -0.004)
    return src


def _case_offset_step(m):
    src = _federated_sources(m)
    src["workerd:workerd-w0"] = _skewed(src["workerd:workerd-w0"], None,
                                        -2.0)
    return src


MERGE_CASES = {
    # case -> (sources, roots, gaps, skew suspects)
    "four-recorders": (_case_four, 1, 0, 0),
    "dead-workerd-gap": (_case_dead_workerd, 1, 1, 0),
    "torn-upstream": (_case_torn_upstream, 1, 1, 0),
    "duplicate-span-id": (_case_duplicate, 1, 0, 0),
    "other-runs-filtered": (_case_other_runs, 1, 0, 0),
    "skew-suspect": (_case_skew_suspect, 1, 0, 1),
    "negative-skew-tolerated": (_case_negative_skew, 1, 0, 0),
    "mid-run-offset-change": (_case_offset_step, 1, 0, 1),
    "causal-submit-edge": (_case_four, 1, 0, 0),
}


def _merged(doc: dict) -> dict:
    """A MergeResult's dict with the span ids the merge drew for its
    ``expect=workerd`` gap spans replaced (uuid-random on both sides)."""
    def walk(node):
        if node["attrs"].get("expect") == "workerd":
            node["span_id"] = "GAP"
        for c in node["children"]:
            walk(c)

    for tree in doc["trees"]:
        walk(tree)
    return doc


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_matches_reference(case):
    build, roots, gaps, suspects = MERGE_CASES[case]

    def run(m):
        res = m.merge.merge_records(build(m), RUN)
        return (_merged(res.to_dict()), m.merge.hop_waits(res.roots),
                [r.record.name for r in res.roots])

    want, got = each(run)
    assert got == want
    doc, waits, names = got
    assert (len(doc["trees"]), doc["gaps"], doc["skew_suspects"]) == (
        roots, gaps, suspects)
    assert all(t["trace_id"] == RUN for t in doc["trees"])
    assert names == (["gap"] if case == "torn-upstream"
                     else ["router.submit"])
    if case == "four-recorders":
        assert waits == {"create": 50.0, "router.submit": 50.0}
    if case == "duplicate-span-id":
        assert "stale" not in doc["trees"][0]["attrs"]
    if case == "causal-submit-edge":
        # the iterations loopd.submit causally parents outlive the RPC
        # and are no containment violation
        (submit,) = doc["trees"][0]["children"]
        assert all(c["t_end"] > submit["t_end"]
                   and not c["attrs"].get("skew_suspect")
                   for c in submit["children"])


def test_merge_constants_match_reference():
    assert port_merge.SKEW_TOLERANCE_S == ref_merge.SKEW_TOLERANCE_S
    assert port_names.SPAN_GAP == ref_names.SPAN_GAP


def test_trace_verb_json_and_waterfall_match_reference(tmp_path,
                                                       monkeypatch):
    """``trace RUN --json`` and the waterfall over one workerd-backed
    run's flight records (the port's scheduler over two fake workers'
    workerd, both recorder families in one logs dir), rendered by the
    reference's CLI and by the port's."""
    from click.testing import CliRunner

    import clawker_tpu.cli.factory as ref_factory
    import clawker_tpu.cli.root as ref_root
    import clawker_tpu.config as ref_config
    import clawker_tpu_torch.cli as port_cli
    from test_torch_workerd import (
        IMAGE,
        PKGS as WD_PKGS,
        driver_with,
        pod,
        side,
        teardown,
    )

    with side("port", tmp_path) as s:
        drv = driver_with(WD_PKGS["port"], 2)
        servers, execset = pod(s, drv)
        try:
            sched = s.m.loop.LoopScheduler(
                s.cfg, drv, s.m.loop.LoopSpec(parallel=2, iterations=2,
                                              image=IMAGE),
                executors=execset)
            sched.start()
            sched.run(poll_s=0.1)
            sched.cleanup(remove_containers=True)
        finally:
            teardown(servers, execset, drv)
        run_id = sched.loop_id
        ref_cfg = ref_config.load_config(s.proj)
        ref_root.register_commands()
        out = {}
        for pkg, cli, factory in (
                ("ref", ref_root.cli, ref_factory.Factory(config=ref_cfg)),
                ("port", port_cli.cli, port_cli.Factory(config=s.cfg))):
            runner = CliRunner()
            doc = runner.invoke(cli, ["trace", run_id[:6], "--json"],
                                obj=factory, catch_exceptions=False)
            text = runner.invoke(cli, ["trace", run_id], obj=factory,
                                 catch_exceptions=False)
            out[pkg] = (doc.exit_code, json.loads(doc.output),
                        text.exit_code, text.output)
    assert out["port"] == out["ref"]
    rc, doc, text_rc, text = out["port"]
    assert rc == text_rc == 0
    # one rooted tree per iteration, each with its worker-side segment
    assert doc["run"] == run_id and doc["gaps"] == 0
    assert len(doc["trees"]) == 4
    assert all(t["name"] == "iteration" and any(
        c["name"].startswith("workerd.") for c in t["children"])
        for t in doc["trees"])
    assert set(doc["sources"]) == {"scheduler", "workerd:workerd-fake-0",
                                   "workerd:workerd-fake-1"}
    assert "workerd.start" in text and "per-hop WAN wait:" in text
