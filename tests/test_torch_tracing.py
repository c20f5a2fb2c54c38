"""The port's trace context and clock-skew estimator against the
reference's: twins of the tests/test_tracing.py cases that need only
``tracing.context`` and ``tracing.skew`` (the merge's cases wait for
``tracing/merge.py``, which comes with workerd and federation: ROADMAP
§1 items 4 and 13).  Each case runs on both packages' classes with the
same inputs and holds the port's result to the reference's.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import clawker_tpu.tracing.context as ref_context
import clawker_tpu.tracing.names as ref_names
import clawker_tpu.tracing.skew as ref_skew
import clawker_tpu_torch.tracing.context as port_context
import clawker_tpu_torch.tracing.names as port_names
import clawker_tpu_torch.tracing.skew as port_skew

RUN = "run0000trace"
PKGS = {
    "ref": SimpleNamespace(context=ref_context, skew=ref_skew),
    "port": SimpleNamespace(context=port_context, skew=port_skew),
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
