"""The port's terminal views against the reference's, byte for byte.

Twins of tests/test_ui.py's iostreams, colour and table cases
(:32-122), tests/test_fleetconsole.py (the painter, the feed,
virtualization, ``SpanTail``, the 256-agent repaint budget, every
section, ``merge_feeds``, the multi-pod feed, the dashboard's dirty
rows, the run-count bound, ``fleet console --once`` / ``--format json``
and the no-daemon exit) and tests/test_egress_feed.py's local cases
(:28, :44, :84, :104).  Each twin runs the same input through both
packages and holds the port's output to the reference's: the painted
bytes, the frame lines with colour on and with colour off, the tails.
The frames' clocks (elapsed seconds, event timestamps) are fixed
through each ui module's ``time``.

The two SSH-tail cases of tests/test_egress_feed.py
(``test_remote_tail_rides_ssh_mux`` and the transport half of
``add_worker``) are twinned over the port's ``SSHTransport`` in
tests/test_torch_fleet.py.  tests/test_ui.py's progress and buildview
cases (:130-200) are twinned at the end, their clocks fixed through each
``progress`` module's ``time``; its prompter cases are twinned in
tests/test_torch_verbs.py.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.fleet.egress_tail as ref_egress
import clawker_tpu.loopd.feed as ref_feed
import clawker_tpu.monitor.ledger as ref_ledger
import clawker_tpu.telemetry.spans as ref_spans
import clawker_tpu.ui.buildview as ref_buildview
import clawker_tpu.ui.colors as ref_colors
import clawker_tpu.ui.damage as ref_damage
import clawker_tpu.ui.dashboard as ref_dashboard
import clawker_tpu.ui.fleetconsole as ref_console
import clawker_tpu.ui.iostreams as ref_iostreams
import clawker_tpu.ui.progress as ref_progress
import clawker_tpu.ui.table as ref_table
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.fleet.egress_tail as port_egress
import clawker_tpu_torch.loopd.feed as port_feed
import clawker_tpu_torch.monitor.ledger as port_ledger
import clawker_tpu_torch.telemetry.spans as port_spans
import clawker_tpu_torch.ui.buildview as port_buildview
import clawker_tpu_torch.ui.colors as port_colors
import clawker_tpu_torch.ui.damage as port_damage
import clawker_tpu_torch.ui.dashboard as port_dashboard
import clawker_tpu_torch.ui.fleetconsole as port_console
import clawker_tpu_torch.ui.iostreams as port_iostreams
import clawker_tpu_torch.ui.progress as port_progress
import clawker_tpu_torch.ui.table as port_table
from test_torch_loopd import (  # noqa: F401
    _time_limit,
    daemon,
    driver_with,
    invoke,
    norm,
    run_to_done,
    twin,
)

PKGS = {
    "ref": SimpleNamespace(
        colors=ref_colors, iostreams=ref_iostreams, table=ref_table,
        damage=ref_damage, dashboard=ref_dashboard, console=ref_console,
        feed=ref_feed, egress=ref_egress, ledger=ref_ledger,
        spans=ref_spans, drivers=ref_drivers, progress=ref_progress,
        buildview=ref_buildview),
    "port": SimpleNamespace(
        colors=port_colors, iostreams=port_iostreams, table=port_table,
        damage=port_damage, dashboard=port_dashboard, console=port_console,
        feed=port_feed, egress=port_egress, ledger=port_ledger,
        spans=port_spans, drivers=port_drivers, progress=port_progress,
        buildview=port_buildview),
}
COLOUR = {"on": {"TERM": "xterm-256color"}, "off": {"NO_COLOR": "1"}}


def both(fn):
    """``fn(m)`` for the reference's modules, then the port's: ->
    (reference's result, port's)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


class FixedTime:
    """A ui module's ``time``: a clock that does not move."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def monotonic(self) -> float:
        return self.now

    def strftime(self, fmt: str) -> str:
        return "12:34:56"

    perf_counter = staticmethod(time.perf_counter)


@pytest.fixture
def fixed_clock(monkeypatch):
    clock = FixedTime()
    for m in PKGS.values():
        monkeypatch.setattr(m.dashboard, "time", clock)
        monkeypatch.setattr(m.console, "time", clock)
    return clock


def tty(streams):
    """Dress the buffer streams as a TTY (out + err + in)."""
    for stream in (streams.stdin, streams.stdout, streams.stderr):
        stream.isatty = lambda: True
    return streams


def streams_for(m, colour: str):
    """A TTY over buffers with colour ``on`` or ``off``: -> (streams,
    stdout buffer)."""
    s, _, out, _ = m.iostreams.IOStreams.test()
    s.env = dict(COLOUR[colour])
    return tty(s), out


class Sink:
    def __init__(self):
        self.chunks: list[str] = []

    def write(self, s: str) -> None:
        self.chunks.append(s)

    def flush(self) -> None:
        pass

    def text(self) -> str:
        return "".join(self.chunks)


def wait_for(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.05)
    return False


# -------------------------------------------------------------- iostreams


def test_quad_buffer_constructor_no_tty_no_color():
    def run(m):
        s, fin, fout, ferr = m.iostreams.IOStreams.test()
        probes = (s.is_stdout_tty(), s.is_interactive(), s.color_enabled(),
                  s.terminal_width())
        s.println("hello")
        s.eprintln("oops")
        return probes, fout.getvalue(), ferr.getvalue()

    want, got = both(run)
    assert got == want == ((False, False, False, 80), "hello\n", "oops\n")


@pytest.mark.parametrize("env,is_tty,expect", [
    ({}, True, True),
    ({}, False, False),
    ({"NO_COLOR": "1"}, True, False),
    ({"CLICOLOR_FORCE": "1"}, False, True),
    ({"CLICOLOR": "0"}, True, False),
    ({"TERM": "dumb"}, True, False),
])
def test_color_detection_matrix(env, is_tty, expect):
    def run(m):
        s, *_ = m.iostreams.IOStreams.test()
        s.env = env
        if is_tty:
            tty(s)
        return s.color_enabled(), s.colors().red("x")

    want, got = both(run)
    assert got == want
    assert got[0] is expect


def test_color_capability_tiers():
    def run(m):
        s, *_ = m.iostreams.IOStreams.test()
        out = []
        for env in ({"TERM": "xterm-256color"}, {"COLORTERM": "truecolor"},
                    {"COLORTERM": "24bit"}, {}):
            s.env = env
            out.append((s.is_256_color(), s.is_truecolor()))
        return out

    want, got = both(run)
    assert got == want
    assert got[0] == (True, False) and got[1] == (True, True)


def test_spinner_noop_without_tty():
    def run(m):
        s, _, _, ferr = m.iostreams.IOStreams.test()
        return s.run_with_progress("working", lambda: 42), ferr.getvalue()

    want, got = both(run)
    assert got == want == (42, "")


def test_spinner_animates_on_tty():
    """The frames depend on the clock; their bytes may not: the same
    first frame, the same erase at the end."""
    def run(m):
        s, _, _, ferr = m.iostreams.IOStreams.test()
        tty(s)
        s.start_progress("thinking")
        time.sleep(0.25)
        s.stop_progress()
        frames = ferr.getvalue().split("\r\x1b[2K")
        return frames[1], frames[-1], m.iostreams.SPINNER_FRAMES

    want, got = both(run)
    assert got == want
    assert got[0] == got[2][0] + " thinking" and got[1] == ""


def test_never_prompt_gates_can_prompt():
    def run(m):
        s, *_ = m.iostreams.IOStreams.test()
        tty(s)
        before = s.can_prompt()
        s.set_never_prompt(True)
        return before, s.can_prompt()

    want, got = both(run)
    assert got == want == (True, False)


def test_alt_screen_and_println_bytes():
    def run(m):
        s, _, out, err = m.iostreams.IOStreams.test()
        tty(s)
        s.start_alt_screen()
        s.start_alt_screen()
        s.println("a", "b")
        s.stop_alt_screen()
        s.eprintln("c")
        return out.getvalue(), err.getvalue()

    want, got = both(run)
    assert got == want


# ----------------------------------------------------------------- colors


@pytest.mark.parametrize("enabled", [False, True], ids=["plain", "wraps"])
def test_colorscheme_every_style(enabled):
    def run(m):
        cs = m.colors.ColorScheme(enabled=enabled)
        styles = [getattr(cs, k)("abc") for k in (
            "bold", "dim", "red", "green", "yellow", "blue", "magenta",
            "cyan", "invert", "gray")]
        states = [cs.status(s) for s in ("running", "done", "failed",
                                         "stopped", "pending", "")]
        icons = [cs.success_icon(), cs.warning_icon(), cs.failure_icon()]
        return styles, states, icons, cs.red("")

    want, got = both(run)
    assert got == want
    if enabled:
        assert got[0][2] == "\x1b[31mabc\x1b[0m"
    else:
        assert set(got[0]) == {"abc"} and got[2][0] == "+"


def test_visible_len_ignores_escapes():
    cs = port_colors.ColorScheme(enabled=True)
    cells = [cs.red("abc") + cs.bold("de"), "plain", "", "\x1b[31m", "x\x1b"]
    assert ([port_colors.visible_len(c) for c in cells]
            == [ref_colors.visible_len(c) for c in cells])
    assert port_colors.visible_len(cells[0]) == 5


# ------------------------------------------------------------------ table


@pytest.mark.parametrize("colour", ["on", "off"])
def test_table_alignment_ansi_aware(colour):
    def run(m):
        cs = m.colors.ColorScheme(enabled=colour == "on")
        return m.table.render_table(
            ["NAME", "STATE", "Z"],
            [["dev", cs.green("running"), "1.0"],
             ["longer-name", cs.red("failed")],
             ["x", "", cs.red("9.9")]])

    want, got = both(run)
    assert got == want
    lines = got.splitlines()
    offsets = {port_colors.visible_len(l.split("running")[0])
               for l in lines if "running" in l}
    offsets |= {port_colors.visible_len(l.split("failed")[0])
                for l in lines if "failed" in l}
    assert len(offsets) == 1


@pytest.mark.parametrize("max_width", [20, 9, 0])
def test_table_truncates_to_max_width(max_width):
    def run(m):
        cs = m.colors.ColorScheme(enabled=True)
        return m.table.render_table(
            ["A", "B"], [["x" * 100, cs.red("y" * 30)]],
            max_width=max_width, gap=3)

    want, got = both(run)
    assert got == want
    if max_width == 20:
        assert "…" in got


# --------------------------------------------------------------- painter


PAINTS = {
    "first-frame": [["a", "b", "c"]],
    "unchanged": [["a", "b", "c"], ["a", "b", "c"]],
    "dirty-rows": [["a", "b", "c", "d"], ["a", "B", "c", "d"]],
    "growth-and-shrink": [["a"], ["a", "b", "c"], ["a"], ["a"]],
    "reset": [["a", "b"], None, ["a", "b"]],
}


@pytest.mark.parametrize("frames", list(PAINTS.values()), ids=list(PAINTS))
def test_damage_painter_twin(frames):
    """Each painted chunk, each paint's rewritten rows and the counters
    equal the reference's."""
    def run(m):
        sink = Sink()
        p = m.damage.DamagePainter(sink.write, sink.flush)
        out = []
        for lines in frames:
            if lines is None:
                p.reset()
                continue
            sink.chunks.clear()
            out.append((p.paint(lines), sink.text()))
        return out, p.stats()

    want, got = both(run)
    assert got == want
    if frames is PAINTS["unchanged"]:
        assert got[0][1] == (0, "\x1b[3A\x1b[3B")


# ------------------------------------------------------------------ feed


def _status_doc() -> dict:
    return {
        "pid": 99, "project": "p", "uptime_s": 7.5,
        "runs": [{
            "run": "r1", "state": "running", "tenant": "t", "client": "c",
            "parallel": 2, "iterations": 3, "placement": "spread",
            "subscribers": 1, "events_dropped": 4,
            "agents": [
                {"agent": "a0", "worker": "w0", "status": "running",
                 "iteration": 2, "exit_codes": [0, 0]},
                {"agent": "a1", "worker": "w1", "status": "failed",
                 "iteration": 1, "exit_codes": []},
            ]}],
        "admission": {"workers": {"w0": {"inflight": 1, "capacity": 4,
                                         "pending": 0, "rejected": 0}},
                      "tenants": {"t": {"weight": 1.0, "inflight": 1,
                                        "queued": 0, "dispatched": 3}}},
        "health": [{"worker": "w0", "state": "closed",
                    "breaker_state_gauge": 0, "probe_p50_ms": 1.0}],
        "workerd": {"w0": "ok"},
        "warm_pools": {"r1": {"target_depth": 2, "hits": 3, "misses": 1,
                              "workers": {"w0": {"ready": 2}}}},
        "sentinel": {"enabled": True, "rows": [
            {"agent": "a1", "worker": "w1", "latest_z": 4.4,
             "flagged": True}]},
        "shipper": {"enabled": True, "ingested_docs": 10,
                    "pending_batches": 0, "dropped_docs": 0},
        "events_dropped_total": 4,
    }


@pytest.mark.parametrize("doc", [_status_doc(), {}], ids=["full", "sparse"])
def test_console_feed_twin(doc):
    want, got = both(lambda m: m.feed.console_feed(doc))
    assert got == want
    if doc:
        assert got["runs"][0]["agents"][1]["anomaly_z"] == 4.4
    else:
        assert got["runs"] == [] and got["shipper"] == {"enabled": False}


# -------------------------------------------------------- virtualization


def _agents(n: int, run: int, status: str = "running") -> list[dict]:
    return [{"agent": f"r{run}-a{i:03d}", "worker": f"w{i % 4}",
             "status": status, "iteration": 1, "exits": "-",
             "anomaly_z": None} for i in range(n)]


def test_virtualize_below_budget_shows_everything():
    runs = [{"run": "r0", "agents": _agents(10, 0)}]
    want, got = both(lambda m: m.console.virtualize(runs))
    assert got == want
    ((_, visible, hidden),) = got
    assert len(visible) == 10 and hidden == 0


def test_virtualize_bounds_rows_and_keeps_interesting_first():
    runs = []
    for r in range(4):
        agents = _agents(64, r)
        agents[50]["status"] = "failed"
        agents[51]["anomaly_z"] = 9.9
        runs.append({"run": f"r{r}", "agents": agents})
    want, got = both(lambda m: m.console.virtualize(
        runs, budget=m.console.MAX_AGENT_ROWS))
    assert got == want
    assert sum(len(v) for _, v, _ in got) <= port_console.MAX_AGENT_ROWS
    for _, visible, hidden in got:
        assert any(a["status"] == "failed" for a in visible)
        assert any(a.get("anomaly_z") == 9.9 for a in visible)


# -------------------------------------------------------------- spantail


def _write_spans(path: Path, n: int, t0: float = 0.0, trace: str = "r1"):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        for i in range(n):
            root = ref_spans.SpanRecord(
                trace_id=trace, span_id=f"s{t0}-{i}", parent_id="",
                name="iteration", agent=f"a{i % 4}", worker="w0",
                t_start=t0 + i, t_end=t0 + i + 0.8,
                attrs={"iteration": i})
            child = ref_spans.SpanRecord(
                trace_id=trace, span_id=f"c{t0}-{i}",
                parent_id=f"s{t0}-{i}", name="wait", agent=root.agent,
                worker="w0", t_start=t0 + i + 0.2, t_end=t0 + i + 0.7)
            fh.write(json.dumps(root.to_json()) + "\n")
            fh.write(json.dumps(child.to_json()) + "\n")


def _write_hops(path: Path, trace: str = "r1"):
    """A workerd segment per iteration and a loopd submit hop: the
    remote rows of the waterfall."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        for i in range(2):
            rec = ref_spans.SpanRecord(
                trace_id=trace, span_id=f"w{i}", parent_id="", agent="a0",
                name="workerd.create", worker="w0", t_start=i + 0.1,
                t_end=i + 0.3, attrs={"iteration": i, "skew_s": 0.01,
                                      "wan_ms": 2.5})
            fh.write(json.dumps(rec.to_json()) + "\n")
        hop = ref_spans.SpanRecord(
            trace_id=trace, span_id="h", parent_id="", name="loopd.submit",
            agent="", worker="", t_start=-0.5, t_end=-0.4)
        fh.write(json.dumps(hop.to_json()) + "\n")


@pytest.mark.parametrize("colour", ["on", "off"])
def test_spantail_incremental_and_bounded(tmp_path, colour):
    path = tmp_path / "flight" / "loop-r1.jsonl"
    _write_spans(path, 3)
    _write_hops(tmp_path / "flight" / "workerd-w0.jsonl")

    def run(m):
        cs = m.colors.ColorScheme(enabled=colour == "on")
        tail = m.console.SpanTail(path, limit=8, remote_dir=path.parent,
                                  run_id="r1")
        first = tail.poll()
        return first, tail.waterfall_lines(cs), tail

    (n0, want_lines, ref_tail), (n1, got_lines, port_tail) = both(run)
    assert (n1, got_lines) == (n0, want_lines)
    assert n1 == 9 and any("=" in l for l in got_lines)
    assert any("↳" in l for l in got_lines)
    # incremental and bounded: only the new records parse
    _write_spans(path, 2, t0=100.0)
    assert port_tail.poll() == ref_tail.poll() == 4
    assert len(port_tail.records) == len(ref_tail.records) == 8
    cs = port_colors.ColorScheme(enabled=colour == "on")
    assert (port_tail.waterfall_lines(cs)
            == ref_tail.waterfall_lines(ref_colors.ColorScheme(
                enabled=colour == "on")))


def test_tail_rotated_drains_the_rotated_generation(tmp_path):
    """A recorder that rotates between two polls: both packages' tails
    return every record once, in order, and bump ``resets``."""
    path = tmp_path / "flight.jsonl"
    states = {pkg: m.ledger.TailState() for pkg, m in PKGS.items()}

    def poll():
        return {pkg: [d["n"] for d in PKGS[pkg].ledger.tail_rotated(
            path, states[pkg])] for pkg in PKGS}

    def write(ns, *, partial: str = ""):
        with open(path, "a") as fh:
            for n in ns:
                fh.write(json.dumps({"n": n}) + "\n")
            fh.write(partial)

    write(range(3))
    first = poll()
    write(range(3, 5), partial='{"n": 5')    # a torn tail, then rotation
    with open(path, "a") as fh:
        fh.write("}\n")
    os.replace(path, port_ledger.rotated_path(path))
    write(range(6, 8))
    second = poll()
    write(range(8, 9))
    third = poll()
    assert first["port"] == first["ref"] == [0, 1, 2]
    assert second["port"] == second["ref"] == [3, 4, 5, 6, 7]
    assert third["port"] == third["ref"] == [8]
    assert (states["port"].resets, states["port"].offset) == (
        states["ref"].resets, states["ref"].offset)
    assert states["port"].resets == 1
    # read_rotated crosses the boundary as the reference's does
    assert (port_ledger.read_rotated(path) == ref_ledger.read_rotated(path)
            == [{"n": n} for n in range(9)])


# ---------------------------------------------------- repaint budget @256


def _budget_doc(statuses: dict) -> dict:
    runs = []
    for r in range(4):
        agents = []
        for i in range(64):
            status, iteration = statuses.get((r, i), ("running", 1))
            agents.append({"agent": f"loop-r{r}-{i:03d}",
                           "worker": f"w{i % 4}", "status": status,
                           "iteration": iteration, "exit_codes": [0]})
        runs.append({"run": f"run{r}", "state": "running",
                     "tenant": f"t{r}", "client": "x", "parallel": 64,
                     "iterations": 4, "placement": "spread",
                     "subscribers": 1, "events_dropped": 0,
                     "agents": agents})
    return {"pid": 1, "project": "p", "uptime_s": 1.0, "runs": runs,
            "admission": {"workers": {}, "tenants": {}}, "health": [],
            "workerd": {}, "warm_pools": {},
            "sentinel": {"enabled": True, "rows": [
                {"agent": "loop-r2-007", "latest_z": 6.25}]},
            "shipper": {"enabled": False}, "events_dropped_total": 0}


@pytest.mark.parametrize("colour", ["on", "off"])
def test_repaint_budget_256_agents_4_runs(fixed_clock, colour):
    """4 hosted runs x 64 agents, 8 rows churning a frame: every painted
    frame's bytes equal the reference's; the port's frame stays bounded
    and its steady-state frames repaint under half their rows."""
    def run(m):
        statuses: dict = {}
        streams, out = streams_for(m, colour)
        console = m.console.FleetConsole(
            streams, lambda: m.feed.console_feed(_budget_doc(statuses)))
        frames, walls = [], []
        console.render_once()
        frames.append(out.getvalue())
        base = dict(console.painter.stats())
        for f in range(12):
            for j in range(8):
                statuses[(j % 4, (f + j) % 64)] = (
                    "running" if (f + j) % 5 else "done", f)
            out.truncate(0)
            out.seek(0)
            t0 = time.perf_counter()
            console.render_once()
            walls.append(time.perf_counter() - t0)
            frames.append(out.getvalue())
        last = console.frame_lines(m.feed.console_feed(
            _budget_doc(statuses)))
        return frames, last, base, console.painter.stats(), walls

    (want, want_last, _, want_stats, _), (got, last, base, stats, walls) = \
        both(run)
    assert got == want and last == want_last and stats == want_stats
    agent_rows = sum(1 for l in last if "loop-r" in l)
    assert agent_rows <= port_console.MAX_AGENT_ROWS
    assert len(last) <= 140
    assert any("+" in l and "more" in l for l in last)
    painted = stats["rows_painted"] - base["rows_painted"]
    total = stats["rows_total"] - base["rows_total"]
    assert painted < total * 0.5, (painted, total)
    assert sorted(walls)[len(walls) // 2] < 0.25


@pytest.mark.parametrize("colour", ["on", "off"])
def test_console_renders_all_sections(tmp_path, fixed_clock, colour):
    logs = tmp_path / "logs"
    _write_spans(port_ledger.flight_path(logs, "r1"), 2)
    doc = _status_doc()

    def run(m):
        streams, _ = streams_for(m, colour)
        console = m.console.FleetConsole(
            streams, lambda: m.feed.console_feed(doc), logs_dir=logs)
        return console.snapshot()

    want, got = both(run)
    assert got == want
    for needle in ("fleet console", "run r1", "ANOM-Z", "4.4",
                   "workerd=ok", "tenants", "warm pools", "drops=4",
                   "spans", "ship:0p/0d", "anom:1"):
        assert needle in got, needle
    if colour == "on":
        assert "\x1b[31m4.4\x1b[0m" in got      # the flagged cell is red


# ------------------------------------------------------- multi-pod merge


def _pod_status_doc(pod: str, n_agents: int = 16) -> dict:
    return {
        "pid": 1, "pod": pod, "project": "p", "uptime_s": 1.0,
        "runs": [{
            "run": f"r-{pod}", "state": "running", "tenant": "shared",
            "client": "c", "parallel": n_agents, "iterations": 2,
            "placement": "spread", "subscribers": 0, "events_dropped": 1,
            "agents": [
                {"agent": f"{pod}-a{i:03d}", "worker": f"{pod}-0",
                 "status": "running", "iteration": 1, "exit_codes": [0]}
                for i in range(n_agents)]}],
        "admission": {
            "workers": {"fake-0": {"inflight": 1, "capacity": 4,
                                   "pending": 0, "rejected": 0}},
            "tenants": {"shared": {"weight": 1.0, "inflight": 1,
                                   "queued": 0, "dispatched": 2}}},
        "health": [{"worker": "fake-0", "state": "closed",
                    "breaker_state_gauge": 0, "probe_p50_ms": 1.0}],
        "workerd": {"fake-0": "ok"}, "warm_pools": {},
        "sentinel": {"enabled": True, "rows": [
            {"agent": f"{pod}-a003", "latest_z": 5.0}]},
        "shipper": {"enabled": False}, "events_dropped_total": 1,
    }


def test_merge_feeds_concatenates_and_disambiguates():
    def run(m):
        feeds = [m.feed.console_feed(_pod_status_doc(f"pod{i}"))
                 for i in range(8)]
        return m.feed.merge_feeds(feeds), m.feed.merge_feeds([feeds[0]])

    (want, want_one), (got, got_one) = both(run)
    assert got == want and got_one == want_one
    assert got["pods"] == [f"pod{i}" for i in range(8)]
    assert "pod0/fake-0" in got["workers"]
    assert got["tenants"]["shared"]["dispatched"] == 16
    assert "pods" not in got_one


@pytest.mark.parametrize("colour", ["on", "off"])
def test_console_multi_pod_feed_pod_column_and_budget(fixed_clock, colour):
    def run(m):
        feeds = [m.feed.console_feed(_pod_status_doc(f"pod{i}"))
                 for i in range(8)]
        merged = m.feed.merge_feeds(feeds)
        streams, out = streams_for(m, colour)
        console = m.console.FleetConsole(streams, lambda: merged)
        frame = console.frame_lines(merged)
        console.render_once()
        base = console.painter.stats()["rows_painted"]
        console.render_once()
        return (frame, console.frame_lines(feeds[0]), out.getvalue(),
                console.painter.stats()["rows_painted"] - base)

    want, got = both(run)
    assert got == want
    frame, single, _, repainted = got
    text = "\n".join(frame)
    assert "POD" in text and "pods=pod0" in text
    assert sum(1 for l in frame if "-a0" in l) <= port_console.MAX_AGENT_ROWS
    assert len(frame) <= 140 and repainted == 0
    assert "POD" not in "\n".join(single)


def test_console_bounds_run_count_live_runs_first(fixed_clock):
    runs = []
    for i in range(70):
        runs.append({"run": f"done{i:02d}", "state": "done", "tenant": "t",
                     "client": "c", "parallel": 2, "iterations": 1,
                     "placement": "spread", "subscribers": 0,
                     "events_dropped": 0, "agents": _agents(2, i, "done")})
    runs.append({"run": "liveA", "state": "running", "tenant": "t",
                 "client": "c", "parallel": 2, "iterations": 1,
                 "placement": "spread", "subscribers": 1,
                 "events_dropped": 0, "agents": _agents(2, 99)})
    feed = {"pid": 1, "project": "p", "uptime_s": 0.0, "runs": runs,
            "workers": {}, "tenants": {}, "health": [], "workerd": {},
            "warm_pools": {}, "sentinel": {"enabled": False},
            "shipper": {"enabled": False}, "events_dropped_total": 0}

    def run(m):
        streams, _ = streams_for(m, "off")
        return m.console.FleetConsole(streams, lambda: feed).frame_lines(feed)

    want, got = both(run)
    assert got == want
    text = "\n".join(got)
    assert len(got) <= 140 and "run liveA" in text and "run done69" in text
    assert "run done00" not in text and "more run(s) not shown" in text


# ------------------------------------------------------------- dashboard


class _Sched:
    """The scheduler surface the dashboard reads."""

    loop_id = "dash1"

    def __init__(self, rows: list[dict]):
        self.rows = rows

    def status(self):
        return [dict(r) for r in self.rows]


def _dash_rows(n: int = 16, z: bool = False) -> list[dict]:
    rows = []
    for i in range(n):
        row = {"agent": f"a{i}", "worker": f"w{i % 4}",
               "status": "running" if i % 3 else "done", "iteration": 1,
               "exit_codes": [0] * (i % 3)}
        if z and i != 5:
            row["anomaly_z"] = round(0.37 * i, 2) if i != 7 else 4.25
        rows.append(row)
    return rows


def test_dashboard_repaints_only_dirty_rows(fixed_clock):
    def run(m):
        streams, out = streams_for(m, "on")
        dash = m.dashboard.LoopDashboard(streams, _Sched(_dash_rows()))
        dash.render_once()
        first = dash.painter.stats()["rows_painted"]
        total = dash.painter.stats()["rows_total"]
        fixed_clock.now += 3.0          # only the elapsed time moves
        dash.render_once()
        fixed_clock.now -= 3.0
        return out.getvalue(), first, total, dash.painter.stats()

    want, got = both(run)
    assert got == want
    _, first, total, stats = got
    assert first == total
    assert stats["rows_painted"] - first <= 2


@pytest.mark.parametrize("colour", ["on", "off"])
def test_dashboard_anom_z_frame_twin(fixed_clock, colour):
    """The ANOM-Z column, the events ticker, the worker-tagged egress
    ticker and the status bar's ``anom-max``: the same frame lines."""
    def run(m):
        feed = m.egress.EgressFeed()
        feed._push("w3", json.dumps({"verdict": "deny", "dst": "8.8.8.8",
                                     "dst_port": 53, "zone": "z1"}))
        feed._push("w1", json.dumps({"verdict": 0, "dst_ip": "1.1.1.1"}))
        streams, _ = streams_for(m, colour)
        dash = m.dashboard.LoopDashboard(
            streams, _Sched(_dash_rows(8, z=True)), egress_feed=feed)
        for i in range(8):
            dash.record_event(f"a{i}", "iteration_done", f"{i}:0")
        dash.record_event("a7", "anomaly", "z=4.25")
        return dash._frame_lines()

    want, got = both(run)
    assert got == want
    text = "\n".join(got)
    assert "ANOM-Z" in text and "anom-max:4.2" in text
    assert "[w3]" in text and "8.8.8.8" in text
    if colour == "on":
        assert "\x1b[31m4.2\x1b[0m" in text
    else:
        assert "\x1b" not in text


def test_dashboard_egress_from_a_jsonl_path(tmp_path, fixed_clock):
    path = tmp_path / "ebpf-egress.jsonl"
    path.write_text("".join(json.dumps({"action": a, "dst": f"10.0.0.{i}"})
                            + "\n" for i, a in enumerate(
                                ["ALLOW", "DENY", "1"] * 3)) + "torn")

    def run(m):
        streams, _ = streams_for(m, "off")
        dash = m.dashboard.LoopDashboard(streams, _Sched([]),
                                         egress_path=path)
        return dash._frame_lines(), m.dashboard.tail_jsonl(path, 4)

    want, got = both(run)
    assert got == want
    assert "denies:4" in got[0][-1]     # DENY, 1, ALLOW, DENY, 1


def test_dashboard_paints_nothing_off_a_tty(fixed_clock):
    def run(m):
        s, _, out, _ = m.iostreams.IOStreams.test()
        with m.dashboard.LoopDashboard(s, _Sched(_dash_rows(2))) as dash:
            dash.render_once()
        return out.getvalue(), dash._thread

    want, got = both(run)
    assert got == want == ("", None)


# ----------------------------------------------------------- egress feed


def test_local_tail_streams_appended_records(tmp_path):
    log = tmp_path / "ebpf-egress.jsonl"
    log.write_text(json.dumps({"verdict": "deny", "dst": "1.2.3.4"}) + "\n")
    feeds = {pkg: m.egress.EgressFeed() for pkg, m in PKGS.items()}
    try:
        for feed in feeds.values():
            feed.add_local("local-0", log)
        assert wait_for(lambda: all(len(f.tail()) == 1
                                    for f in feeds.values()))
        with log.open("a") as fh:
            fh.write(json.dumps({"verdict": "allow", "dst": "5.6.7.8"})
                     + "\n")
        assert wait_for(lambda: all(len(f.tail()) == 2
                                    for f in feeds.values()))
    finally:
        for feed in feeds.values():
            feed.stop()
    assert feeds["port"].tail() == feeds["ref"].tail()
    assert feeds["port"].tail()[0]["worker"] == "local-0"


def test_partial_line_not_consumed(tmp_path):
    log = tmp_path / "egress.jsonl"
    rec = json.dumps({"verdict": "deny", "dst": "4.4.4.4"})
    log.write_text(rec[:10])
    feeds = {pkg: m.egress.EgressFeed() for pkg, m in PKGS.items()}
    try:
        for feed in feeds.values():
            feed.add_local("w", log)
        time.sleep(0.7)
        assert [f.tail() for f in feeds.values()] == [[], []]
        with log.open("a") as fh:
            fh.write(rec[10:] + "\n")
        assert wait_for(lambda: all(len(f.tail()) == 1
                                    for f in feeds.values()))
    finally:
        for feed in feeds.values():
            feed.stop()
    assert feeds["port"].tail() == feeds["ref"].tail()
    assert feeds["port"].tail()[0]["dst"] == "4.4.4.4"


def test_add_worker_tails_fake_workers_locally(tmp_path):
    """The fake engine has no transport: every worker tails the local
    file, tagged with its id."""
    log = tmp_path / "egress.jsonl"
    log.write_text(json.dumps({"verdict": "deny", "dst": "1.1.1.1"}) + "\n")
    feeds = {}
    try:
        for pkg, m in PKGS.items():
            feeds[pkg] = m.egress.EgressFeed()
            for w in m.drivers.FakeDriver(n_workers=2).workers():
                feeds[pkg].add_worker(w, local_path=log)
        assert wait_for(lambda: all(len(f.tail()) >= 2
                                    for f in feeds.values()))
    finally:
        for feed in feeds.values():
            feed.stop()
    assert ({r["worker"] for r in feeds["port"].tail()}
            == {r["worker"] for r in feeds["ref"].tail()}
            == {"fake-0", "fake-1"})


def test_remote_tail_takes_a_transports_ssh_mux():
    """``add_remote`` over a duck-typed transport (the SSH transport
    waits for its slice): the same command spawned, the same records."""
    class Proc:
        def __init__(self, lines):
            import io

            self.stdout = io.BytesIO(b"".join(lines))

        def terminate(self):
            pass

    def run(m):
        spawned = []
        line = json.dumps({"verdict": "deny", "dst": "9.9.9.9"}).encode()
        transport = SimpleNamespace(
            ssh_base=lambda: ["ssh", "-S", "mux", "w1"],
            runner=SimpleNamespace(spawn_piped=lambda cmd: (
                spawned.append(cmd), Proc([line + b"\n"]))[1]))
        feed = m.egress.EgressFeed()
        feed.add_remote("gpu-1", transport)
        try:
            assert wait_for(lambda: len(feed.tail()) == 1)
        finally:
            feed.stop()
        return spawned, feed.tail()

    want, got = both(run)
    assert got == want
    assert port_egress.REMOTE_EGRESS_LOG in got[0][0][-1]


# --------------------------------------------------------------- CLI/RPC


def _console_lines(text: str, run_id: str) -> list[str]:
    """The frame's run section, the run id, the pid and the clocks
    replaced, the workers' probe times dropped."""
    import re

    out = []
    for line in text.replace(run_id, "RUN").replace(
            run_id[:6], "RUN").splitlines():
        line = re.sub(r"loopd pid \d+", "loopd pid PID", line)
        line = re.sub(r"up \d+s", "up Ns", line)
        line = re.sub(r"  \d+s  ctrl-c", "  Ns  ctrl-c", line)
        line = re.sub(r"p50=[\d.]+ms", "p50=Pms", line)
        out.append(line)
    return out


def test_cli_fleet_console_once_and_json(tmp_path):
    def scenario(s):
        drv = driver_with(s.m, 2)
        with daemon(s, drv) as srv:
            with s.m.client.LoopdClient(srv.sock_path) as c:
                ack, final = run_to_done(c, {"parallel": 2,
                                             "iterations": 1})
            once = invoke(s, drv, ["fleet", "console", "--once",
                                   "--no-spans"], catch_exceptions=False)
            spans = invoke(s, drv, ["fleet", "console", "--once"],
                           catch_exceptions=False)
            js = invoke(s, drv, ["fleet", "console", "--format", "json"],
                        catch_exceptions=False)
        run = ack["run"]
        feed = json.loads(js.stdout)
        return ((once.exit_code, spans.exit_code, js.exit_code),
                _console_lines(once.stdout, run),
                "spans (c=create s=start ==wait)" in spans.stdout,
                norm([{k: v for k, v in r.items() if k != "client"}
                      for r in feed["runs"]], run),
                sorted(feed))

    want, got = twin(tmp_path, scenario)
    assert got == want
    codes, lines, has_spans, runs, keys = got
    assert codes == (0, 0, 0) and has_spans
    assert lines[0].startswith("fleet console")
    assert any(l.startswith("run RUN done") for l in lines)
    assert runs[0]["agents"] and "events_dropped" in runs[0]


def test_cli_fleet_console_without_daemon_exits_nonzero(tmp_path):
    def scenario(s):
        res = invoke(s, driver_with(s.m, 1), ["fleet", "console", "--once"])
        return res.exit_code, "loopd" in res.output

    want, got = twin(tmp_path, scenario)
    assert got == want == (1, True)


# ------------------------------------------- progress tree and build view


@pytest.fixture
def progress_clock(monkeypatch):
    """Both packages' progress trees on a clock that does not move, so
    no elapsed time reaches a line."""
    for m in PKGS.values():
        monkeypatch.setattr(m.progress, "time", FixedTime())


def test_progress_tree_nontty_emits_state_lines(progress_clock):
    def run(m):
        s, _, fout, _ = m.iostreams.IOStreams.test()
        tree = m.progress.ProgressTree(s)
        tree.add("a", "stage one")
        with tree:
            tree.update("a", "running")
            tree.add("a.1", "step", parent="a")
            tree.update("a.1", "running")
            tree.update("a.1", "done")
            tree.update("a", "done")
        return fout.getvalue(), [n.key for n in tree.failed()]

    want, got = both(run)
    assert got == want
    assert "• stage one" in got[0] and "+ step" in got[0]
    assert got[1] == []


def test_progress_tree_failure_carries_detail(progress_clock):
    def run(m):
        s, _, fout, _ = m.iostreams.IOStreams.test()
        tree = m.progress.ProgressTree(s)
        tree.add("a", "stage")
        tree.update("a", "running")
        tree.update("a", "failed", "exit 1")
        return fout.getvalue(), [n.key for n in tree.failed()]

    want, got = both(run)
    assert got == want
    assert "x stage" in got[0] and "exit 1" in got[0]
    assert got[1] == ["a"]


@pytest.mark.parametrize("colour", sorted(COLOUR))
def test_progress_tree_live_repaints_in_place(progress_clock, colour):
    def run(m):
        s, out = streams_for(m, colour)
        tree = m.progress.ProgressTree(s)
        tree.add("a", "stage")
        tree.update("a", "running")
        tree.render_once()
        tree.render_once()
        return out.getvalue()

    want, got = both(run)
    assert got == want
    assert "\x1b[2K" in got            # line clear
    assert "\x1b[1A" in got            # cursor-up repaint on second frame


def test_buildview_maps_docker_steps_to_tree(progress_clock):
    def run(m):
        s, _, fout, _ = m.iostreams.IOStreams.test()
        view = m.buildview.BuildProgressView(m.progress.ProgressTree(s))
        view.stage("building clawker-p:base (stack python)")
        view.line("Step 1/3 : FROM python:3.12-slim")
        view.line(" ---> abc123")                       # detail, no new node
        view.line("Step 2/3 : RUN pip install x")
        view.stage("building clawker-p:claude (harness claude)")
        view.line("Step 1/2 : FROM clawker-p:base")
        view.line("#1 [internal] load build definition")
        view.line("#1 DONE 0.2s")
        view.line("#2 [1/1] COPY . .")
        view.line("#2 CACHED")
        view.done()
        return fout.getvalue(), [n.key for n in view.tree.failed()]

    want, got = both(run)
    assert got == want
    out, failed = got
    assert "[1/3] FROM python:3.12-slim" in out
    assert "[2/3] RUN pip install x" in out
    assert out.count("• building ") == 2   # each stage started once
    assert "+ [internal] load build definition" in out
    assert failed == []


def test_buildview_failure_marks_current_step(progress_clock):
    def run(m):
        s, _, fout, _ = m.iostreams.IOStreams.test()
        view = m.buildview.BuildProgressView(m.progress.ProgressTree(s))
        view.stage("building x")
        view.line("Step 1/1 : RUN false")
        view.failed("exit code 1")
        return fout.getvalue(), sorted(n.key for n in view.tree.failed())

    want, got = both(run)
    assert got == want
    assert got[1] == ["stage-1", "stage-1.1"]
