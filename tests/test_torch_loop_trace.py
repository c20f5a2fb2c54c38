"""``loop trace`` of the port against the reference's, over one flight
record the test writes.

The reference's own case (tests/test_telemetry.py
``test_cli_loop_trace_renders_tree_and_json``) records its flight file
through a live run, whose spans a host short of disk sheds (ROADMAP §3
item 2).  Here the test writes the records itself, the same bytes into
each package's logs dir: two iterations with their phase spans, a
resumed iteration with a migration hop, a sentinel tick (a root by
design), a phase span whose iteration root never flushed, an older
generation rotated out to ``<path>.1``, a second run sharing an id
prefix, and a run with no span records.  Each package's CLI traces them
by id, by prefix, by path and as the newest run, as text and as JSON,
and names what it cannot trace; exit codes, standard output and error
output are compared, with each package's base path read ``<BASE>``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.testenv as ref_testenv
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.testenv as port_testenv

PKGS = {
    "ref": SimpleNamespace(cli=ref_root.cli, Factory=ref_factory.Factory,
                           config=ref_config, drivers=ref_drivers,
                           testenv=ref_testenv),
    "port": SimpleNamespace(cli=port_cli.cli, Factory=port_cli.Factory,
                            config=port_config, drivers=port_drivers,
                            testenv=port_testenv),
}
RUN = "run-aaaa1111"
T0 = 1_785_000_000.0


def span(span_id, name, agent, t0, t1, *, parent="", worker="fake-0",
         status="ok", trace=RUN, **attrs) -> dict:
    return {"kind": "span", "trace_id": trace, "span_id": span_id,
            "parent_id": parent, "name": name, "agent": agent,
            "worker": worker, "t_start": T0 + t0, "t_end": T0 + t1,
            "status": status, "attrs": attrs}


def flight_records() -> tuple[list[dict], list[dict]]:
    """(current generation, rotated-out generation) of ``RUN``."""
    current = [
        {"kind": "run", "run": RUN, "agents": 2},
        span("i-0-1", "iteration", "loop-0", 2.0, 3.5, iteration=1,
             queue_ms=12.5),
        span("c-0-1", "create", "loop-0", 2.0, 2.2, parent="i-0-1",
             iteration=1, image="img"),
        span("s-0-1", "start", "loop-0", 2.2, 2.3, parent="i-0-1",
             iteration=1),
        span("w-0-1", "wait", "loop-0", 2.3, 3.4, parent="i-0-1",
             iteration=1),
        span("e-0-1", "exit", "loop-0", 3.4, 3.5, parent="i-0-1",
             iteration=1, code=0),
        span("i-1-0", "iteration", "loop-1", 0.5, 4.0, worker="fake-1",
             status="failed", iteration=0, resumed=True, adopted=False),
        span("m-1-0", "migrate", "loop-1", 1.0, 1.0, parent="i-1-0",
             worker="fake-1", iteration=0, src="fake-0", dst="fake-1"),
        span("t-1", "sentinel.tick", "sentinel", 3.0, 3.2, worker="",
             windows=4),
        # its iteration root never flushed: promoted, and warned about
        span("w-1-1", "wait", "loop-1", 4.5, 5.0, parent="i-1-1",
             worker="fake-1", iteration=1),
        "{torn line",
    ]
    rotated = [
        span("i-0-0", "iteration", "loop-0", 0.0, 1.5, iteration=0),
        span("c-0-0", "create", "loop-0", 0.0, 0.4, parent="i-0-0",
             iteration=0),
    ]
    return current, rotated


def write_flights(flight: Path) -> None:
    flight.mkdir(parents=True)
    current, rotated = flight_records()

    def dump(path: Path, recs) -> None:
        path.write_text("".join(
            (r if isinstance(r, str) else json.dumps(r)) + "\n"
            for r in recs))

    dump(flight / f"loop-{RUN}.jsonl", current)
    dump(flight / f"loop-{RUN}.jsonl.1", rotated)
    dump(flight / "loop-run-aaaa2222.jsonl",
         [span("x", "iteration", "loop-9", 0.0, 1.0, trace="run-aaaa2222",
               iteration=0)])
    dump(flight / "loop-run-empty.jsonl", [{"kind": "run", "run": "e"}])
    for age, name in enumerate((f"loop-{RUN}.jsonl", "loop-run-empty.jsonl",
                                "loop-run-aaaa2222.jsonl")):
        os.utime(flight / name, (T0 - age * 60, T0 - age * 60))


CASES = {
    "by-id": lambda flight: [RUN],
    "newest": lambda flight: [],
    "by-prefix": lambda flight: ["run-aaaa1"],
    "by-path": lambda flight: [str(flight / "loop-run-aaaa2222.jsonl")],
    "json": lambda flight: ["--json", RUN],
    "ambiguous": lambda flight: ["run-aaaa"],
    "missing": lambda flight: ["nope"],
    "no-spans": lambda flight: ["run-empty"],
    "no-records": None,
}


def trace(m, base: Path, case: str) -> list:
    with m.testenv.TestEnv(base=base) as tenv:
        tenv.write_settings("host_proxy:\n  enable: false\n")
        proj = tenv.base / "proj"
        tenv.make_project(proj, "project: tracer\n")
        flight = m.config.load_config(proj).logs_dir / "flight"
        if CASES[case] is None:
            flight.mkdir(parents=True)
            args = []
        else:
            write_flights(flight)
            args = CASES[case](flight)
        res = CliRunner().invoke(
            m.cli, ["loop", "trace", *args],
            obj=m.Factory(cwd=proj, driver=m.drivers.FakeDriver()))
        return json.loads(json.dumps(
            [res.exit_code, res.stdout, res.stderr]).replace(
                str(tenv.base), "<BASE>"))


@pytest.mark.parametrize("case", list(CASES))
def test_loop_trace_matches_the_reference(tmp_path, case):
    want = trace(PKGS["ref"], tmp_path / "ref", case)
    got = trace(PKGS["port"], tmp_path / "port", case)
    assert got == want
    code, out, err = got
    if case in ("by-id", "newest", "by-prefix"):
        assert code == 0
        lines = out.splitlines()
        assert lines[0] == (f"run {RUN}: 3 iteration span(s) across 3 "
                            "agent(s)  (<BASE>/state/logs/flight/"
                            f"loop-{RUN}.jsonl)")
        assert lines[1] == ("loop-0  iteration 0 [ok] 1500.0ms "
                            "worker=fake-0")
        assert "loop-1  iteration 0 [failed] 3500.0ms worker=fake-1 " \
               "resumed=True adopted=False" in lines
        assert "sentinel  sentinel.tick [ok] 200.0ms worker=" in lines
        assert "loop-1  wait (no iteration root) [ok] 500.0ms " \
               "worker=fake-1" in lines
        assert lines[-2:] == ["migration hops:",
                              "  loop-1 iteration 0: fake-0 -> fake-1"]
        assert err == ("warning: 1 span(s) without a recorded iteration "
                       "root (crashed run?)\n")
    elif case == "json":
        doc = json.loads(out)
        assert code == 0 and doc["run"] == RUN and len(doc["iterations"]) == 5
        assert doc["iterations"][0]["children"][0]["wall_ms"] == 400.0
    elif case == "by-path":
        assert code == 0 and out.startswith("run run-aaaa2222: 1 iteration")
    else:
        assert code == 1 and out == ""
        said = {"ambiguous": "run 'run-aaaa' is ambiguous: run-aaaa1111, "
                             "run-aaaa2222",
                "missing": "no flight record for run 'nope' under",
                "no-spans": "loop-run-empty.jsonl: no span records",
                "no-records": "no flight records under"}[case]
        assert said in err
