"""The port's static analyzer and lock-order tracer against the
reference's.

Twins of tests/test_analysis.py.  Each fixture repo is written twice:
its package paths under ``clawker_tpu/`` for the reference's analyzer
and under ``clawker_tpu_torch/`` for the port's.  The two reports must
agree once the package name (and the baseline file's name) is swapped
back in every path, message and output line, and every fingerprint of
the port's must be ``fingerprint()`` of the port's own fields.  The
lockgraph cases run on each package in turn, never one package's tracer
inside the other's, with thread names masked.  The whole-tree twin runs
the reference's analyzer over a view of the port's tree (its
``clawker_tpu`` a symlink to ``clawker_tpu_torch``) beside the port's
analyzer over the tree itself; the repo gate holds the port's tree to
``analysis-baseline-torch.json``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.analysis.baseline as ref_baseline
import clawker_tpu.analysis.core as ref_core
import clawker_tpu.analysis.lockgraph as ref_lockgraph
import clawker_tpu.analysis.runner as ref_runner
import clawker_tpu.testenv as ref_testenv
import clawker_tpu_torch.analysis.baseline as port_baseline
import clawker_tpu_torch.analysis.core as port_core
import clawker_tpu_torch.analysis.lockgraph as port_lockgraph
import clawker_tpu_torch.analysis.runner as port_runner
import clawker_tpu_torch.testenv as port_testenv
from test_analysis import (
    DURABLE_BAD,
    DURABLE_GOOD,
    SOCK_BAD,
    SOCK_GOOD,
    SPAN_DOC,
    WAL_BAD,
    WAL_GOOD,
    _seams_module,
)

ROOT = Path(__file__).resolve().parents[1]
REF_PKG = "clawker_tpu"

PKGS = {
    "ref": SimpleNamespace(pkg="clawker_tpu", core=ref_core,
                           baseline=ref_baseline, runner=ref_runner,
                           lockgraph=ref_lockgraph, testenv=ref_testenv),
    "port": SimpleNamespace(pkg="clawker_tpu_torch", core=port_core,
                            baseline=port_baseline, runner=port_runner,
                            lockgraph=port_lockgraph, testenv=port_testenv),
}


def make_repo(root: Path, files: dict[str, str], pkg: str) -> Path:
    """The fixture repo ``files`` under ``root``, its package paths
    moved from ``clawker_tpu/`` to ``pkg/``; in the texts, ``@PKG@``
    names ``pkg`` and ``@OTHER@`` the other package."""
    other = "clawker_tpu_torch" if pkg == REF_PKG else REF_PKG
    for rel, text in files.items():
        if rel.startswith(REF_PKG + "/"):
            rel = pkg + rel[len(REF_PKG):]
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text).replace("@PKG@", pkg)
                     .replace("@OTHER@", other))
    return root


_WALL = re.compile(r"\d+\.\d\ds\)")
_THREAD = re.compile(r"Thread-\d+")


def swap(obj, root: Path | None = None):
    """``obj`` with the port's names spelt as the reference's, ``root``
    as ``<root>``, a run's wall seconds and thread numbers masked."""
    if isinstance(obj, dict):
        return {swap(k, root): swap(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(swap(v, root) for v in obj)
    if isinstance(obj, str):
        if root is not None:
            obj = obj.replace(str(root), "<root>")
        obj = obj.replace(port_baseline.BASELINE_NAME,
                          ref_baseline.BASELINE_NAME)
        obj = obj.replace("clawker_tpu_torch", REF_PKG)
        return _THREAD.sub("Thread-<n>", _WALL.sub("<s>s)", obj))
    return obj


def rows(m, findings) -> list[tuple]:
    """Each finding's fields; its fingerprint must be ``fingerprint()``
    of them in its own package."""
    for f in findings:
        assert f.fingerprint == m.baseline.fingerprint(
            f.checker, f.path, f.message, f.occurrence), f
    return [(f.checker, f.path, f.line, f.message, f.suppressed,
             f.justification, f.occurrence) for f in findings]


def report_doc(m, rep) -> dict:
    return {"findings": rows(m, rep.findings),
            "suppressed": rows(m, rep.suppressed),
            "new": rows(m, rep.new),
            "grandfathered": rows(m, rep.grandfathered),
            "stale": len(rep.stale_baseline),
            "files": rep.files_scanned, "checkers": sorted(rep.checkers),
            "exit": rep.exit_code}


def baseline_doc(m, doc: dict) -> dict:
    """A saved baseline with each entry's fingerprint checked against
    its fields, then dropped (it hashes the package's own path, and the
    file orders its entries by it)."""
    entries = []
    for e in doc["findings"]:
        e = dict(e)
        assert e.pop("fingerprint") == m.baseline.fingerprint(
            e["checker"], e["path"], e["message"])
        entries.append(e)
    return dict(doc, findings=sorted(
        entries, key=lambda e: (e["checker"], e["path"], e["message"])))


def twin(tmp_path: Path, case):
    """``case(m, root)`` on the reference, then on the port, each in its
    own root: the outcomes agree once swapped; -> the reference's."""
    got = {}
    for tag, m in PKGS.items():
        root = tmp_path / tag
        root.mkdir()
        got[tag] = swap(case(m, root), root)
    assert got["port"] == got["ref"]
    return got["ref"]


# ------------------------------------------------- fixture findings

CASES = {
    # name: (files, checker, findings, suppressed) -- the reference
    # test's fixture and what it asserts
    "wal-bad": (WAL_BAD, "wal-before-mutation", 1, 0),
    "wal-good": (WAL_GOOD, "wal-before-mutation", 0, 0),
    "wal-helper": ({
        "clawker_tpu/loop/warmpool.py": """
        class P:
            def _note(self):
                self._journal("pool_add", durable=True)

            def fill(self, engine, opts):
                self._note()
                return engine.create_container(opts)
        """}, "wal-before-mutation", 0, 0),
    "wal-thread-start": ({
        "clawker_tpu/loop/scheduler.py": """
        import threading

        class S:
            def start(self):
                self._journal("run", durable=True)

            def _create(self, rt, opts):
                threading.Thread(target=self._pump).start()
                cid = rt.create(opts)
                rt.start(cid)
                return cid
        """}, "wal-before-mutation", 2, 0),
    "durable-bad": (DURABLE_BAD, "durable-append-checked", 1, 0),
    "durable-good": (DURABLE_GOOD, "durable-append-checked", 0, 0),
    "durable-unhealthy": ({
        "clawker_tpu/capacity/controller.py": """
        from ..loop.journal import JournalUnhealthy

        class C:
            def scale(self):
                try:
                    self.hooks.journal("capacity_scale", durable=True)
                except JournalUnhealthy:
                    self._halt()
        """}, "durable-append-checked", 0, 0),
    "durable-passthrough": ({
        "clawker_tpu/loopd/server.py": """
        class D:
            def fanout(self, kind, durable):
                rcpt = self._wal.append(kind, durable=durable)
                for s in self.scheds:
                    s._journal(kind, durable=durable)
                return rcpt

            def unrelated(self, recorder):
                recorder.journal("note", durable=True)
        """}, "durable-append-checked", 0, 0),
    "layering-sentinel-engine": ({
        "clawker_tpu/sentinel/bad.py": """
        from ..engine.api import Engine
        """}, "import-layering", 1, 0),
    "layering-rank-inversion": ({
        "clawker_tpu/engine/bad.py": """
        from ..loop import scheduler
        """}, "import-layering", 1, 0),
    "layering-absolute-imports": ({
        # absolute imports name the package: the reference's spelling
        # in its tree, the port's in the port's
        "clawker_tpu/sentinel/abs.py": """
        import @PKG@.engine.api
        from @PKG@.loop import scheduler
        from @PKG@ import placement
        """}, "import-layering", 3, 0),
    "layering-other-package-is-not-this-one": ({
        # one package's name is a prefix of the other's: an import of
        # the other package is no edge of this one's DAG
        "clawker_tpu/sentinel/other.py": """
        import @OTHER@.engine.api
        from @OTHER@.loop import scheduler
        from @OTHER@ import placement
        import @OTHER@
        """}, "import-layering", 0, 0),
    "layering-clean": ({
        "clawker_tpu/sentinel/ok.py": """
        from ..monitor.ledger import parse_jsonl
        from ..fleet.egress_tail import REMOTE_EGRESS_LOG
        from .. import telemetry
        """,
        "clawker_tpu/loop/ok.py": """
        from ..engine.api import Engine
        from ..placement.policy import PlacementPolicy
        """}, "import-layering", 0, 0),
    "locks-sleep": ({
        "clawker_tpu/monitor/bad.py": """
        import threading
        import time

        class C:
            def poke(self):
                with self._lock:
                    time.sleep(1)
        """}, "no-blocking-under-lock", 1, 0),
    "locks-repaired": ({
        "clawker_tpu/monitor/ok.py": """
        import threading
        import time

        class C:
            def poke(self):
                with self._lock:
                    self._n += 1
                time.sleep(1)

            def park(self):
                with self._cond:
                    self._cond.wait(1.0)   # waiting the HELD cond is fine

            def spawn_later(self):
                with self._lock:
                    # defining a closure under the lock is fine
                    def work():
                        time.sleep(1)
                    self._pending = work
                    label = ",".join(self._names)   # str.join, not thread
        """}, "no-blocking-under-lock", 0, 0),
    "locks-foreign-wait": ({
        "clawker_tpu/engine/bad.py": """
        class C:
            def reap(self, proc):
                with self._lock:
                    proc.wait(timeout=3)
        """}, "no-blocking-under-lock", 1, 0),
    "sockets-bad": (SOCK_BAD, "socket-hardening", 1, 0),
    "sockets-good": (SOCK_GOOD, "socket-hardening", 0, 0),
    "parity-unregistered-seam": ({
        "clawker_tpu/chaos/seams.py": _seams_module(("launch.pre_create",)),
        "clawker_tpu/loop/x.py": """
        class S:
            def go(self):
                self.seams.fire("launch.pre_create")
                self.seams.fire("launch.pre_creat")    # typo: dead site
        """}, "registry-parity", 1, 0),
    "parity-never-fired": ({
        "clawker_tpu/chaos/seams.py": _seams_module(
            ("launch.pre_create", "launch.ghost_seam")),
        "clawker_tpu/loop/x.py": """
        class S:
            def go(self):
                self.seams.fire("launch.pre_create")
        """}, "registry-parity", 1, 0),
    "parity-metrics": ({
        "clawker_tpu/chaos/seams.py": _seams_module(()),
        "clawker_tpu/loop/m.py": """
        from .. import telemetry

        _A = telemetry.counter("documented_total", "ok")
        _B = telemetry.counter("undocumented_total", "drifted")
        """,
        "docs/telemetry.md": """
        | name | type |
        |---|---|
        | `documented_total` | counter |
        | `ghost_metric_total` | counter |
        """}, "registry-parity", 2, 0),
    "parity-spans-both-ways": ({
        "clawker_tpu/chaos/seams.py": _seams_module(()),
        "clawker_tpu/tracing/names.py": """
        SPAN_ITERATION = "iteration"
        SPAN_ROGUE = "rogue.span"
        SPAN_CATALOGUE = (
            "iteration",
            "undocumented.span",
        )
        """,
        "docs/telemetry.md": SPAN_DOC}, "registry-parity", 3, 0),
    "parity-spans-in-sync": ({
        "clawker_tpu/chaos/seams.py": _seams_module(()),
        "clawker_tpu/tracing/names.py": """
        SPAN_ITERATION = "iteration"
        SPAN_GAP = "gap"
        SPAN_CATALOGUE = (
            "iteration",
            "gap",
        )
        """,
        "docs/telemetry.md": SPAN_DOC}, "registry-parity", 0, 0),
    "parity-spans-no-section": ({
        "clawker_tpu/chaos/seams.py": _seams_module(()),
        "clawker_tpu/tracing/names.py": """
        SPAN_ITERATION = "iteration"
        SPAN_CATALOGUE = (
            "iteration",
        )
        """,
        "docs/telemetry.md": "| `documented_total` | counter |\n"},
        "registry-parity", 1, 0),
    "parity-in-sync": ({
        "clawker_tpu/chaos/seams.py": _seams_module(("launch.pre_create",)),
        "clawker_tpu/loop/m.py": """
        from .. import telemetry

        _A = telemetry.counter("documented_total", "ok")

        class S:
            def go(self):
                self.seams.fire("launch.pre_create")
        """,
        "docs/telemetry.md": "| `documented_total` | counter |\n"},
        "registry-parity", 0, 0),
    "determinism-clock-and-random": ({
        "clawker_tpu/chaos/plan.py": """
        import random
        import time

        def generate_plan(seed, scenario):
            jitter = random.random()
            stamp = time.time()
            return [jitter, stamp]
        """}, "chaos-determinism", 2, 0),
    "determinism-seeded": ({
        "clawker_tpu/chaos/plan.py": """
        import random

        def generate_plan(seed, scenario):
            rng = random.Random((seed & 0xFFFFFFFF) * 100_003 + scenario)
            return [rng.random() for _ in range(4)]
        """}, "chaos-determinism", 0, 0),
    "allow-comment": ({
        "clawker_tpu/monitor/bad.py": """
        import time

        class C:
            def poke(self):
                with self._lock:
                    # analyze: allow(no-blocking-under-lock): test waiver
                    time.sleep(1)
        """}, "no-blocking-under-lock", 0, 1),
    "testenv-excluded": ({
        "clawker_tpu/chaos/seams.py": _seams_module(("launch.pre_create",)),
        "clawker_tpu/testenv.py": """
        class S:
            def go(self):
                self.seams.fire("launch.typo")     # the harness: unseen
        """,
        "clawker_tpu/loop/x.py": """
        class S:
            def go(self):
                self.seams.fire("launch.pre_create")
        """}, "registry-parity", 0, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixture_findings_match_the_reference(tmp_path, name):
    files, checker, n_found, n_suppressed = CASES[name]

    def case(m, root):
        return report_doc(m, m.core.run_analysis(
            make_repo(root, files, m.pkg), only={checker}))

    got = twin(tmp_path, case)
    assert len(got["findings"]) == n_found, got
    assert len(got["suppressed"]) == n_suppressed, got


def test_every_checker_on_one_repo_matches_the_reference(tmp_path):
    """Every fixture that writes distinct paths at once, every checker:
    the merged, sorted report and the occurrence counter agree."""
    files = {**WAL_BAD, **DURABLE_BAD, **SOCK_BAD,
             **CASES["locks-sleep"][0], **CASES["parity-metrics"][0],
             **CASES["determinism-clock-and-random"][0],
             **CASES["layering-rank-inversion"][0]}

    def case(m, root):
        return report_doc(m, m.core.run_analysis(make_repo(root, files,
                                                           m.pkg)))

    got = twin(tmp_path, case)
    assert len(got["checkers"]) == 7 and len(got["findings"]) == 9


# ------------------------------------------------ baseline workflow

def test_baseline_add_and_expire_round_trip(tmp_path):
    def case(m, root):
        only = {"wal-before-mutation"}
        repo = make_repo(root, WAL_BAD, m.pkg)
        first = m.core.run_analysis(repo, only=only)
        base = m.baseline.Baseline().updated_from(first)
        path = base.save(root / m.baseline.BASELINE_NAME)
        saved = baseline_doc(m, json.loads(path.read_text()))
        base2 = m.baseline.Baseline.load(path)
        second = m.core.run_analysis(repo, baseline=base2, only=only)
        make_repo(root, WAL_GOOD, m.pkg)
        third = m.core.run_analysis(repo, baseline=base2, only=only)
        return {"first": report_doc(m, first), "saved": saved,
                "second": report_doc(m, second),
                "third": report_doc(m, third),
                "stale is the baseline": (third.stale_baseline
                                          == base2.fingerprints()),
                "after update": len(base2.updated_from(third))}

    got = twin(tmp_path, case)
    assert len(got["first"]["new"]) == 1
    assert got["second"]["new"] == [] and got["second"]["exit"] == 0
    assert len(got["second"]["grandfathered"]) == 1
    assert got["third"]["findings"] == [] and got["stale is the baseline"]
    assert got["after update"] == 0


def test_scoped_baseline_update_preserves_other_checkers(tmp_path, capsys):
    files = {**WAL_BAD, "clawker_tpu/chaos/plan.py": """
        import time

        def generate_plan(seed, scenario):
            return [time.time()]
        """}

    def case(m, root):
        repo = make_repo(root, files, m.pkg)
        path = repo / m.baseline.BASELINE_NAME
        out = []
        for argv in (["--baseline-update"],
                     ["--checker", "chaos-determinism", "--baseline-update"],
                     []):
            rc = m.runner.main(["--root", str(repo), *argv])
            cap = capsys.readouterr()
            out.append((rc, cap.out, cap.err,
                        baseline_doc(m, json.loads(path.read_text()))))
        return out

    got = twin(tmp_path, case)
    assert [rc for rc, *_ in got] == [0, 0, 0]
    assert {e["checker"] for e in got[1][3]["findings"]} == {
        "wal-before-mutation", "chaos-determinism"}


def test_second_identical_finding_is_not_grandfathered(tmp_path):
    one = {"clawker_tpu/loop/scheduler.py": """
        class S:
            def _create(self, engine, opts):
                return engine.create_container(opts)
        """}
    two = {"clawker_tpu/loop/scheduler.py": """
        class S:
            def _create(self, engine, opts):
                engine.create_container(opts)
                return engine.create_container(opts)
        """}

    def case(m, root):
        only = {"wal-before-mutation"}
        repo = make_repo(root, one, m.pkg)
        base = m.baseline.Baseline().updated_from(
            m.core.run_analysis(repo, only=only))
        make_repo(root, two, m.pkg)
        rep = m.core.run_analysis(repo, baseline=base, only=only)
        return report_doc(m, rep), len({f.fingerprint for f in rep.findings})

    doc, distinct = twin(tmp_path, case)
    assert len(doc["findings"]) == 2 and distinct == 2
    assert len(doc["grandfathered"]) == 1 and len(doc["new"]) == 1
    assert [f[-1] for f in doc["findings"]] == [0, 1]


def test_fingerprint_survives_line_drift(tmp_path):
    def case(m, root):
        repo = make_repo(root, WAL_BAD, m.pkg)
        only = {"wal-before-mutation"}
        first = m.core.run_analysis(repo, only=only).new[0]
        src = repo / m.pkg / "loop" / "scheduler.py"
        src.write_text("\n\n\n# a comment pushing everything down\n"
                       + src.read_text())
        second = m.core.run_analysis(repo, only=only).new[0]
        return (first.fingerprint == second.fingerprint,
                second.line - first.line, rows(m, [second]))

    same, drift, _ = twin(tmp_path, case)
    assert same and drift == 4


def test_fingerprints_are_the_same_function():
    for args in (("c", "p", "m"), ("c", "p", "m", 0), ("c", "p", "m", 3),
                 ("wal-before-mutation", "clawker_tpu/x.py", "`create`", 1)):
        assert port_baseline.fingerprint(*args) == \
            ref_baseline.fingerprint(*args)
    assert port_baseline.BASELINE_NAME == "analysis-baseline-torch.json"


# ------------------------------------------------------------- CLI

def test_cli_exit_2_on_new_finding_and_0_after_baseline(tmp_path, capsys):
    def case(m, root):
        repo = make_repo(root, WAL_BAD, m.pkg)
        out = []
        for argv in ([], ["--baseline-update"], []):
            rc = m.runner.main(["--root", str(repo), *argv])
            cap = capsys.readouterr()
            out.append((rc, cap.out, cap.err))
        return out, (repo / m.baseline.BASELINE_NAME).is_file()

    got, written = twin(tmp_path, case)
    assert [rc for rc, _, _ in got] == [2, 0, 0] and written


def test_cli_json_shape_is_stable(tmp_path, capsys):
    def case(m, root):
        rc = m.runner.main(["--root", str(make_repo(root, WAL_BAD, m.pkg)),
                            "--json"])
        doc = json.loads(capsys.readouterr().out)
        assert doc.pop("wall_s") >= 0
        for f in doc["new"]:
            assert f.pop("fingerprint") == m.baseline.fingerprint(
                f["checker"], f["path"], f["message"])
        return rc, doc

    rc, doc = twin(tmp_path, case)
    assert rc == 2 and doc["ok"] is False and doc["version"] == 1
    assert {"new", "grandfathered", "suppressed", "stale_baseline",
            "checkers", "files_scanned"} <= set(doc)
    assert {"checker", "path", "line", "message"} <= set(doc["new"][0])


@pytest.mark.parametrize("argv,code", [
    (["--checker", "nope"], 1),
    (["--list-checkers"], 0),
    (["--checker", "wal-before-mutation", "--checker", "import-layering"],
     0),
    (["--checker", "no-blocking-under-lock", "--json"], 2),
], ids=["unknown-checker", "list-checkers", "two-checkers", "one-checker"])
def test_cli_flags_match_the_reference(tmp_path, capsys, argv, code):
    def case(m, root):
        repo = make_repo(root, {**WAL_GOOD, **CASES["locks-sleep"][0]},
                         m.pkg)
        rc = m.runner.main(["--root", str(repo), *argv])
        cap = capsys.readouterr()
        out = cap.out
        if "--json" in argv:
            out = json.loads(out)
            out.pop("wall_s")
            for f in out["new"]:
                assert f.pop("fingerprint") == m.baseline.fingerprint(
                    f["checker"], f["path"], f["message"])
        return rc, out, cap.err

    rc, out, err = twin(tmp_path, case)
    assert rc == code, (out, err)
    if argv == ["--list-checkers"]:
        assert len(out.splitlines()) == 7


def test_cli_refuses_a_root_without_its_package(tmp_path, capsys):
    def case(m, root):
        rc = m.runner.main(["--root", str(root)])
        return rc, capsys.readouterr().err

    rc, err = twin(tmp_path, case)
    assert rc == 1 and "has no clawker_tpu package" in err


def test_clawker_analyze_click_command(tmp_path):
    from clawker_tpu.cli.root import cli as ref_cli
    from clawker_tpu_torch.cli.root import cli as port_cli

    clis = {"clawker_tpu": ref_cli, "clawker_tpu_torch": port_cli}

    def case(m, root):
        repo = make_repo(root, WAL_BAD, m.pkg)
        out = []
        for argv in ([], ["--baseline-update"], [], ["--json"]):
            r = CliRunner().invoke(clis[m.pkg],
                                   ["analyze", "--root", str(repo), *argv])
            text = r.output
            if argv == ["--json"]:
                doc = json.loads(text)
                doc.pop("wall_s")
                for f in doc["grandfathered"]:
                    f.pop("fingerprint")
                text = doc
            out.append((r.exit_code, text))
        return out

    got = twin(tmp_path, case)
    assert [code for code, _ in got] == [2, 0, 0, 0]
    assert got[3][1]["ok"] is True and len(got[3][1]["grandfathered"]) == 1


# -------------------------------------------------------- lockgraph

def _skip_if_traced():
    for m in PKGS.values():
        if m.lockgraph.installed_graph() is not None:
            pytest.skip("a lock tracer is installed process-wide "
                        "(CLAWKER_TPU_LOCKGRAPH=1); these cases patch the "
                        "global lock factories themselves")


def _cycles(graph, *, counts: bool = True) -> list:
    """Each cycle's locks and edges; without ``counts``, not how often
    an edge was seen nor which thread drew it first."""
    return [{"locks": c["locks"],
             "edges": [(e["from"], e["to"], e["held_stack"],
                        e["acquire_stack"])
                       + ((e["count"], e["thread"]) if counts else ())
                       for e in c["edges"]]}
            for c in graph.cycles()]


def lg_ab_ba_cycle(lg) -> dict:
    graph = lg.install_lock_tracing()
    try:
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        gate = threading.Barrier(2, timeout=5)

        def ab():
            with lock_a:
                gate.wait()
                if lock_b.acquire(timeout=0.3):
                    lock_b.release()

        def ba():
            with lock_b:
                gate.wait()
                if lock_a.acquire(timeout=0.3):
                    lock_a.release()

        t1, t2 = threading.Thread(target=ab), threading.Thread(target=ba)
        t1.start(); t2.start(); t1.join(5); t2.join(5)
    finally:
        g = lg.uninstall_lock_tracing()
    return {"popped": g is graph, "cycles": _cycles(graph, counts=False),
            "restored": type(threading.Lock()).__module__}


def lg_hierarchical(lg) -> dict:
    graph = lg.LockGraph()
    outer = lg.TracedLock(graph, "x.py:1")
    inner = lg.TracedLock(graph, "x.py:2")

    def nested():
        with outer:
            with inner:
                pass

    threads = [threading.Thread(target=nested) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    rep = graph.report()
    return {"cycles": graph.cycles(), "edges": rep["edges"],
            "acquires": rep["acquires"], "pairs": sorted(graph.edges),
            "repr": repr(outer)}


def lg_same_site(lg) -> dict:
    graph = lg.LockGraph()
    lanes = [lg.TracedLock(graph, "lanes.py:7") for _ in range(2)]
    with lanes[0]:
        with lanes[1]:
            pass
    with lanes[1]:
        with lanes[0]:
            pass
    return {"cycles": graph.cycles(), "same_site": dict(graph.same_site),
            "report": graph.report()}


def lg_condition_wait(lg) -> dict:
    graph = lg.LockGraph()
    cond = threading.Condition(lg.TracedRLock(graph, "cond.py:1"))
    other = lg.TracedLock(graph, "other.py:1")
    done = threading.Event()

    def waiter():
        with cond:
            cond.wait(timeout=2)
        with other:
            pass
        done.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    with cond:
        cond.notify_all()
    t.join(5)
    return {"done": done.is_set(), "cycles": graph.cycles(),
            "edges": sorted(graph.edges)}


def lg_self_deadlock(lg) -> dict:
    graph = lg.LockGraph()
    lk = lg.TracedLock(graph, "x.py:9")
    probes = []

    def deadlocker():
        with lk:
            probes.append(lk.acquire(blocking=False))   # trylock: exempt
            probes.append(lk.acquire(timeout=0.05))     # timed: exempt
            lk.acquire()    # unbounded: records, then parks forever

    t = threading.Thread(target=deadlocker, daemon=True)
    t.start()
    for _ in range(100):
        if graph.cycles():
            break
        time.sleep(0.05)
    return {"cycles": _cycles(graph), "probes": probes,
            "parked": t.is_alive(), "rendered": graph.render_cycles()}


def lg_acquire_count(lg) -> dict:
    graph = lg.LockGraph()
    lk = lg.TracedLock(graph, "x.py:1")

    def spin():
        for _ in range(200):
            with lk:
                pass

    threads = [threading.Thread(target=spin) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    return {"acquires": graph.acquires, "cycles": graph.cycles()}


def lg_uninstall_restores(lg) -> dict:
    lg.install_lock_tracing()
    traced = type(threading.Lock()).__name__, type(threading.RLock()).__name__
    g = lg.uninstall_lock_tracing()
    return {"traced": traced, "enabled": g.enabled,
            "restored": (type(threading.Lock()).__module__,
                         type(threading.RLock()).__name__),
            "none left": lg.uninstall_lock_tracing()}


def lg_nested_install(lg) -> dict:
    outer = lg.install_lock_tracing()
    try:
        inner = lg.install_lock_tracing()
        lk = threading.Lock()
        with lk:
            pass
        popped = lg.uninstall_lock_tracing() is inner
        still = lg.installed_graph() is outer and outer.enabled
        before = outer.acquires
        with threading.Lock():
            pass
        counted = outer.acquires - before
        fewer = inner.acquires < outer.acquires
    finally:
        lg.uninstall_lock_tracing()
    return {"popped": popped, "inner enabled": inner.enabled,
            "outer live": still, "counted": counted, "fewer": fewer,
            "restored": type(threading.Lock()).__module__}


def lg_at_fork_reinit(lg) -> dict:
    lk = lg.TracedLock(lg.LockGraph(), "x.py:1")
    lk._at_fork_reinit()
    took = lk.acquire(timeout=1)
    lk.release()
    rl = lg.TracedRLock(lg.LockGraph(), "x.py:2")
    rl._at_fork_reinit()
    with rl:
        owned = rl._is_owned()
    return {"took": took, "owned": owned, "locked": lk.locked(),
            "repr": repr(rl)}


LOCKGRAPH_CASES = [lg_ab_ba_cycle, lg_hierarchical, lg_same_site,
                   lg_condition_wait, lg_self_deadlock, lg_acquire_count,
                   lg_uninstall_restores, lg_nested_install,
                   lg_at_fork_reinit]


@pytest.mark.parametrize("case", LOCKGRAPH_CASES,
                         ids=[c.__name__[3:] for c in LOCKGRAPH_CASES])
def test_lockgraph_matches_the_reference(case):
    _skip_if_traced()
    got = {tag: swap(case(m.lockgraph)) for tag, m in PKGS.items()}
    assert got["port"] == got["ref"]
    want = got["ref"]
    if case is lg_ab_ba_cycle:
        assert want["popped"] and want["restored"] == "_thread"
        assert len(want["cycles"]) == 1
        assert len(want["cycles"][0]["edges"]) == 2
    elif case is lg_self_deadlock:
        assert want["probes"] == [False, False] and want["parked"]
        assert [c["locks"] for c in want["cycles"]] == [["x.py:9"]]
    elif case is lg_acquire_count:
        assert want["acquires"] == 800
    elif case is lg_nested_install:
        assert want["popped"] and want["outer live"] and want["counted"] == 1
    else:
        assert want.get("cycles", []) == []


def test_lock_tracing_matches_the_reference():
    """``testenv.lock_tracing()`` over each package's tracer: the same
    AB/BA workload gives the same cycle, and the real factories are back
    after the block."""
    _skip_if_traced()
    got = {}
    for tag, m in PKGS.items():
        with m.testenv.lock_tracing() as graph:
            inside = m.lockgraph.installed_graph() is graph
            lock_a = threading.Lock()
            lock_b = threading.Lock()      # a site of its own
            with lock_a:
                with lock_b:
                    pass
            with lock_b:
                if lock_a.acquire(timeout=0.01):
                    lock_a.release()
        got[tag] = swap({"inside": inside, "cycles": _cycles(graph),
                         "enabled": graph.enabled,
                         "after": m.lockgraph.installed_graph(),
                         "restored": type(threading.Lock()).__module__})
    assert got["port"] == got["ref"]
    assert got["ref"]["inside"] and got["ref"]["restored"] == "_thread"
    assert len(got["ref"]["cycles"]) == 1


# ------------------------------------------------------ repo gates

def test_whole_tree_matches_the_reference_over_a_view(tmp_path):
    """The reference's analyzer over a view of the port's tree (its
    ``clawker_tpu`` a symlink to ``clawker_tpu_torch``, the repo's docs)
    and the port's over the tree itself report the same findings."""
    view = tmp_path / "view"
    view.mkdir()
    (view / REF_PKG).symlink_to(ROOT / "clawker_tpu_torch")
    (view / "docs").symlink_to(ROOT / "docs")
    ref = ref_core.run_analysis(view, baseline=ref_baseline.Baseline())
    port = port_core.run_analysis(ROOT, baseline=port_baseline.Baseline())
    want = swap(report_doc(PKGS["ref"], ref))
    got = swap(report_doc(PKGS["port"], port))
    assert got == want
    assert len(want["checkers"]) == 7
    assert [(f[0], f[1]) for f in want["findings"]] == [
        ("no-blocking-under-lock", "clawker_tpu/agentd/daemon.py")]
    # the loopback ssh's -L bind is hardened at its site, not grandfathered
    assert ("socket-hardening", "clawker_tpu/sshseam.py") in {
        (f[0], f[1]) for f in want["suppressed"]}


def test_repo_is_clean_against_committed_baseline():
    """The port's gate: a new un-baselined finding anywhere in the
    port's tree fails this test, and the forked ``analyze`` verb agrees
    with the in-process run."""
    path = ROOT / port_baseline.BASELINE_NAME
    base = port_baseline.Baseline.load(path)
    report = port_core.run_analysis(ROOT, baseline=base)
    assert report.new == [], "\n".join(f.render() for f in report.new)
    assert 1 <= len(base) <= 15
    assert report.stale_baseline == [], (
        "baseline entries went stale; run `python -m clawker_tpu_torch "
        "analyze --baseline-update`")
    assert len(report.grandfathered) == len(base)
    proc = subprocess.run([sys.executable, "-m", "clawker_tpu_torch",
                           "analyze", "--json"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    want = report.to_doc()
    for d in (doc, want):
        d.pop("wall_s")
    assert doc == want


def test_all_seven_checkers_registered():
    for m in PKGS.values():
        m.core._load_checkers()
    docs = {tag: {cid: c.doc for cid, c in m.core.CHECKERS.items()}
            for tag, m in PKGS.items()}
    assert docs["port"] == docs["ref"]
    assert set(docs["port"]) == {
        "wal-before-mutation", "durable-append-checked", "import-layering",
        "no-blocking-under-lock", "socket-hardening", "registry-parity",
        "chaos-determinism"}


def test_analyzer_imports_pure_stdlib():
    """``python -m clawker_tpu_torch.analysis`` pulls no torch, JAX,
    click or numpy."""
    code = (
        "import sys\n"
        "import clawker_tpu_torch.analysis\n"
        "import clawker_tpu_torch.analysis.runner\n"
        "import clawker_tpu_torch.analysis.checkers\n"
        "heavy = {'jax', 'jaxlib', 'numpy', 'click', 'torch'} & set(sys.modules)\n"
        "assert not heavy, f'analyzer pulled heavy deps: {heavy}'\n"
        "print('pure')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr
    assert "pure" in out.stdout
