"""The port's 22-scenario firewall parity corpus against the reference's.

Twins of tests/test_parity.py.  Each scenario runs the reference's side
and then the port's in this process, one after the other (each side's
``World`` binds a DNS gate on port 0, so the twins never hold more gates
open at once than the reference's suite does), and the two scorecard
rows are compared after masking only what a run cannot repeat: ``ms``,
the side's tmp dir, loopback ports and PEM blocks.  Every row's name,
``pass`` and evidence, keys and values, must be the reference's.

Each side's ``World`` binds its DNS gate on a loopback port no TCP socket
held a moment before (``free_gate_ports``), as the port's own rigs bind
theirs (tests/test_torch_firewall_handler.py, ``tcp_free_port``): on port
0 the gate binds UDP and then TCP on the number UDP drew, which another
socket of the host may hold for TCP, and ``DnsGate.start`` raises
``OSError`` (ROADMAP §3 item 16).  A side that still fails so says so.
"""

from __future__ import annotations

import importlib
import re
import socket
from pathlib import Path

import pytest

# the parity worlds sit on the PKI/firewall stack; sandboxes without
# the cryptography package skip the suite instead of erroring collection
pytest.importorskip("cryptography")

import clawker_tpu.parity.redteam as ref_R  # noqa: E402
import clawker_tpu.parity.scenarios as ref_S  # noqa: E402
import clawker_tpu_torch.parity.redteam as port_R  # noqa: E402
import clawker_tpu_torch.parity.scenarios as port_S  # noqa: E402

SIDES = (("ref", ref_S), ("port", port_S))
NAMES = [n for n, _ in ref_S.SCENARIOS]
ITEM16 = ("OSError from DnsGate.start: the gate's TCP bind lost on port 0 "
          "(ROADMAP §3 item 16)")

_PEM = re.compile(r"-----BEGIN [A-Z ]+-----.*?-----END [A-Z ]+-----", re.S)
_LOOPBACK_PORT = re.compile(r"(127\.\d+\.\d+\.\d+['\"]?[:,]\s*)\d+")
_TIMES = frozenset({"ms", "wall_s"})


def mask(obj, base: Path):
    """``obj`` with what a run cannot repeat masked: the values of
    ``ms``/``wall_s``, ``base`` (the side's tmp dir) in any string,
    loopback ports and PEM blocks.  Everything else is kept."""
    if isinstance(obj, dict):
        return {k: "<time>" if k in _TIMES else mask(v, base)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v, base) for v in obj]
    if isinstance(obj, bytes):
        obj = obj.decode("latin-1")
    if isinstance(obj, str):
        obj = obj.replace(str(base), "<tmp>")
        obj = _PEM.sub("<pem>", obj)
        return _LOOPBACK_PORT.sub(r"\1<port>", obj)
    return obj


def tcp_free_port() -> int:
    """A loopback port no TCP socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_gate_ports(pkg: str, setattr=setattr) -> None:
    """``pkg``'s parity ``World`` starts its DNS gate, which it asks for
    port 0, on ``tcp_free_port()`` instead (``setattr``: the caller's, a
    monkeypatch's in a test).  Nothing else of the gate or the world
    changes; the rows mask loopback ports either way."""
    world = importlib.import_module(f"{pkg}.parity.world")
    gate_cls = world.DnsGate

    def gate(*args, **kw):
        if kw.get("port") == 0:
            kw["port"] = tcp_free_port()
        return gate_cls(*args, **kw)

    setattr(world, "DnsGate", gate)


@pytest.fixture(autouse=True)
def _free_gates(monkeypatch):
    for pkg in ("clawker_tpu", "clawker_tpu_torch"):
        free_gate_ports(pkg, monkeypatch.setattr)


def item16(row: dict) -> bool:
    """The row failed on the DNS gate's lost TCP bind."""
    err = str(row.get("evidence", {}).get("error", row.get("detail", "")))
    return "OSError" in err and ("Address already in use" in err
                                 or "DnsGate" in err)


def test_corpus_is_the_references():
    """The 22 scenario names, in the reference's order."""
    assert [n for n, _ in port_S.SCENARIOS] == NAMES
    assert len(NAMES) == 22 and len(set(NAMES)) == 22


@pytest.mark.parametrize("name", NAMES, ids=NAMES)
def test_scenario_row_matches_reference(name, tmp_path):
    i = NAMES.index(name) + 1
    rows = {}
    for side, S in SIDES:
        base = tmp_path / side
        row = S._scenario_case((i, str(base)))
        assert not item16(row), f"{side}: {ITEM16}: {row}"
        rows[side] = mask(row, base)
    assert rows["port"] == rows["ref"]
    assert rows["port"]["pass"], rows["port"]


# ------------------------------------------------- parallel suite runner
# tests/test_parity.py's two pins, each on both packages: the parallel
# runner keeps the serial one's order, per-case isolation and failure
# accounting, with the case tables monkeypatched (fork-based pool
# workers inherit the patched module state)

def _ok(tmp):
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "marker").write_text("x")    # per-case tmpdir subtree
    return {"ok": 1}


def _boom(tmp):
    raise AssertionError("nope")


def test_run_all_parallel_matches_serial_in_both(monkeypatch, tmp_path):
    strip = lambda rows: [(r["name"], r["pass"]) for r in rows]  # noqa: E731
    got = {}
    for side, S in SIDES:
        monkeypatch.setattr(S, "SCENARIOS",
                            [("a", _ok), ("b", _boom), ("c", _ok),
                             ("d", _ok)])
        ser = S.run_all(tmp_path / side / "ser", jobs=1)
        par = S.run_all(tmp_path / side / "par", jobs=3)
        assert strip(ser) == strip(par) == [
            ("a", True), ("b", False), ("c", True), ("d", True)]
        assert (tmp_path / side / "par" / "01-a" / "marker").is_file()
        assert "nope" in par[1]["evidence"]["error"]
        got[side] = [mask(r, tmp_path / side) for r in ser + par]
    assert got["port"] == got["ref"]


class _StubStore:
    def __init__(self):
        self.rows = []

    def count(self):
        return len(self.rows)

    def all(self):
        return list(self.rows)


class _StubAttacker:
    def __init__(self):
        self.store = _StubStore()
        self.technique = ""

    def set_technique(self, name):
        self.technique = name


class _StubWorld:
    def __init__(self):
        self.attacker = _StubAttacker()

    def close(self):
        pass


def _contained(w):
    return "clean"


def _escapes(w):
    w.attacker.store.rows.append(("cap", w.attacker.technique))
    return "leaked"


def _crashes(w):
    raise RuntimeError("kaboom")


def test_run_corpus_parallel_matches_serial_in_both(monkeypatch, tmp_path):
    got = {}
    for side, R in (("ref", ref_R), ("port", port_R)):
        monkeypatch.setattr(R, "TECHNIQUES", [
            ("t1", _contained), ("t2", _escapes), ("t3", _contained),
            ("t4", _crashes), ("t5", _contained)])
        monkeypatch.setattr(R, "build_world", lambda tmp: _StubWorld())
        monkeypatch.setattr(R, "grading_of", lambda name: "socket")
        monkeypatch.setattr(R, "kernel_regrade", lambda *a, **k: None)
        monkeypatch.setattr(R.time, "sleep", lambda s: None)

        ser = R.run_corpus(tmp_path / side / "ser", jobs=1)
        par = R.run_corpus(tmp_path / side / "par", jobs=2)
        for doc in (ser, par):
            assert [t["technique"] for t in doc["techniques"]] == [
                "t1", "t2", "t3", "t4", "t5"]
            assert [t["pass"] for t in doc["techniques"]] == [
                True, False, True, False, True]
            assert doc["passed"] == 3 and doc["total"] == 5
            # the capture landed on t2's OWN world: per-shard stores
            # merge into the count the single world reported
            assert doc["captures"] == 1
            assert doc["techniques"][1]["captures"] == 1
            assert "kaboom" in doc["techniques"][3]["detail"]
        got[side] = (ser, par)
    assert got["port"] == got["ref"]
