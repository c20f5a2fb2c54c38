"""Checker registry + AST-walking analysis engine (pure stdlib).

A :class:`Checker` owns one architectural invariant.  The engine parses
every ``clawker_tpu_torch/**/*.py`` file once, hands each checker the files
it declared interest in, and merges the findings.  Findings carry a
line-number-free fingerprint so the grandfather baseline survives
unrelated edits above a finding (see baseline.py).

Inline suppression: a finding is suppressed when the offending line --
or one of the two lines above it -- carries

    # analyze: allow(<checker-id>): <justification>

The justification is mandatory by convention (reviews reject bare
allows); suppressed findings still show up in the report's
``suppressed`` list so the waiver stays visible, they just never fail
the gate.  ``allow(*)`` waives every checker for that line.

The port's copy of ``clawker_tpu/analysis/core.py``, whole.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import time
from pathlib import Path

from .baseline import Baseline, fingerprint

PACKAGE_DIR = "clawker_tpu_torch"

# dirs under the package that are test/dev support, not production
# surface -- checkers never see them (tests/ lives outside the package
# already; testenv is the public fake-pod harness)
EXCLUDED_PARTS = {"__pycache__"}
EXCLUDED_FILES = {"clawker_tpu_torch/testenv.py"}

_ALLOW_RE = re.compile(
    r"#\s*analyze:\s*allow\(\s*(?P<ids>[\w*,\s-]+?)\s*\)\s*(?::\s*(?P<why>.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation at one site."""

    checker: str            # checker id, e.g. "no-blocking-under-lock"
    path: str               # repo-relative posix path
    line: int               # 1-based line of the offending node
    message: str            # human sentence; stable across line drift
    suppressed: bool = False
    justification: str = ""
    # nth finding with this exact (checker, path, message) in one run,
    # in (path, line) order -- keeps fingerprints unique so a NEW
    # second instance of a baselined defect still fails the gate
    occurrence: int = 0

    @property
    def fingerprint(self) -> str:
        return fingerprint(self.checker, self.path, self.message,
                           self.occurrence)

    def to_doc(self) -> dict:
        doc = {"checker": self.checker, "path": self.path,
               "line": self.line, "message": self.message,
               "fingerprint": self.fingerprint}
        if self.suppressed:
            doc["suppressed"] = True
            doc["justification"] = self.justification
        return doc

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


class SourceFile:
    """One parsed file: path + AST + source lines, parsed at most once."""

    def __init__(self, root: Path, rel: str):
        self.rel = rel
        self.abspath = root / rel
        self.text = self.abspath.read_text(encoding="utf-8")
        self.lines = self.text.splitlines()
        self.tree: ast.AST | None
        try:
            self.tree = ast.parse(self.text, filename=rel)
        except SyntaxError:
            self.tree = None    # a file the interpreter rejects is not
            #                     this analyzer's problem to diagnose

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def allowed(self, lineno: int, checker_id: str) -> str | None:
        """The justification string when ``lineno`` -- or the contiguous
        run of comment/blank lines directly above it -- carries an
        ``analyze: allow(...)`` marker naming this checker (or ``*``);
        None otherwise."""
        candidates = [lineno]
        ln = lineno - 1
        while ln >= 1:
            stripped = self.line_at(ln).strip()
            if stripped and not stripped.startswith("#"):
                break
            candidates.append(ln)
            ln -= 1
        for ln in candidates:
            m = _ALLOW_RE.search(self.line_at(ln))
            if not m:
                continue
            ids = {s.strip() for s in m.group("ids").split(",")}
            if "*" in ids or checker_id in ids:
                return (m.group("why") or "").strip() or "(no justification)"
        return None


class RepoContext:
    """Everything a checker may look at: the file set, lazy parses, and
    sibling artifacts (docs tables, the seam registry) read as text."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._files: dict[str, SourceFile] = {}
        self._rels: list[str] | None = None

    def python_files(self) -> list[str]:
        if self._rels is None:
            rels = []
            pkg = self.root / PACKAGE_DIR
            for p in sorted(pkg.rglob("*.py")):
                rel = p.relative_to(self.root).as_posix()
                if any(part in EXCLUDED_PARTS for part in p.parts):
                    continue
                if rel in EXCLUDED_FILES:
                    continue
                rels.append(rel)
            self._rels = rels
        return self._rels

    def source(self, rel: str) -> SourceFile | None:
        if rel not in self._files:
            if not (self.root / rel).is_file():
                return None
            self._files[rel] = SourceFile(self.root, rel)
        return self._files[rel]

    def read_text(self, rel: str) -> str | None:
        p = self.root / rel
        return p.read_text(encoding="utf-8") if p.is_file() else None


class Checker:
    """Base class: subclass, set ``id``/``doc``, implement check()."""

    id = ""
    doc = ""        # one-line catalogue entry (docs/static-analysis.md)

    def interested(self, rel: str) -> bool:
        """Whether ``check`` wants this file (checkers that work off the
        whole repo can return False for everything and use finish())."""
        return True

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        return []

    def finish(self, ctx: RepoContext) -> list[Finding]:
        """Called once after every file; whole-repo checks live here."""
        return []


CHECKERS: dict[str, Checker] = {}


def register_checker(cls):
    """Class decorator: instantiate + register by ``id``."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"checker {cls.__name__} has no id")
    if inst.id in CHECKERS:
        raise ValueError(f"duplicate checker id {inst.id!r}")
    CHECKERS[inst.id] = inst
    return cls


def _load_checkers() -> None:
    # importing the subpackage registers every built-in checker exactly
    # once (idempotent: register_checker guards duplicates via CHECKERS)
    from . import checkers  # noqa: F401


@dataclasses.dataclass
class AnalysisReport:
    """The full result of one analysis run against a baseline."""

    findings: list[Finding]             # active (not suppressed)
    suppressed: list[Finding]           # waived by allow() comments
    new: list[Finding]                  # active and NOT in the baseline
    grandfathered: list[Finding]        # active and in the baseline
    stale_baseline: list[str]           # baseline fingerprints nothing matched
    files_scanned: int = 0
    wall_s: float = 0.0
    checkers: tuple[str, ...] = ()

    @property
    def exit_code(self) -> int:
        return 2 if self.new else 0

    def to_doc(self) -> dict:
        """Stable JSON shape for CI consumption (docs/static-analysis.md
        pins it): keys sorted, findings ordered by (path, line)."""
        return {
            "version": 1,
            "ok": not self.new,
            "files_scanned": self.files_scanned,
            "wall_s": round(self.wall_s, 3),
            "checkers": sorted(self.checkers),
            "new": [f.to_doc() for f in self.new],
            "grandfathered": [f.to_doc() for f in self.grandfathered],
            "suppressed": [f.to_doc() for f in self.suppressed],
            "stale_baseline": sorted(self.stale_baseline),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2, sort_keys=True) + "\n"


def run_analysis(root: Path | str, *, baseline: Baseline | None = None,
                 only: set[str] | None = None) -> AnalysisReport:
    """Run every registered checker (or the ``only`` subset) over the
    repo at ``root`` and classify findings against ``baseline``."""
    _load_checkers()
    t0 = time.monotonic()
    ctx = RepoContext(Path(root))
    active = {cid: c for cid, c in CHECKERS.items()
              if only is None or cid in only}
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    scanned = 0
    for rel in ctx.python_files():
        interested = [c for c in active.values() if c.interested(rel)]
        if not interested:
            continue
        src = ctx.source(rel)
        if src is None or src.tree is None:
            continue
        scanned += 1
        for checker in interested:
            for f in checker.check(src, ctx):
                why = src.allowed(f.line, checker.id)
                if why is not None:
                    suppressed.append(dataclasses.replace(
                        f, suppressed=True, justification=why))
                else:
                    findings.append(f)
    for checker in active.values():
        for f in checker.finish(ctx):
            src = ctx.source(f.path)
            why = src.allowed(f.line, checker.id) if src else None
            if why is not None:
                suppressed.append(dataclasses.replace(
                    f, suppressed=True, justification=why))
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    suppressed.sort(key=lambda f: (f.path, f.line, f.checker))
    # disambiguate identical (checker, path, message) findings in
    # (path, line) order, so each gets its own fingerprint
    counts: dict[tuple[str, str, str], int] = {}
    for i, f in enumerate(findings):
        key = (f.checker, f.path, f.message)
        n = counts.get(key, 0)
        counts[key] = n + 1
        if n:
            findings[i] = dataclasses.replace(f, occurrence=n)

    base = baseline if baseline is not None else Baseline()
    new = [f for f in findings if f.fingerprint not in base]
    old = [f for f in findings if f.fingerprint in base]
    matched = {f.fingerprint for f in old}
    stale = [fp for fp in base.fingerprints() if fp not in matched]
    return AnalysisReport(
        findings=findings, suppressed=suppressed, new=new,
        grandfathered=old, stale_baseline=stale, files_scanned=scanned,
        wall_s=time.monotonic() - t0, checkers=tuple(active))
