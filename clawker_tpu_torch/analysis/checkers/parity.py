"""Checker: seam and metric name registries must stay in sync.

Two registries keep string-keyed surfaces honest:

- chaos/seams.py ``SEAM_NAMES``: every ``seams.fire("...")`` site must
  name a registered seam (``arm`` validates at runtime, ``fire`` does
  NOT -- a typo'd fire site silently never fires), and every registered
  seam must have at least one fire site (a seam nothing fires is dead
  coverage the chaos plan generator still draws).

- docs/telemetry.md's registry table: every metric registered via
  ``telemetry.counter/gauge/histogram("name", ...)`` must have a
  ``| `name` |`` row, and every documented name must still be
  registered somewhere (documented-but-never-emitted names rot the
  operator docs the monitor stack dashboards are built from).

- tracing/names.py ``SPAN_CATALOGUE``: every ``SPAN_*`` string
  constant anywhere in the tree must appear in the catalogue, the
  catalogue must match docs/telemetry.md's span-catalogue table both
  ways, and the metric scan above EXCLUDES that table's section (span
  names like ``iteration`` would otherwise read as phantom metrics).

The port's copy of ``clawker_tpu/analysis/checkers/parity.py``, whole.
"""

from __future__ import annotations

import ast
import re

from ..core import Checker, Finding, RepoContext, SourceFile, register_checker
from ._util import call_tail, first_str_arg, receiver

SEAMS_FILE = "clawker_tpu_torch/chaos/seams.py"
TELEMETRY_DOC = "docs/telemetry.md"
SPAN_NAMES_FILE = "clawker_tpu_torch/tracing/names.py"

_DOC_ROW_RE = re.compile(r"^\|\s*`([a-z][a-z0-9_]+)`\s*\|", re.MULTILINE)
_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
_METRIC_RECEIVERS = {"telemetry", "REGISTRY"}

# span names may carry dots (router.submit); rows only count inside the
# span-catalogue section, which the metric scan symmetrically excludes
_SPAN_ROW_RE = re.compile(r"^\|\s*`([a-z][a-z0-9_.]+)`\s*\|", re.MULTILINE)
_SPAN_HEADING_RE = re.compile(r"^(#{2,6})\s+.*span catalogue",
                              re.IGNORECASE | re.MULTILINE)


def _split_span_section(doc: str) -> tuple[str, str]:
    """(doc without the span-catalogue section, that section) -- the
    section runs from its heading to the next same-or-higher heading."""
    m = _SPAN_HEADING_RE.search(doc)
    if m is None:
        return doc, ""
    level = len(m.group(1))
    rest = doc[m.end():]
    nxt = re.search(rf"^#{{2,{level}}}\s", rest, re.MULTILINE)
    end = m.end() + (nxt.start() if nxt else len(rest))
    return doc[:m.start()] + doc[end:], doc[m.start():end]


def _literal_tuple(ctx: RepoContext, rel: str, var: str
                   ) -> tuple[set[str], int] | None:
    """``var`` parsed as a tuple/list of string literals from ``rel``'s
    AST, with its line; None when the fixture repo lacks the registry."""
    src = ctx.source(rel)
    if src is None or src.tree is None:
        return None
    for n in ast.walk(src.tree):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == var
                for t in n.targets):
            if isinstance(n.value, (ast.Tuple, ast.List)):
                names = {e.value for e in n.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)}
                return names, n.lineno
    return None


def _seam_names(ctx: RepoContext) -> tuple[set[str], int] | None:
    return _literal_tuple(ctx, SEAMS_FILE, "SEAM_NAMES")


@register_checker
class RegistryParityChecker(Checker):
    id = "registry-parity"
    doc = ("every fired seam name must be registered in chaos/seams.py "
           "(and every seam fired somewhere); every registered metric "
           "must have a docs/telemetry.md row (and vice versa); every "
           "SPAN_* constant must be in tracing/names.py SPAN_CATALOGUE, "
           "which must match the doc's span-catalogue table both ways")

    def __init__(self):
        self._fired: dict[str, tuple[str, int]] = {}
        self._metrics: dict[str, tuple[str, int]] = {}
        self._span_consts: dict[str, tuple[str, int]] = {}

    def interested(self, rel: str) -> bool:
        return True

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        assert src.tree is not None
        if src.rel == SEAMS_FILE:
            return []
        for c in ast.walk(src.tree):
            if isinstance(c, ast.Assign) \
                    and isinstance(c.value, ast.Constant) \
                    and isinstance(c.value.value, str) \
                    and re.fullmatch(r"[a-z][a-z0-9_.]*", c.value.value):
                for t in c.targets:
                    if isinstance(t, ast.Name) and t.id.startswith("SPAN_"):
                        self._span_consts.setdefault(
                            c.value.value, (src.rel, c.lineno))
                continue
            if not isinstance(c, ast.Call):
                continue
            tail = call_tail(c)
            if tail == "fire" and receiver(c) in {"seams", "self"} \
                    or tail == "_fire_seam":
                name = first_str_arg(c)
                if name and "." in name:
                    self._fired.setdefault(name, (src.rel, c.lineno))
            elif tail in _METRIC_FACTORIES \
                    and receiver(c) in _METRIC_RECEIVERS:
                name = first_str_arg(c)
                if name:
                    self._metrics.setdefault(name, (src.rel, c.lineno))
        return []

    def finish(self, ctx: RepoContext) -> list[Finding]:
        findings: list[Finding] = []
        fired, self._fired = self._fired, {}
        metrics, self._metrics = self._metrics, {}
        span_consts, self._span_consts = self._span_consts, {}

        seams = _seam_names(ctx)
        if seams is not None:
            registered, reg_line = seams
            for name, (rel, line) in sorted(fired.items()):
                if name not in registered:
                    findings.append(Finding(
                        checker=self.id, path=rel, line=line,
                        message=(f"seam `{name}` is fired but not "
                                 f"registered in chaos/seams.py SEAM_NAMES "
                                 f"-- fire() does not validate, this site "
                                 f"is silently dead")))
            for name in sorted(registered - set(fired)):
                findings.append(Finding(
                    checker=self.id, path=SEAMS_FILE, line=reg_line,
                    message=(f"seam `{name}` is registered in SEAM_NAMES "
                             f"but nothing fires it -- the chaos plan "
                             f"generator still draws it as dead coverage")))

        doc = ctx.read_text(TELEMETRY_DOC)
        metric_doc, span_section = _split_span_section(doc or "")

        catalogue = _literal_tuple(ctx, SPAN_NAMES_FILE, "SPAN_CATALOGUE")
        if catalogue is not None:
            registered, reg_line = catalogue
            for name, (rel, line) in sorted(span_consts.items()):
                if name not in registered:
                    findings.append(Finding(
                        checker=self.id, path=rel, line=line,
                        message=(f"span `{name}` has a SPAN_* constant but "
                                 f"is missing from tracing/names.py "
                                 f"SPAN_CATALOGUE")))
            if doc is not None and span_section:
                span_doc = set(_SPAN_ROW_RE.findall(span_section))
                for name in sorted(registered - span_doc):
                    findings.append(Finding(
                        checker=self.id, path=SPAN_NAMES_FILE, line=reg_line,
                        message=(f"span `{name}` is in SPAN_CATALOGUE but "
                                 f"has no row in docs/telemetry.md's "
                                 f"span-catalogue table")))
                for name in sorted(span_doc - registered):
                    findings.append(Finding(
                        checker=self.id, path=TELEMETRY_DOC, line=1,
                        message=(f"span `{name}` is documented in the "
                                 f"span-catalogue table but absent from "
                                 f"tracing/names.py SPAN_CATALOGUE -- "
                                 f"documented-but-never-emitted")))
            elif doc is not None:
                findings.append(Finding(
                    checker=self.id, path=TELEMETRY_DOC, line=1,
                    message=("docs/telemetry.md has no span-catalogue "
                             "section (heading containing 'span "
                             "catalogue') to cross-check SPAN_CATALOGUE "
                             "against")))

        if doc is not None and metrics:
            documented = set(_DOC_ROW_RE.findall(metric_doc))
            for name, (rel, line) in sorted(metrics.items()):
                if name not in documented:
                    findings.append(Finding(
                        checker=self.id, path=rel, line=line,
                        message=(f"metric `{name}` is registered but has "
                                 f"no row in docs/telemetry.md's registry "
                                 f"table")))
            for name in sorted(documented - set(metrics)):
                findings.append(Finding(
                    checker=self.id, path=TELEMETRY_DOC, line=1,
                    message=(f"metric `{name}` is documented in "
                             f"docs/telemetry.md but never registered -- "
                             f"documented-but-never-emitted")))
        return findings
