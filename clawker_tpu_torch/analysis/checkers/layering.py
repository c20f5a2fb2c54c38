"""Checker: whole-package import-layering DAG + sentinel observe-only.

The architecture has a spine (docs/loop-parallel.md, docs/loopd.md,
docs/analytics-online.md):

    cli  ->  loop / loopd / workerd / chaos / sentinel / ...
         ->  engine / controlplane / placement / health / monitor /
             telemetry / fleet / ...
         ->  util / config / consts / errors / logsetup

A package may import its own rank or below, never above: an
``engine`` module importing ``loop`` couples the data plane to one
consumer and is exactly the inversion that rots a 20-package codebase.
Violations are reported with the offending edge.

On top of the ranks, DENY edges encode the sentinel's observe-only
contract (docs/analytics-online.md): ``sentinel`` may not import --
and therefore cannot call into -- ``engine``, ``placement``,
``health``, or the scheduler packages.  The chaos soak proves the
contract dynamically with the byte-identical-placements twin; this
checker rejects the import at diff time.

The port's copy of ``clawker_tpu/analysis/checkers/layering.py``, whole.
"""

from __future__ import annotations

from ..core import Checker, Finding, RepoContext, SourceFile, register_checker
from ._util import module_imports

RANKS = {
    # rank 4: the CLI -- imports everything, imported by nothing
    "cli": 4,
    # rank 3: orchestration / long-lived daemons / analysis surfaces
    "loop": 3, "loopd": 3, "workerd": 3, "chaos": 3, "sentinel": 3,
    "ui": 3, "storeui": 3, "bundler": 3, "adversarial": 3, "parity": 3,
    "nsd": 3, "analysis": 3, "federation": 3,
    # rank 2: subsystems the orchestration layer composes
    "engine": 2, "controlplane": 2, "placement": 2, "health": 2,
    "monitor": 2, "telemetry": 2, "fleet": 2, "runtime": 2,
    "firewall": 2, "agentd": 2, "analytics": 2, "hostproxy": 2,
    "socketbridge": 2, "workspace": 2, "project": 2, "bundle": 2,
    "gitx": 2, "capacity": 2, "gitguard": 2, "tracing": 2,
    # rank 1: leaves -- importable from anywhere, import nothing above
    "util": 1, "config": 1, "consts": 1, "errors": 1, "logsetup": 1,
    "state": 1, "storage": 1, "containerfs": 1,
}

# forbidden regardless of rank: the observe-only sentinel contract.
# (loop/loopd/workerd share sentinel's rank, so the rank rule alone
# would let these through.)
DENY_EDGES = {
    ("sentinel", "engine"),
    ("sentinel", "placement"),
    ("sentinel", "health"),
    ("sentinel", "loop"),
    ("sentinel", "loopd"),
    ("sentinel", "workerd"),
    ("sentinel", "cli"),
    # the analyzer itself must stay pure stdlib (docs/static-analysis.md:
    # importable in <2s with no JAX on a bare host)
    ("analysis", "analytics"),
    ("analysis", "engine"),
    ("analysis", "loop"),
    ("analysis", "telemetry"),
    ("analysis", "cli"),
}


@register_checker
class LayeringChecker(Checker):
    id = "import-layering"
    doc = ("package imports must follow the layering DAG (cli -> "
           "loop/loopd/workerd -> engine/controlplane -> util); "
           "sentinel may not import engine/placement/health/scheduler "
           "(observe-only)")

    def interested(self, rel: str) -> bool:
        return True

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        assert src.tree is not None
        parts = src.rel.split("/")
        # parts[0] == "clawker_tpu_torch"; top-level modules rank with their
        # stem (state.py -> "state")
        inner = parts[1:]
        pkg = inner[0] if len(inner) > 1 else inner[0].removesuffix(".py")
        my_rank = RANKS.get(pkg)
        findings: list[Finding] = []
        seen: set[tuple[str, int]] = set()
        for target, lineno in module_imports(
                src.tree, pkg_parts=tuple(p.removesuffix(".py")
                                          for p in inner)):
            if target == pkg or (target, lineno) in seen:
                continue
            seen.add((target, lineno))
            if (pkg, target) in DENY_EDGES:
                findings.append(Finding(
                    checker=self.id, path=src.rel, line=lineno,
                    message=(f"forbidden edge {pkg} -> {target}: "
                             + ("sentinel is observe-only and may not "
                                "import the scheduling/engine side "
                                "(docs/analytics-online.md)"
                                if pkg == "sentinel" else
                                "the analyzer must stay pure stdlib "
                                "(docs/static-analysis.md)"))))
                continue
            t_rank = RANKS.get(target)
            if my_rank is None or t_rank is None:
                continue
            if t_rank > my_rank:
                findings.append(Finding(
                    checker=self.id, path=src.rel, line=lineno,
                    message=(f"layering violation: {pkg} (rank {my_rank}) "
                             f"imports {target} (rank {t_rank}) -- imports "
                             f"must point down the DAG "
                             f"(docs/static-analysis.md)")))
        return findings
