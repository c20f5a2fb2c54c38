"""First-party static analysis: architectural invariant checkers.

Eleven PRs accreted a set of load-bearing invariants -- write-ahead
journaling before engine mutations, the sentinel's observe-only
contract, the 0600-socket-under-0700-dir hardening pattern, seam and
metric name registries, deterministic chaos plan generation -- and
every one of them was enforced only *dynamically*, by the chaos soak
and hand-written invariant audits.  The soak catches a break hours
after it ships, on the schedules it happens to draw; this package
catches the same class of bug at diff time, on every call site.

``clawker analyze`` (and ``python -m clawker_tpu_torch.analysis`` on hosts
without the CLI deps) walks the package with the stdlib ``ast`` module
and runs every registered checker.  Pre-existing findings live in a
committed grandfather baseline (``analysis-baseline-torch.json``); NEW
findings exit 2 and fail CI.  See docs/static-analysis.md.

IMPORT DISCIPLINE: this package is pure stdlib on purpose -- it must
import (and finish) in under two seconds on a bare host with no JAX,
no click, no device libs.  Nothing under ``clawker_tpu_torch.analysis``
imports any other ``clawker_tpu_torch`` module; the analyzer reads the repo
as *text*, never as code.

The port's copy of ``clawker_tpu/analysis/__init__.py``, whole.
"""

from __future__ import annotations

from .baseline import Baseline, fingerprint
from .core import (
    CHECKERS,
    AnalysisReport,
    Checker,
    Finding,
    RepoContext,
    register_checker,
    run_analysis,
)
from .lockgraph import LockGraph, install_lock_tracing, uninstall_lock_tracing

__all__ = [
    "AnalysisReport",
    "Baseline",
    "CHECKERS",
    "Checker",
    "Finding",
    "LockGraph",
    "RepoContext",
    "fingerprint",
    "install_lock_tracing",
    "register_checker",
    "run_analysis",
    "uninstall_lock_tracing",
]
