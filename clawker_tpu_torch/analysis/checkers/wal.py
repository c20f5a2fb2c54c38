"""Checker: write-ahead discipline on engine mutations.

The durability contract (docs/loop-resume.md, docs/chaos.md): every
engine mutation the scheduler performs -- create / start / restart /
put_archive -- must be *dominated* by a write-ahead journal record or a
named crash seam in the enclosing flow, so a SIGKILL anywhere leaves a
journal the resume reconcile can replay.  The chaos soak proves this
dynamically on the schedules it draws; this checker proves it on every
call site, lexically.

A mutation call is covered when, earlier in the same function, one of:

- a ``_journal(...)`` / ``journal.append(...)`` call (the WAL itself),
- a ``seams.fire("...")`` call (seams are defined as fired at journaled
  transition boundaries -- chaos/seams.py -- and the registry-parity
  checker keeps the set honest),
- a call to a same-module helper whose own body journals or fires,

appears.  Sites that are genuinely covered by a WAL on the *other* side
of a process boundary (workerd executes intents the scheduler already
journaled) carry an ``analyze: allow`` justification instead.

The port's copy of ``clawker_tpu/analysis/checkers/wal.py``, whole.
"""

from __future__ import annotations

import ast

from ..core import Checker, Finding, RepoContext, SourceFile, register_checker
from ._util import body_calls, call_tail, functions, receiver

# the files that perform engine mutations inside the journaled control
# plane; fixture repos mirror these relative paths
SCOPED_FILES = (
    "clawker_tpu_torch/loop/scheduler.py",
    "clawker_tpu_torch/loop/warmpool.py",
    "clawker_tpu_torch/workerd/server.py",
    "clawker_tpu_torch/capacity/controller.py",
    "clawker_tpu_torch/workspace/strategy.py",
    "clawker_tpu_torch/gitx/git.py",
    # gitguard rule install/teardown mutates the shared rules store and
    # must be dominated by a REC_GITGUARD_RULES journal write
    # (docs/git-policy.md); the proxy itself is I/O-only and exempt
    "clawker_tpu_torch/gitguard/server.py",
)

# attribute names that are unambiguous engine mutations anywhere
MUTATIONS = {"create_container", "start_container", "restart_container",
             "put_archive"}
# runtime-wrapper mutations, only when called on a runtime handle (the
# bare names are far too generic to match on any receiver)
RT_MUTATIONS = {"create", "start", "adopt_pooled"}
RT_RECEIVERS = {"rt", "runtime"}
# fleet-scaler mutations (capacity controller): provisioning or
# draining a worker must be dominated by a journaled REC_CAPACITY_*
# record exactly like an engine mutation (docs/elastic-capacity.md)
SCALER_MUTATIONS = {"provision", "drain"}
SCALER_RECEIVERS = {"scaler"}

WAL_MARKERS = {"_journal"}
# the capacity controller journals through its hooks bag
# (self.hooks.journal(...)): same WAL, different spelling
HOOKS_WAL = ("journal", "hooks")
SEAM_MARKERS = {"fire"}


def _is_mutation(call: ast.Call) -> bool:
    tail = call_tail(call)
    if tail in MUTATIONS:
        return True
    if tail in SCALER_MUTATIONS and receiver(call) in SCALER_RECEIVERS:
        return True
    return tail in RT_MUTATIONS and receiver(call) in RT_RECEIVERS


def _is_wal_marker(call: ast.Call, journaling_helpers: set[str]) -> bool:
    tail = call_tail(call)
    if tail in WAL_MARKERS:
        return True
    if tail == HOOKS_WAL[0] and receiver(call) == HOOKS_WAL[1]:
        return True
    if tail in SEAM_MARKERS and receiver(call) in {"seams", "self"}:
        return True
    if tail == "_fire_seam":
        return True
    # helper-name matching is the loosest rule, so it gets the
    # tightest guards: only bare `helper()` / `self.helper()` calls
    # count (never `thread.start()` or `Thread(...).start()` hitting a
    # journaling method named `start`), and a name that is itself a
    # mutation can never be evidence
    if tail in MUTATIONS or tail in RT_MUTATIONS:
        return False
    if tail not in journaling_helpers:
        return False
    f = call.func
    if isinstance(f, ast.Name):
        return True
    return (isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name) and f.value.id == "self")


@register_checker
class WriteAheadChecker(Checker):
    id = "wal-before-mutation"
    doc = ("engine mutations (create/start/restart/put_archive) in the "
           "journaled control plane must be dominated by a _journal()/"
           "seam-fire call in the enclosing flow")

    def interested(self, rel: str) -> bool:
        return rel in SCOPED_FILES

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        assert src.tree is not None
        # pass 1: same-module helpers whose body journals or fires a
        # seam -- calling one of them counts as WAL evidence
        journaling_helpers: set[str] = set()
        for fn in functions(src.tree):
            for c in body_calls(fn):
                if call_tail(c) in WAL_MARKERS or (
                        call_tail(c) == HOOKS_WAL[0]
                        and receiver(c) == HOOKS_WAL[1]) or (
                        call_tail(c) in SEAM_MARKERS
                        and receiver(c) in {"seams", "self"}):
                    journaling_helpers.add(fn.name)
                    break
        findings: list[Finding] = []
        for fn in functions(src.tree):
            # lexical order within the function: a marker covers every
            # mutation after it
            covered_from: int | None = None
            events: list[tuple[int, str, ast.Call]] = []
            for c in body_calls(fn):
                if _is_wal_marker(c, journaling_helpers):
                    events.append((c.lineno, "wal", c))
                elif _is_mutation(c):
                    events.append((c.lineno, "mut", c))
            events.sort(key=lambda e: e[0])
            for lineno, kind, call in events:
                if kind == "wal":
                    if covered_from is None:
                        covered_from = lineno
                    continue
                if covered_from is None or lineno < covered_from:
                    findings.append(Finding(
                        checker=self.id, path=src.rel, line=lineno,
                        message=(
                            f"engine mutation `{call_tail(call)}` in "
                            f"`{fn.name}` is not dominated by a _journal/"
                            f"seam-fire call in the enclosing flow "
                            f"(write-ahead discipline, docs/loop-resume.md)"),
                    ))
        return findings
