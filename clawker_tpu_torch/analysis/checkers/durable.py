"""Checker: durable journal appends must consume their receipt.

The fail-loud durability contract (docs/durability.md): a
``durable=True`` append fsyncs before returning and reports what
actually happened in its
:class:`~clawker_tpu_torch.loop.journal.AppendReceipt`.
A call site that discards the receipt turns a storage fault back into
a silent drop -- exactly the failure mode the receipt exists to
prevent.  The chaos soak proves the degraded paths dynamically on the
faults it draws; this checker proves every durable call site consumes
its verdict, lexically.

A ``append(..., durable=True)`` / ``_journal(..., durable=True)`` /
``hooks.journal(..., durable=True)`` call is covered when:

- its result is consumed -- assigned, returned, passed as an argument,
  wrapped (``self._durable_ok(self._journal(...))``), chained
  (``.require_durable()``), or tested in a condition -- i.e. the call
  is anything but a bare expression statement, or
- the enclosing function handles ``JournalUnhealthy`` (the fail-stop
  policy raises instead of returning a degraded receipt).

Only a literal ``durable=True`` matches: ``durable=durable``
pass-through wrappers re-export the receipt and are checked at *their*
call sites.

The port's copy of ``clawker_tpu/analysis/checkers/durable.py``, whole.
"""

from __future__ import annotations

import ast

from ..core import Checker, Finding, RepoContext, SourceFile, register_checker
from ._util import call_tail, functions, receiver

# the modules that perform durable write-ahead appends; fixture repos
# mirror these relative paths
SCOPED_FILES = (
    "clawker_tpu_torch/loop/scheduler.py",
    "clawker_tpu_torch/loop/warmpool.py",
    "clawker_tpu_torch/loop/journal.py",
    "clawker_tpu_torch/loopd/server.py",
    "clawker_tpu_torch/capacity/controller.py",
    "clawker_tpu_torch/chaos/runner.py",
)

# spellings of the WAL append in the journaled control plane
APPEND_TAILS = {"append", "_journal", "journal"}


def _is_durable_append(call: ast.Call) -> bool:
    tail = call_tail(call)
    if tail not in APPEND_TAILS:
        return False
    if tail == "journal" and receiver(call) not in {"hooks", "self"}:
        return False
    return any(kw.arg == "durable"
               and isinstance(kw.value, ast.Constant)
               and kw.value.value is True
               for kw in call.keywords)


def _handles_unhealthy(fn: ast.AST) -> bool:
    """True when ``fn`` contains a handler naming JournalUnhealthy (the
    fail-stop policy surfaces the fault by raising, so a discarded
    receipt under such a handler is still fail-loud)."""
    for n in ast.walk(fn):
        if not isinstance(n, ast.ExceptHandler) or n.type is None:
            continue
        types = n.type.elts if isinstance(n.type, ast.Tuple) else [n.type]
        for t in types:
            name = t.attr if isinstance(t, ast.Attribute) else (
                t.id if isinstance(t, ast.Name) else "")
            if name == "JournalUnhealthy":
                return True
    return False


@register_checker
class DurableAppendChecker(Checker):
    id = "durable-append-checked"
    doc = ("every append(..., durable=True) call site must consume the "
           "receipt (assign/return/wrap/chain) or handle "
           "JournalUnhealthy -- discarding it silently re-hides the "
           "storage fault the receipt reports")

    def interested(self, rel: str) -> bool:
        return rel in SCOPED_FILES

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        assert src.tree is not None
        findings: list[Finding] = []
        for fn in functions(src.tree):
            handled = None  # computed lazily: most functions never trip
            for node in ast.walk(fn):
                # the only way to DISCARD a call's value in Python is a
                # bare expression statement; every other position
                # (assign, return, argument, attribute, boolean test)
                # consumes it
                if not (isinstance(node, ast.Expr)
                        and isinstance(node.value, ast.Call)
                        and _is_durable_append(node.value)):
                    continue
                if handled is None:
                    handled = _handles_unhealthy(fn)
                if handled:
                    continue
                findings.append(Finding(
                    checker=self.id, path=src.rel, line=node.lineno,
                    message=(
                        f"durable append `{call_tail(node.value)}(..., "
                        f"durable=True)` in `{fn.name}` discards its "
                        f"receipt -- consume it or handle "
                        f"JournalUnhealthy (fail-loud durability, "
                        f"docs/durability.md)"),
                ))
        return findings
