"""Checker: no blocking calls lexically inside a held-lock block.

The control plane's locks are *stamp* locks: they order in-memory state
and must be held for microseconds.  A blocking call under one -- an
engine round-trip, ``subprocess`` spawn/wait, a socket dial, a
``time.sleep`` -- couples every other thread contending that lock to an
external party's latency, which is how one wedged daemon freezes a
whole pod (the exact coupling per-worker lanes exist to prevent,
docs/loop-parallel.md).

Flagged inside ``with <something lock-ish>:`` blocks:

- ``time.sleep``
- ``subprocess.run/call/check_*/Popen``; ``.communicate()``
- socket ops: ``.connect/.recv/.accept/.sendall/.sendto``, ``urlopen``
- engine calls: ``create/start/restart/stop/remove_container``,
  ``wait_container``, ``put_archive``, ``.exec(...)``, ``.ping()``
- ``.join()`` on anything (joining a thread that needs the held lock is
  a deadlock), ``.wait()`` on anything OTHER than the lock object the
  ``with`` holds (``cond.wait()`` releases the lock; ``proc.wait()``
  does not)

Lock-ish context expressions: a name/attribute containing ``lock`` or
``cond`` (the repo convention: ``self._lock``, ``_placement_lock``,
``self._ev_cond``).

The port's copy of ``clawker_tpu/analysis/checkers/locks.py``, whole.
"""

from __future__ import annotations

import ast

from ..core import Checker, Finding, RepoContext, SourceFile, register_checker
from ._util import call_tail, dotted, receiver

SCOPED_PREFIXES = (
    "clawker_tpu_torch/monitor/",
    "clawker_tpu_torch/telemetry/",
    "clawker_tpu_torch/engine/",
    "clawker_tpu_torch/socketbridge/",
    "clawker_tpu_torch/loopd/",
    "clawker_tpu_torch/workerd/",
    "clawker_tpu_torch/agentd/",
    "clawker_tpu_torch/fleet/transport.py",
)

BLOCKING_TAILS = {
    "sleep", "run", "call", "check_output", "check_call", "Popen",
    "communicate", "connect", "recv", "recv_into", "accept", "sendall",
    "sendto", "urlopen", "join", "put_archive", "create_container",
    "start_container", "restart_container", "stop_container",
    "remove_container", "wait_container", "exec", "ping", "wait",
}
# tails only blocking when the receiver is clearly the right kind of
# object (``.run`` on subprocess/runner-ish receivers, not ``app.run``)
NEEDS_RECEIVER = {
    "run": {"subprocess", "runner"},
    "call": {"subprocess"},
    "check_output": {"subprocess"},
    "check_call": {"subprocess"},
    "Popen": {"subprocess"},
    "exec": {"engine"},
    "ping": {"engine"},
}


def _calls_outside_nested_defs(node: ast.AST):
    """Every Call under ``node``, NOT descending into nested function or
    lambda definitions: defining a closure under a lock is fine, it is
    executing one that blocks."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _lockish(expr: ast.expr) -> str | None:
    """The dotted name of a lock-ish with-context, else None."""
    if isinstance(expr, ast.Call):
        return None     # with phases.phase("..."), with open(...), ...
    name = dotted(expr)
    tail = name.rsplit(".", 1)[-1].lower()
    if "lock" in tail or "cond" in tail:
        return name
    return None


@register_checker
class BlockingUnderLockChecker(Checker):
    id = "no-blocking-under-lock"
    doc = ("no engine/socket/subprocess/sleep calls lexically inside a "
           "`with <lock>:` block -- stamp locks are held for "
           "microseconds, never across external latency")

    def interested(self, rel: str) -> bool:
        return rel.startswith(SCOPED_PREFIXES) or rel in SCOPED_PREFIXES

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        assert src.tree is not None
        findings: list[Finding] = []
        for w in ast.walk(src.tree):
            if not isinstance(w, ast.With):
                continue
            held = [n for n in (_lockish(i.context_expr) for i in w.items)
                    if n]
            if not held:
                continue
            held_set = set(held)
            for node in w.body:
                for c in _calls_outside_nested_defs(node):
                    tail = call_tail(c)
                    if tail not in BLOCKING_TAILS:
                        continue
                    if tail == "wait":
                        # .wait() on the held condition releases the
                        # lock -- only a wait on some OTHER object
                        # (proc.wait, thread-ish waits) blocks under it
                        if not isinstance(c.func, ast.Attribute):
                            continue
                        target = dotted(c.func.value)
                        last = target.rsplit(".", 1)[-1].lower()
                        if target and any(
                                target == h or h.endswith("." + target)
                                or target.endswith("." + h)
                                for h in held_set):
                            continue
                        if "cond" in last or "event" in last \
                                or last.endswith("_stop") or last == "_stop":
                            continue    # cond/event waits park, they
                            #             don't hold foreign latency
                        findings.append(self._finding(src, c, "wait", held[0]))
                        continue
                    if tail == "join" and isinstance(c.func, ast.Attribute) \
                            and isinstance(c.func.value, ast.Constant):
                        continue    # ", ".join(...) -- str.join, not a
                        #             thread join
                    need = NEEDS_RECEIVER.get(tail)
                    if need is not None and receiver(c) not in need:
                        continue
                    findings.append(self._finding(src, c, tail, held[0]))
        return findings

    def _finding(self, src: SourceFile, call: ast.Call, tail: str,
                 lock: str) -> Finding:
        return Finding(
            checker=self.id, path=src.rel, line=call.lineno,
            message=(f"blocking call `{tail}` inside `with {lock}:` -- "
                     f"move the blocking work outside the lock "
                     f"(docs/static-analysis.md#no-blocking-under-lock)"))
