"""Shared AST helpers for the built-in checkers (pure stdlib).

The port's copy of ``clawker_tpu/analysis/checkers/_util.py``, whole.
"""

from __future__ import annotations

import ast
from typing import Iterator


def call_tail(call: ast.Call) -> str:
    """The called name's last component: ``self._journal(...)`` ->
    ``_journal``, ``time.sleep(...)`` -> ``sleep``, ``foo(...)`` ->
    ``foo``.  Empty for exotic callees (subscripts, lambdas)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def receiver(call: ast.Call) -> str:
    """Name of the object an attribute call is made on: ``rt.create``
    -> ``rt``, ``self.engine.put_archive`` -> ``engine``,
    ``self._lock`` context -> ``_lock``.  Empty for bare names."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return ""
    v = f.value
    if isinstance(v, ast.Name):
        return v.id
    if isinstance(v, ast.Attribute):
        return v.attr
    return ""


def dotted(node: ast.expr) -> str:
    """Best-effort dotted rendering: ``time.time`` -> "time.time",
    ``self._lock`` -> "self._lock".  Empty when not a name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def first_str_arg(call: ast.Call) -> str | None:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n


def body_calls(fn: ast.AST) -> Iterator[ast.Call]:
    """Every call lexically inside ``fn`` -- nested defs included (a
    closure's engine call still executes in the enclosing flow)."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            yield n


def module_imports(tree: ast.AST, *, pkg_parts: tuple[str, ...]) -> list[tuple[str, int]]:
    """(imported top-level clawker_tpu_torch package, lineno) pairs for every
    import in the module.  ``pkg_parts`` is the module's own path inside
    the package (for resolving relative imports), e.g. ("sentinel",
    "collector") for clawker_tpu_torch/sentinel/collector.py."""
    out: list[tuple[str, int]] = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name == "clawker_tpu_torch":
                    continue
                if a.name.startswith("clawker_tpu_torch."):
                    out.append((a.name.split(".")[1], n.lineno))
        elif isinstance(n, ast.ImportFrom):
            if n.level == 0:
                if n.module and n.module.startswith("clawker_tpu_torch."):
                    out.append((n.module.split(".")[1], n.lineno))
                elif n.module == "clawker_tpu_torch":
                    out.extend((a.name, n.lineno) for a in n.names)
                continue
            # relative: climb level-1 dirs up from the module's package
            base = list(pkg_parts[:-1])
            for _ in range(n.level - 1):
                if base:
                    base.pop()
            if n.module:
                target = base + n.module.split(".")
                if target:
                    out.append((target[0], n.lineno))
            else:
                # ``from .. import engine`` style: the names are packages
                for a in n.names:
                    target = base + [a.name]
                    out.append((target[0], n.lineno))
    return out
