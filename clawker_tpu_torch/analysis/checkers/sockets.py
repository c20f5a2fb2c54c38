"""Checker: AF_UNIX server sockets must use the hardening pattern.

Every first-party daemon socket (nsd, loopd, workerd, bksession) is
root-equivalent or project-scoped: filesystem permissions ARE the auth
(docs/nsd-security.md, docs/loopd.md#socket-security).  The committed
pattern, hand-rolled at each site today:

    old = os.umask(0o177)        # cover the bind itself
    try:
        sock.bind(path)
    finally:
        os.umask(old)
    os.chmod(path, 0o600)        # umask-proof pin
    # ... under a 0o700 parent directory

This checker finds every ``.bind()`` in a function that creates an
``AF_UNIX`` socket and requires, in the same function: ``os.umask(0o177)``
before the bind and ``os.chmod(..., 0o600)`` after it -- plus ``0o700``
parent-directory evidence somewhere in the same file.  Client-side
functions (ones that ``connect`` and never ``listen``) are exempt, as
are in-container endpoints with an explicit allow justification.

The port's copy of ``clawker_tpu/analysis/checkers/sockets.py``, whole.
"""

from __future__ import annotations

import ast

from ..core import Checker, Finding, RepoContext, SourceFile, register_checker
from ._util import body_calls, call_tail, functions

EXEMPT_PREFIXES = (
    # band-limited fixture/simulation surfaces, not production daemons
    "clawker_tpu_torch/parity/",
    "clawker_tpu_torch/adversarial/",
)


def _mentions_af_unix(fn: ast.AST) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Attribute) and n.attr == "AF_UNIX":
            return True
    return False


@register_checker
class SocketHardeningChecker(Checker):
    id = "socket-hardening"
    doc = ("every AF_UNIX server bind() must sit in the umask-0o177 + "
           "chmod-0600 + 0700-parent pattern (fs perms are the auth)")

    def interested(self, rel: str) -> bool:
        return not rel.startswith(EXEMPT_PREFIXES)

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        assert src.tree is not None
        file_has_0700 = "0o700" in src.text
        findings: list[Finding] = []
        for fn in functions(src.tree):
            if not _mentions_af_unix(fn):
                continue
            binds: list[ast.Call] = []
            listens = False
            connects = False
            umask_lines: list[int] = []
            chmod600_lines: list[int] = []
            for c in body_calls(fn):
                tail = call_tail(c)
                if tail == "bind":
                    binds.append(c)
                elif tail == "listen":
                    listens = True
                elif tail == "connect":
                    connects = True
                elif tail == "umask":
                    if any(isinstance(a, ast.Constant) and a.value == 0o177
                           for a in c.args):
                        umask_lines.append(c.lineno)
                elif tail == "chmod":
                    if any(isinstance(a, ast.Constant) and a.value == 0o600
                           for a in c.args):
                        chmod600_lines.append(c.lineno)
            if not binds or (connects and not listens):
                continue    # client side: nothing to harden
            for b in binds:
                problems = []
                if not any(ln < b.lineno for ln in umask_lines):
                    problems.append("no os.umask(0o177) before the bind")
                if not any(ln > b.lineno for ln in chmod600_lines):
                    problems.append("no os.chmod(..., 0o600) after the bind")
                if not file_has_0700:
                    problems.append("no 0o700 parent-dir evidence in the file")
                if problems:
                    findings.append(Finding(
                        checker=self.id, path=src.rel, line=b.lineno,
                        message=(f"AF_UNIX bind in `{fn.name}` misses the "
                                 f"hardening pattern: {'; '.join(problems)} "
                                 f"(docs/nsd-security.md)")))
        return findings
