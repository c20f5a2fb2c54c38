"""Egress-rule composition: required internal + harness + project rules.

Reference: internal/bundler/egress.go + internal/config EgressRules() --
the effective allowlist for an agent is the union of (a) domains the
framework itself requires, (b) domains the harness declares, and (c) the
project's ``security.egress`` rules, deduped by ``dst:proto:port``.

The port's copy of ``clawker_tpu/bundler/egress.py``, whole.
"""

from __future__ import annotations

from .. import consts
from ..bundle.model import Harness
from ..config.schema import EgressRule, ProjectConfig


def compose_egress_rules(
    project: ProjectConfig | None,
    harness: Harness | None,
) -> list[EgressRule]:
    rules: list[EgressRule] = []
    seen: set[str] = set()

    def add(rule: EgressRule) -> None:
        k = rule.key()
        if k not in seen:
            seen.add(k)
            rules.append(rule)

    for dom in consts.REQUIRED_EGRESS_DOMAINS:
        add(EgressRule(dst=dom, proto="https"))
    if harness is not None:
        for r in harness.egress:
            add(r)
    if project is not None:
        for r in project.security.egress:
            add(r)
    return rules
