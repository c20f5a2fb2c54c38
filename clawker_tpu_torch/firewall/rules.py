"""Persistent egress rule store: the firewall's source of truth.

The port's copy of ``clawker_tpu/firewall/rules.py``, whole.

``egress-rules.yaml`` in the data dir holds the dynamically-added rules
(FirewallAddRules); the effective rule set is always
required-internal + project + stored, deduped by the ``dst:proto:port``
rule key -- first writer wins, matching the config-layer merge.

Parity reference: controlplane/firewall/rules_store.go
(storage.Store[EgressRulesFile], RuleKey dedupe).
"""

from __future__ import annotations

import threading
from pathlib import Path

import yaml

from ..config.schema import EgressRule, from_dict, to_dict
from ..errors import ClawkerError
from ..util.fs import atomic_write


class RuleError(ClawkerError):
    pass


_DOMAIN_CHARS = frozenset("abcdefghijklmnopqrstuvwxyz0123456789.-_")
# Closed allowlist: a typo'd proto ('htps') with an explicit port would
# otherwise install an opaque TCP lane with none of the SNI/MITM
# inspection the user intended.  Arbitrary named lanes use proto "tcp".
KNOWN_PROTOS = ("https", "http", "tcp", "udp", "ssh", "git")


def validate_rule(r: EgressRule) -> None:
    """Ingestion-time rule validation: a bad rule must error at
    ``firewall add-rules`` time, never at traffic time (reference
    ValidateRule; action/path/method checks live in the schema's
    constructors and have already run by the time a rule object exists).
    """
    if not r.dst:
        raise RuleError("rule missing dst")
    body = r.dst[2:] if r.dst.startswith("*.") else r.dst
    if not body or set(body) - _DOMAIN_CHARS or body.startswith((".", "-")) \
            or ".." in body:
        raise RuleError(f"rule {r.dst!r}: not a valid domain")
    if r.proto not in KNOWN_PROTOS:
        raise RuleError(
            f"rule {r.dst}: unknown proto {r.proto!r} (want one of "
            f"{', '.join(KNOWN_PROTOS)})")
    if r.proto not in ("http", "https") and (
            r.path_rules or r.paths or r.path_default):
        # Opaque lanes carry no L7 filtering: a path rule here would be
        # accepted and silently never enforced -- reject at ingestion.
        raise RuleError(
            f"rule {r.dst}: path rules need an HTTP(S) lane, not "
            f"proto {r.proto!r}")
    if not (0 <= r.port <= 65535):
        raise RuleError(f"rule {r.dst}: port {r.port} out of range")
    if r.proto != "udp" and r.effective_port() == 0:
        # Guards two fail-opens: a typo'd proto ('htps') must not become a
        # port-0 all-ports TCP allow, and an opaque 'tcp' rule must name
        # its port explicitly.
        raise RuleError(
            f"rule {r.dst}: proto {r.proto!r} has no default port; pass "
            "an explicit port for a named TCP lane")


def _merge_rule(prior: EgressRule, incoming: EgressRule) -> EgressRule:
    """Collision merge: incoming wins on action/path_default; path rules
    unioned by path with incoming taking precedence.

    Incoming paths are ordered FIRST: routes match first-prefix-wins, so
    a new more-specific carve-out (e.g. allow /repos/public under a prior
    /repos deny) must precede the prior broader prefix or it would be
    unreachable while the add reports success."""
    merged_paths = list(incoming.effective_path_rules())
    seen = {p.path for p in merged_paths}
    merged_paths += [p for p in prior.effective_path_rules()
                     if p.path not in seen]
    return EgressRule(
        dst=incoming.dst, proto=incoming.proto, port=incoming.port,
        action=incoming.action,
        path_rules=merged_paths,
        path_default=incoming.path_default or prior.path_default,
    )


class RulesStore:
    def __init__(self, path: Path):
        self.path = Path(path)
        self._lock = threading.Lock()

    def load(self) -> list[EgressRule]:
        if not self.path.exists():
            return []
        data = yaml.safe_load(self.path.read_text(encoding="utf-8")) or {}
        out: dict[str, EgressRule] = {}
        for raw in data.get("rules") or []:
            try:
                r = from_dict(EgressRule, raw)
            except (ValueError, TypeError) as e:
                # A rule persisted before ingestion validation existed (or
                # hand-edited) must not brick every firewall verb: skip it
                # (the next write garbage-collects it) and say so.
                import logging
                logging.getLogger("clawker.firewall.rules").warning(
                    "egress-rules.yaml: dropping invalid stored rule %r: %s",
                    raw, e)
                continue
            if r.dst:
                out.setdefault(r.key(), r)
        return list(out.values())

    def _save(self, rules: list[EgressRule]) -> None:
        tree = {"rules": [to_dict(r) for r in rules]}
        body = None
        if self.path.exists():
            # egress-rules.yaml is exactly the file users hand-comment:
            # patch item-surgically (storage/yamledit) so an add/remove
            # keeps every comment; fall back to the re-dump on anything
            # not expressible
            try:
                original = self.path.read_text(encoding="utf-8")
            except OSError:
                original = ""
            if original.strip():
                from ..storage.yamledit import apply_edits

                body = apply_edits(original, tree)
        if body is None:
            body = yaml.safe_dump(tree, sort_keys=False)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write(self.path, body.encode())

    def add(self, new: list[EgressRule]) -> list[EgressRule]:
        """Dedupe-add; returns the rules actually added.

        On a key collision the incoming rule wins on action and its path
        rules are unioned by path (reference rules_store.go merge: caller
        wins on Action, PathRules unioned) -- a deny update or a path-rule
        update for an existing dst:proto:port must not be dropped."""
        with self._lock:
            have = {r.key(): r for r in self.load()}
            changed = []
            for r in new:
                validate_rule(r)
                prior = have.get(r.key())
                if prior is None:
                    have[r.key()] = r
                    changed.append(r)
                    continue
                merged = _merge_rule(prior, r)
                if merged != prior:
                    have[r.key()] = merged
                    changed.append(merged)
            if changed:
                self._save(list(have.values()))
            return changed

    def replace(self, rules: list[EgressRule]) -> None:
        """Overwrite the stored set (mutation rollback after a refused
        data-plane swap -- a poison rule must not stay persisted and
        wedge every later sync)."""
        with self._lock:
            self._save(list(rules))

    def remove(self, key: str) -> bool:
        with self._lock:
            rules = self.load()
            kept = [r for r in rules if r.key() != key]
            if len(kept) == len(rules):
                return False
            self._save(kept)
            return True

    def effective(self, base: list[EgressRule]) -> list[EgressRule]:
        """base (required + project) + stored, deduped by key."""
        out = {r.key(): r for r in base}
        for r in self.load():
            out.setdefault(r.key(), r)
        return list(out.values())
