"""Ref-level policy: who may see, fetch, and update which git refs.

The port's copy of ``clawker_tpu/gitguard/refpolicy.py``, whole.

The swarm contract (docs/loop-worktrees.md) gives every agent exactly
one branch, ``{branch_prefix}/{run}/{agent}``, and routes integration
through a merge queue that alone lands ``{branch_prefix}/{run}/merged``.
This module is the pure-decision half of gitguard: given an agent
identity and a ref name, return an allow/deny :class:`Decision` with a
human-and-git-readable reason.  No I/O, no protocol -- the proxy
(:mod:`.server`) and the chaos invariant both call the same functions,
so the thing the soak audits is the thing production enforces.

Identity binding (docs/git-policy.md): inside a swarm the agent's
container carries the mTLS leaf whose CN is ``{project}.{agent}``
and the ``dev.clawker-tpu.agent`` label.  Envoy terminates the MITM'd
TLS, verifies the leaf, and forwards the request over the gitguard unix
socket with the ``X-Clawker-Identity`` header.  gitguard trusts that
header for exactly one reason: the socket is 0600 inside a 0700 runtime
dir, so only the envoy/loopd user can speak to it at all.  Anything
without the header is an unauthenticated peer and gets the empty
namespace (sees the base branch, updates nothing).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..config.schema import EgressRule, PathRule
from ..consts import LABEL_AGENT, LABEL_ROLE

# Header Envoy injects after verifying the client leaf; value is
# "{run}/{agent}" (or "{run}/{agent}/{role}" for the merge queue).
IDENTITY_HEADER = "X-Clawker-Identity"

# The privileged role that alone may fast-forward the integration ref.
MERGE_QUEUE_ROLE = "mergeq"

# Decision verdict strings (journal/bus/metrics vocabulary).
ALLOW = "allow"
DENY = "deny"
DOWN_REFUSED = "down_refused"   # client-observed: guard gone, fail-closed


@dataclass(frozen=True)
class AgentIdentity:
    """A resolved caller: run id, agent name, optional privileged role."""

    run: str
    agent: str
    role: str = ""

    @property
    def merge_queue(self) -> bool:
        return self.role == MERGE_QUEUE_ROLE

    def header_value(self) -> str:
        base = f"{self.run}/{self.agent}"
        return f"{base}/{self.role}" if self.role else base

    @classmethod
    def from_header(cls, value: str) -> "AgentIdentity | None":
        parts = [p for p in (value or "").strip().split("/") if p]
        if len(parts) == 2:
            return cls(run=parts[0], agent=parts[1])
        if len(parts) == 3:
            return cls(run=parts[0], agent=parts[1], role=parts[2])
        return None

    @classmethod
    def from_labels(cls, labels: dict[str, str], run: str,
                    ) -> "AgentIdentity | None":
        """Fallback binding from container labels (no mTLS leaf)."""
        agent = (labels or {}).get(LABEL_AGENT, "")
        if not agent:
            return None
        role = (labels or {}).get(LABEL_ROLE, "")
        return cls(run=run, agent=agent,
                   role=role if role == MERGE_QUEUE_ROLE else "")


@dataclass(frozen=True)
class Decision:
    """One policy verdict, shaped for the journal/bus/metrics."""

    verdict: str                # ALLOW | DENY | DOWN_REFUSED
    reason: str                 # git-readable refusal text ("" on allow)
    service: str = ""           # git-upload-pack | git-receive-pack
    ref: str = ""
    agent: str = ""
    run: str = ""

    @property
    def allowed(self) -> bool:
        return self.verdict == ALLOW

    def to_doc(self) -> dict:
        return {"verdict": self.verdict, "reason": self.reason,
                "service": self.service, "ref": self.ref,
                "agent": self.agent, "run": self.run}


def _bad_ref_name(ref: str) -> str:
    """Syntactic refusal reason for a hostile ref name, or ""."""
    if not ref:
        return "empty ref name"
    if "\x00" in ref:
        return "NUL byte in ref name"
    if any(ord(c) < 0x20 or ord(c) == 0x7F for c in ref):
        return "control byte in ref name"
    if ".." in ref:
        return "'..' in ref name"
    if not ref.startswith("refs/"):
        return "ref outside refs/"
    if ref.endswith("/") or ref.endswith(".lock") or "//" in ref:
        return "malformed ref name"
    return ""


@dataclass(frozen=True)
class RefPolicy:
    """The branch-per-agent namespace rule for one run.

    ``base_refs`` lists refs every agent may fetch (the seed branch and
    anything the operator pins); agents additionally see their own
    namespace, and nothing else.
    """

    run: str
    branch_prefix: str = "loop"
    base_refs: tuple[str, ...] = ("refs/heads/main",)
    merge_ref: str = ""         # "" -> refs/heads/{prefix}/{run}/merged

    def namespace(self, identity: AgentIdentity) -> str:
        return f"refs/heads/{self.branch_prefix}/{self.run}/{identity.agent}"

    def integration_ref(self) -> str:
        if self.merge_ref:
            return self.merge_ref
        return f"refs/heads/{self.branch_prefix}/{self.run}/merged"

    def _in_namespace(self, identity: AgentIdentity, ref: str) -> bool:
        ns = self.namespace(identity)
        return ref == ns or ref.startswith(ns + "/")

    def may_read(self, identity: AgentIdentity | None, ref: str) -> bool:
        """Fetch/advertisement visibility: base refs + own namespace.

        The merge queue sees everything (it must fetch every agent
        branch to land them); HEAD stays visible so clones resolve.
        """
        if ref == "HEAD" or ref in self.base_refs:
            return True
        if identity is None:
            return False
        if identity.merge_queue:
            return True
        return self._in_namespace(identity, ref)

    def may_update(self, identity: AgentIdentity | None, ref: str,
                   *, service: str = "git-receive-pack") -> Decision:
        """Push verdict for one ``old new ref`` command."""
        agent = identity.agent if identity else ""
        run = identity.run if identity else self.run
        bad = _bad_ref_name(ref)
        if bad:
            return Decision(DENY, bad, service=service, ref=ref,
                            agent=agent, run=run)
        if identity is None:
            return Decision(DENY, "unauthenticated push refused",
                            service=service, ref=ref, agent=agent, run=run)
        if identity.run != self.run:
            return Decision(DENY, f"identity run {identity.run!r} does not "
                            f"match guarded run {self.run!r}",
                            service=service, ref=ref, agent=agent, run=run)
        if ref == self.integration_ref():
            if identity.merge_queue:
                return Decision(ALLOW, "", service=service, ref=ref,
                                agent=agent, run=run)
            return Decision(
                DENY, "integration branch is merge-queue only "
                      "(submit via the queue)", service=service, ref=ref,
                agent=agent, run=run)
        if self._in_namespace(identity, ref):
            return Decision(ALLOW, "", service=service, ref=ref,
                            agent=agent, run=run)
        return Decision(
            DENY, f"ref outside agent namespace "
                  f"{self.branch_prefix}/{self.run}/{agent}",
            service=service, ref=ref, agent=agent, run=run)


def git_egress_rules(hosts: list[str]) -> list[EgressRule]:
    """The run-scoped rule set a worktree swarm installs for git hosts.

    For each host: one https rule whose path-ruling forces the MITM +
    gitguard lane, plus explicit ssh/22 and git/9418 deny pins so the
    guarded smart-HTTP lane is the *only* git path even if a broader
    user rule would otherwise allow those ports.  Returned rules are
    added through the normal RulesStore (dedupe key ``dst:proto:port``)
    and removed by key at cleanup.
    """
    rules: list[EgressRule] = []
    for host in hosts:
        rules.append(EgressRule(
            dst=host, proto="https",
            path_rules=[PathRule(path="/", action="allow")]))
        rules.append(EgressRule(dst=host, proto="ssh", port=22,
                                action="deny"))
        rules.append(EgressRule(dst=host, proto="git", port=9418,
                                action="deny"))
    return rules
