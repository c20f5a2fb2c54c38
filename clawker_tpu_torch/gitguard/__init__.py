"""gitguard: a git-protocol-aware firewall proxy for worktree swarms.

The port's copy of ``clawker_tpu/gitguard/__init__.py``, whole.

The swarm-on-a-repo workload enforces branch-per-agent isolation at
the filesystem layer (one worktree + one ``{prefix}/{run}/{agent}``
branch per agent).  That containment is advisory the moment a harness
shells out to ``git push origin main``: the remote does not know about
worktree boundaries.  gitguard closes the gap at the network layer with
the same posture the firewall already applies to DNS and TLS -- deny by
default, then allow a single protocol-aware lane:

- :mod:`.pktline` -- the git pkt-line codec (v0/v2 framing, flush/delim
  packets, torn-frame and oversized-length tolerance).
- :mod:`.protocol` -- the smart-HTTP filter: rewrite ``info/refs``
  advertisements to hide refs outside the caller's namespace, parse
  ``git-receive-pack`` command lists and build git-readable refusals
  (report-status ``ng`` lines, never a bare TCP reset).
- :mod:`.refpolicy` -- agent identity (mTLS leaf / container labels) ->
  allowed ref namespace; fetch visibility; the privileged merge-queue
  identity that alone may land ``{prefix}/{run}/merged``.
- :mod:`.server` -- the proxy itself on a hardened unix socket
  (0600/0700, same pattern as loopd/workerd); Envoy's MITM chain for
  git hosts routes through it, and swarm runs deny ssh/22 and
  git/9418 so this lane is the only git path.

Fail-closed by construction: if the guard is down the Envoy cluster has
no healthy endpoint and the client sees a connection error -- a push is
refused, never silently passed through.  See docs/git-policy.md.
"""

from __future__ import annotations

from .pktline import (
    DELIM_PKT,
    FLUSH_PKT,
    MAX_PKT_PAYLOAD,
    PktError,
    RESPONSE_END_PKT,
    TruncatedPkt,
    encode_pkt,
    iter_pkts,
)
from .protocol import (
    GIT_RECEIVE_PACK,
    GIT_UPLOAD_PACK,
    filter_advertisement,
    parse_receive_commands,
    refusal_response,
)
from .refpolicy import (
    AgentIdentity,
    Decision,
    RefPolicy,
    git_egress_rules,
)
from .server import (
    FakeGitUpstream,
    GitguardServer,
    LocalRepoUpstream,
)

__all__ = [
    "FLUSH_PKT", "DELIM_PKT", "RESPONSE_END_PKT", "MAX_PKT_PAYLOAD",
    "PktError", "TruncatedPkt", "encode_pkt", "iter_pkts",
    "GIT_UPLOAD_PACK", "GIT_RECEIVE_PACK", "filter_advertisement",
    "parse_receive_commands", "refusal_response",
    "AgentIdentity", "Decision", "RefPolicy", "git_egress_rules",
    "GitguardServer", "LocalRepoUpstream", "FakeGitUpstream",
]
