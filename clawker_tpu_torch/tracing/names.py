"""The span-name catalogue: every name any Tracer or daemon emits.

The ``registry-parity`` analyze checker cross-checks this tuple against
the span-catalogue table in docs/telemetry.md exactly the way metric
names are enforced: an emitted name missing from the doc table -- or a
documented name nothing emits -- is a diff-time finding.  Add the name
HERE and in the doc table in the same change that introduces the span.

The port's copy of ``clawker_tpu/tracing/names.py``, whole.
"""

from __future__ import annotations

# cross-process hop spans (docs/tracing.md)
SPAN_ROUTER_SUBMIT = "router.submit"        # federation router -> pod
SPAN_LOOPD_SUBMIT = "loopd.submit"          # loopd accept -> run start
SPAN_WORKERD_CREATE = "workerd.create"      # worker-side container create
SPAN_WORKERD_START = "workerd.start"        # worker-side start + bootstrap
SPAN_WORKERD_WAIT = "workerd.wait"          # worker-resident exit waiter
SPAN_ENGINE_REQUEST = "engine.request"      # one engine HTTP unary call
SPAN_GAP = "gap"                            # synthesized by the merge:
#                             a remote segment that never arrived (dead
#                             daemon, torn tail) -- explicit, not broken

# Every span name that may appear in a flight recorder, scheduler-local
# names included (telemetry/spans.py defines those as constants; they
# are mirrored here as plain strings so the catalogue -- like
# SEAM_NAMES -- is one AST-parseable tuple of literals the analyzer
# reads without importing anything).
SPAN_CATALOGUE = (
    "iteration",
    "create",
    "start",
    "wait",
    "exit",
    "orphan",
    "migrate",
    "resume",
    "sentinel.tick",
    "router.submit",
    "loopd.submit",
    "workerd.create",
    "workerd.start",
    "workerd.wait",
    "engine.request",
    "gap",
)
