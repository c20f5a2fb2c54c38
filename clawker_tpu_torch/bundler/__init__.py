"""Image bundler: two-stage Dockerfile generation + build orchestration.

Parity reference: internal/bundler (SURVEY.md 2.6) -- ``GenerateBase`` /
``GenerateHarness`` render ``clawker-<project>:base`` and
``clawker-<project>:<harness>`` stages; the build context carries the
firewall CA cert and the agentd binary as the *last* COPY so agentd
rebuilds never invalidate earlier layers (cache-tail invariant).

The port's copy of ``clawker_tpu/bundler/__init__.py``, whole.
"""

from .dockerfile import generate_base, generate_harness
from .context import build_context
from .build import ProjectBuilder, BuildResult
from .egress import compose_egress_rules

__all__ = [
    "generate_base",
    "generate_harness",
    "build_context",
    "ProjectBuilder",
    "BuildResult",
    "compose_egress_rules",
]
