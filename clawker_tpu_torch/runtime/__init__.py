"""Runtime middleware: naming, labels, image resolution, container
orchestration -- the glue between CLI verbs and the engine.

The port's copy of ``clawker_tpu/runtime/__init__.py``, whole.

Parity reference: internal/docker middleware (names.go, labels.go, pty.go,
image_resolve.go) + the orchestration in internal/cmd/container/shared
(container_create.go:1473 CreateContainer, container_start.go).
"""

from .names import (
    agent_volume_name,
    container_name,
    image_ref,
    parse_container_name,
)
from .labels import agent_labels, infra_labels
from .resolve import resolve_image
from .orchestrate import AgentRuntime, CreateOptions

__all__ = [
    "AgentRuntime",
    "CreateOptions",
    "agent_labels",
    "agent_volume_name",
    "container_name",
    "image_ref",
    "infra_labels",
    "parse_container_name",
    "resolve_image",
]
