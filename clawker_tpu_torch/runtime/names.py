"""Deterministic object naming.

The port's copy of ``clawker_tpu/runtime/names.py``, whole.

Parity reference: internal/docker/names.go -- containers are
``clawker.<project>.<agent>``; volumes carry a purpose suffix; images are
``clawker-<project>:<tag>``.
"""

from __future__ import annotations

from .. import consts
from ..util.text import validate_name

VOLUME_PURPOSES = ("workspace", "config", "history")


def container_name(project: str, agent: str) -> str:
    validate_name("project", project)
    validate_name("agent", agent)
    return consts.CONTAINER_NAME_SEP.join((consts.CONTAINER_NAME_PREFIX, project, agent))


def parse_container_name(name: str) -> tuple[str, str] | None:
    """-> (project, agent) or None if not one of ours."""
    parts = name.lstrip("/").split(consts.CONTAINER_NAME_SEP)
    if len(parts) != 3 or parts[0] != consts.CONTAINER_NAME_PREFIX:
        return None
    return parts[1], parts[2]


def agent_volume_name(project: str, agent: str, purpose: str) -> str:
    if purpose not in VOLUME_PURPOSES:
        raise ValueError(f"unknown volume purpose {purpose!r}")
    return f"{container_name(project, agent)}.{purpose}"


def image_ref(project: str, tag: str = consts.IMAGE_TAG_DEFAULT) -> str:
    validate_name("project", project)
    return f"{consts.IMAGE_NAME_PREFIX}{project}:{tag}"
