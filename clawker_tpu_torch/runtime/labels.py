"""Label builders (reference: internal/docker/labels.go dev.clawker.*).

The port's copy of ``clawker_tpu/runtime/labels.py``, whole.
"""

from __future__ import annotations

from .. import consts


def agent_labels(
    project: str,
    agent: str,
    *,
    harness: str = "",
    worker: str = "",
    loop_id: str = "",
) -> dict[str, str]:
    labels = {
        consts.LABEL_PROJECT: project,
        consts.LABEL_AGENT: agent,
        consts.LABEL_ROLE: "agent",
    }
    if harness:
        labels[consts.LABEL_HARNESS] = harness
    if worker:
        labels[consts.LABEL_WORKER] = worker
    if loop_id:
        labels[consts.LABEL_LOOP] = loop_id
    return labels


def infra_labels(role: str, *, content_sha: str = "") -> dict[str, str]:
    labels = {consts.LABEL_ROLE: role}
    if content_sha:
        labels[consts.LABEL_CONTENT_SHA] = content_sha
    return labels


def volume_labels(project: str, agent: str, purpose: str) -> dict[str, str]:
    return {
        consts.LABEL_PROJECT: project,
        consts.LABEL_AGENT: agent,
        consts.LABEL_VOLUME_PURPOSE: purpose,
    }
