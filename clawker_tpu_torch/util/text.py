"""Text helpers: name validation, truncation, table-ish formatting.

The port's copy of ``clawker_tpu/util/text.py``, whole.

Parity reference: internal/text (SURVEY.md 2, foundation layer).
"""

from __future__ import annotations

import re

# Project and agent names share Docker-compatible constraints: they embed into
# container names `clawker.<project>.<agent>` and image names
# `clawker-<project>:<tag>` (reference: internal/docker/names.go).
_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{0,62}$")


def valid_name(name: str) -> bool:
    return bool(_NAME_RE.match(name))


def validate_name(kind: str, name: str) -> str:
    if not valid_name(name):
        raise ValueError(
            f"invalid {kind} name {name!r}: must match [a-z0-9][a-z0-9_-]*, max 63 chars"
        )
    return name


def truncate(s: str, n: int) -> str:
    return s if len(s) <= n else s[: max(0, n - 1)] + "…"


def humanize_bytes(n: int) -> str:
    f = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if f < 1024 or unit == "TiB":
            return f"{f:.1f}{unit}" if unit != "B" else f"{int(f)}B"
        f /= 1024
    return f"{n}B"


def humanize_duration(seconds: float) -> str:
    s = int(seconds)
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m{s % 60}s"
    return f"{s // 3600}h{(s % 3600) // 60}m"
