"""Random ids.

A copy of ``short_id`` from ``clawker_tpu/util/ids.py``.
"""

from __future__ import annotations

import secrets


def short_id(n: int = 12) -> str:
    """Random hex id (container-id style)."""
    return secrets.token_hex((n + 1) // 2)[:n]
