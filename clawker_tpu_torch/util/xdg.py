"""XDG state-directory resolution with the CLAWKER_TPU_STATE_DIR override.

A copy of ``state_dir`` from ``clawker_tpu/util/xdg.py`` (with its
constants), so the port's CLI finds the same default egress stream
(``<state>/logs/ebpf-egress.jsonl``) as the reference CLI.
"""

from __future__ import annotations

import os
from pathlib import Path

PRODUCT = "clawker-tpu"
ENV_STATE_DIR = "CLAWKER_TPU_STATE_DIR"


def _base(env_override: str, xdg_var: str, fallback: str) -> Path:
    if v := os.environ.get(env_override):
        return Path(v)
    if v := os.environ.get(xdg_var):
        return Path(v) / PRODUCT
    return Path.home() / fallback / PRODUCT


def state_dir() -> Path:
    return _base(ENV_STATE_DIR, "XDG_STATE_HOME", ".local/state")


def logs_dir() -> Path:
    return state_dir() / "logs"
