"""XDG base-directory resolution with CLAWKER_TPU_*_DIR overrides.

The port's copy of ``clawker_tpu/util/xdg.py``, whole, plus
``logs_dir``: the port's CLI finds the same default egress stream
(``<state>/logs/ebpf-egress.jsonl``) as the reference CLI.

Parity reference: internal/config path accessors + internal/storage
ValidateDirectories XDG collision check (internal/clawker/cmd.go:31 Main).
"""

from __future__ import annotations

import os
from pathlib import Path

from .. import consts


def _base(env_override: str, xdg_var: str, fallback: str) -> Path:
    if v := os.environ.get(env_override):
        return Path(v)
    if v := os.environ.get(xdg_var):
        return Path(v) / consts.PRODUCT
    return Path.home() / fallback / consts.PRODUCT


def config_dir() -> Path:
    return _base(consts.ENV_CONFIG_DIR, "XDG_CONFIG_HOME", ".config")


def data_dir() -> Path:
    return _base(consts.ENV_DATA_DIR, "XDG_DATA_HOME", ".local/share")


def state_dir() -> Path:
    return _base(consts.ENV_STATE_DIR, "XDG_STATE_HOME", ".local/state")


def cache_dir() -> Path:
    return _base(consts.ENV_CACHE_DIR, "XDG_CACHE_HOME", ".cache")


def logs_dir() -> Path:
    return state_dir() / "logs"


def validate_directories() -> list[str]:
    """Detect distinct logical dirs resolving to the same physical path.

    Returns human-readable collision warnings (reference: storage
    ValidateDirectories called at CLI start, internal/clawker/cmd.go).
    """
    dirs = {
        "config": config_dir(),
        "data": data_dir(),
        "state": state_dir(),
        "cache": cache_dir(),
    }
    seen: dict[Path, str] = {}
    problems: list[str] = []
    for name, p in dirs.items():
        rp = p.resolve() if p.exists() else p
        if rp in seen:
            problems.append(f"{name} dir and {seen[rp]} dir both resolve to {rp}")
        else:
            seen[rp] = name
    return problems
