"""Project config discovery: bounded walk-up, dir-form vs flat-form.

The port's copy of ``clawker_tpu/storage/discovery.py``, whole.

Parity reference: internal/storage discovery (SURVEY.md 2.5) -- static XDG
plus bounded walk-up finding either the dir form ``.clawker/clawker.yaml``
(with ``clawker.local.yaml`` overlay) or the flat form ``.clawker.yaml``
(with ``.clawker.local.yaml`` overlay).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .. import consts
from .store import Layer


@dataclass
class ProjectDiscovery:
    """Result of walking up from a directory looking for project config."""

    root: Path                       # directory containing the config
    form: str                        # "dir" | "flat"
    layers: list[Layer] = field(default_factory=list)  # lowest priority first

    @property
    def config_path(self) -> Path:
        return self.layers[0].path


def _dir_form(root: Path) -> ProjectDiscovery | None:
    d = root / consts.PROJECT_DIR_FORM
    main = d / "clawker.yaml"
    if d.is_dir() and main.exists():
        local = d / "clawker.local.yaml"
        layers = [Layer("project", main)]
        layers.append(Layer("project-local", local))
        return ProjectDiscovery(root=root, form="dir", layers=layers)
    return None


def _flat_form(root: Path) -> ProjectDiscovery | None:
    main = root / consts.PROJECT_FLAT_FORM
    if main.exists():
        local = root / ".clawker.local.yaml"
        layers = [Layer("project", main), Layer("project-local", local)]
        return ProjectDiscovery(root=root, form="flat", layers=layers)
    return None


def discover_project_layers(start: Path | str, limit: int = consts.WALKUP_LIMIT) -> ProjectDiscovery | None:
    """Walk up from ``start`` (at most ``limit`` levels) to find project config.

    Dir form wins over flat form within one directory.  Returns None when no
    config is found before the filesystem root or the limit.
    """
    cur = Path(start).resolve()
    for _ in range(limit):
        found = _dir_form(cur) or _flat_form(cur)
        if found:
            return found
        if cur.parent == cur:
            return None
        cur = cur.parent
    return None
