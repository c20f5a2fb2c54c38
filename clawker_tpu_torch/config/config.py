"""Config facade: layered stores for project + settings, path accessors,
egress-rule composition.

The port's copy of ``clawker_tpu/config/config.py``, whole.

Parity reference: internal/config Config interface over Store[Project] +
Store[Settings] with ~40 path accessors and EgressRules() merging required
internal rules with project rules (SURVEY.md 2.5).
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from pathlib import Path

from .. import consts
from ..util import text, xdg
from ..storage import Layer, Store, discover_project_layers
from .schema import EgressRule, ProjectConfig, Settings, from_dict


def settings_store(config_dir: Path | None = None) -> Store[Settings]:
    base = config_dir or xdg.config_dir()
    layers = [Layer("settings", base / consts.SETTINGS_FILE)]
    return Store(
        layers,
        schema_factory=functools.partial(from_dict, Settings),
        strategies=Settings.merge_strategies(),
    )


def project_store(start: Path | str | None = None) -> Store[ProjectConfig] | None:
    disc = discover_project_layers(start or Path.cwd())
    if disc is None:
        return None
    store: Store[ProjectConfig] = Store(
        disc.layers,
        schema_factory=functools.partial(from_dict, ProjectConfig),
        strategies=ProjectConfig.merge_strategies(),
    )
    store.project_root = disc.root  # type: ignore[attr-defined]
    return store


@dataclass
class Config:
    """Resolved configuration for one CLI invocation."""

    settings: Settings
    project: ProjectConfig | None
    project_root: Path | None
    settings_store_ref: Store[Settings]
    project_store_ref: Store[ProjectConfig] | None

    # ------------------------------------------------------------ paths

    @property
    def data_dir(self) -> Path:
        return xdg.data_dir()

    @property
    def state_dir(self) -> Path:
        return xdg.state_dir()

    @property
    def cache_dir(self) -> Path:
        return xdg.cache_dir()

    @property
    def registry_path(self) -> Path:
        return self.data_dir / consts.REGISTRY_FILE

    @property
    def worktrees_dir(self) -> Path:
        return self.data_dir / "worktrees"

    @property
    def bundles_dir(self) -> Path:
        return self.data_dir / "bundles"

    @property
    def pki_dir(self) -> Path:
        return self.data_dir / "pki"

    @property
    def egress_rules_path(self) -> Path:
        return self.data_dir / consts.EGRESS_RULES_FILE

    @property
    def ssh_mux_dir(self) -> Path:
        return self.state_dir / consts.TPU_SSH_MUX_DIR

    @property
    def logs_dir(self) -> Path:
        return self.state_dir / "logs"

    # ------------------------------------------------------------ domain

    def project_name(self) -> str:
        if self.project and self.project.project:
            return text.validate_name("project", self.project.project)
        if self.project_root is not None:
            # sanitize the directory name into the container-name charset
            raw = self.project_root.name.lower()
            name = re.sub(r"[^a-z0-9_-]+", "-", raw).strip("-_") or "project"
            return text.validate_name("project", name)
        raise LookupError("no project configured here (run `clawker init`)")

    def egress_rules(self) -> list[EgressRule]:
        """Required internal rules + project rules, deduped by rule key.

        Reference: internal/config EgressRules() (SURVEY.md 2.5) -- the
        harness always needs its API endpoints even when the project allows
        nothing else.
        """
        rules: dict[str, EgressRule] = {}
        for dom in consts.REQUIRED_EGRESS_DOMAINS:
            r = EgressRule(dst=dom, proto="https")
            rules[r.key()] = r
        if self.project:
            for r in self.project.security.egress:
                rules.setdefault(r.key(), r)
        return list(rules.values())


def load_config(start: Path | str | None = None) -> Config:
    sstore = settings_store()
    pstore = project_store(start)
    return Config(
        settings=sstore.typed(),
        project=pstore.typed() if pstore else None,
        project_root=getattr(pstore, "project_root", None) if pstore else None,
        settings_store_ref=sstore,
        project_store_ref=pstore,
    )
