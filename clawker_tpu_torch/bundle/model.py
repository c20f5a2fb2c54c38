"""Bundle component models and directory loading.

A component is a directory with a manifest (``harness.yaml`` /
``stack.yaml`` / ``monitoring.yaml``) plus optional support files.  The
manifest schema is deliberately small; Dockerfile rendering lives in
the reference's ``bundler`` (the component only *declares* what it needs).
Parity reference: internal/bundle/assets harness.yaml + stack bundles
(SURVEY.md 2.6).

The port's copy of ``clawker_tpu/bundle/model.py``, whole.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from pathlib import Path

import yaml

from ..config.schema import EgressRule, from_dict
from ..errors import ConfigError


@dataclass
class Harness:
    """An agent harness: what to install and how to run the agent."""

    name: str = ""
    description: str = ""
    version: str = ""
    packages: list[str] = field(default_factory=list)   # OS packages it needs
    install: list[str] = field(default_factory=list)    # RUN lines (shell)
    cmd: list[str] = field(default_factory=list)        # container CMD
    env: dict[str, str] = field(default_factory=dict)
    egress: list[EgressRule] = field(default_factory=list)  # required domains
    files: list[str] = field(default_factory=list)      # extra files copied into image
    # create-time host->container config staging directives, interpreted
    # by containerfs (raw tree; schema lives there)
    staging: dict = field(default_factory=dict)
    source_dir: Path | None = None                      # where files resolve from
    tier: str = ""                                      # floor | installed | loose

    def validate(self) -> list[str]:
        errs = []
        if not self.name:
            errs.append("harness: missing name")
        if not self.cmd:
            errs.append(f"harness {self.name}: missing cmd")
        for f in self.files:
            if self.source_dir and not (self.source_dir / f).exists():
                errs.append(f"harness {self.name}: missing file {f}")
        return errs


@dataclass
class Stack:
    """A language stack: the base image layer of a project image."""

    name: str = ""
    description: str = ""
    base_image: str = ""
    packages: list[str] = field(default_factory=list)
    install: list[str] = field(default_factory=list)    # RUN lines after packages
    env: dict[str, str] = field(default_factory=dict)
    source_dir: Path | None = None
    tier: str = ""

    def validate(self) -> list[str]:
        errs = []
        if not self.name:
            errs.append("stack: missing name")
        if not self.base_image:
            errs.append(f"stack {self.name}: missing base_image")
        return errs


@dataclass
class MonitoringUnit:
    """Per-harness observability overlay: index templates, pipelines,
    saved objects seeded into the monitor stack (reference:
    internal/monitor/unit.go:48)."""

    name: str = ""
    description: str = ""
    indices: list[str] = field(default_factory=list)
    files: list[str] = field(default_factory=list)
    source_dir: Path | None = None
    tier: str = ""

    def validate(self) -> list[str]:
        return [] if self.name else ["monitoring unit: missing name"]


MANIFESTS = {
    "harness": ("harness.yaml", Harness),
    "stack": ("stack.yaml", Stack),
    "monitoring": ("monitoring.yaml", MonitoringUnit),
}


# mtime-keyed parse cache: component resolution runs on every container
# create (harness staging), and re-parsing an unchanged manifest costs
# more than the rest of the create path combined
_manifest_cache: dict[tuple[str, int, int], dict] = {}


def _load_manifest(mf: Path) -> dict:
    try:
        st = mf.stat()
        key = (str(mf), st.st_mtime_ns, st.st_size)
    except OSError as e:
        raise ConfigError(f"{mf}: unreadable: {e}") from e
    cached = _manifest_cache.get(key)
    if cached is None:
        try:
            cached = yaml.safe_load(mf.read_text()) or {}
        except OSError as e:
            raise ConfigError(f"{mf}: unreadable: {e}") from e
        except yaml.YAMLError as e:
            raise ConfigError(f"{mf}: invalid yaml: {e}") from e
        if len(_manifest_cache) > 256:
            _manifest_cache.clear()
        _manifest_cache[key] = cached
    # deep copy: from_dict/__post_init__ may normalize nested values in
    # place, and the cache must stay pristine
    return copy.deepcopy(cached)


def load_component_dir(kind: str, path: Path, *, tier: str = "loose"):
    """Load one component of ``kind`` from a directory."""
    manifest_name, cls = MANIFESTS[kind]
    mf = path / manifest_name
    if not mf.is_file():
        raise ConfigError(f"{path}: no {manifest_name}")
    raw = _load_manifest(mf)
    comp = from_dict(cls, raw)
    comp.source_dir = path
    comp.tier = tier
    if not comp.name:
        comp.name = path.name
    return comp
