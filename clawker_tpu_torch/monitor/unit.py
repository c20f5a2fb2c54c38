"""Monitoring units: pluggable per-harness observability overlays.

The port's copy of ``clawker_tpu/monitor/unit.py``, whole.

A unit is a directory with a ``monitoring.yaml`` manifest plus artifact
subdirectories mirroring the opensearch-bootstrap tree, so materializing
a unit is a plain overlay copy and the bootstrap script's directory
loops apply unit artifacts unmodified.

Every validation failure is a named error at this front door -- never a
silent bootstrap-time skip.

Parity reference: internal/monitor/unit.go:48 (MonitoringUnit, lane/
metric/tree validation, index-name grammar) -- semantics re-derived.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from dataclasses import dataclass, field
from pathlib import Path

import yaml

from ..errors import ClawkerError
from .corpus import RETENTIONS

MANIFEST_FILE = "monitoring.yaml"

# Artifact subdirectories a unit may ship (the opensearch-bootstrap tree).
ARTIFACT_DIRS = (
    "index-templates",
    "ingest-pipelines",
    "component-templates",
    "ism-policies",
    "saved-objects",
)

# Index-name grammar a unit lane may declare: lowercase letters, digits,
# internal hyphens.  Deliberately a subset of what OpenSearch accepts --
# the quote/backslash-free charset makes injection into bootstrap curl
# commands unspellable by construction.  Service names share the rule.
_INDEX_RE = re.compile(r"^[a-z0-9][a-z0-9-]{0,62}$")
_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9-]{0,62}$")

# Base lanes are cluster infrastructure: a unit may not claim them.
# "default" and "traces" are reserved too: lane exporters are named
# opensearch/{index} in the collector config, and those two names are
# the fixed default-logs and spans exporters (monitor/stack.py) -- a
# lane by either name would silently clobber them.
RESERVED_INDICES = frozenset({
    "clawker-otlp", "clawker-cli", "clawkercp", "clawker-envoy",
    "clawker-dnsgate", "clawker-ebpf-egress", "default", "traces",
})


class UnitError(ClawkerError):
    pass


@dataclass
class LogLane:
    """One log lane: an index the unit owns + the OTLP service.name
    values routed into it."""

    index: str = ""
    service_names: list[str] = field(default_factory=list)
    retention: str = "default"


@dataclass
class UnitManifest:
    name: str = ""
    description: str = ""
    logs: list[LogLane] = field(default_factory=list)


@dataclass
class MonitoringUnit:
    name: str
    root: Path
    manifest: UnitManifest

    def artifact_files(self) -> list[Path]:
        out: list[Path] = []
        for sub in ARTIFACT_DIRS:
            d = self.root / sub
            if d.is_dir():
                out.extend(sorted(p for p in d.rglob("*") if p.is_file()))
        return out

    def content_hash(self) -> str:
        """Stable hash over manifest + every artifact byte (ledger
        identity: same hash == same content, regardless of source)."""
        h = hashlib.sha256()
        h.update((self.root / MANIFEST_FILE).read_bytes())
        for p in self.artifact_files():
            h.update(str(p.relative_to(self.root)).encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:16]


def load_unit(name: str, root: Path) -> MonitoringUnit:
    """Load + validate a unit directory.  Fails loud on: bad names, bad
    index/service grammar, reserved indices, unknown artifact dirs,
    unparseable JSON artifacts."""
    root = Path(root)
    if not _NAME_RE.fullmatch(name):
        raise UnitError(f"monitoring unit name {name!r} is not a valid key")
    mpath = root / MANIFEST_FILE
    if not mpath.is_file():
        raise UnitError(f"monitoring unit {name!r}: no {MANIFEST_FILE} in {root}")
    try:
        raw = yaml.safe_load(mpath.read_text()) or {}
    except yaml.YAMLError as e:
        raise UnitError(f"monitoring unit {name!r}: parse {MANIFEST_FILE}: {e}")
    lanes_raw = raw.get("logs") or []
    for l in lanes_raw:
        if not isinstance(l, dict):
            raise UnitError(
                f"monitoring unit {name!r}: each logs entry must be a "
                f"mapping with index/service_names, got {l!r}")
    manifest = UnitManifest(
        name=str(raw.get("name") or name),
        description=str(raw.get("description") or ""),
        logs=[LogLane(index=str(l.get("index") or ""),
                      service_names=[str(s) for s in l.get("service_names") or []],
                      retention=str(l.get("retention") or "default"))
              for l in lanes_raw],
    )
    if manifest.name != name:
        raise UnitError(
            f"monitoring unit {name!r}: manifest names itself "
            f"{manifest.name!r} (registry key and manifest must agree)")
    _validate_lanes(name, manifest.logs)
    _validate_tree(name, root)
    return MonitoringUnit(name=name, root=root, manifest=manifest)


def _validate_lanes(name: str, lanes: list[LogLane]) -> None:
    if not lanes:
        raise UnitError(
            f"monitoring unit {name!r}: logs must declare at least one lane")
    seen_index: set[str] = set()
    seen_service: set[str] = set()
    for lane in lanes:
        if not _INDEX_RE.fullmatch(lane.index):
            raise UnitError(
                f"monitoring unit {name!r}: index {lane.index!r} is not a "
                "valid OpenSearch index name (lowercase/digits/hyphens)")
        if lane.index in RESERVED_INDICES:
            raise UnitError(
                f"monitoring unit {name!r}: index {lane.index!r} is a "
                "reserved clawker lane")
        if lane.index in seen_index:
            raise UnitError(
                f"monitoring unit {name!r}: duplicate index {lane.index!r}")
        seen_index.add(lane.index)
        if not lane.service_names:
            raise UnitError(
                f"monitoring unit {name!r}: lane {lane.index!r} needs at "
                "least one service name")
        for svc in lane.service_names:
            if not _INDEX_RE.fullmatch(svc):
                raise UnitError(
                    f"monitoring unit {name!r}: service name {svc!r} is not "
                    "valid (lowercase/digits/hyphens)")
            if svc in seen_service:
                raise UnitError(
                    f"monitoring unit {name!r}: duplicate service {svc!r}")
            seen_service.add(svc)
        if lane.retention not in RETENTIONS:
            raise UnitError(
                f"monitoring unit {name!r}: unknown retention "
                f"{lane.retention!r} (want one of {sorted(RETENTIONS)})")


def _validate_tree(name: str, root: Path) -> None:
    for entry in root.iterdir():
        if entry.name == MANIFEST_FILE or entry.name.startswith("."):
            continue
        if entry.is_dir():
            if entry.name not in ARTIFACT_DIRS:
                raise UnitError(
                    f"monitoring unit {name!r}: unknown artifact dir "
                    f"{entry.name!r} (want one of {ARTIFACT_DIRS})")
            for p in entry.rglob("*.json"):
                try:
                    json.loads(p.read_text())
                except (OSError, json.JSONDecodeError) as e:
                    raise UnitError(
                        f"monitoring unit {name!r}: bad artifact "
                        f"{p.relative_to(root)}: {e}")
        else:
            raise UnitError(
                f"monitoring unit {name!r}: stray file {entry.name!r} "
                "(artifacts live under the known subdirectories)")


def materialize(unit: MonitoringUnit, bootstrap_root: Path) -> list[Path]:
    """Overlay the unit's artifacts into the bootstrap tree.

    A destination that already exists with DIFFERENT content (base
    corpus, or another unit's artifact) is a named refusal, never a
    silent clobber: a unit shipping ingest-pipelines/envelope-normalize
    .json would otherwise replace the final pipeline shared by every
    lane, cluster-wide."""
    written: list[Path] = []
    for src in unit.artifact_files():
        rel = src.relative_to(unit.root)
        dst = bootstrap_root / rel
        if dst.exists() and dst.read_bytes() != src.read_bytes():
            raise UnitError(
                f"monitoring unit {unit.name!r}: artifact {rel} collides "
                "with an already-materialized file of different content "
                "(base corpus artifacts and other units' files cannot be "
                "overridden)")
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dst)
        written.append(dst)
    return written


def discover_units(roots: list[Path]) -> dict[str, MonitoringUnit]:
    """Load every unit directory under the given roots (embedded floor
    first, then loose extension dirs -- later roots win on name)."""
    out: dict[str, MonitoringUnit] = {}
    for root in roots:
        root = Path(root)
        if not root.is_dir():
            continue
        for entry in sorted(root.iterdir()):
            if entry.is_dir() and (entry / MANIFEST_FILE).is_file():
                out[entry.name] = load_unit(entry.name, entry)
    return out
