"""Generic layered Store over YAML files.

The port's copy of ``clawker_tpu/storage/store.py``, whole.

Parity reference: internal/storage Store[T] (SURVEY.md 2.5): per-layer
migrations, N-way merge, provenance-routed writes, atomic temp+rename under
flock, lock-free snapshot reads.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Generic, Mapping, Sequence, TypeVar

import yaml

from ..util.fs import atomic_write, file_lock
from .merge import (
    OVERWRITE,
    UNION,
    PathKey,
    Provenance,
    delete_path,
    get_path,
    merge_trees,
    set_path,
)

T = TypeVar("T")

MergeStrategy = str  # OVERWRITE | UNION

# A migration rewrites one layer's raw tree from schema version N to N+1.
Migration = Callable[[dict], dict]


@dataclass
class Layer:
    """One YAML file participating in the merge, lowest priority first."""

    name: str
    path: Path
    writable: bool = True

    def read(self) -> dict | None:
        if not self.path.exists():
            return None
        text = self.path.read_text(encoding="utf-8")
        data = yaml.safe_load(text)
        if data is None:
            return {}
        if not isinstance(data, dict):
            raise ValueError(f"layer {self.name} ({self.path}): top level must be a mapping")
        return data

@dataclass
class _Snapshot:
    merged: Any
    provenance: Provenance
    raw_layers: list[dict | None]


class Store(Generic[T]):
    """Layered YAML store with typed view, provenance, and routed writes.

    ``schema_factory`` converts the merged raw tree into the typed view T
    (usually a dataclass ``from_dict``).  ``strategies`` maps dotted paths to
    merge strategies; everything else defaults to overwrite.
    """

    def __init__(
        self,
        layers: Sequence[Layer],
        *,
        schema_factory: Callable[[dict], T] | None = None,
        strategies: Mapping[str, MergeStrategy] | None = None,
        migrations: Sequence[tuple[int, Migration]] = (),
        version: int = 1,
    ):
        self.layers = list(layers)
        self._schema_factory = schema_factory
        self._strategies: dict[PathKey, str] = {
            tuple(k.split(".")): v for k, v in (strategies or {}).items()
        }
        self._migrations = sorted(migrations)
        self._version = version
        self._lock = threading.Lock()
        self._snap: _Snapshot | None = None

    # ---------------------------------------------------------------- load

    def reload(self) -> None:
        raws: list[dict | None] = []
        for layer in self.layers:
            tree = layer.read()
            if tree is not None:
                tree = self._migrate(tree)
            raws.append(tree)
        merged, prov = merge_trees(
            [t if t is not None else None for t in raws], self._strategies
        )
        if merged is None:
            merged = {}
        if isinstance(merged, dict):
            merged.pop("_v", None)
        self._snap = _Snapshot(merged=merged, provenance=prov, raw_layers=raws)

    def _migrate(self, tree: dict) -> dict:
        v = int(tree.get("_v", 1))
        for target, fn in self._migrations:
            if v < target <= self._version:
                tree = fn(copy.deepcopy(tree))
                tree["_v"] = target
                v = target
        return tree

    def _snapshot(self) -> _Snapshot:
        snap = self._snap
        if snap is None:
            with self._lock:
                if self._snap is None:
                    self.reload()
                snap = self._snap
        assert snap is not None
        return snap

    # ---------------------------------------------------------------- read

    def raw(self) -> dict:
        """Merged raw tree (deep copy; callers may mutate freely)."""
        return copy.deepcopy(self._snapshot().merged)

    def typed(self) -> T:
        if self._schema_factory is None:
            raise TypeError("store has no schema_factory")
        return self._schema_factory(self.raw())

    def get(self, dotted: str, default: Any = None) -> Any:
        try:
            return copy.deepcopy(get_path(self._snapshot().merged, tuple(dotted.split("."))))
        except KeyError:
            return default

    def provenance_of(self, dotted: str) -> list[str]:
        """Names of the layers that supplied the effective value at ``dotted``."""
        snap = self._snapshot()
        key = tuple(dotted.split("."))
        idxs = snap.provenance.get(key, ())
        return [self.layers[i].name for i in idxs]

    # --------------------------------------------------------------- write

    def set(self, dotted: str, value: Any, *, layer: str | None = None) -> None:
        """Provenance-routed write.

        If ``layer`` is not given, the write goes to the layer that currently
        supplies the value (reference: provenance-routed writes,
        SURVEY.md 2.5); if the key is new, it goes to the highest-priority
        writable layer.
        """
        key = tuple(dotted.split("."))
        idx = self._route(key, layer)
        self._mutate_layer(idx, lambda tree: set_path(tree, key, value))

    def unset(self, dotted: str, *, layer: str | None = None) -> bool:
        key = tuple(dotted.split("."))
        try:
            idx = self._route(key, layer)
        except KeyError:
            return False
        changed = {"v": False}

        def fn(tree: dict) -> None:
            changed["v"] = delete_path(tree, key)

        self._mutate_layer(idx, fn)
        return changed["v"]

    def write_layer(self, layer_name: str, tree: dict) -> None:
        """Replace a whole layer's raw tree."""
        idx = self._layer_index(layer_name)
        self._mutate_layer(idx, None, replace=tree)

    def _route(self, key: PathKey, layer: str | None) -> int:
        if layer is not None:
            return self._layer_index(layer)
        snap = self._snapshot()
        idxs = snap.provenance.get(key, ())
        for i in reversed(idxs):
            if self.layers[i].writable:
                return i
        for i in reversed(range(len(self.layers))):
            if self.layers[i].writable:
                return i
        raise PermissionError("no writable layer")

    def _layer_index(self, name: str) -> int:
        for i, l in enumerate(self.layers):
            if l.name == name:
                return i
        raise KeyError(f"no layer named {name!r}")

    def _mutate_layer(
        self,
        idx: int,
        fn: Callable[[dict], Any] | None,
        *,
        replace: dict | None = None,
    ) -> None:
        layer = self.layers[idx]
        with self._lock:
            with file_lock(layer.path):
                original = (layer.path.read_text(encoding="utf-8")
                            if layer.path.exists() else "")
                tree = (yaml.safe_load(original) if original else None) or {}
                if not isinstance(tree, dict):
                    raise ValueError(
                        f"layer {layer.name} ({layer.path}): top level must "
                        "be a mapping")
                tree = self._migrate(tree)
                if replace is not None:
                    tree = copy.deepcopy(replace)
                elif fn is not None:
                    fn(tree)
                if self._version > 1:
                    tree["_v"] = self._version
                # comment-preserving surgical patch first; a change the
                # editor cannot express (or that fails its re-parse
                # verification) falls back to a full re-dump
                from .yamledit import apply_edits

                text = apply_edits(original, tree) if original else None
                if text is None:
                    text = yaml.safe_dump(tree, sort_keys=False,
                                          default_flow_style=False)
                elif text and not text.endswith("\n"):
                    text += "\n"
                atomic_write(layer.path, text)
            self._snap = None  # invalidate snapshot; next read re-merges


__all__ = ["Layer", "Store", "MergeStrategy", "OVERWRITE", "UNION"]
