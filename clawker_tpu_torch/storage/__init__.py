"""Layered YAML storage engine.

The port's copy of ``clawker_tpu/storage/__init__.py``, whole.

Parity reference: internal/storage (SURVEY.md 2.5) -- generic Store[T] with
static + walk-up discovery, N-way merge with per-field strategies
(union/overwrite), provenance-routed writes, atomic temp+rename, flock, and
per-layer migrations.
"""

from .store import Layer, Store, MergeStrategy
from .merge import merge_trees, Provenance
from .discovery import discover_project_layers, ProjectDiscovery

__all__ = [
    "Layer",
    "Store",
    "MergeStrategy",
    "merge_trees",
    "Provenance",
    "discover_project_layers",
    "ProjectDiscovery",
]
