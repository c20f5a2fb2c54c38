"""N-way tree merge with per-path strategies and provenance tracking.

The port's copy of ``clawker_tpu/storage/merge.py``, whole.

Semantics (parity reference: internal/storage merge engine with
``merge:"union"|"overwrite"`` struct tags, SURVEY.md 2.5):

* Layers are ordered lowest priority first; later layers override earlier.
* Mappings merge recursively, key by key.
* Scalars: highest-priority layer that defines the key wins.
* Lists: strategy ``overwrite`` (default) -- highest layer's list replaces;
  strategy ``union`` -- concatenation lowest-to-highest with stable
  de-duplication (first occurrence kept).
* ``None`` in a higher layer is an explicit override to null (it wins), but a
  layer simply not defining a key does not mask lower layers.
* Provenance records, for every leaf path, which layer index supplied the
  effective value (for union lists: every contributing layer).
"""

from __future__ import annotations

from typing import Any, Mapping

PathKey = tuple[str, ...]
Provenance = dict[PathKey, tuple[int, ...]]

OVERWRITE = "overwrite"
UNION = "union"


def _strategy_for(path: PathKey, strategies: Mapping[PathKey, str]) -> str:
    if path in strategies:
        return strategies[path]
    # Allow glob-ish addressing one level deep: ("security", "egress", "*")
    for cand, strat in strategies.items():
        if len(cand) == len(path) and all(a == "*" or a == b for a, b in zip(cand, path)):
            return strat
    return OVERWRITE


def _canon(item: Any) -> str:
    """Order-insensitive canonical key for union dedupe (two YAML mappings
    with the same keys in different order are the same rule)."""
    import json

    try:
        return json.dumps(item, sort_keys=True, default=repr)
    except (TypeError, ValueError):
        return repr(item)


def _dedupe(items: list[Any]) -> list[Any]:
    seen: set[str] = set()
    out: list[Any] = []
    for it in items:
        key = _canon(it)
        if key not in seen:
            seen.add(key)
            out.append(it)
    return out


def merge_trees(
    trees: list[Any],
    strategies: Mapping[PathKey, str] | None = None,
) -> tuple[Any, Provenance]:
    """Merge raw YAML trees (dict/list/scalar) lowest-priority-first.

    Returns ``(merged, provenance)``.  Layer indexes in provenance refer to
    positions in ``trees``.
    """
    strategies = strategies or {}
    prov: Provenance = {}
    merged = _merge_at((), [(i, t) for i, t in enumerate(trees) if t is not None], strategies, prov)
    return merged, prov


def _merge_at(
    path: PathKey,
    entries: list[tuple[int, Any]],
    strategies: Mapping[PathKey, str],
    prov: Provenance,
) -> Any:
    if not entries:
        return None
    # If every present value is a mapping, merge recursively.
    if all(isinstance(v, Mapping) for _, v in entries):
        keys: list[str] = []
        for _, tree in entries:
            for k in tree:
                if k not in keys:
                    keys.append(k)
        out: dict[str, Any] = {}
        for k in keys:
            sub = [(i, v[k]) for i, v in entries if k in v]
            out[k] = _merge_at(path + (str(k),), sub, strategies, prov)
        return out
    # Lists under a union strategy combine across layers.
    if all(isinstance(v, list) for _, v in entries) and _strategy_for(path, strategies) == UNION:
        combined: list[Any] = []
        contributors: list[int] = []
        for i, v in entries:
            if v:
                contributors.append(i)
            combined.extend(v)
        prov[path] = tuple(contributors) or (entries[-1][0],)
        return _dedupe(combined)
    # Otherwise the highest-priority entry wins outright (scalar, list
    # overwrite, or mixed types where the override changes shape).
    winner_idx, winner = entries[-1]
    prov[path] = (winner_idx,)
    return winner


def get_path(tree: Any, path: PathKey) -> Any:
    cur = tree
    for p in path:
        if not isinstance(cur, Mapping) or p not in cur:
            raise KeyError(".".join(path))
        cur = cur[p]
    return cur


def set_path(tree: dict, path: PathKey, value: Any) -> None:
    cur = tree
    for p in path[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[path[-1]] = value


def delete_path(tree: dict, path: PathKey) -> bool:
    cur = tree
    for p in path[:-1]:
        if not isinstance(cur, Mapping) or p not in cur:
            return False
        cur = cur[p]
    if isinstance(cur, dict) and path[-1] in cur:
        del cur[path[-1]]
        return True
    return False
