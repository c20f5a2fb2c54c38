"""Bind vs snapshot workspace strategies.

The port's copy of ``clawker_tpu/workspace/strategy.py``, whole.

Snapshot seeding is content-addressed (docs/loop-worktrees.md#seed-cache):
:func:`_tar_tree` produces a *deterministic* tar -- normalized mtime/uid/
gid/mode, stable walk order -- so one project tree always digests to the
same sha256 (:func:`seed_digest`).  That stable digest is the ABI the
whole fan-out path keys on: the host-side TTL cache
(:func:`~clawker_tpu.runtime.orchestrate.workspace_seed_tar`) builds the
tar once per fan-out, the workerd seed store holds it once per *worker*,
and a 32-agent swarm on one repo pays one tree walk and one WAN transfer
per worker instead of 32 of each.
"""

from __future__ import annotations

import hashlib
import io
import os
import tarfile
from dataclasses import dataclass, field
from pathlib import Path

from .. import consts, telemetry
from ..engine.api import Engine
from ..runtime.labels import volume_labels
from ..runtime.names import agent_volume_name
from ..util import phases

_SEED_BYTES = telemetry.counter(
    "workspace_seed_bytes_total",
    "Workspace snapshot bytes shipped into agent containers",
    labels=("worker",))
_SEED_CACHE_HITS = telemetry.counter(
    "workspace_seed_cache_hits_total",
    "Workspace seeds served from the content-addressed tar cache")
_SEED_CACHE_MISSES = telemetry.counter(
    "workspace_seed_cache_misses_total",
    "Workspace seeds that paid the tree walk + tar build")


@dataclass
class WorkspaceMounts:
    """Result of mount setup: bind strings + volumes that were ensured."""

    binds: list[str] = field(default_factory=list)
    volumes: list[str] = field(default_factory=list)
    post_create: list["SnapshotSeed"] = field(default_factory=list)

    def seed(self, engine: Engine, container_id: str, *,
             tar: bytes | None = None, worker: str = "") -> None:
        """Run post-create seeding steps (snapshot copies).

        ``tar`` short-circuits the tree walk with pre-resolved seed
        bytes -- the workerd path hands the worker-local seed store's
        copy down here so the put_archive fans out from the worker's
        own engine socket with zero further WAN bytes."""
        for s in self.post_create:
            s.run(engine, container_id, tar=tar, worker=worker)


@dataclass
class SnapshotSeed:
    """Copy a host tree into the container's workspace volume after create.

    On a tpu_vm worker there is no shared filesystem with the laptop, so
    snapshot seeding travels through put_archive (the same channel bootstrap
    material uses) rather than host bind mounts -- this is what makes
    snapshot mode the default for remote workers.

    The seed bytes come from the content-addressed TTL cache
    (``runtime.orchestrate.workspace_seed_tar``): one fan-out builds the
    tar once and every subsequent create reuses it, instead of the
    historical walk-and-buffer-the-whole-tree per call.
    """

    src: Path
    dst: str = consts.WORKSPACE_DIR

    def run(self, engine: Engine, container_id: str, *,
            tar: bytes | None = None, worker: str = "") -> None:
        with phases.phase("workspace.seed"):
            if tar is None:
                from ..runtime.orchestrate import workspace_seed_tar

                _digest, tar = workspace_seed_tar(self.src)
            # analyze: allow(wal-before-mutation): seeding is an
            # idempotent content transfer into a container whose create
            # was already journaled write-ahead (REC_CREATED /
            # REC_SEED_TAR scheduler-side; workerd intents carry the
            # scheduler's WAL across the process boundary) -- this layer
            # has no journal handle by design (docs/loop-worktrees.md).
            engine.put_archive(container_id, self.dst, tar)
            _SEED_BYTES.labels(worker or "local").inc(len(tar))


def seed_digest(tar: bytes) -> str:
    """Content digest of a deterministic seed tar (the cache/store key).

    Stable across machines and rebuilds because :func:`_tar_tree`
    normalizes every non-content tar field -- two trees with identical
    bytes-on-disk always share one digest, which is what lets N git
    worktrees forked from one base collapse to a single cached seed."""
    return hashlib.sha256(tar).hexdigest()


def _norm_tarinfo(ti: tarfile.TarInfo) -> tarfile.TarInfo:
    """Normalize the non-content tar fields so the archive bytes are a
    pure function of the tree's contents: mtime/uid/gid/owner names
    zeroed, mode collapsed to 0o755 (dirs + executables) / 0o644
    (everything else).  Without this, each rebuild (or each worktree of
    the same base) digests differently and the content-addressed cache
    never hits."""
    ti.mtime = 0
    ti.uid = 0
    ti.gid = 0
    ti.uname = ""
    ti.gname = ""
    if ti.isdir() or (ti.mode & 0o100):
        ti.mode = 0o755
    else:
        ti.mode = 0o644
    return ti


def _tar_tree(src: Path) -> bytes:
    """Deterministically tar the project tree, never descending into
    .git, symlinked dirs or foreign mounts.  A mount point inside the
    project (say a runtime's overlay that mirrors the whole host) would
    otherwise turn the seed walk into a filesystem-wide -- or cyclic --
    traversal.  Entries are added in sorted order with normalized
    metadata (:func:`_norm_tarinfo`) so the output digests stably."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        def walk(d: Path, rel: str) -> None:
            for p in sorted(d.iterdir()):
                arc = f"{rel}/{p.name}" if rel else p.name
                if p.name == ".git" and p.is_dir():
                    continue
                if p.is_dir() and not p.is_symlink():
                    if os.path.ismount(p):
                        continue
                    tf.add(p, arcname=arc, recursive=False,
                           filter=_norm_tarinfo)
                    walk(p, arc)
                else:
                    tf.add(p, arcname=arc, recursive=False,
                           filter=_norm_tarinfo)

        walk(src, "")
    return buf.getvalue()


class BindStrategy:
    """Live bind-mount of the project root (local driver only)."""

    name = "bind"

    def mounts(
        self, engine: Engine, project: str, agent: str, project_root: Path
    ) -> WorkspaceMounts:
        m = WorkspaceMounts()
        m.binds.append(f"{project_root}:{consts.WORKSPACE_DIR}")
        return m


class SnapshotStrategy:
    """Ephemeral copy-on-create workspace in a named volume."""

    name = "snapshot"

    def mounts(
        self, engine: Engine, project: str, agent: str, project_root: Path
    ) -> WorkspaceMounts:
        m = WorkspaceMounts()
        vol = agent_volume_name(project, agent, "workspace")
        engine.ensure_volume(vol, labels=volume_labels(project, agent, "workspace"))
        m.volumes.append(vol)
        m.binds.append(f"{vol}:{consts.WORKSPACE_DIR}")
        if project_root.exists():
            m.post_create.append(SnapshotSeed(src=project_root))
        return m


def setup_mounts(
    engine: Engine,
    project: str,
    agent: str,
    project_root: Path,
    *,
    mode: str = "bind",
    extra_mounts: list[str] | None = None,
    worktree_git_dir: Path | None = None,
) -> WorkspaceMounts:
    """Full mount assembly (reference: workspace.SetupMounts setup.go:106).

    Adds the workspace (strategy-dependent), per-agent config + history
    volumes, optional extra mounts, and -- for linked git worktrees -- the
    main repo's git dir.  In bind mode the git dir mounts read-only so the
    worktree's ``.git`` file resolves inside the container (reference:
    setup.go:288); in snapshot mode the worktree's *content* travels via
    the content-addressed seed instead (the container sees a plain tree,
    branch identity stays host-side; docs/loop-worktrees.md).
    """
    strategy = BindStrategy() if mode == "bind" else SnapshotStrategy()
    m = strategy.mounts(engine, project, agent, project_root)
    for purpose in ("config", "history"):
        vol = agent_volume_name(project, agent, purpose)
        engine.ensure_volume(vol, labels=volume_labels(project, agent, purpose))
        m.volumes.append(vol)
    m.binds.append(f"{agent_volume_name(project, agent, 'config')}:/home/agent/.config")
    m.binds.append(f"{agent_volume_name(project, agent, 'history')}:/home/agent/.history")
    if worktree_git_dir is not None:
        if mode == "bind":
            m.binds.append(f"{worktree_git_dir}:{worktree_git_dir}:ro")
        # snapshot worktrees: no git-dir bind -- the seed is the content
    for em in extra_mounts or []:
        m.binds.append(em)
    return m
