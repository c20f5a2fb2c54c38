"""Workspace mounting strategies.

The port's copy of ``clawker_tpu/workspace/__init__.py``, whole.

Parity reference: internal/workspace (SURVEY.md 2.10) -- Strategy interface
(strategy.go:17) with BindStrategy (live bind-mount) vs SnapshotStrategy
(volume copy = ephemeral); SetupMounts (setup.go:106) adds config/history
volumes and optional docker-socket mount.
"""

from .strategy import BindStrategy, SnapshotStrategy, WorkspaceMounts, setup_mounts

__all__ = ["BindStrategy", "SnapshotStrategy", "WorkspaceMounts", "setup_mounts"]
