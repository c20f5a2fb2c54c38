"""Project registry + worktree service (reference: internal/project).

The port's copy of ``clawker_tpu/project/__init__.py``, whole.
"""

from .manager import ProjectManager, ProjectRecord, WorktreeRecord

__all__ = ["ProjectManager", "ProjectRecord", "WorktreeRecord"]
