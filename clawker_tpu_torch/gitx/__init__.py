"""Git operations via the git CLI (reference: internal/git go-git GitManager).

The port's copy of ``clawker_tpu/gitx``, whole.
"""

from .git import GitError, GitManager, MergeConflict, WorktreeInfo

__all__ = ["GitError", "GitManager", "MergeConflict", "WorktreeInfo"]
