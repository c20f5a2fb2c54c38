"""GitManager: worktree lifecycle over the git CLI.

The port's copy of ``clawker_tpu/gitx/git.py``, whole.

Parity reference: internal/git/git.go -- SetupWorktree (:191),
RemoveWorktree (:356), ListWorktrees (:392).  The reference uses go-git;
this build shells out to the ubiquitous git binary (no vendored VCS), which
also works unchanged over SSH on TPU-VM workers.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

from ..errors import ClawkerError


class GitError(ClawkerError):
    pass


class MergeConflict(GitError):
    """A merge-queue landing hit conflicting hunks.

    Carries enough context for the scheduler to resubmit the losing
    branch through admission (docs/loop-worktrees.md#merge-queue)."""

    def __init__(self, target: str, src: str, detail: str = ""):
        super().__init__(
            f"merge of {src} into {target} conflicts"
            + (f": {detail}" if detail else ""))
        self.target = target
        self.src = src


@dataclass
class WorktreeInfo:
    path: Path
    branch: str
    head: str


class GitManager:
    def __init__(self, repo_root: Path):
        self.root = Path(repo_root)

    def _git(self, *args: str, cwd: Path | None = None, check: bool = True) -> str:
        res = subprocess.run(
            ["git", *args],
            cwd=str(cwd or self.root),
            capture_output=True,
            text=True,
        )
        if check and res.returncode != 0:
            raise GitError(
                f"git {' '.join(args)} failed ({res.returncode}): {res.stderr.strip()}"
            )
        return res.stdout

    # ----------------------------------------------------------- queries

    def is_repo(self) -> bool:
        try:
            return self._git("rev-parse", "--is-inside-work-tree").strip() == "true"
        except GitError:
            return False

    def git_dir(self) -> Path:
        """Absolute path of the main repository's .git directory (mounted
        read-only into worktree agent containers, reference setup.go:288)."""
        out = self._git("rev-parse", "--path-format=absolute", "--git-common-dir").strip()
        return Path(out)

    def current_branch(self) -> str:
        return self._git("rev-parse", "--abbrev-ref", "HEAD").strip()

    def is_dirty(self, path: Path | None = None) -> bool:
        out = self._git("status", "--porcelain", cwd=path or self.root)
        return bool(out.strip())

    def branch_exists(self, branch: str) -> bool:
        try:
            self._git("rev-parse", "--verify", "--quiet", f"refs/heads/{branch}")
            return True
        except GitError:
            return False

    # --------------------------------------------------------- worktrees

    def setup_worktree(self, dest: Path, branch: str, *, base: str = "HEAD") -> WorktreeInfo:
        """Create -- or RE-ATTACH -- a linked worktree at ``dest`` on
        ``branch`` (created from ``base`` if it does not exist).

        Idempotent against every stale state a crashed prior run leaves
        behind (docs/loop-worktrees.md#degrade-matrix): ``branch``
        already checked out at ``dest`` reuses it as-is; a worktree
        registration whose directory vanished is pruned before re-adding;
        a branch that exists with no worktree (prior run died between
        branch create and ``worktree add``) is attached rather than
        erroring.  This is what lets ``--resume`` replay REC_SEED_WORKTREE
        records straight back through this call with zero duplicates."""
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        existing = None
        for wt in self.list_worktrees():
            if wt.branch == branch or wt.path == dest:
                existing = wt
                break
        if existing is not None:
            if existing.path == dest and existing.branch == branch:
                if dest.exists():
                    # crash-survivor: the worktree is intact, reuse it
                    head = self._git("rev-parse", "HEAD", cwd=dest).strip()
                    return WorktreeInfo(path=dest, branch=branch, head=head)
                # registered but the directory is gone: drop the stale
                # registration, then fall through to a fresh add
                self.prune_worktrees()
            else:
                raise GitError(
                    f"branch {branch!r} / dest {dest} already attached to "
                    f"worktree {existing.path} (branch {existing.branch!r})")
        if self.branch_exists(branch):
            self._git("worktree", "add", str(dest), branch)
        else:
            self._git("worktree", "add", "-b", branch, str(dest), base)
        head = self._git("rev-parse", "HEAD", cwd=dest).strip()
        return WorktreeInfo(path=dest, branch=branch, head=head)

    def list_worktrees(self) -> list[WorktreeInfo]:
        out = self._git("worktree", "list", "--porcelain")
        infos: list[WorktreeInfo] = []
        cur: dict = {}
        for line in out.splitlines() + [""]:
            if not line.strip():
                if cur.get("worktree"):
                    infos.append(
                        WorktreeInfo(
                            path=Path(cur["worktree"]),
                            branch=cur.get("branch", "").removeprefix("refs/heads/"),
                            head=cur.get("HEAD", ""),
                        )
                    )
                cur = {}
                continue
            key, _, val = line.partition(" ")
            cur[key] = val
        return infos

    def remove_worktree(self, path: Path, *, force: bool = False) -> None:
        args = ["worktree", "remove", str(path)]
        if force:
            args.insert(2, "--force")
        self._git(*args)

    def prune_worktrees(self) -> None:
        self._git("worktree", "prune")

    # ------------------------------------------------------- merge queue

    def ensure_branch(self, branch: str, *, base: str = "HEAD") -> str:
        """Create ``branch`` at ``base`` if missing; return its tip sha."""
        if not self.branch_exists(branch):
            self._git("branch", branch, base)
        return self._git("rev-parse", f"refs/heads/{branch}").strip()

    def merge_into(self, target: str, src: str, *, message: str = "") -> str:
        """Land branch ``src`` onto branch ``target`` without touching any
        checked-out tree.  Returns ``"clean"`` (src already contained),
        ``"ff"`` (fast-forwarded), or ``"merged"`` (true merge commit);
        raises :class:`MergeConflict` on conflicting hunks.

        The container's git predates ``merge-tree --write-tree``
        (needs >= 2.38), so a true merge runs in a throwaway *detached*
        temp worktree and publishes via a guarded ``update-ref`` -- the
        old-value argument makes the ref move atomic against a
        concurrent mover, and no user checkout is ever mutated (the
        merge queue lands onto a run-scoped integration branch for the
        same reason; docs/loop-worktrees.md#merge-queue)."""
        target_tip = self._git("rev-parse", f"refs/heads/{target}").strip()
        src_tip = self._git("rev-parse", f"refs/heads/{src}").strip()
        if self._is_ancestor(src_tip, target_tip):
            return "clean"
        if self._is_ancestor(target_tip, src_tip):
            self._git("update-ref", f"refs/heads/{target}", src_tip,
                      target_tip)
            return "ff"
        tmp = Path(tempfile.mkdtemp(prefix="clawker-mergeq-")) / "wt"
        try:
            self._git("worktree", "add", "--detach", str(tmp), target_tip)
            res = subprocess.run(
                ["git", *self._identity_args(), "merge", "--no-ff", "-m",
                 message or f"merge {src} into {target}", src_tip],
                cwd=str(tmp), capture_output=True, text=True)
            if res.returncode != 0:
                subprocess.run(["git", "merge", "--abort"], cwd=str(tmp),
                               capture_output=True, text=True)
                raise MergeConflict(target, src,
                                    detail=res.stdout.strip()[:200])
            new_tip = self._git("rev-parse", "HEAD", cwd=tmp).strip()
            self._git("update-ref", f"refs/heads/{target}", new_tip,
                      target_tip)
            return "merged"
        finally:
            self._git("worktree", "remove", "--force", str(tmp),
                      check=False)
            shutil.rmtree(tmp.parent, ignore_errors=True)
            self.prune_worktrees()

    def _identity_args(self) -> list[str]:
        """``-c`` identity fallback for commits the merge queue itself
        authors.  A configured user identity always wins; the synthetic
        one only keeps the landing from dying with "committer identity
        unknown" on bare CI hosts / fresh TPU-VM workers."""
        res = subprocess.run(
            ["git", "config", "user.email"],
            cwd=str(self.root), capture_output=True, text=True)
        if res.returncode == 0 and res.stdout.strip():
            return []
        return ["-c", "user.name=clawker", "-c",
                "user.email=clawker@localhost"]

    def _is_ancestor(self, maybe_ancestor: str, descendant: str) -> bool:
        res = subprocess.run(
            ["git", "merge-base", "--is-ancestor", maybe_ancestor,
             descendant],
            cwd=str(self.root), capture_output=True, text=True)
        return res.returncode == 0
