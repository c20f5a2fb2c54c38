"""ProjectManager: global registry.yaml CRUD + worktree lifecycle.

The port's copy of ``clawker_tpu/project/manager.py``, whole.

Parity reference: internal/project (manager.go:45 ProjectManager,
registry.yaml in XDG data dir, worktree_service.go) + internal/git
integration.  Worktrees live under ``<data>/worktrees/<project>/<name>``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..config import Config
from ..errors import ConflictError, NotFoundError
from ..gitx import GitManager
from ..storage import Layer, Store
from ..util.text import validate_name


@dataclass
class WorktreeRecord:
    name: str
    path: Path
    branch: str

    @property
    def main_git_dir(self) -> Path:
        """The main repo's git dir (for read-only mounting into containers)."""
        gm = GitManager(self.path)
        return gm.git_dir()


@dataclass
class ProjectRecord:
    name: str
    root: Path
    worktrees: list[WorktreeRecord] = field(default_factory=list)


class ProjectManager:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self._store = Store([Layer("registry", cfg.registry_path)])

    # ------------------------------------------------------------ registry

    def _load(self) -> dict[str, ProjectRecord]:
        raw = self._store.raw().get("projects") or {}
        out: dict[str, ProjectRecord] = {}
        for name, rec in raw.items():
            out[name] = ProjectRecord(
                name=name,
                root=Path(rec.get("root", "")),
                worktrees=[
                    WorktreeRecord(name=w["name"], path=Path(w["path"]), branch=w.get("branch", ""))
                    for w in rec.get("worktrees", [])
                ],
            )
        return out

    def _save(self, projects: dict[str, ProjectRecord]) -> None:
        tree = {
            "projects": {
                p.name: {
                    "root": str(p.root),
                    "worktrees": [
                        {"name": w.name, "path": str(w.path), "branch": w.branch}
                        for w in p.worktrees
                    ],
                }
                for p in projects.values()
            }
        }
        self._store.write_layer("registry", tree)

    def register_current(self) -> ProjectRecord:
        name = self.cfg.project_name()
        root = self.cfg.project_root
        if root is None:
            raise NotFoundError("no project config found (run `clawker init` first)")
        projects = self._load()
        existing = projects.get(name)
        if existing and existing.root != root:
            raise ConflictError(
                f"project {name!r} already registered at {existing.root}; "
                "remove it first or rename this project"
            )
        rec = existing or ProjectRecord(name=name, root=root)
        rec.root = root
        projects[name] = rec
        self._save(projects)
        return rec

    def get(self, name: str) -> ProjectRecord:
        projects = self._load()
        if name not in projects:
            raise NotFoundError(f"project {name!r} not registered")
        return projects[name]

    def list_projects(self) -> list[ProjectRecord]:
        return sorted(self._load().values(), key=lambda p: p.name)

    def remove(self, name: str) -> None:
        projects = self._load()
        if name not in projects:
            raise NotFoundError(f"project {name!r} not registered")
        del projects[name]
        self._save(projects)

    # ----------------------------------------------------------- worktrees

    def _ensure_registered(self, project: str) -> ProjectRecord:
        projects = self._load()
        if project in projects:
            return projects[project]
        # auto-register when invoked from within the project
        if self.cfg.project_root is not None and self.cfg.project_name() == project:
            return self.register_current()
        raise NotFoundError(f"project {project!r} not registered")

    def add_worktree(self, project: str, name: str, *, branch: str = "") -> WorktreeRecord:
        validate_name("worktree", name)
        rec = self._ensure_registered(project)
        if any(w.name == name for w in rec.worktrees):
            raise ConflictError(f"worktree {name!r} already exists for {project!r}")
        branch = branch or f"clawker/{name}"
        dest = self.cfg.worktrees_dir / project / name
        gm = GitManager(rec.root)
        if not gm.is_repo():
            raise ConflictError(f"project root {rec.root} is not a git repository")
        info = gm.setup_worktree(dest, branch)
        wt = WorktreeRecord(name=name, path=info.path, branch=info.branch)
        projects = self._load()
        projects.setdefault(project, rec).worktrees = [
            w for w in rec.worktrees if w.name != name
        ] + [wt]
        self._save(projects)
        return wt

    def get_worktree(self, project: str, name: str) -> WorktreeRecord:
        rec = self.get(project)
        for w in rec.worktrees:
            if w.name == name:
                return w
        raise NotFoundError(f"worktree {name!r} not found for project {project!r}")

    def list_worktrees(self, project: str) -> list[WorktreeRecord]:
        try:
            return list(self.get(project).worktrees)
        except NotFoundError:
            return []

    def remove_worktree(self, project: str, name: str, *, force: bool = False) -> None:
        rec = self.get(project)
        wt = self.get_worktree(project, name)
        gm = GitManager(rec.root)
        if wt.path.exists():
            if not force and gm.is_dirty(wt.path):
                raise ConflictError(
                    f"worktree {name!r} has local changes; use --force to discard"
                )
            gm.remove_worktree(wt.path, force=force)
        else:
            gm.prune_worktrees()
        projects = self._load()
        projects[project].worktrees = [w for w in rec.worktrees if w.name != name]
        self._save(projects)

    def prune_worktrees(self, project: str) -> list[str]:
        """Drop registry records whose directories no longer exist."""
        rec = self.get(project)
        gone = [w.name for w in rec.worktrees if not w.path.exists()]
        if gone:
            GitManager(rec.root).prune_worktrees()
            projects = self._load()
            projects[project].worktrees = [w for w in rec.worktrees if w.path.exists()]
            self._save(projects)
        return gone
