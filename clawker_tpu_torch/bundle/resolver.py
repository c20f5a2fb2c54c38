"""Three-tier component resolution.

Precedence (reference: internal/bundle/resolver.go): **installed** bundles
(under ``<data>/bundles/<ns>/<name>``) shadow **loose** directories
(project-local ``.clawker/bundles``) shadow the embedded **floor**
(``bundle/assets`` package data) -- the floor guarantees a
working claude harness + language stacks with zero installation.

The port's copy of ``clawker_tpu/bundle/resolver.py``, whole; its floor
is the port's own copy of the reference's assets.
"""

from __future__ import annotations

from pathlib import Path

from ..config import Config
from ..errors import NotFoundError
from .model import MANIFESTS, load_component_dir

FLOOR_DIR = Path(__file__).parent / "assets"

KIND_DIRS = {"harness": "harnesses", "stack": "stacks", "monitoring": "monitoring"}


class Resolver:
    def __init__(self, cfg: Config):
        self.cfg = cfg

    # ------------------------------------------------------------- tiers

    def _tier_roots(self) -> list[tuple[str, Path]]:
        """(tier, root) pairs in decreasing precedence."""
        roots: list[tuple[str, Path]] = []
        bundles = self.cfg.bundles_dir
        if bundles.is_dir():
            # installed bundles: <bundles>/<ns>/<name>/ each a bundle root
            for ns in sorted(bundles.iterdir()):
                if ns.is_dir() and not ns.name.startswith("."):
                    for b in sorted(ns.iterdir()):
                        # dot-dirs are install staging (manager.py swap)
                        if b.is_dir() and not b.name.startswith("."):
                            roots.append(("installed", b))
        if self.cfg.project_root is not None:
            loose = self.cfg.project_root / ".clawker" / "bundles"
            if loose.is_dir():
                for b in sorted(loose.iterdir()):
                    if b.is_dir():
                        roots.append(("loose", b))
        roots.append(("floor", FLOOR_DIR))
        return roots

    # ----------------------------------------------------------- resolve

    def resolve(self, kind: str, name: str):
        sub = KIND_DIRS[kind]
        for tier, root in self._tier_roots():
            cdir = root / sub / name
            if cdir.is_dir() and (cdir / MANIFESTS[kind][0]).is_file():
                return load_component_dir(kind, cdir, tier=tier)
        raise NotFoundError(f"no {kind} component named {name!r}")

    def harness(self, name: str):
        return self.resolve("harness", name)

    def stack(self, name: str):
        return self.resolve("stack", name)

    def monitoring(self, name: str):
        return self.resolve("monitoring", name)

    def list(self, kind: str) -> list:
        """All visible components of ``kind`` (higher tiers shadow lower)."""
        sub = KIND_DIRS[kind]
        seen: dict[str, object] = {}
        for tier, root in self._tier_roots():
            d = root / sub
            if not d.is_dir():
                continue
            for cdir in sorted(d.iterdir()):
                if (
                    cdir.is_dir()
                    and (cdir / MANIFESTS[kind][0]).is_file()
                    and cdir.name not in seen
                ):
                    seen[cdir.name] = load_component_dir(kind, cdir, tier=tier)
        return list(seen.values())
