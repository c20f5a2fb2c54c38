"""Build progress view: docker build stream lines -> ProgressTree.

Parity reference: internal/cmd/image/build/build.go:395 (build-progress
events feeding tui.RunProgress) -- here the mapping is from the daemon's
classic `Step i/n :` stream (and BuildKit vertex lines) into tree nodes:
one root per stage (base/harness), one child per Dockerfile step.

The port's copy of ``clawker_tpu/ui/buildview.py``, whole.
"""

from __future__ import annotations

import re

from .progress import ProgressTree

_STEP = re.compile(r"^Step (\d+)/(\d+) : (.*)$")
_BK_VERTEX = re.compile(r"^#(\d+) (.+)$")


class BuildProgressView:
    """Feed me every progress line; I keep the tree current."""

    def __init__(self, tree: ProgressTree):
        self.tree = tree
        self._stage = ""
        self._stage_n = 0
        self._step_key = ""
        self._bk_keys: dict[str, str] = {}

    def _finish_stage(self, state: str = "done") -> None:
        if self._step_key:
            self.tree.update(self._step_key, state)
            self._step_key = ""
        if self._stage:
            self.tree.update(self._stage, state)
            self._stage = ""

    def stage(self, label: str) -> None:
        """A new build stage begins (base/harness/tag)."""
        self._finish_stage()
        self._stage_n += 1
        self._stage = f"stage-{self._stage_n}"
        self.tree.add(self._stage, label)
        self.tree.update(self._stage, "running")

    def line(self, line: str) -> None:
        line = line.rstrip()
        if not line:
            return
        if not self._stage:
            self.stage(line)
            return
        m = _STEP.match(line)
        if m:
            if self._step_key:
                self.tree.update(self._step_key, "done")
            i, n, cmd = m.group(1), m.group(2), m.group(3)
            self._step_key = f"{self._stage}.{i}"
            self.tree.add(self._step_key, f"[{i}/{n}] {cmd}",
                          parent=self._stage)
            self.tree.update(self._step_key, "running")
            return
        m = _BK_VERTEX.match(line)
        if m:
            num, rest = m.group(1), m.group(2)
            key = self._bk_keys.get(num)
            if rest.startswith("DONE") and key:
                self.tree.update(key, "done")
            elif rest.startswith("CACHED") and key:
                self.tree.update(key, "done", "cached")
            elif rest.startswith("ERROR") and key:
                self.tree.update(key, "failed", rest)
            elif key is None and not rest.startswith(("CACHED", "DONE", "ERROR")):
                key = f"{self._stage}.bk{num}"
                self._bk_keys[num] = key
                self.tree.add(key, rest, parent=self._stage)
                self.tree.update(key, "running")
            return
        # any other output becomes the running step's detail ticker
        target = self._step_key or self._stage
        self.tree.update(target, "running", line)

    def done(self) -> None:
        self._finish_stage("done")

    def failed(self, detail: str = "") -> None:
        if self._step_key:
            self.tree.update(self._step_key, "failed", detail)
            self._step_key = ""
        if self._stage:
            self.tree.update(self._stage, "failed", detail)
            self._stage = ""
