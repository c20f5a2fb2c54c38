"""ProgressTree: live multi-step progress for build/provision flows.

Parity reference: internal/tui/progress.go (BubbleTea progress trees fed
by build events, used by `clawker build` -- build.go:395 status mapping).
Re-designed: a plain ANSI repaint loop on a TTY, sequential state-change
lines otherwise, so the same caller code serves interactive terminals,
pipes, and CI logs.

The port's copy of ``clawker_tpu/ui/progress.py``, whole.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .colors import visible_len
from .iostreams import IOStreams, SPINNER_FRAMES

STATES = ("pending", "running", "done", "failed", "skipped")


@dataclass
class Node:
    key: str
    label: str
    state: str = "pending"
    detail: str = ""
    parent: str = ""
    started: float = 0.0
    finished: float = 0.0
    children: list["Node"] = field(default_factory=list)

    def elapsed(self) -> float:
        if not self.started:
            return 0.0
        end = self.finished or time.monotonic()
        return end - self.started


class ProgressTree:
    """Thread-safe tree of steps; render() paints the whole tree."""

    def __init__(self, streams: IOStreams, *, fps: float = 10.0):
        self.streams = streams
        self.fps = fps
        self._nodes: dict[str, Node] = {}
        self._roots: list[Node] = []
        self._lock = threading.Lock()
        self._painted_lines = 0
        self._live = streams.is_stdout_tty()
        self._frame = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- mutation

    def add(self, key: str, label: str, *, parent: str = "") -> Node:
        with self._lock:
            node = Node(key=key, label=label, parent=parent)
            self._nodes[key] = node
            if parent and parent in self._nodes:
                self._nodes[parent].children.append(node)
            else:
                self._roots.append(node)
            return node

    def update(self, key: str, state: str, detail: str = "") -> None:
        assert state in STATES, state
        with self._lock:
            node = self._nodes.get(key)
            if node is None:
                return
            if state == "running" and not node.started:
                node.started = time.monotonic()
            if state in ("done", "failed", "skipped") and not node.finished:
                node.finished = time.monotonic()
            prev, node.state = node.state, state
            node.detail = detail or node.detail
        if not self._live and prev != state and state != "pending":
            cs = self.streams.colors()
            mark = {"running": "•", "done": cs.success_icon(),
                    "failed": cs.failure_icon(), "skipped": "-"}[state]
            line = f"{mark} {node.label}"
            if state != "running" and node.elapsed() > 0.05:
                line += f" ({node.elapsed():.1f}s)"
            if detail and state == "failed":
                line += f": {detail}"
            self.streams.println(line)

    # ------------------------------------------------------------ rendering

    def _mark(self, node: Node) -> str:
        cs = self.streams.colors()
        if node.state == "running":
            return cs.cyan(SPINNER_FRAMES[self._frame % len(SPINNER_FRAMES)])
        return {
            "pending": cs.gray("·"),
            "done": cs.success_icon(),
            "failed": cs.failure_icon(),
            "skipped": cs.gray("-"),
        }[node.state]

    def _lines(self) -> list[str]:
        cs = self.streams.colors()
        width = self.streams.terminal_width()
        out: list[str] = []

        def walk(node: Node, depth: int) -> None:
            label = node.label if node.state != "pending" else cs.gray(node.label)
            line = "  " * depth + f"{self._mark(node)} {label}"
            if node.state == "running" and node.elapsed() > 1.0:
                line += cs.gray(f" {node.elapsed():.0f}s")
            elif node.state in ("done", "failed") and node.elapsed() > 0.05:
                line += cs.gray(f" ({node.elapsed():.1f}s)")
            if node.detail and node.state in ("running", "failed"):
                room = width - visible_len(line) - 2
                if room > 8:
                    detail = node.detail[-room:]
                    line += " " + (cs.red(detail) if node.state == "failed"
                                   else cs.gray(detail))
            out.append(line)
            for child in node.children:
                walk(child, depth + 1)

        with self._lock:
            for root in self._roots:
                walk(root, 0)
        return out

    def render_once(self) -> None:
        if not self._live:
            return
        lines = self._lines()
        w = self.streams.stdout.write
        if self._painted_lines:
            w(f"\x1b[{self._painted_lines}A")   # cursor up, repaint in place
        for line in lines:
            w("\x1b[2K" + line + "\n")
        self.streams.stdout.flush()
        self._painted_lines = len(lines)
        self._frame += 1

    # ------------------------------------------------------------- lifecycle

    def __enter__(self) -> "ProgressTree":
        if self._live:
            self._thread = threading.Thread(target=self._loop,
                                            name="progress", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(1.0 / self.fps):
            self.render_once()

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(1.0)
        if self._live:
            self.render_once()       # final state frame

    # -------------------------------------------------------------- summary

    def failed(self) -> list[Node]:
        with self._lock:
            return [n for n in self._nodes.values() if n.state == "failed"]
