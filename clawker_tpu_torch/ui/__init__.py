"""Terminal I/O layer: streams, colors, tables, damage-tracked painting.

Parity reference: internal/iostreams/ (TTY detect, colorscheme, spinner,
pager, alt-screen, Test() quad-buffer constructor -- iostreams.go:140).
Re-designed for Python: one IOStreams facade object threaded through the
factory, ANSI rendered directly (no lipgloss), and every component
degrades to plain line output when stdout is not a TTY -- the
non-interactive path is the contract, the animation is the garnish.

The port's copy of ``clawker_tpu/ui``: ``colors``, ``iostreams``,
``table``, ``damage``, ``dashboard`` (``LoopDashboard``),
``fleetconsole`` (``FleetConsole``), ``prompter`` (``Prompter``),
``progress`` (``ProgressTree``) and ``buildview``.  ``fieldbrowser``
waits for the verbs that use it (``project edit``, ``settings edit``:
ROADMAP §1 item 13), so this package exports only what is ported.
"""

from .colors import ColorScheme
from .iostreams import IOStreams
from .progress import Node, ProgressTree
from .prompter import Prompter
from .table import render_table

__all__ = [
    "IOStreams", "ColorScheme", "ProgressTree", "Node", "render_table",
    "Prompter",
]
