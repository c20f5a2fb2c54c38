"""Damage-tracked terminal repainting.

The port's copy of ``clawker_tpu/ui/damage.py``, whole.

The original :class:`~clawker_tpu_torch.ui.dashboard.LoopDashboard` rewrote
its FULL frame every tick -- cursor-up N, then ``\\x1b[2K`` + line for
every row, changed or not.  At 8 agents that is noise; at 256 agents
across 4 hosted runs it is most of the repaint budget, and every
unchanged byte still crosses the pty (and an SSH session's wire).

:class:`DamagePainter` keeps the previous frame and rewrites only rows
whose content changed: clean rows cost one cursor-down escape, dirty
rows an erase + rewrite, growth appends, shrink erases the stale tail.
Both the per-run dashboard and the fleet console paint through it; the
``console_repaint_p95`` bench gate and the repaint-budget tests assert
on its counters (docs/fleet-console.md#repaint-budget).

Row accounting assumes rows do not wrap (every caller truncates to the
terminal width, as the dashboard always has).
"""

from __future__ import annotations


class DamagePainter:
    """Paint successive frames in place, rewriting only damaged rows.

    ``write``/``flush`` are the output seam (a TTY's ``stdout.write``
    in production, a buffer in tests/bench).  Counters: ``frames``
    painted, ``rows_total`` across all frames, ``rows_painted``
    actually rewritten -- their ratio IS the damage-tracking win.
    """

    def __init__(self, write, flush):
        self._write = write
        self._flush = flush
        self._prev: list[str] = []
        self.frames = 0
        self.rows_total = 0
        self.rows_painted = 0

    def reset(self) -> None:
        """Forget the previous frame: the next paint rewrites fully
        (terminal resize, alt-screen transitions)."""
        self._prev = []

    def paint(self, lines: list[str]) -> int:
        """Paint ``lines`` over the previous frame; returns rows
        rewritten.  The cursor starts and ends on the row after the
        painted region (the contract the dashboard's full-repaint loop
        already kept)."""
        w = self._write
        prev = self._prev
        painted = 0
        if prev:
            w(f"\x1b[{len(prev)}A")
        overlap = min(len(prev), len(lines))
        pending_skips = 0
        for i in range(overlap):
            if lines[i] == prev[i]:
                pending_skips += 1
                continue
            if pending_skips:
                # batch consecutive clean rows into one cursor-down
                w(f"\x1b[{pending_skips}B")
                pending_skips = 0
            w("\x1b[2K" + lines[i] + "\n")
            painted += 1
        if pending_skips:
            w(f"\x1b[{pending_skips}B")
        for line in lines[overlap:]:        # growth: plain appends
            w("\x1b[2K" + line + "\n")
            painted += 1
        extra = len(prev) - len(lines)
        if extra > 0:
            # a shrinking frame must not leave stale tail rows
            for _ in range(extra):
                w("\x1b[2K\n")
            w(f"\x1b[{extra}A")
        self._flush()
        self._prev = list(lines)
        self.frames += 1
        self.rows_total += len(lines)
        self.rows_painted += painted
        return painted

    def stats(self) -> dict:
        return {"frames": self.frames, "rows_total": self.rows_total,
                "rows_painted": self.rows_painted}
