"""Shared monitor dashboard for ``clawker loop --parallel N``.

Parity reference: internal/tui/dashboard.go + progress.go (BubbleTea);
BASELINE config 4 names the shared monitor TUI for the pod-wide loop
fan-out.  Re-designed as an ANSI repaint panel over the scheduler's
public status surface plus two tickers: scheduler events and the
netlogger's egress jsonl (the same stream the monitor stack indexes).

Non-TTY behavior is handled by the CALLER (the CLI keeps its plain
event lines); the dashboard itself only paints on a live terminal.

The port's copy of ``clawker_tpu/ui/dashboard.py``, whole but for the
threshold's fallback: the port's analytics runtime is always there, so
``_anomaly_threshold`` reads ``ANOMALY_Z`` with no ``ImportError`` path.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from pathlib import Path

from .colors import visible_len
from .damage import DamagePainter
from .iostreams import IOStreams
from .table import render_table

EVENT_TICKER = 6     # recent scheduler events shown
EGRESS_TICKER = 5    # recent egress decisions shown


def _anomaly_threshold() -> float:
    """Single source: analytics.runtime.ANOMALY_Z, imported on first
    use so that importing the ui loads no torch."""
    from ..analytics.runtime import ANOMALY_Z

    return ANOMALY_Z


def tail_jsonl(path: Path, max_lines: int = 64) -> list[dict]:
    """Last records of a jsonl file (netlogger's ebpf-egress.jsonl)."""
    try:
        with path.open("rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            fh.seek(max(0, size - 16384))
            chunk = fh.read().decode(errors="replace")
    except OSError:
        return []
    out = []
    for line in chunk.splitlines()[-max_lines:]:
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


class LoopDashboard:
    """Live panel: loop table + event ticker + egress ticker."""

    def __init__(self, streams: IOStreams, scheduler, *,
                 egress_path: Path | None = None, egress_feed=None,
                 fps: float = 4.0):
        self.streams = streams
        self.scheduler = scheduler
        self.egress_path = egress_path
        # multi-worker merged feed (fleet.egress_tail.EgressFeed): takes
        # precedence over the single local jsonl -- remote loop agents'
        # deny events tick here live (round-3 verdict weak #5)
        self.egress_feed = egress_feed
        self.fps = fps
        self.events: collections.deque = collections.deque(maxlen=64)
        self.started = time.monotonic()
        # damage-tracked repaint (ui/damage.py): an idle fleet's tick
        # costs cursor motion, not a full-frame rewrite -- the same
        # painter the fleet console budgets at 256 agents
        self.painter = DamagePainter(streams.stdout.write,
                                     streams.stdout.flush)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- feed

    def record_event(self, agent: str, event: str, detail: str = "") -> None:
        with self._lock:
            self.events.append((time.strftime("%H:%M:%S"), agent, event, detail))

    # -------------------------------------------------------------- render

    def _frame_lines(self) -> list[str]:
        cs = self.streams.colors()
        width = self.streams.terminal_width()
        sched = self.scheduler
        status = sched.status()
        has_anom = any("anomaly_z" in s for s in status)
        rows = []
        for s in status:
            codes = ",".join(map(str, s.get("exit_codes", []))) or "-"
            row = [
                s["agent"], s["worker"], cs.status(s["status"]),
                str(s["iteration"]), codes,
            ]
            if has_anom:
                z = s.get("anomaly_z")
                if z is None:
                    row.append("-")
                else:
                    cell = f"{z:.1f}"
                    row.append(cs.red(cell) if z >= _anomaly_threshold()
                               else cell)
            rows.append(row)
        elapsed = time.monotonic() - self.started
        running = sum(1 for s in status if s["status"] == "running")
        head = (cs.bold(f"loop {sched.loop_id}")
                + cs.gray(f"  {running}/{len(rows)} running"
                          f"  {elapsed:5.0f}s"))
        lines = [head, ""]
        headers = ["AGENT", "WORKER", "STATUS", "ITER", "EXITS"]
        if has_anom:
            headers.append("ANOM-Z")
        lines += render_table(headers, rows, max_width=width).splitlines()

        with self._lock:
            recent = list(self.events)[-EVENT_TICKER:]
        if recent:
            lines += ["", cs.bold("events")]
            for ts, agent, event, detail in recent:
                line = f"  {cs.gray(ts)} [{agent}] {event}"
                if detail:
                    line += f" {cs.gray(detail)}"
                lines.append(line[: width + (len(line) - visible_len(line))])

        if self.egress_feed is not None:
            egress = self.egress_feed.tail(EGRESS_TICKER)
        elif self.egress_path is not None:
            egress = tail_jsonl(self.egress_path)[-EGRESS_TICKER:]
        else:
            egress = []
        if egress:
            lines += ["", cs.bold("egress")]
            for ev in egress:
                verdict = str(ev.get("verdict", ev.get("action", "?")))
                color = cs.red if verdict in ("1", "deny", "DENY") else cs.green
                worker = ev.get("worker", "")
                lines.append(
                    "  " + (cs.gray(f"[{worker}] ") if worker else "")
                    + color(verdict.lower() if not verdict.isdigit()
                            else ("deny" if verdict == "1" else "allow"))
                    + f" {ev.get('dst', ev.get('dst_ip', '?'))}"
                    + cs.gray(f":{ev.get('dst_port', '?')}"
                              f" zone={ev.get('zone', ev.get('zone_hash', ''))}")
                )
        lines += ["", self._statusbar(status, egress, elapsed, width)]
        return lines

    def _statusbar(self, status: list[dict], egress: list[dict],
                   elapsed: float, width: int) -> str:
        """One inverted summary line (reference internal/tui statusbar):
        loop id, per-state agent counts, recent denies, hottest anomaly
        z-score, elapsed, quit hint."""
        cs = self.streams.colors()
        by_state: dict[str, int] = {}
        for s in status:
            by_state[s["status"]] = by_state.get(s["status"], 0) + 1
        states = " ".join(f"{k}:{v}" for k, v in sorted(by_state.items()))
        denies = sum(1 for e in egress
                     if str(e.get("verdict", e.get("action", ""))).upper()
                     in ("1", "DENY"))
        zs = [s["anomaly_z"] for s in status if s.get("anomaly_z") is not None]
        anom = f"  anom-max:{max(zs):.1f}" if zs else ""
        bar = (f" loop {self.scheduler.loop_id}  {states or 'no agents'}"
               f"  denies:{denies}{anom}  {elapsed:.0f}s  ctrl-c stops ")
        bar = bar[:max(10, width)]
        return cs.invert(bar + " " * max(0, width - visible_len(bar)))

    def render_once(self) -> None:
        if not self.streams.is_stdout_tty():
            return
        self.painter.paint(self._frame_lines())

    # ----------------------------------------------------------- lifecycle

    def __enter__(self) -> "LoopDashboard":
        if self.streams.is_stdout_tty():
            self._thread = threading.Thread(target=self._loop,
                                            name="dashboard", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(1.0 / self.fps):
            self.render_once()

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(1.0)
        if self.streams.is_stdout_tty():
            self.render_once()   # final frame with terminal states
