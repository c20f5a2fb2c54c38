"""The fleet console: daemon-backed multi-run TUI (BASELINE config #4).

One pane of glass over everything a loopd hosts, driven entirely by the
status RPC's console feed (loopd/feed.py -- the SAME schema
``clawker loopd status --format json`` serves scripts) plus span
waterfalls tailed incrementally from each run's flight recorder:

- per-loop status across every hosted run (agent, worker, status,
  iteration, exits, sentinel ANOM-Z);
- per-worker breaker + admission-token + workerd-liveness row;
- tenant queues, warm-pool depths, shipper/ingest state;
- a span waterfall of the most recent iterations per run.

**Repaint budget** (docs/fleet-console.md#repaint-budget): frames paint
through :class:`~clawker_tpu_torch.ui.damage.DamagePainter` (only changed
rows rewrite), and past :data:`MAX_AGENT_ROWS` total agent rows the
table VIRTUALIZES -- each run shows its most interesting rows (failed/
orphaned first, then hottest anomaly, then running) with an explicit
``+N more`` marker, so frame size is bounded no matter how many agents
the daemon hosts.  ``bench.py``'s ``console_repaint_p95`` gates the
result at 256 agents across 4 hosted runs.

The port's copy of ``clawker_tpu/ui/fleetconsole.py``, whole; it shares
the dashboard's ``_anomaly_threshold`` instead of keeping a second one
with a fallback.
"""

from __future__ import annotations

import collections
import time
from pathlib import Path

from ..monitor.ledger import (FLIGHT_DIR, TailState, flight_path,
                              tail_rotated)
from ..telemetry.spans import SPAN_ITERATION, SpanRecord, build_trees
from .colors import visible_len
from .damage import DamagePainter
from .dashboard import _anomaly_threshold
from .iostreams import IOStreams
from .table import render_table

MAX_AGENT_ROWS = 64     # total agent rows before virtualization kicks in
MIN_RUN_ROWS = 4        # every run keeps at least this many visible rows
MAX_RUNS = 8            # run sections per frame: live runs first, then the
#                         newest done runs; the rest collapse to one line
#                         (loopd retains up to 64 done runs -- rendering
#                         them all would blow the frame bound AND the
#                         painter's cursor math past the terminal height)
WATERFALL_ROWS = 4      # recent iteration waterfalls per run
WATERFALL_WIDTH = 28    # bar width, chars
SPAN_TAIL_LIMIT = 160   # recent span records kept per run (bounded)

# status sort weight: most interesting first (virtualization order)
_STATUS_WEIGHT = {"failed": 0, "orphaned": 1, "stopped": 2,
                  "running": 3, "pending": 4, "done": 5}

# waterfall segment glyphs per child-span name
_PHASE_GLYPH = {"create": "c", "start": "s", "wait": "=",
                "exit": "x", "orphan": "o", "migrate": "m", "resume": "r"}


class SpanTail:
    """Bounded incremental tail of one run's flight recorder.

    ``poll`` is O(new bytes) (monitor.ledger.tail_rotated cursor); only
    the newest :data:`SPAN_TAIL_LIMIT` span records are retained, so a
    long-lived console never re-reads or re-holds a multi-hour flight
    file.  A size-capped recorder's rotation is drained losslessly at
    the boundary; only a genuine truncation loses records.

    With ``remote_dir`` + ``run_id`` the tail ALSO follows the daemon
    recorders that may hold this run's remote trace segments
    (docs/tracing.md): workerd's create/start/wait spans and the
    router/loopd submit hops, filtered by trace id, rendered as hop
    rows under the waterfall."""

    def __init__(self, path: Path, *, limit: int = SPAN_TAIL_LIMIT,
                 remote_dir: Path | None = None, run_id: str = ""):
        self.path = Path(path)
        self.state = TailState()
        self.records: collections.deque[SpanRecord] = collections.deque(
            maxlen=limit)
        self.remote_dir = Path(remote_dir) if remote_dir is not None else None
        self.run_id = run_id
        self._remote_states: dict[Path, TailState] = {}
        self.remote: collections.deque[SpanRecord] = collections.deque(
            maxlen=limit)

    def poll(self) -> int:
        n = 0
        for doc in tail_rotated(self.path, self.state):
            if doc.get("kind") == "span":
                self.records.append(SpanRecord.from_json(doc))
                n += 1
        if self.remote_dir is not None and self.run_id:
            for pattern in ("workerd-*.jsonl", "router-*.jsonl",
                            "loopd-*.jsonl"):
                for p in sorted(self.remote_dir.glob(pattern)):
                    st = self._remote_states.setdefault(p, TailState())
                    for doc in tail_rotated(p, st):
                        if (doc.get("kind") == "span"
                                and doc.get("trace_id") == self.run_id):
                            self.remote.append(SpanRecord.from_json(doc))
                            n += 1
        return n

    def _hop_line(self, cs, rec: SpanRecord, t0: float) -> str:
        """One remote segment as a hop row, offset skew-adjusted onto
        the scheduler's clock (attr ``skew_s`` is the segment's
        cumulative offset estimate -- docs/tracing.md#skew)."""
        skew = float(rec.attrs.get("skew_s") or 0.0)
        off = (rec.t_start - skew - t0) * 1000.0
        wan = rec.attrs.get("wan_ms")
        extra = f" wan={float(wan):.1f}ms" if wan is not None else ""
        return cs.gray(
            f"    ↳ {rec.name:<16.16} {rec.worker:<12.12} "
            f"+{off:7.1f}ms {rec.wall_s * 1000:6.1f}ms{extra}")

    def waterfall_lines(self, cs, *, rows: int = WATERFALL_ROWS,
                        width: int = WATERFALL_WIDTH) -> list[str]:
        """The newest completed iteration roots as proportional phase
        bars (create/start/wait/exit...), newest last."""
        if not self.records:
            return []
        trees = build_trees(list(self.records))
        roots = [t for t in trees if t.record.name == SPAN_ITERATION]
        roots.sort(key=lambda t: t.record.t_end)
        out = []
        # run-level submit hops (router/loopd: agent-less) lead the
        # waterfall -- the WAN cost the whole run paid to get here
        for hop in [r for r in self.remote if not r.agent][-2:]:
            t0 = roots[0].record.t_start if roots else hop.t_start
            out.append(self._hop_line(cs, hop, t0))
        for tree in roots[-rows:]:
            rec = tree.record
            span = max(rec.wall_s, 1e-9)
            bar = ["·"] * width
            for child in tree.children:
                c = child.record
                glyph = _PHASE_GLYPH.get(c.name, "?")
                lo = int((c.t_start - rec.t_start) / span * width)
                hi = int((c.t_end - rec.t_start) / span * width)
                lo = min(max(lo, 0), width - 1)
                hi = min(max(hi, lo + 1), width)
                for i in range(lo, hi):
                    bar[i] = glyph
            label = f"{rec.agent}#{rec.attrs.get('iteration', '?')}"
            status = (cs.green(rec.status) if rec.status == "ok"
                      else cs.red(rec.status))
            out.append(f"  {label:<20.20} |{''.join(bar)}| "
                       f"{rec.wall_s * 1000:6.1f}ms {status}")
            # this iteration's remote workerd segment, as hop rows
            # offset onto the scheduler's clock (newest 3)
            it = rec.attrs.get("iteration")
            hops = [r for r in self.remote
                    if r.agent == rec.agent and r.attrs.get("iteration") == it]
            for hop in hops[-3:]:
                out.append(self._hop_line(cs, hop, rec.t_start))
        return out


def virtualize(runs: list[dict], *, budget: int = MAX_AGENT_ROWS
               ) -> list[tuple[dict, list[dict], int]]:
    """(run, visible agent rows, hidden count) per run under a total
    row budget.  Below the budget everything shows; past it each run
    gets a proportional share (never under :data:`MIN_RUN_ROWS`) and
    rows rank most-interesting-first: failed/orphaned, then hottest
    ANOM-Z, then running -- the rows an operator would scroll to are
    the rows that stay."""
    total = sum(len(r.get("agents") or []) for r in runs)
    out = []
    if total <= budget or not runs:
        for r in runs:
            out.append((r, list(r.get("agents") or []), 0))
        return out
    share = max(MIN_RUN_ROWS, budget // len(runs))
    for r in runs:
        agents = list(r.get("agents") or [])
        ranked = sorted(agents, key=lambda a: (
            _STATUS_WEIGHT.get(a.get("status", ""), 9),
            -(a.get("anomaly_z") or 0.0),
            a.get("agent", "")))
        keep = ranked[:share]
        # render in stable agent order, whatever the interest ranking
        keep.sort(key=lambda a: a.get("agent", ""))
        out.append((r, keep, len(agents) - len(keep)))
    return out


class FleetConsole:
    """Render the console feed; the CLI drives the poll/paint loop.

    ``feed_fn`` returns the *normalized* console feed dict per tick
    (the CLI wraps a loopd status RPC in loopd.feed.console_feed;
    tests/bench hand in synthetic feeds).  ``logs_dir`` enables the
    span waterfalls (flight recorders live under it); None disables
    them (a console pointed at a remote daemon's feed alone)."""

    def __init__(self, streams: IOStreams, feed_fn, *,
                 logs_dir: Path | None = None, fps: float = 4.0,
                 max_agent_rows: int = MAX_AGENT_ROWS,
                 waterfall_rows: int = WATERFALL_ROWS):
        self.streams = streams
        self.feed_fn = feed_fn
        self.logs_dir = Path(logs_dir) if logs_dir is not None else None
        self.fps = fps
        self.max_agent_rows = max_agent_rows
        self.waterfall_rows = waterfall_rows
        self.started = time.monotonic()
        self.painter = DamagePainter(streams.stdout.write,
                                     streams.stdout.flush)
        self._tails: dict[str, SpanTail] = {}

    # ------------------------------------------------------------ sections

    def _tail_for(self, run_id: str) -> SpanTail | None:
        if self.logs_dir is None or not run_id:
            return None
        tail = self._tails.get(run_id)
        if tail is None:
            tail = self._tails[run_id] = SpanTail(
                flight_path(self.logs_dir, run_id),
                remote_dir=self.logs_dir / FLIGHT_DIR, run_id=run_id)
            # bound the tail map to the runs the feed still reports
            # (done-run eviction on the daemon side drops them here too)
        return tail

    def _prune_tails(self, live: set[str]) -> None:
        for rid in [r for r in self._tails if r not in live]:
            del self._tails[rid]

    @staticmethod
    def _select_runs(runs: list[dict], *, limit: int = MAX_RUNS
                     ) -> tuple[list[dict], int]:
        """(runs to render in feed order, hidden count): live runs win
        the budget, the remainder goes to the NEWEST done runs (feed
        order is submit order)."""
        if len(runs) <= limit:
            return list(runs), 0
        live = [r for r in runs if r.get("state") != "done"]
        chosen = set(id(r) for r in live[:limit])
        room = limit - len(chosen)
        if room > 0:
            done = [r for r in runs if r.get("state") == "done"]
            chosen.update(id(r) for r in done[-room:])
        shown = [r for r in runs if id(r) in chosen]
        return shown, len(runs) - len(shown)

    def _run_lines(self, feed: dict, width: int) -> list[str]:
        cs = self.streams.colors()
        thr = _anomaly_threshold()
        lines: list[str] = []
        # POD column only on a merged multi-pod feed (feed["pods"] set
        # by loopd.feed.merge_feeds): the single-pod frame stays
        # byte-identical (docs/federation.md#console)
        has_pod = len(feed.get("pods") or []) > 1
        all_runs = feed.get("runs") or []
        runs, hidden_runs = self._select_runs(all_runs)
        self._prune_tails({r.get("run", "") for r in runs})
        for run, agents, hidden in virtualize(
                runs, budget=self.max_agent_rows):
            drops = run.get("events_dropped", 0)
            head = (cs.bold(f"run {run.get('run')}")
                    + f" {cs.status(run.get('state', ''))}"
                    + cs.gray(f"  tenant={run.get('tenant')}"
                              f"  {run.get('placement')}"
                              f"  {len(run.get('agents') or [])} agent(s)"
                              f"  subs={run.get('subscribers', 0)}")
                    + (cs.red(f"  drops={drops}") if drops else ""))
            lines.append(head)
            rows = []
            has_anom = any(a.get("anomaly_z") is not None for a in agents)
            pod = str(run.get("pod") or "-")
            for a in agents:
                row = [a.get("agent", ""), a.get("worker", "")]
                if has_pod:
                    row.append(pod)
                row += [cs.status(a.get("status", "")),
                        str(a.get("iteration", 0)), a.get("exits", "-")]
                if has_anom:
                    z = a.get("anomaly_z")
                    cell = "-" if z is None else f"{z:.1f}"
                    row.append(cs.red(cell)
                               if z is not None and z >= thr else cell)
                rows.append(row)
            headers = ["AGENT", "WORKER", "STATUS", "ITER", "EXITS"]
            if has_pod:
                headers.insert(2, "POD")
            if has_anom:
                headers.append("ANOM-Z")
            lines += ["  " + l for l in
                      render_table(headers, rows,
                                   max_width=max(20, width - 2)).splitlines()]
            if hidden:
                lines.append(cs.gray(f"  … +{hidden} more agent(s) "
                                     "(virtualized)"))
            tail = self._tail_for(str(run.get("run", "")))
            if tail is not None:
                tail.poll()
                wf = tail.waterfall_lines(cs, rows=self.waterfall_rows)
                if wf:
                    lines.append(cs.gray("  spans "
                                         "(c=create s=start ==wait)"))
                    lines += wf
        if hidden_runs:
            n_done = sum(1 for r in all_runs if r.get("state") == "done")
            lines.append(cs.gray(
                f"… +{hidden_runs} more run(s) not shown "
                f"({n_done} done; `clawker loopd status` lists all)"))
        return lines

    def _worker_lines(self, feed: dict) -> list[str]:
        cs = self.streams.colors()
        health = {h.get("worker"): h for h in feed.get("health") or []}
        tokens = feed.get("workers") or {}
        workerd = feed.get("workerd") or {}
        ids = sorted(set(health) | set(tokens))
        if not ids:
            return []
        lines = [cs.bold("workers")]
        for wid in ids:
            h = health.get(wid, {})
            t = tokens.get(wid, {})
            state = str(h.get("state", "closed"))
            brk = cs.green(state) if state == "closed" else cs.red(state)
            wd = str(workerd.get(wid, "absent"))
            lines.append(
                f"  {wid:<14.14} brk={brk} "
                f"tokens={t.get('inflight', 0)}/{t.get('capacity', '-')} "
                f"pend={t.get('pending', 0)} rej={t.get('rejected', 0)} "
                f"p50={h.get('probe_p50_ms', 0)}ms workerd={wd}")
        return lines

    def _tenant_pool_lines(self, feed: dict) -> list[str]:
        cs = self.streams.colors()
        lines: list[str] = []
        tenants = feed.get("tenants") or {}
        if tenants:
            lines.append(cs.bold("tenants"))
            for name, t in sorted(tenants.items()):
                lines.append(
                    f"  {name:<20.20} w={t.get('weight', 1.0)} "
                    f"inflight={t.get('inflight', 0)} "
                    f"queued={t.get('queued', 0)} "
                    f"dispatched={t.get('dispatched', 0)}")
        pools = feed.get("warm_pools") or {}
        if pools:
            lines.append(cs.bold("warm pools"))
            for rid, st in sorted(pools.items()):
                depths = " ".join(
                    f"{wid}:{w.get('ready', 0)}"
                    for wid, w in sorted((st.get("workers") or {}).items()))
                lines.append(
                    f"  run {rid}: depth={st.get('target_depth', 0)} "
                    f"hits={st.get('hits', 0)} misses={st.get('misses', 0)}"
                    + (f"  [{depths}]" if depths else ""))
        return lines

    def _statusbar(self, feed: dict, width: int) -> str:
        cs = self.streams.colors()
        runs = feed.get("runs") or []
        agents = [a for r in runs for a in (r.get("agents") or [])]
        by_state: dict[str, int] = {}
        for a in agents:
            by_state[a["status"]] = by_state.get(a["status"], 0) + 1
        states = " ".join(f"{k}:{v}" for k, v in sorted(by_state.items()))
        thr = _anomaly_threshold()
        flagged = sum(1 for a in agents
                      if (a.get("anomaly_z") or 0.0) >= thr)
        ship = feed.get("shipper") or {}
        if ship.get("enabled"):
            ship_s = (f"ship:{ship.get('pending_batches', 0)}p"
                      f"/{ship.get('dropped_docs', 0)}d")
        else:
            ship_s = "ship:off"
        bar = (f" fleet {len(runs)} run(s) {len(agents)} agent(s)"
               f"  {states or 'idle'}  anom:{flagged}  {ship_s}"
               f"  drops:{feed.get('events_dropped_total', 0)}"
               f"  {time.monotonic() - self.started:.0f}s"
               "  ctrl-c exits ")
        bar = bar[:max(10, width)]
        return cs.invert(bar + " " * max(0, width - visible_len(bar)))

    # -------------------------------------------------------------- render

    def frame_lines(self, feed: dict) -> list[str]:
        cs = self.streams.colors()
        width = self.streams.terminal_width()
        pods = feed.get("pods") or []
        who = (f"pods={','.join(pods)}" if len(pods) > 1
               else f"loopd pid {feed.get('pid')}")
        head = (cs.bold("fleet console")
                + cs.gray(f"  {who}"
                          f"  project={feed.get('project') or '-'}"
                          f"  up {feed.get('uptime_s', 0):.0f}s"))
        lines = [head, ""]
        runs = feed.get("runs") or []
        if runs:
            lines += self._run_lines(feed, width)
        else:
            lines.append(cs.gray("no hosted runs (submit with "
                                 "`clawker loop --daemon`)"))
        worker_lines = self._worker_lines(feed)
        if worker_lines:
            lines += [""] + worker_lines
        tp = self._tenant_pool_lines(feed)
        if tp:
            lines += [""] + tp
        lines += ["", self._statusbar(feed, width)]
        return [l[: width + (len(l) - visible_len(l))] for l in lines]

    def render_once(self) -> int:
        """Fetch one feed and paint; returns rows rewritten.  Non-TTY
        callers use :meth:`frame_lines`/`snapshot` instead."""
        feed = self.feed_fn()
        return self.painter.paint(self.frame_lines(feed))

    def snapshot(self) -> str:
        """One plain frame (no repaint escapes): `fleet console --once`
        and the non-TTY degrade path."""
        return "\n".join(self.frame_lines(self.feed_fn()))
