"""Join per-process flight recorders into one causal span tree.

Four recorder families may hold pieces of one run's trace
(docs/tracing.md#merge):

- ``logs/flight/loop-<run>.jsonl`` -- the scheduler's own spans
  (iteration roots + phase children), wherever the scheduler ran;
- ``logs/flight/loopd-<pod>.jsonl`` -- daemon-lifetime ``loopd.submit``
  hop spans, one file per pod;
- ``logs/flight/router-<name>.jsonl`` -- the federation router's
  ``router.submit`` hop spans;
- ``logs/flight/workerd-<worker>.jsonl`` -- worker-side remote spans
  (``workerd.create`` / ``workerd.start`` / ``workerd.wait``).

Everything in those files that belongs to the run shares its
``trace_id`` (the run id).  Within one recorder, ``parent_id`` links
children exactly as telemetry/spans.py always has; ACROSS recorders a
segment's root carries a ``ctx_parent`` attribute naming its upstream
parent span id (iteration roots keep ``parent_id == ""`` so every
single-file consumer -- `loop trace`, the chaos span-tree invariant,
the console tail -- still sees them as roots).

The merge is defensive the way :func:`build_trees` is, and then some:

- **skew**: a record stamped ``skew_s`` (its recorder's cumulative
  clock offset to the root clock) is shifted by exactly that much and
  marked ``skew_adjusted`` -- raw timestamps stay in the file, only
  the merged rendering moves.  A child that still escapes its parent
  beyond tolerance is marked ``skew_suspect``, never re-ordered.
- **gaps**: a ``ctx_parent`` naming a span no recorder holds gets a
  synthesized ``gap`` placeholder node; an iteration that launched via
  workerd but has no worker-side segment (dead daemon, torn tail)
  gets an explicit ``gap`` child.  A dead workerd renders as a gap,
  not a broken tree.

The port's copy of ``clawker_tpu/tracing/merge.py``, whole.  Nothing in
the port writes a ``router-*`` recorder yet (federation, ROADMAP §1
item 13); the merge reads one wherever it finds it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from ..monitor.ledger import FLIGHT_DIR, flight_path, read_rotated_lines
from ..telemetry.spans import (SPAN_ITERATION, SpanNode, SpanRecord,
                               load_spans, tree_to_dict)
from .names import SPAN_GAP

# parent-encloses-child slack after skew adjustment: EWMA-smoothed
# midpoint offsets are good to ~rtt/2, and phase boundaries are stamped
# on different threads -- anything inside this window is clock noise,
# anything outside is a suspect estimate worth flagging
SKEW_TOLERANCE_S = 0.050


@dataclass
class MergeResult:
    run_id: str
    roots: list[SpanNode] = field(default_factory=list)
    spans: int = 0
    gaps: int = 0
    skew_suspects: int = 0
    sources: dict = field(default_factory=dict)     # source -> records used

    def to_dict(self) -> dict:
        return {
            "run": self.run_id, "spans": self.spans, "gaps": self.gaps,
            "skew_suspects": self.skew_suspects,
            "sources": dict(self.sources),
            "trees": [tree_to_dict(r) for r in self.roots],
        }


def _adjusted(rec: SpanRecord, source: str) -> SpanRecord:
    """Tag the record's source and apply its recorder's cumulative
    clock offset (attr ``skew_s``).  Pure: the on-disk record is not
    what renders, and the shift is auditable from the kept attrs."""
    attrs = dict(rec.attrs)
    attrs.setdefault("source", source)
    skew = float(attrs.get("skew_s") or 0.0)
    if skew:
        attrs["skew_adjusted"] = True
        return dataclasses.replace(rec, t_start=rec.t_start - skew,
                                   t_end=rec.t_end - skew, attrs=attrs)
    return dataclasses.replace(rec, attrs=attrs)


def _gap_record(run_id: str, span_id: str, *, agent: str = "",
                worker: str = "", t_start: float = 0.0,
                t_end: float = 0.0, **attrs) -> SpanRecord:
    return SpanRecord(
        trace_id=run_id, span_id=span_id, parent_id="", name=SPAN_GAP,
        agent=agent, worker=worker, t_start=t_start, t_end=t_end,
        status="ok", attrs={"gap": True, **attrs})


def merge_records(sources: dict, run_id: str) -> MergeResult:
    """``{source_name: [SpanRecord, ...]}`` -> one merged causal forest
    for ``run_id``.  Records whose trace_id differs are ignored (daemon
    recorders hold every run the daemon ever served)."""
    res = MergeResult(run_id=run_id)
    nodes: dict[str, SpanNode] = {}
    order: list[SpanNode] = []
    for source, recs in sources.items():
        used = 0
        for rec in recs:
            if rec.trace_id != run_id:
                continue
            used += 1
            rec = _adjusted(rec, source)
            if rec.span_id in nodes:
                # duplicate span_id (double flush / re-emit): keep LAST
                nodes[rec.span_id].record = rec
                continue
            node = SpanNode(rec)
            nodes[rec.span_id] = node
            order.append(node)
        if used:
            res.sources[source] = used
    res.spans = len(order)

    # ---- iteration-root index: workerd's LAUNCH-path spans cannot name
    # a parent span id (the scheduler opens the iteration root only when
    # the created event lands, AFTER the intent shipped), so they attach
    # by (agent, iteration) instead -- the one join key both sides hold.
    iter_roots: dict[tuple, SpanNode] = {}
    for node in order:
        rec = node.record
        if rec.name == SPAN_ITERATION:
            iter_roots[(rec.agent, rec.attrs.get("iteration"))] = node

    # ---- link: parent_id within a recorder, ctx_parent across them.
    # An upstream parent nothing recorded becomes a synthesized gap
    # placeholder so the segment stays ROOTED (torn router/loopd tail).
    placeholders: dict[str, SpanNode] = {}
    roots: list[SpanNode] = []
    for node in order:
        rec = node.record
        pid = rec.parent_id or str(rec.attrs.get("ctx_parent") or "")
        if not pid and rec.name.startswith("workerd."):
            host = iter_roots.get((rec.agent, rec.attrs.get("iteration")))
            if host is not None and host is not node:
                host.children.append(node)
                continue
        if not pid or nodes.get(pid) is node:
            roots.append(node)
            continue
        parent = nodes.get(pid)
        if parent is None:
            if rec.parent_id:
                # in-recorder parent lost (crashed writer): promote,
                # exactly like build_trees -- the segment still renders
                roots.append(node)
                continue
            ph = placeholders.get(pid)
            if ph is None:
                ph = SpanNode(_gap_record(
                    run_id, pid, agent=rec.agent, worker=rec.worker,
                    t_start=rec.t_start, t_end=rec.t_end,
                    expect="upstream"))
                placeholders[pid] = ph
                roots.append(ph)
            ph.record = dataclasses.replace(
                ph.record,
                t_start=min(ph.record.t_start, rec.t_start),
                t_end=max(ph.record.t_end, rec.t_end))
            ph.children.append(node)
            continue
        parent.children.append(node)
    res.gaps += len(placeholders)

    # ---- gap-mark iterations whose remote segment never arrived: the
    # scheduler's create/start children say the launch went VIA workerd
    # (attr workerd=True), so a complete trace must hold worker-side
    # spans under that root -- a dead workerd's loss is made explicit.
    from ..util import ids

    for node in order:
        rec = node.record
        if rec.name != SPAN_ITERATION:
            continue
        via, remote = "", False
        for c in node.children:
            if c.record.attrs.get("workerd"):
                via = via or c.record.worker
            if c.record.name.startswith("workerd."):
                remote = True
        if via and not remote:
            gap = SpanNode(_gap_record(
                run_id, ids.short_id(16), agent=rec.agent, worker=via,
                t_start=rec.t_start, t_end=rec.t_end, expect="workerd",
                iteration=rec.attrs.get("iteration")))
            gap.record = dataclasses.replace(gap.record,
                                             parent_id=rec.span_id)
            node.children.append(gap)
            res.gaps += 1

    # ---- monotonicity: after skew adjustment an enclosed child should
    # fall inside its parent (within tolerance).  Causal edges -- a
    # submit span linked via ctx_parent to work that outlives the RPC --
    # only promise that the effect does not precede the cause, so they
    # get the start check alone.  Launch-path children of an iteration
    # (workerd.* segments and the create/start spans that rode the
    # channel) legitimately start BEFORE their parent -- the iteration
    # root only opens when the created event lands -- so their start is
    # floored not by the parent but by the scheduler-side sibling that
    # caused them: workerd.create cannot precede create.  A skewed
    # remote clock betrays itself against that floor or by overrunning
    # the iteration's end.  A violator is FLAGGED, never re-ordered: a
    # wrong-looking time under a suspect offset is evidence, and
    # evidence does not get rewritten.
    def _audit(parent: SpanNode) -> None:
        p = parent.record
        for child in parent.children:
            c = child.record
            causal = not c.parent_id and c.attrs.get("ctx_parent")
            launch = p.name == SPAN_ITERATION and (
                c.name.startswith("workerd.") or c.attrs.get("workerd"))
            floor = p.t_start
            if launch:
                floor = None
                if c.name.startswith("workerd."):
                    base = c.name[len("workerd."):]
                    sib = next((s.record for s in parent.children
                                if s.record.name == base), None)
                    floor = sib.t_start if sib is not None else None
            if not c.attrs.get("gap") and (
                    (floor is not None
                     and c.t_start < floor - SKEW_TOLERANCE_S)
                    or (not causal
                        and c.t_end > p.t_end + SKEW_TOLERANCE_S)):
                attrs = dict(c.attrs)
                attrs["skew_suspect"] = True
                child.record = dataclasses.replace(c, attrs=attrs)
                res.skew_suspects += 1
            _audit(child)

    for node in order:
        node.children.sort(key=lambda n: (n.record.t_start, n.record.name))
    roots.sort(key=lambda n: (n.record.t_start, n.record.agent))
    for root in roots:
        _audit(root)
    res.roots = roots
    return res


def recorder_files(logs_dir: Path, run_id: str) -> dict:
    """Every recorder file that may hold a piece of this run's trace:
    ``{source_name: Path}``.  Daemon recorders are included wholesale
    (merge_records filters by trace id); missing files are fine."""
    out: dict = {}
    run_file = flight_path(logs_dir, run_id)
    if run_file.exists() or Path(str(run_file) + ".1").exists():
        out["scheduler"] = run_file
    fdir = Path(logs_dir) / FLIGHT_DIR
    for pattern, label in (("router*.jsonl", "router"),
                           ("loopd-*.jsonl", "loopd"),
                           ("workerd-*.jsonl", "workerd")):
        for p in sorted(fdir.glob(pattern)):
            if p.suffix == ".jsonl":
                out[f"{label}:{p.stem}"] = p
    return out


def merge_run(logs_dir: Path, run_id: str) -> MergeResult:
    """Discover + read + merge every recorder for ``run_id`` under
    ``logs_dir`` (rotation-aware: each recorder's ``.1`` generation is
    read first, so a rotated tail still joins)."""
    sources = {}
    for name, path in recorder_files(logs_dir, run_id).items():
        sources[name] = load_spans(read_rotated_lines(path))
    return merge_records(sources, run_id)


def hop_waits(roots: Iterable[SpanNode]) -> dict:
    """Aggregate per-hop WAN wait: ``{span_name: total_wan_ms}`` over
    every span carrying a ``wan_ms`` attribute (the submit/launch hops
    stamp it at emit time from their own round-trip measurements)."""
    waits: dict = {}
    def _walk(node: SpanNode) -> None:
        wan = node.record.attrs.get("wan_ms")
        if wan is not None:
            waits[node.record.name] = (
                waits.get(node.record.name, 0.0) + float(wan))
        for c in node.children:
            _walk(c)
    for r in roots:
        _walk(r)
    return {k: round(v, 3) for k, v in sorted(waits.items())}
