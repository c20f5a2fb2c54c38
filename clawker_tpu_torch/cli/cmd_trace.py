"""``trace [RUN] [--json]``: the port's copy of
``clawker_tpu/cli/cmd_trace.py``.
"""

from __future__ import annotations

import json
from pathlib import Path

import click

from .factory import Factory, _factory


def _trace_run_id(f: Factory, run: str | None) -> str:
    """A run id from an id, an unambiguous prefix, a flight-recorder
    path, or (when omitted) the newest scheduler recorder."""
    from ..monitor.ledger import FLIGHT_DIR

    flight_dir = f.config.logs_dir / FLIGHT_DIR
    if run:
        as_path = Path(run)
        if as_path.is_file():
            return as_path.stem.removeprefix("loop-")
        matches = sorted(flight_dir.glob(f"loop-{run}*.jsonl"))
        if len(matches) == 1:
            return matches[0].stem.removeprefix("loop-")
        if matches:
            names = ", ".join(m.stem.removeprefix("loop-") for m in matches)
            raise click.ClickException(f"run {run!r} is ambiguous: {names}")
        return run      # daemon recorders may hold it without a local file
    latest = max(flight_dir.glob("loop-*.jsonl"), default=None,
                 key=lambda p: p.stat().st_mtime)
    if latest is None:
        raise click.ClickException(
            f"no flight records under {flight_dir} (runs record one by "
            "default; check settings telemetry.flight_recorder)")
    return latest.stem.removeprefix("loop-")


def _trace_flags(rec) -> str:
    out = []
    wan = rec.attrs.get("wan_ms")
    if wan is not None:
        out.append(f"wan={float(wan):.1f}ms")
    if rec.attrs.get("skew_adjusted"):
        out.append(f"skew={float(rec.attrs.get('skew_s', 0.0)) * 1000:+.1f}ms")
    if rec.attrs.get("skew_suspect"):
        out.append("SKEW-SUSPECT")
    if rec.attrs.get("gap"):
        out.append(f"GAP(expect={rec.attrs.get('expect', '?')})")
    if rec.status not in ("ok", ""):
        out.append(rec.status)
    return "  ".join(out)


def _trace_render(node, t0: float, depth: int, out: list[str]) -> None:
    rec = node.record
    label = (f"iteration {rec.attrs.get('iteration', '?')}"
             if rec.name == "iteration" else rec.name)
    who = rec.agent or rec.worker or "-"
    src = rec.attrs.get("source", "")
    off = (rec.t_start - t0) * 1000.0
    wall = rec.wall_s * 1000.0
    flags = _trace_flags(rec)
    out.append(f"  {'  ' * depth}{label:<24} {who:<14} "
               f"{src:<18} +{off:>8.1f}ms {wall:>9.1f}ms"
               + (f"  {flags}" if flags else ""))
    for child in node.children:
        _trace_render(child, t0, depth + 1, out)


@click.command("trace")
@click.argument("run", required=False)
@click.option("--json", "as_json", is_flag=True,
              help="Merged trace forest as JSON.")
@click.pass_context
def trace_cmd(ctx, run, as_json):
    """Cross-process trace waterfall for a loop run.

    RUN is a loop id (as printed by `loop`), an unambiguous id prefix,
    or a path to a flight-recorder JSONL file; the newest run is traced
    when omitted.  Joins the router/loopd/scheduler/workerd flight
    recorders into one causal tree per iteration (docs/tracing.md):
    per-hop WAN wait, clock-skew-adjusted offsets, explicit gap spans
    where a daemon's segment is missing.
    """
    from ..tracing.merge import hop_waits, merge_run

    f = _factory(ctx)
    run_id = _trace_run_id(f, run)
    res = merge_run(f.config.logs_dir, run_id)
    if as_json:
        click.echo(json.dumps(res.to_dict(), indent=2))
        return
    if not res.roots:
        raise click.ClickException(
            f"no spans for run {run_id!r} in any recorder under "
            f"{f.config.logs_dir}")
    srcs = ", ".join(f"{k}={v}" for k, v in sorted(res.sources.items()))
    click.echo(f"run {run_id}: {res.spans} span(s) from [{srcs}]")
    if res.gaps or res.skew_suspects:
        click.echo(f"  {res.gaps} gap(s), "
                   f"{res.skew_suspects} skew suspect(s)")
    t0 = min(r.record.t_start for r in res.roots)
    out: list[str] = []
    for root in res.roots:
        _trace_render(root, t0, 0, out)
    for line in out:
        click.echo(line)
    waits = hop_waits(res.roots)
    if waits:
        click.echo("per-hop WAN wait:")
        for name, ms in waits.items():
            click.echo(f"  {name:<24} {ms:>9.1f}ms")


def register(root: click.Group) -> None:
    root.add_command(trace_cmd)
