"""``monitor anomalies``: the port's copy of that verb of
``clawker_tpu/cli/cmd_monitor.py`` (:115-185), with its options,
table/JSON output and exit codes: 0 scored, 1 no scorable windows (or no
accelerator), 2 when an agent's latest z crosses ``--threshold``.  The
monitoring stack's verbs (``init``, ``up``, ``down``, ``status``,
``units``, ``egress``) are not ported yet (ROADMAP §1 item 13).
"""

from __future__ import annotations

import json
from pathlib import Path

import click

from .factory import _device


@click.group("monitor")
def monitor_group():
    """Fleet monitoring verbs."""


@monitor_group.command("anomalies")
@click.option("--input", "input_path", type=click.Path(),
              default=None, help="Egress jsonl (default: logs dir stream).")
@click.option("--window", type=click.IntRange(min=1), default=60,
              help="Window seconds.")
@click.option("--train-steps", type=click.IntRange(min=1), default=120,
              help="Autoencoder fit steps before scoring.")
@click.option("--top", type=int, default=0, help="Only the N hottest agents.")
@click.option("--threshold", type=float, default=None,
              help="Exit 2 when any agent's latest z-score crosses this.")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
def monitor_anomalies(input_path, window, train_steps, top, threshold, fmt):
    """Score per-agent egress behavior on the GPU.

    Folds the netlogger stream into per-agent windows (32-feature
    vectors), fits the fleet autoencoder on them, and reports
    reconstruction-error z-scores: the fleet's own behavior is the
    normal profile, agents that deviate surface first.
    """
    from ..analytics import runtime as art
    from ..util.xdg import logs_dir

    device = _device("anomalies")
    path = (Path(input_path) if input_path
            else logs_dir() / "ebpf-egress.jsonl")
    rep = art.score_file(path, window_s=window, train_steps=train_steps,
                         device=device)
    if rep is None:
        click.echo(f"anomalies: no scorable egress windows in {path}",
                   err=True)
        raise SystemExit(1)

    thr = threshold if threshold is not None else art.ANOMALY_Z
    agents = sorted(rep.agents, key=lambda a: -a.latest)
    if top:
        agents = agents[:top]
    hot = [a for a in rep.agents if a.latest >= thr]
    if fmt == "json":
        click.echo(json.dumps({
            "windows": len(rep.keys), "device": rep.device,
            "train_ms": round(rep.train_ms, 2),
            "score_ms": round(rep.score_ms, 2),
            "train_steps": rep.train_steps,
            "threshold": thr,
            "agents": [{
                "agent": a.agent, "windows": a.windows,
                "latest_z": round(a.latest, 3), "peak_z": round(a.peak, 3),
                "latest_window": a.latest_start,
                "anomalous": a.latest >= thr,
            } for a in agents],
        }))
    else:
        click.echo(f"{'AGENT':<28} {'WINDOWS':>7} {'LATEST-Z':>9} "
                   f"{'PEAK-Z':>8}  FLAG")
        for a in agents:
            flag = "ANOMALOUS" if a.latest >= thr else ""
            click.echo(f"{a.agent:<28.28} {a.windows:>7} {a.latest:>9.2f} "
                       f"{a.peak:>8.2f}  {flag}")
        click.echo(f"\n{len(rep.keys)} windows scored on {rep.device} "
                   f"(fit {rep.train_steps} steps {rep.train_ms:.0f} ms, "
                   f"score {rep.score_ms:.1f} ms)")
    if threshold is not None and hot:
        raise SystemExit(2)


def register(root: click.Group) -> None:
    root.add_command(monitor_group)
