"""monitor verbs: init/up/down/status/units + egress log tail, and
``anomalies``.

The port's copy of ``clawker_tpu/cli/cmd_monitor.py``, whole.
``anomalies`` scores on the GPU (``CLAWKER_TORCH_DEVICE`` picks the
device) with the reference's options, table/JSON output and exit codes:
0 scored, 1 no scorable windows (or no accelerator), 2 when an agent's
latest z crosses ``--threshold``.  Its default input is the one
``egress`` reads, ``<logs>/ebpf-egress.jsonl``.

Parity reference: internal/cmd/monitor (init/up/down/status/reload,
SURVEY.md 2.4); `up` drives docker compose over the rendered stack.
"""

from __future__ import annotations

import json
from pathlib import Path

import click

from ..monitor.stack import LOG_INDICES, MonitorStack
from .factory import Factory, _device

pass_factory = click.make_pass_decorator(Factory)


@click.group("monitor")
def monitor_group():
    """Manage the observability stack (OTel, OpenSearch, Prometheus)."""


@monitor_group.command("init")
@pass_factory
def monitor_init(f: Factory):
    """Render the compose stack + configs without starting anything."""
    path = MonitorStack(f.config).render()
    click.echo(f"rendered monitor stack under {path}")
    click.echo("indices: " + ", ".join(LOG_INDICES))


@monitor_group.command("up")
@pass_factory
def monitor_up(f: Factory):
    MonitorStack(f.config).up()
    s = f.config.settings.monitoring
    click.echo(f"monitor stack up: dashboards http://localhost:{s.dashboards_port} "
               f"prometheus http://localhost:{s.prometheus_port}")


@monitor_group.command("down")
@pass_factory
def monitor_down(f: Factory):
    MonitorStack(f.config).down()
    click.echo("monitor stack down")


@monitor_group.command("status")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@pass_factory
def monitor_status(f: Factory, fmt):
    rows = MonitorStack(f.config).status()
    if fmt == "json":
        click.echo(json.dumps(rows, indent=2))
        return
    if not rows:
        click.echo("monitor stack: not running")
        raise SystemExit(1)
    for r in rows:
        click.echo(f"{r.get('Service', r.get('Name', '?'))}\t{r.get('State', '?')}")


@monitor_group.command("units")
@pass_factory
def monitor_units(f: Factory):
    """List monitoring units: discovered (floor + loose) and seeded.

    Reference: `clawker monitor extensions` over the units ledger
    (internal/monitor/ledger.go)."""
    from ..monitor.ledger import Ledger
    from ..monitor.unit import discover_units

    stack = MonitorStack(f.config)
    units = discover_units(stack.unit_roots())
    ledger = Ledger(stack.dir)
    for name, unit in sorted(units.items()):
        seeded = ledger.units.get(name)
        state = "seeded" if seeded and seeded.content_hash == unit.content_hash() \
            else ("stale" if seeded else "unseeded")
        lanes = ",".join(l.index for l in unit.manifest.logs)
        click.echo(f"{name}\t{state}\t{lanes}\t{unit.manifest.description}")
    if not units:
        click.echo("no monitoring units discovered")


@monitor_group.command("egress")
@click.option("--tail", type=int, default=20, help="Last N egress decisions.")
@click.option("--deny-only", is_flag=True, help="Only DENY verdicts.")
@pass_factory
def monitor_egress(f: Factory, tail, deny_only):
    """Show recent kernel egress decisions (netlogger output)."""
    path = f.config.logs_dir / "ebpf-egress.jsonl"
    if not path.exists():
        click.echo("no egress log yet (is the control plane running with "
                   "the firewall enabled?)", err=True)
        raise SystemExit(1)
    records = []
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if deny_only and rec.get("verdict") != "DENY":
            continue
        records.append(rec)
    for rec in records[-tail:]:  # the NEWEST N matching decisions
        click.echo(f"{rec.get('@timestamp','')}\t{rec.get('verdict','')}\t"
                   f"{rec.get('container') or rec.get('cgroup_id')}\t"
                   f"{rec.get('dst_ip')}:{rec.get('dst_port')}\t"
                   f"{rec.get('zone') or '-'}\t{rec.get('reason','')}")


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
