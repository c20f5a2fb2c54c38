"""``fleet workers|provision|status|health|placement|warmpool|anomaly|
console``: the port's copy of ``clawker_tpu/cli/cmd_fleet.py``.  ``fleet
anomaly`` (:761-900) exits 0 scored, 1 no scorable windows (or no accelerator), 2
when an agent's window flags; its sentinel tails the configured driver's
workers with settings ``sentinel``'s defaults under the flags, and with
a loopd answering, the one-shot renders the daemon sentinel's rows
(:123-140,806-822).  ``fleet workers|provision|status`` are the
reference's (:23-121,973-996).  ``fleet console``
is :901-972.  ``fleet health``, ``placement`` and ``warmpool`` (:123-760)
read a loopd's status RPC when one answers (``health`` then shows the
daemon sentinel's ANOM-Z a worker), else probe the driver's workers.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import click

from .factory import _device, _factory, _project


@click.group("fleet")
def fleet_group():
    """Fleet-wide verbs."""


_ANOMALY_COLUMNS = ("AGENT", "WORKER", "WINDOWS", "LATEST-Z", "PEAK-Z",
                    "RECORDS", "FLAG")


def _transports(f):
    """One SSH transport per discovered pod worker, in pod order
    (``clawker_tpu/cli/cmd_fleet.py:23-35``)."""
    from ..fleet.inventory import discover_workers
    from ..fleet.transport import SSHTransport

    tpu = f.config.settings.runtime.tpu
    hosts = discover_workers(tpu)
    if not hosts:
        raise click.ClickException(
            "no TPU workers configured (runtime.tpu.workers / runtime.tpu.pod)"
        )
    mux = f.config.ssh_mux_dir
    return [SSHTransport(tpu, h, i, mux_dir=mux) for i, h in enumerate(hosts)]


@fleet_group.command("workers")
@click.pass_context
def fleet_workers(ctx):
    """List the pod's worker hosts in pod order."""
    from ..fleet.inventory import discover_workers

    hosts = discover_workers(_factory(ctx).config.settings.runtime.tpu)
    for i, h in enumerate(hosts):
        click.echo(f"{i}\t{h}")
    if not hosts:
        raise SystemExit(1)


@fleet_group.command("provision")
@click.option("--dry-run", is_flag=True, help="Print the plan, touch nothing.")
@click.option("--no-firewall", is_flag=True, help="Skip the eBPF/kernel half.")
@click.option("--no-cp", is_flag=True, help="Skip the per-worker control plane.")
@click.option("--worker", "only", type=int, default=-1,
              help="Provision a single worker index.")
@click.option("--jobs", "-j", type=int, default=8,
              help="Concurrent worker provisions (bounded pool).")
@click.pass_context
def fleet_provision(ctx, dry_run, no_firewall, no_cp, only, jobs):
    """Install the worker stack (native bits, eBPF, control plane).

    Workers provision concurrently (one payload tar shared by all);
    step results stream as they land, prefixed with the worker index.
    """
    from ..fleet.provision import build_plan, provision_fleet

    f = _factory(ctx)
    plan = build_plan(with_firewall=not no_firewall, with_cp=not no_cp)
    if dry_run:
        for step in plan:
            opt = " (optional)" if step.optional else ""
            click.echo(f"{step.name}{opt}\n    {step.cmd}")
        return
    repo_root = Path(__file__).resolve().parents[2]
    transports = _transports(f)
    if only >= 0:
        chosen = [t for t in transports if t.index == only]
        if not chosen:
            valid = ", ".join(str(t.index) for t in transports)
            raise click.ClickException(
                f"--worker {only}: no such worker index (valid: {valid})")
        transports = chosen

    echo_lock = threading.Lock()   # step lines land from worker threads

    def on_step(index, r):
        mark = "+" if r.ok else "!"
        with echo_lock:
            click.echo(f"worker {index}: {mark} {r.name}"
                       + (f": {r.detail}" if r.detail else ""))

    def on_report(report):
        """Per-worker summary the moment THAT worker finishes: a slow
        worker must not hold back the fast workers' verdicts."""
        if report.ok:
            line = f"worker {report.index} ({report.host}): ok"
        else:
            # the streamed '!' line may be interleaved far above: the
            # summary must carry the failure on its own
            bad = next((r for r in report.results if not r.ok), None)
            why = ""
            if bad is not None:
                why = f" at {bad.name}" + (f": {bad.detail}" if bad.detail else "")
            line = f"worker {report.index} ({report.host}): FAILED{why}"
        with echo_lock:
            click.echo(line)

    reports = provision_fleet(
        transports, repo_root,
        with_firewall=not no_firewall, with_cp=not no_cp,
        monitor=f.config.settings.monitoring.enable,
        max_workers=max(1, jobs), on_step=on_step, on_report=on_report)
    if any(not r.ok for r in reports):
        raise SystemExit(1)


@fleet_group.command("status")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]), default="table")
@click.pass_context
def fleet_status(ctx, fmt):
    """Per-worker daemon + control-plane health over SSH."""
    from .. import consts

    rows = []
    for t in _transports(_factory(ctx)):
        docker = t.run("docker info --format '{{.ServerVersion}}'", timeout=20.0)
        cp = t.run(
            f"curl -fsS -m 3 http://127.0.0.1:{consts.CP_HEALTH_PORT}/healthz",
            timeout=20.0,
        )
        rows.append({
            "worker": t.index, "host": t.host,
            "docker": docker.out.strip() if docker.rc == 0 else "DOWN",
            "control_plane": "ok" if cp.rc == 0 else "DOWN",
        })
    if fmt == "json":
        click.echo(json.dumps(rows, indent=2))
        return
    for r in rows:
        click.echo(f"{r['worker']}\t{r['host']}\tdocker={r['docker']}\tcp={r['control_plane']}")


_HEALTH_COLUMNS = ("WORKER", "STATE", "BRK", "WORKERD", "STORAGE", "P50MS",
                   "P95MS", "PROBES", "FAILS", "ORPHANED", "MIG-OUT",
                   "MIG-IN", "LAST-ERROR")


def _storage_verdict(doc: dict | None) -> str:
    """Compact STORAGE cell from a loopd status doc: the worst WAL
    durability across hosted runs (ok|degraded|failed,
    docs/durability.md) with the disk-pressure ladder level appended
    when the daemon is shedding (``/p1``) or GC-ing (``/p2``)."""
    if not doc:
        return "-"
    worst = "ok"
    for r in doc.get("runs") or []:
        d = (r.get("storage") or {}).get("durability")
        if d == "failed":
            worst = "failed"
            break
        if d == "degraded":
            worst = "degraded"
    stor = doc.get("storage") or {}
    wal = stor.get("capacity_wal") or {}
    if worst == "ok" and wal and not wal.get("healthy", True):
        worst = "degraded"
    level = int((stor.get("pressure") or {}).get("level") or 0)
    return f"{worst}/p{level}" if level else worst


def _health_rows(stats: list[dict], anom: dict | None = None,
                 workerd: dict | None = None,
                 storage: str = "-") -> list[str]:
    # BRK is the registry's health_breaker_state gauge (0=closed
    # 1=half_open 2=open) -- the same value a Prometheus scrape of
    # `clawker loop --metrics-port` serves (docs/telemetry.md).
    # WORKERD is the worker-resident launch daemon's liveness
    # (docs/workerd.md): `degraded` means the socket exists but nothing
    # answers -- that worker's data plane silently fell back to the WAN
    # path, visibly slower while every breaker still reads healthy.
    # ``anom`` (worker -> hottest sentinel z, from a loopd-hosted
    # sentinel) appends the live ANOM-Z column (docs/analytics-online.md)
    cols = _HEALTH_COLUMNS + (("ANOM-Z",) if anom is not None else ())
    lines = ["\t".join(cols)]
    for s in stats:
        row = [str(x) for x in (
            s["worker"], s["state"], s["breaker_state_gauge"],
            (workerd or {}).get(s["worker"], "absent"), storage,
            s["probe_p50_ms"], s["probe_p95_ms"],
            s["probes"], s["probe_failures"], s["orphaned"],
            s["migrations_out"], s["migrations_in"],
            (s["last_error"] or "-")[:60])]
        if anom is not None:
            z = anom.get(s["worker"])
            row.append("-" if z is None else f"{z:.2f}")
        lines.append("\t".join(row))
    return lines


def _sentinel_anom_by_worker(doc: dict | None) -> dict | None:
    """worker -> hottest latest z from a loopd status doc's sentinel
    rows; None when the daemon hosts no sentinel."""
    rows = ((doc or {}).get("sentinel") or {}).get("rows")
    if not rows:
        return None
    out: dict = {}
    for r in rows:
        wid = r.get("worker") or ""
        z = float(r.get("latest_z", 0.0))
        if wid and (wid not in out or z > out[wid]):
            out[wid] = z
    return out


@fleet_group.command("health")
@click.option("--probes", type=int, default=3,
              help="Probe rounds before the one-shot verdict.")
@click.option("--watch", is_flag=True,
              help="Keep probing and re-print the table every interval.")
@click.option("--interval", type=float, default=2.0,
              help="Probe/refresh interval seconds (with --watch).")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
@click.option("--no-daemon", is_flag=True,
              help="Probe directly even when a loopd daemon is running.")
@click.pass_context
def fleet_health(ctx, probes, watch, interval, fmt, no_daemon):
    """Per-worker breaker state, probe latency, and failover counters.

    With a loopd daemon running (docs/loopd.md) this renders the
    daemon's LIVE breakers over its status RPC -- the breakers actual
    placements use -- instead of a fresh CLI-side probe round.
    Otherwise probes every worker of the active runtime driver through
    the same probe hook and circuit breakers `loop --failover`
    uses (docs/fleet-health.md).  One-shot by default: exits non-zero
    when any worker's breaker is not closed.
    """
    f = _factory(ctx)
    import json as _json
    import time as _time

    from ..health import BreakerConfig, HealthConfig, HealthMonitor

    from ..workerd import liveness as workerd_liveness

    if not watch:
        doc = _loopd_status(f, no_daemon)
        if doc is not None:
            stats = doc.get("health", [])
            anom = _sentinel_anom_by_worker(doc)
            wd = doc.get("workerd") or {}
            storage = _storage_verdict(doc)
            if fmt == "json":
                out = {"source": f"loopd:{doc.get('pid')}", "health": stats,
                       "workerd": wd,
                       "storage": {"verdict": storage,
                                   **(doc.get("storage") or {})}}
                if doc.get("sentinel"):
                    out["sentinel"] = doc["sentinel"]
                click.echo(_json.dumps(out, indent=2))
            else:
                click.echo(f"source: loopd (pid {doc.get('pid')}, "
                           f"{len(doc.get('runs', []))} hosted run(s))",
                           err=True)
                for line in _health_rows(stats, anom, wd, storage):
                    click.echo(line)
            if any(s["state"] != "closed" for s in stats):
                raise SystemExit(1)
            return

    # one-shot: the breaker must be able to open within the rounds the
    # user asked for, or `--probes 1` would report a dead fleet healthy
    threshold = (BreakerConfig.failure_threshold if watch
                 else max(1, min(BreakerConfig.failure_threshold, probes)))
    cfg = HealthConfig(probe_interval_s=max(0.1, interval),
                       probe_deadline_s=max(1.0, min(interval, 5.0)),
                       breaker=BreakerConfig(failure_threshold=threshold,
                                             backoff_base_s=max(0.5, interval)))
    mon = HealthMonitor(f.driver, config=cfg)

    def emit() -> list[dict]:
        # liveness probed per emit, not once: under --watch a workerd
        # dying mid-session must flip the column to `degraded`, which
        # is the whole reason the column exists
        wd = workerd_liveness(f.config, f.driver)
        stats = mon.stats()
        if fmt == "json":
            for s in stats:
                s["workerd"] = wd.get(s["worker"], "absent")
            click.echo(_json.dumps(stats, indent=2))
        else:
            for line in _health_rows(stats, None, wd):
                click.echo(line)
        return stats

    if watch:
        try:
            while True:
                mon.probe_all()
                emit()
                _time.sleep(max(0.1, interval))
        except KeyboardInterrupt:
            return
    for _ in range(max(1, probes)):
        mon.probe_all()
    stats = emit()
    if any(s["state"] != "closed" for s in stats):
        raise SystemExit(1)


_PLACEMENT_COLUMNS = ("WORKER", "STATE", "COORD", "GROUP", "P50MS",
                      "WEIGHT", "SLOTS", "TOKENS", "REJECTS")


@fleet_group.command("placement")
@click.option("--policy", type=click.Choice(["spread", "pack", "topology"]),
              default=None,
              help="Policy to preview (default: settings "
                   "loop.placement.policy).")
@click.option("--slots", type=int, default=0,
              help="Loop slots to plan in the preview (default: settings "
                   "loop.parallel).")
@click.option("--probes", type=int, default=1,
              help="Probe rounds before planning (latency weights and "
                   "breaker states come from these).")
@click.option("--metrics-url", default="",
              help="Scrape a running loop's --metrics-port endpoint "
                   "(e.g. http://127.0.0.1:9464/metrics) for live queue "
                   "depth, in-flight tokens, and rejection counts.")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
@click.option("--no-daemon", is_flag=True,
              help="Probe directly even when a loopd daemon is running.")
@click.pass_context
def fleet_placement(ctx, policy, slots, probes, metrics_url, fmt,
                    no_daemon):
    """Placement & admission view: per-worker tokens, shares, queue depth.

    With a loopd daemon running (docs/loopd.md) the breakers, probe
    latencies, token counts, and tenant queues come straight off the
    daemon's status RPC -- the LIVE admission state every concurrent
    run bills against -- instead of a fresh CLI-side probe round.
    When the daemon hosts an elastic-capacity controller
    (docs/elastic-capacity.md) the view adds its live state: the
    SLO-scaled token cap per worker, shed/queueing mode with the
    current retry_after_s, and per-tenant SLO headroom.
    Otherwise probes every worker of the active runtime driver (the
    same breakers `clawker loop` places against), derives the pod
    topology, and shows how the chosen policy would spread N loop
    slots -- plus the admission token/queue configuration and
    per-tenant fairness shares (docs/loop-placement.md).  With
    ``--metrics-url`` pointing at a live run's metrics port, the
    static view is joined by the run's actual queue depths and
    in-flight token counts.
    """
    f = _factory(ctx)
    import json as _json
    from collections import Counter

    from ..engine.drivers import Worker
    from ..fleet.inventory import pod_topology
    from ..health import BREAKER_CLOSED, BreakerConfig, HealthConfig, HealthMonitor
    from ..placement import PlacementContext, get_policy

    settings = f.config.settings
    pdef = settings.loop.placement
    policy_name = policy or pdef.policy
    n_slots = slots or settings.loop.parallel
    daemon_doc = _loopd_status(f, no_daemon) if not metrics_url else None
    if daemon_doc is not None:
        hstats = daemon_doc.get("health", [])
        astats = daemon_doc.get("admission", {})
        # plan preview over the DAEMON's breakers/latency: engine-less
        # stand-in workers are fine, policies only read ids/indices
        workers = [Worker(id=s["worker"], index=i, hostname=s["worker"])
                   for i, s in enumerate(hstats)]
        breaker = {s["worker"]: s["state"] for s in hstats}
        lat = {s["worker"]: s.get("probe_p50_ms", 0.0) / 1000.0
               for s in hstats}
        topo = pod_topology(settings.runtime.tpu, len(workers))
        ctx = PlacementContext(
            workers=workers,
            breaker_state=lambda wid: breaker.get(wid, BREAKER_CLOSED),
            latency_s=lambda wid: lat.get(wid, 0.0), topology=topo)
        eng = get_policy(policy_name)
        try:
            plan = Counter(w.id for w in eng.plan(ctx, n_slots))
        except Exception as e:      # noqa: BLE001 -- preview must render
            plan = Counter()
            click.echo(f"plan: {e}", err=True)
        aworkers = astats.get("workers", {})
        cap = astats.get("max_inflight_per_worker",
                         pdef.max_inflight_per_worker)
        rows = []
        for w in workers:
            coord = topo.coords.get(w.index) if topo.known else None
            aw = aworkers.get(w.id, {})
            rows.append({
                "worker": w.id,
                "state": breaker.get(w.id, "closed"),
                "coord": f"{coord[0]},{coord[1]}" if coord else "-",
                "group": topo.group_of(w.index) if topo.known else "-",
                "probe_p50_ms": round(lat.get(w.id, 0.0) * 1000, 2),
                "weight": round(ctx.weight(w.id), 2),
                "planned_slots": plan.get(w.id, 0),
                "tokens": f"{aw.get('inflight', 0)}"
                          f"/{aw.get('capacity', cap)}",
                "rejections": aw.get("rejected", 0),
            })
        cstats = daemon_doc.get("capacity") or {}
        if cstats.get("enabled"):
            # live adaptive state joins the static columns: the token
            # cap each worker's bucket was scaled to, and whether its
            # queue is shedding (docs/elastic-capacity.md)
            for r in rows:
                cw = (cstats.get("workers") or {}).get(r["worker"]) or {}
                r["scaled_cap"] = cw.get("token_cap", 0)
                r["shed_retry_after_s"] = cw.get("shed_retry_after_s", 0.0)
        doc = {
            "source": f"loopd:{daemon_doc.get('pid')}",
            "policy": policy_name,
            "slots": n_slots,
            "topology": ({"rows": topo.rows, "cols": topo.cols}
                         if topo.known else None),
            "admission": {
                "max_inflight_per_worker": cap,
                "max_pending_per_worker": astats.get(
                    "max_pending_per_worker", pdef.max_pending_per_worker),
            },
            "tenants": {
                t: {"weight": s["weight"], "queue_depth": s["queued"],
                    "inflight": s["inflight"],
                    "dispatched": s["dispatched"]}
                for t, s in astats.get("tenants", {}).items()},
            "workers": rows,
        }
        if cstats.get("enabled"):
            doc["capacity"] = cstats
        # per-run git firewall summary (docs/git-policy.md): which runs
        # have a gitguard up, the egress rule set it installed (the
        # ssh/git lane pins + guarded https hosts), and its decision
        # tallies -- the placement view doubles as the "is the only git
        # path the guarded one" check
        grows = [{"run": r.get("run"), **(r.get("gitguard") or {})}
                 for r in daemon_doc.get("runs", [])
                 if (r.get("gitguard") or {}).get("enabled")]
        if grows:
            doc["gitguard"] = grows
        if fmt == "table":
            click.echo(f"source: loopd (pid {daemon_doc.get('pid')}, "
                       f"{len(daemon_doc.get('runs', []))} hosted "
                       "run(s))", err=True)
        _render_placement(doc, topo, fmt)
        return
    # same clamp as fleet health: the breaker must be able to open
    # within the probe rounds requested, or --probes 1 would preview a
    # dead fleet as healthy (and plan slots onto it)
    threshold = max(1, min(BreakerConfig.failure_threshold, probes))
    mon = HealthMonitor(f.driver, config=HealthConfig(
        breaker=BreakerConfig(failure_threshold=threshold)))
    for _ in range(max(1, probes)):
        mon.probe_all()
    workers = mon.workers
    topo = pod_topology(settings.runtime.tpu, len(workers))
    ctx = PlacementContext(
        workers=workers, breaker_state=mon.state,
        latency_s=mon.latency_p50_s, topology=topo)
    eng = get_policy(policy_name)
    try:
        plan = Counter(w.id for w in eng.plan(ctx, n_slots))
    except Exception as e:      # noqa: BLE001 -- preview must still render
        plan = Counter()
        click.echo(f"plan: {e}", err=True)
    live = _scrape_placement_metrics(metrics_url) if metrics_url else {}
    rows = []
    for w in workers:
        coord = topo.coords.get(w.index) if topo.known else None
        rows.append({
            "worker": w.id,
            "state": mon.state(w.id),
            "coord": f"{coord[0]},{coord[1]}" if coord else "-",
            "group": topo.group_of(w.index) if topo.known else "-",
            "probe_p50_ms": round(mon.latency_p50_s(w.id) * 1000, 2),
            "weight": round(ctx.weight(w.id), 2),
            "planned_slots": plan.get(w.id, 0),
            "tokens": (f"{live['inflight'].get(w.id, 0)}"
                       f"/{pdef.max_inflight_per_worker}" if live
                       else f"-/{pdef.max_inflight_per_worker}"),
            "rejections": live.get("rejections", {}).get(w.id, 0)
            if live else 0,
        })
    doc = {
        "policy": policy_name,
        "slots": n_slots,
        "topology": ({"rows": topo.rows, "cols": topo.cols}
                     if topo.known else None),
        "admission": {
            "max_inflight_per_worker": pdef.max_inflight_per_worker,
            "max_pending_per_worker": pdef.max_pending_per_worker,
        },
        "tenants": ({t: {"queue_depth": d}
                     for t, d in live.get("queue_depth", {}).items()}
                    if live else
                    {pdef.tenant: {"weight": pdef.tenant_weight,
                                   "max_inflight": pdef.tenant_max_inflight}}),
        "workers": rows,
    }
    _render_placement(doc, topo, fmt)


def _render_placement(doc: dict, topo, fmt: str) -> None:
    """Shared render + exit contract for both placement sources (CLI
    probe round and loopd status RPC): exits non-zero when any worker's
    breaker is not closed, in both formats, so CI gates identically."""
    import json as _json

    rows = doc["workers"]
    adm = doc["admission"]
    unhealthy = any(r["state"] != "closed" for r in rows)
    if fmt == "json":
        click.echo(_json.dumps(doc, indent=2))
        if unhealthy:
            raise SystemExit(1)
        return
    click.echo(f"policy={doc['policy']} slots={doc['slots']} "
               f"topology={'%dx%d' % (topo.rows, topo.cols) if topo.known else 'unknown (spread fallback)'} "
               f"admission={adm['max_inflight_per_worker']} in-flight / "
               f"{adm['max_pending_per_worker']} pending per worker")
    lines = ["\t".join(_PLACEMENT_COLUMNS)]
    for r in rows:
        lines.append("\t".join(str(x) for x in (
            r["worker"], r["state"], r["coord"], r["group"],
            r["probe_p50_ms"], r["weight"], r["planned_slots"],
            r["tokens"], r["rejections"])))
    for line in lines:
        click.echo(line)
    for t, info in doc["tenants"].items():
        pairs = " ".join(f"{k}={v}" for k, v in info.items())
        click.echo(f"tenant {t}: {pairs}")
    cstats = doc.get("capacity")
    if cstats:
        # the elastic controller's live view (docs/elastic-capacity.md):
        # scaled token caps, shed state, and per-tenant SLO headroom
        click.echo(f"capacity: slo={cstats.get('slo_s') or 'off'} "
                   f"ticks={cstats.get('ticks', 0)} "
                   f"autoscale={'on' if (cstats.get('autoscale') or {}).get('enabled') else 'off'}")
        for wid, cw in sorted((cstats.get("workers") or {}).items()):
            shed = cw.get("shed_retry_after_s", 0.0)
            click.echo(
                f"  {wid}\tcap={cw.get('token_cap') or '-'}\t"
                f"rate={cw.get('arrival_rate', 0.0)}/s\t"
                + (f"SHED retry_after={shed}s" if shed else "queueing"))
        for t, info in sorted((cstats.get("tenants") or {}).items()):
            click.echo(f"  slo {t}: {info.get('slo_s')}s "
                       f"headroom={info.get('headroom_s')}s")
    for g in doc.get("gitguard") or []:
        dec = g.get("decisions") or {}
        tallies = " ".join(f"{k}={v}" for k, v in sorted(dec.items()))
        click.echo(f"gitguard {g.get('run')}: "
                   f"{'up' if g.get('running') else 'DOWN (fail-closed)'}"
                   f" hosts={','.join(g.get('hosts') or []) or '-'}"
                   + (f" {tallies}" if tallies else ""))
        for key in g.get("rules") or []:
            click.echo(f"  rule {key}")
    if unhealthy:
        raise SystemExit(1)


def _scrape_placement_metrics(url: str) -> dict:
    """Pull placement_* gauges/counters off a live run's Prometheus
    endpoint; {} when unreachable (the static view still renders)."""
    from urllib import request as urlrequest

    try:
        with urlrequest.urlopen(url, timeout=3.0) as r:
            text = r.read().decode()
    except Exception as e:      # noqa: BLE001
        click.echo(f"metrics scrape failed: {e}", err=True)
        return {}
    out: dict = {"inflight": {}, "queue_depth": {}, "rejections": {}}
    wanted = {
        "placement_inflight_launches": ("inflight", "worker"),
        "placement_queue_depth": ("queue_depth", "tenant"),
        "admission_rejections_total": ("rejections", "worker"),
    }
    for line in text.splitlines():
        if line.startswith("#") or "{" not in line:
            continue
        name, _, rest = line.partition("{")
        key = wanted.get(name)
        if key is None:
            continue
        labels_raw, _, value = rest.partition("}")
        labels = dict(
            p.split("=", 1) for p in labels_raw.split(",") if "=" in p)
        label = labels.get(key[1], "").strip('"')
        try:
            out[key[0]][label] = int(float(value.strip()))
        except ValueError:
            continue
    return out


@fleet_group.command("warmpool")
@click.option("--metrics-url", default="",
              help="Scrape a running loop's --metrics-port endpoint for "
                   "live per-worker pool depth and hit/miss/refill "
                   "counters.")
@click.option("--run", "run_ref", default="",
              help="Replay a run journal (id, unambiguous prefix, or "
                   "path) and show its journaled pool membership.")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
@click.option("--no-daemon", is_flag=True,
              help="Skip loopd discovery; settings/metrics/journal only.")
@click.pass_context
def fleet_warmpool(ctx, metrics_url, run_ref, fmt, no_daemon):
    """Warm-pool view: settings, live depth/hit counters, membership.

    The warm pool keeps pre-created agent containers per worker that
    loop placements adopt instead of paying a full create
    (docs/loop-warmpool.md).  With a loopd daemon running
    (docs/loopd.md) this shows every hosted run's live pool state over
    the status RPC -- including the elastic controller's adaptive
    TARGET/ACTUAL depth and arrival rate per worker when capacity is
    enabled (docs/elastic-capacity.md); with ``--metrics-url``
    pointing at a live run's metrics port it shows the run's actual
    per-worker depth and hit/miss/refill counters; with ``--run`` it
    replays that run's journal and lists every pool member's journaled
    state (what a ``--resume`` would restore or sweep).
    """
    f = _factory(ctx)
    import json as _json

    wps = f.config.settings.loop.warm_pool
    doc: dict = {
        "settings": {
            "enable": wps.enable,
            "depth": wps.depth,
            "max_age_s": wps.max_age_s,
            "tenant_weight": wps.tenant_weight,
        },
    }
    if not metrics_url and not run_ref:
        daemon_doc = _loopd_status(f, no_daemon)
        if daemon_doc is not None:
            doc["source"] = f"loopd:{daemon_doc.get('pid')}"
            doc["daemon_pools"] = daemon_doc.get("warm_pools", {})
            cstats = daemon_doc.get("capacity") or {}
            if cstats.get("enabled"):
                doc["capacity"] = cstats
    if metrics_url:
        doc["live"] = _scrape_warmpool_metrics(metrics_url)
    if run_ref:
        from .cmd_loop import _resolve_journal
        from ..loop.journal import RunJournal, replay

        image = replay(RunJournal.read(_resolve_journal(f, run_ref)))
        doc["run"] = image.run_id
        doc["members"] = [
            {"agent": m.agent, "worker": m.worker, "cid": m.cid[:12],
             "state": m.state,
             **({"adopted_by": m.adopted_by} if m.adopted_by else {})}
            for m in image.pool.values()
        ]
    if fmt == "json":
        click.echo(_json.dumps(doc, indent=2))
        return
    s = doc["settings"]
    click.echo(f"warm-pool: enable={s['enable']} depth={s['depth']} "
               f"max_age_s={s['max_age_s']} "
               f"tenant_weight={s['tenant_weight']}")
    pools = doc.get("daemon_pools")
    if pools is not None:
        click.echo(f"source: {doc.get('source')}", err=True)
        if not pools:
            click.echo("no pooled runs hosted by loopd")
        for run_id, st in sorted(pools.items()):
            click.echo(f"run {run_id}: target_depth={st['target_depth']}"
                       + (" (adaptive)" if st.get("adaptive") else "")
                       + f" hits={st['hits']} misses={st['misses']} "
                       f"refills={st['refills']} recycled={st['recycled']}")
            # TARGET is the live (possibly capacity-adapted) per-worker
            # target; ACTUAL the adoptable depth right now
            for wid, w in sorted(st.get("workers", {}).items()):
                click.echo(f"  {wid}\ttarget={w.get('target', st['target_depth'])}\t"
                           f"ready={w['ready']}\t"
                           f"inflight={w['inflight']}")
    cstats = doc.get("capacity")
    if cstats:
        click.echo(f"capacity: slo={cstats.get('slo_s') or 'off'} "
                   f"ticks={cstats.get('ticks', 0)}")
        for wid, cw in sorted((cstats.get("workers") or {}).items()):
            click.echo(f"  {wid}\tTARGET={cw.get('pool_target', 0)}\t"
                       f"ACTUAL={cw.get('pool_ready', 0)}\t"
                       f"cap={cw.get('token_cap') or '-'}\t"
                       f"rate={cw.get('arrival_rate', 0.0)}/s")
    live = doc.get("live")
    if live is not None:
        click.echo("WORKER\tDEPTH\tHITS\tMISSES\tREFILLS\tRECYCLED")
        workers = sorted(set(live["depth"]) | set(live["hits"])
                         | set(live["misses"]) | set(live["refills"]))
        for w in workers:
            click.echo("\t".join(str(x) for x in (
                w, live["depth"].get(w, 0), live["hits"].get(w, 0),
                live["misses"].get(w, 0), live["refills"].get(w, 0),
                live["recycled"].get(w, 0))))
    for m in doc.get("members", []):
        by = f" by={m['adopted_by']}" if m.get("adopted_by") else ""
        click.echo(f"member {m['agent']}\t{m['worker']}\t{m['cid']}\t"
                   f"{m['state']}{by}")


def _scrape_warmpool_metrics(url: str) -> dict:
    """Pull warm_pool_* gauges/counters off a live run's Prometheus
    endpoint; zeroed tables when unreachable (settings still render)."""
    from urllib import request as urlrequest

    out: dict = {"depth": {}, "hits": {}, "misses": {}, "refills": {},
                 "recycled": {}}
    try:
        with urlrequest.urlopen(url, timeout=3.0) as r:
            text = r.read().decode()
    except Exception as e:      # noqa: BLE001
        click.echo(f"metrics scrape failed: {e}", err=True)
        return out
    wanted = {
        "warm_pool_depth": "depth",
        "warm_pool_hits_total": "hits",
        "warm_pool_misses_total": "misses",
        "warm_pool_refills_total": "refills",
        "warm_pool_recycled_total": "recycled",
    }
    for line in text.splitlines():
        if line.startswith("#") or "{" not in line:
            continue
        name, _, rest = line.partition("{")
        key = wanted.get(name)
        if key is None:
            continue
        labels_raw, _, value = rest.partition("}")
        labels = dict(
            p.split("=", 1) for p in labels_raw.split(",") if "=" in p)
        worker = labels.get("worker", "").strip('"')
        try:
            val = int(float(value.strip()))
        except ValueError:
            continue
        # recycled carries a reason label too: sum per worker
        out[key][worker] = out[key].get(worker, 0) + val
    return out


@fleet_group.command("anomaly")
@click.option("--watch", is_flag=True,
              help="Keep scoring and re-print the table every interval.")
@click.option("--interval", type=float, default=None,
              help="Scoring tick seconds with --watch (default: settings "
                   "sentinel.interval_s).")
@click.option("--ticks", type=int, default=0,
              help="With --watch: stop after N ticks (0 = until Ctrl-C).")
@click.option("--window", type=int, default=None,
              help="Window seconds (default: settings sentinel.window_s).")
@click.option("--train-steps", type=int, default=None,
              help="Denoising fit steps per tick (default: settings "
                   "sentinel.train_steps).")
@click.option("--threshold", type=float, default=None,
              help="Worker-relative robust z past which an agent flags "
                   "(default: settings sentinel.threshold).")
@click.option("--stream", "streams", multiple=True, metavar="WORKER=PATH",
              help="Extra local stream source(s): tail PATH as WORKER's "
                   "egress jsonl (besides the fleet's own streams).")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table")
@click.option("--no-daemon", is_flag=True,
              help="Score locally even when a loopd daemon hosts a "
                   "sentinel.")
@click.pass_context
def fleet_anomaly(ctx, watch, interval, ticks, window, train_steps,
                  threshold, streams, fmt, no_daemon):
    """Live fleet-wide anomaly scores: every agent's fused egress +
    behavior windows fitted and scored on the GPU in one fit and one
    score per tick.

    One-shot by default: collect every worker's stream (local reads on
    local/fake, ``tail -F`` over the SSH mux for tpu_vm) and every
    ``--stream``, score once, and exit 2 when any agent's window flags
    past the threshold (default: settings ``sentinel``).  ``--watch``
    keeps ticking and re-prints live scores.  With a loopd daemon
    hosting a sentinel (settings sentinel.enable) the one-shot renders
    the daemon's LIVE rows instead of building a second scorer.
    """
    from ..sentinel import FleetSentinel

    f = _factory(ctx)
    ss = f.config.settings.sentinel
    if not watch:
        doc = _loopd_status(f, no_daemon)
        sent = (doc or {}).get("sentinel") if doc else None
        if sent and sent.get("enabled"):
            if fmt == "json":
                click.echo(json.dumps(
                    {"source": f"loopd:{doc.get('pid')}", **sent}, indent=2))
            else:
                click.echo(f"source: loopd (pid {doc.get('pid')}, run "
                           f"{sent.get('run') or '-'}, "
                           f"{sent.get('ticks', 0)} tick(s))", err=True)
                _render_anomaly_rows(sent.get("rows", []))
            if any(r.get("flagged") for r in sent.get("rows", [])):
                raise SystemExit(2)
            return
    device = _device("fleet anomaly")
    sentinel = FleetSentinel(
        f.config, f.driver,
        interval_s=(interval if interval is not None else ss.interval_s),
        window_s=window or ss.window_s,
        train_steps=train_steps or ss.train_steps,
        threshold=(threshold if threshold is not None else ss.threshold),
        baseline_window=ss.baseline_window, device=device)
    for kv in streams:
        wid, _, path = kv.partition("=")
        if not wid or not path:
            raise click.BadParameter(f"--stream {kv!r}: expected WORKER=PATH")
        sentinel.collector.add_local(wid, Path(path))

    def render() -> list[dict]:
        rows = sentinel.rows()
        if fmt == "json":
            click.echo(json.dumps(sentinel.status_doc(), indent=2))
        else:
            _render_anomaly_rows(rows)
        return rows

    try:
        if watch:
            n = 0
            try:
                while True:
                    sentinel.refresh_once()
                    n += 1
                    rep = sentinel.last_tick
                    if fmt == "table":
                        click.echo(f"-- tick {n}: "
                                   f"{rep.windows if rep else 0} window(s)"
                                   + (f" on {rep.device}" if rep else ""),
                                   err=True)
                    rows = render()
                    if ticks and n >= ticks:
                        break
                    time.sleep(max(0.05, sentinel.interval_s))
            except KeyboardInterrupt:
                rows = sentinel.rows()
        else:
            # remote (tpu_vm) tails replay worker history asynchronously
            # over the SSH mux: let the feed settle before the one
            # verdict tick, or a busy fleet reads as empty
            sentinel.collector.wait_quiescent(2.0)
            n = sentinel.refresh_once()
            if n == 0 and not sentinel.rows():
                # a tick that failed says why, not that nothing was there
                why = (f"scoring failed: {sentinel.last_error}"
                       if sentinel.last_error
                       else "no scorable windows in any worker stream")
                click.echo(f"fleet anomaly: {why}", err=True)
                raise SystemExit(1)
            rows = render()
    finally:
        sentinel.stop()
    if any(r.get("flagged") for r in rows):
        raise SystemExit(2)


@fleet_group.command("console")
@click.option("--fps", type=float, default=4.0,
              help="Repaint rate for the live view.")
@click.option("--once", is_flag=True,
              help="Render one plain frame and exit (scripts/CI).")
@click.option("--format", "fmt", type=click.Choice(["table", "json"]),
              default="table",
              help="json emits the console feed document -- the same "
                   "schema `loopd status --format json` carries under its "
                   "`console` key.")
@click.option("--no-spans", is_flag=True,
              help="Skip the flight-recorder span waterfalls.")
@click.pass_context
def fleet_console(ctx, fps, once, fmt, no_spans):
    """Live multi-run fleet console over the loopd status RPC.

    One pane of glass over every run the daemon hosts: per-loop status
    with the daemon sentinel's ANOM-Z, per-worker breaker/admission-token/
    workerd rows, tenant queues, warm pools, ingest state, and span
    waterfalls tailed from each run's flight recorder.  Requires a
    running loopd (`loopd start`); Ctrl-C exits the console, never a
    run.  ``clawker_tpu/cli/cmd_fleet.py:901-972``.
    """
    from ..errors import ClawkerError
    from ..loopd.client import discover_all
    from ..loopd.feed import console_feed, merge_feeds
    from ..ui.fleetconsole import FleetConsole

    f = _factory(ctx)
    # every federated pod's daemon (single-pod fleets get exactly the
    # one canonical socket)
    clients = discover_all(f.config, require_project=_project(f))
    if not clients:
        click.echo("fleet console: no loopd daemon answering (start one "
                   "with `loopd start`)", err=True)
        raise SystemExit(1)

    def feed_fn() -> dict:
        return merge_feeds([console_feed(c.status()) for c in clients])

    try:
        if fmt == "json":
            click.echo(json.dumps(feed_fn(), indent=2))
            return
        console = FleetConsole(
            f.streams, feed_fn,
            logs_dir=None if no_spans else f.config.logs_dir, fps=fps)
        if once or not f.streams.is_stdout_tty():
            click.echo(console.snapshot())
            return
        try:
            while True:
                console.render_once()
                time.sleep(1.0 / max(0.5, fps))
        except KeyboardInterrupt:
            pass
    except (ClawkerError, OSError) as e:
        # OSError too: a daemon killed mid-poll surfaces as a raw
        # BrokenPipe from the socket send, not a wrapped protocol error
        raise click.ClickException(f"fleet console: loopd went away ({e})")
    finally:
        for c in clients:
            c.close()


def _loopd_status(f, no_daemon: bool) -> dict | None:
    """One status RPC to this project's loopd, or None (degrade to the
    CLI-side probe path, or to local scoring).  Project-scoped like the
    loop submit path: another project's daemon state is not this
    fleet's.  The daemon already probes the fleet continuously -- fleet
    views should read ITS breakers instead of spinning up their own
    probe rounds (docs/loopd.md)."""
    if no_daemon:
        return None
    from ..errors import ClawkerError
    from ..loopd.client import discover

    try:
        client = discover(f.config, require_project=_project(f))
    except ClawkerError:
        return None         # unreadable settings: no daemon to find
    if client is None:
        return None
    try:
        doc = client.status()
    except Exception as e:      # noqa: BLE001 -- view must degrade
        click.echo(f"loopd status failed ({e}); probing directly", err=True)
        return None
    finally:
        client.close()
    return doc


def _render_anomaly_rows(rows: list[dict]) -> None:
    click.echo("\t".join(_ANOMALY_COLUMNS))
    for r in rows:
        click.echo("\t".join(str(x) for x in (
            r["agent"], r["worker"] or "-", r["windows"],
            r["latest_z"], r["peak_z"], r.get("stream_records", 0),
            "ANOMALOUS" if r.get("flagged") else "-")))


def register(root: click.Group) -> None:
    root.add_command(fleet_group)
