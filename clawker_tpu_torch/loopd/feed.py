"""The console feed: ONE schema over the loopd status RPC.

``clawker fleet console`` (the live multi-run TUI), ``clawker loopd
status --format json`` (scripts), and the repaint-budget tests all read
the same normalized document, built here from a raw status RPC reply --
so a field the console renders is by construction a field scripts can
select on, and the two can never drift (docs/fleet-console.md#feed).

Normalizations over the raw RPC doc:

- every hosted run gets uniform ``agents`` rows (``agent``, ``worker``,
  ``status``, ``iteration``, ``exits`` as a comma string,
  ``anomaly_z``) with the daemon sentinel's latest per-agent z merged
  in -- the RPC carries sentinel rows separately because the sentinel
  outlives any one run;
- per-run ``events_dropped`` (the run's slice of
  ``loopd_events_dropped_total``) always present, 0 when nothing
  dropped;
- admission/health/workerd/warm-pool/shipper blocks pass through under
  stable keys with absent sections as empty containers, so consumers
  never need ``.get`` chains.

The port's copy of ``clawker_tpu/loopd/feed.py``, whole; the port's
``fleet console`` (:mod:`clawker_tpu_torch.ui.fleetconsole`) renders it.
"""

from __future__ import annotations


def _agent_rows(run: dict, anom: dict[str, float]) -> list[dict]:
    rows = []
    for a in run.get("agents") or []:
        agent = str(a.get("agent", ""))
        z = a.get("anomaly_z")
        if z is None:
            z = anom.get(agent)
        rows.append({
            "agent": agent,
            "worker": str(a.get("worker", "")),
            "status": str(a.get("status", "")),
            "iteration": int(a.get("iteration", 0)),
            "exits": ",".join(map(str, a.get("exit_codes") or [])) or "-",
            "anomaly_z": (round(float(z), 2) if z is not None else None),
        })
    return rows


def console_feed(doc: dict) -> dict:
    """Raw loopd status RPC reply -> the normalized console feed."""
    doc = doc or {}
    sentinel = doc.get("sentinel") or {"enabled": False}
    anom: dict[str, float] = {}
    for r in sentinel.get("rows") or []:
        agent = str(r.get("agent", ""))
        try:
            z = float(r.get("latest_z", 0.0))
        except (TypeError, ValueError):
            continue
        if agent and (agent not in anom or z > anom[agent]):
            anom[agent] = z
    pod = str(doc.get("pod") or "")
    runs = []
    for r in doc.get("runs") or []:
        runs.append({
            "run": str(r.get("run", "")),
            "state": str(r.get("state", "")),
            # the hosting pod, stamped from the daemon's status doc so a
            # multi-pod merge (merge_feeds) keeps rows attributable
            "pod": str(r.get("pod") or pod),
            "tenant": str(r.get("tenant", "")),
            "client": str(r.get("client", "")),
            "parallel": int(r.get("parallel", 0)),
            "iterations": int(r.get("iterations", 0)),
            "placement": str(r.get("placement", "")),
            "subscribers": int(r.get("subscribers", 0)),
            "events_dropped": int(r.get("events_dropped", 0)),
            **({"ok": r.get("ok")} if "ok" in r else {}),
            "agents": _agent_rows(r, anom),
        })
    admission = doc.get("admission") or {}
    return {
        "pid": doc.get("pid"),
        "pod": pod,
        "project": str(doc.get("project") or ""),
        "uptime_s": float(doc.get("uptime_s") or 0.0),
        "runs": runs,
        "workers": admission.get("workers") or {},
        "tenants": admission.get("tenants") or {},
        "health": doc.get("health") or [],
        "workerd": doc.get("workerd") or {},
        "warm_pools": doc.get("warm_pools") or {},
        "sentinel": sentinel,
        "shipper": doc.get("shipper") or {"enabled": False},
        "events_dropped_total": int(doc.get("events_dropped_total", 0)),
    }


def merge_feeds(feeds: list[dict]) -> dict:
    """N pods' normalized console feeds -> ONE cross-pod feed
    (docs/federation.md#console).

    The console and ``--format json`` consumers keep reading the exact
    single-pod schema; the merge adds only a top-level ``pods`` list
    (pod names, feed order) that the TUI keys its POD column off.  Run
    rows concatenate in feed order (each row already carries its
    ``pod``); worker-keyed sections prefix keys with ``pod/`` so two
    pods' ``fake-0`` never alias; tenant rows SUM across pods -- the
    global view of a tenant the router's WFQ is balancing.  A
    single-element list returns that feed unchanged (minus ``pods``):
    the single-pod console is byte-identical to before."""
    if not feeds:
        return console_feed({})
    if len(feeds) == 1:
        return feeds[0]
    pods = []
    for i, f in enumerate(feeds):
        pods.append(str(f.get("pod") or "") or f"pod{i}")
    runs: list[dict] = []
    workers: dict = {}
    workerd: dict = {}
    health: list[dict] = []
    tenants: dict[str, dict] = {}
    warm_pools: dict = {}
    sentinel_rows: list[dict] = []
    sentinel_on = False
    shipper = {"enabled": False}
    dropped = 0
    for pod, f in zip(pods, feeds):
        for r in f.get("runs") or []:
            row = dict(r)
            row["pod"] = str(row.get("pod") or "") or pod
            runs.append(row)
        for wid, w in (f.get("workers") or {}).items():
            workers[f"{pod}/{wid}"] = w
        for wid, w in (f.get("workerd") or {}).items():
            workerd[f"{pod}/{wid}"] = w
        for h in f.get("health") or []:
            row = dict(h)
            row["worker"] = f"{pod}/{h.get('worker', '')}"
            health.append(row)
        for name, t in (f.get("tenants") or {}).items():
            agg = tenants.setdefault(name, {
                "weight": t.get("weight", 1.0), "inflight": 0,
                "queued": 0, "dispatched": 0})
            for k in ("inflight", "queued", "dispatched"):
                agg[k] += int(t.get(k, 0))
        warm_pools.update(f.get("warm_pools") or {})
        sent = f.get("sentinel") or {}
        sentinel_on = sentinel_on or bool(sent.get("enabled"))
        sentinel_rows += list(sent.get("rows") or [])
        if not shipper.get("enabled") and (f.get("shipper") or {}).get(
                "enabled"):
            shipper = f["shipper"]
        dropped += int(f.get("events_dropped_total", 0))
    return {
        "pid": feeds[0].get("pid"),
        "pod": "",
        "pods": pods,
        "project": next((str(f.get("project") or "") for f in feeds
                         if f.get("project")), ""),
        "uptime_s": max(float(f.get("uptime_s") or 0.0) for f in feeds),
        "runs": runs,
        "workers": workers,
        "tenants": tenants,
        "health": health,
        "workerd": workerd,
        "warm_pools": warm_pools,
        "sentinel": {"enabled": sentinel_on, "rows": sentinel_rows},
        "shipper": shipper,
        "events_dropped_total": dropped,
    }
