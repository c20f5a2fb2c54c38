"""Post-scenario fleet invariants: engine vs journal vs telemetry.

The port's copy of ``clawker_tpu/chaos/invariants.py`` but for the
federation audit ``cross_pod_exactly_once``, which waits for
``federation/`` (ROADMAP §1 item 13).

Each invariant cross-audits two independent records of the same run --
what the (fake) daemons actually executed (call recorder + live
container tables), what the write-ahead journal claims happened
(``replay()``), and what telemetry observed (flight-recorder span
trees, admission/gate high-water marks).  A violation means the
robustness composition (breakers + journal/resume + admission + warm
pools) lost track of reality under the injected faults -- exactly the
class of bug no single-layer test catches.

Invariant catalogue (names are the strings violations are prefixed
with; docs/chaos.md#invariants):

- ``terminal-accounting``: every (run, slot) loop ends in exactly one
  terminal state (done|failed|stopped), and the journal's last word per
  agent agrees with the scheduler's.
- ``exit-accounted-once``: no (agent, iteration) exit is journaled
  twice -- the double-accounting a kill/resume cycle must never cause.
- ``duplicate-create``: per worker daemon, container creates for one
  agent name never exceed that agent's journaled placements onto the
  worker (pool members: their journaled refills) -- every real create
  has a write-ahead record that authorized it.
- ``leaked-container``: after cleanup, no daemon holds ANY container
  labeled with the run id (warm-pool members included).
- ``admission-cap``: no worker daemon ever saw more concurrent
  create/start calls than the admission token bucket allows (gate
  high-water mark, measured daemon-side).
- ``spurious-quarantine``: a worker the plan never faulted ends with a
  CLOSED breaker -- faults must not splash onto healthy workers.
- ``span-tree``: the flight record parses, and (for scenarios without
  CLI kills) every span tree is rooted at a terminally-statused
  iteration root.
- ``trace-completeness``: the cross-process trace merge
  (docs/tracing.md) resolves the run to rooted trees.  Kill-free
  scenarios may not leave any bare root below the real top of the
  submit chain; under kills the bare-root audit loosens, but an
  iteration whose children prove a workerd launch must STILL hold
  either its remote segment or an explicit gap span -- a dead workerd
  degrades to a gap, never to a broken tree.
- ``sentinel-observe-only``: the fleet sentinel changes NO scheduling
  outcome.  Two halves: scenarios that ran with a sentinel attached
  audit its mutation counters (zero engine/breaker/placement calls --
  checked here via the ``sentinel`` param), and the dedicated twin
  check (:func:`observe_only_violations`, driven by
  ``runner.run_observe_only_check``) compares a fixed-seed run's
  journaled placements and daemon-side create counts with and without
  ``--sentinel``: they must be identical.
- ``worktree-isolation``: branch-per-agent provisioning never crosses
  agents.  Every journaled ``seed_worktree`` record maps one agent to
  exactly one (path, branch) pair, and no path or branch is ever
  claimed by two agents -- the zero-cross-agent-writes guarantee the
  swarm scenario rests on (docs/loop-worktrees.md).  A kill/resume
  cycle re-attaching worktrees must fold to the same single claim.
- ``stranded-by-drain``: a capacity scale-down never strands a
  journaled run (docs/elastic-capacity.md).  Folding the record stream
  in order with the same liveness rule the controller's journal-replay
  gate uses, every ``capacity_scale`` drain-done record must land at a
  point where its victim hosts no live loop or pool member.
- ``workerd-reconcile``: journaled intent reconciles on link heal.
  A channel that ends the scenario LIVE (any partition healed) must
  leave zero undelivered events on its daemon -- no lost exits -- and
  the standard ``duplicate-create`` audit above already proves no
  workerd-executed create exceeded its write-ahead placements (the
  worker-resident daemon mutates the same fake engine the recorder
  watches).  Intent dedup hits are legitimate (a re-sent intent across
  a partition); an intent executed with no placement to authorize it
  is not, and surfaces as duplicate-create.
- ``ref-isolation-at-proxy``: branch-per-agent ref isolation holds AT
  THE GIT PROXY (docs/git-policy.md).  Ground truth is the upstream's
  acknowledged-update log: no acknowledged update may ever name a ref
  outside its pusher's branch namespace (the sole exception being the
  merge-queue identity landing the integration branch), no allow
  verdict in the proxy's decision stream may name an out-of-namespace
  ref, and after a ``gitguard_down`` kill NOTHING may be acknowledged
  at all -- a dead guard fails closed, it never falls open.
- ``no-silent-drop``: a storage fault that actually fired (FaultFS
  shim counters) must surface -- as a counted scheduler fault AND a
  ``storage.fault`` bus event; a journal that dropped records must
  show degraded durability.  A poisoned or dropped write that
  surfaces nowhere is exactly the silent data loss the fail-loud WAL
  contract forbids (docs/durability.md).
- ``replay-integrity``: the checksummed journal fold reproduces the
  daemon's view of the run up to the declared fault point.  A verify
  pass reporting corruption is legitimate ONLY when the plan injected
  a torn record (bit-flip/power-cut), and the verified prefix must
  still fold to the run's own header -- a fold that lost the run id
  lost the WAL itself.
"""

from __future__ import annotations

from pathlib import Path

from .. import consts
from ..health import BREAKER_CLOSED

TERMINAL_STATUSES = ("done", "failed", "stopped")


def _daemon_view(driver) -> list:
    """(worker, api) pairs for every daemon the scenario ever had --
    the audit must include workers the capacity controller drained
    mid-run (their call recorders survive the fake VM deletion)."""
    all_workers = getattr(driver, "all_workers", None)
    workers = all_workers() if all_workers is not None else driver.workers()
    return list(zip(workers, driver.apis))


def check_invariants(driver, cfg, run_id: str, *, loops=None,
                     cap: int = 0, unfaulted: set[str] | None = None,
                     health=None, kills: int = 0,
                     sentinel=None, workerd=None,
                     shipper=None, gitguard=None,
                     storage=None) -> list[str]:
    """Audit one finished scenario; returns human-readable violations
    (empty list = all invariants hold).

    ``driver`` must be a :class:`~...engine.drivers.FakeDriver` (the
    call recorder and fault gates are the daemon-side evidence).
    ``loops`` are the FINAL generation's AgentLoop objects; ``cap`` the
    admission ``max_inflight_per_worker`` (0 skips the cap audit);
    ``unfaulted`` the worker ids the plan never touched; ``kills`` how
    many CLI SIGKILLs the scenario injected (crashed generations
    legitimately lose un-flushed spans, so the span audit loosens).
    """
    from ..loop.journal import (
        REC_CAPACITY_SCALE,
        REC_CAPACITY_TOKENS,
        REC_EXITED,
        REC_LOOP_END,
        REC_MIGRATED,
        REC_PLACEMENT,
        REC_POOL_ADD,
        REC_POOL_ADOPT,
        REC_POOL_READY,
        REC_POOL_REMOVE,
        REC_SEED_WORKTREE,
        RunJournal,
        journal_path,
        replay,
    )
    from ..monitor.ledger import flight_path
    from ..runtime.names import container_name
    from ..telemetry.spans import (
        SPAN_ITERATION,
        STANDALONE_SPANS,
        build_trees,
        load_spans,
    )

    violations: list[str] = []
    records = RunJournal.read(journal_path(cfg.logs_dir, run_id))
    image = replay(records)
    project = cfg.project_name()
    loops = list(loops or [])

    # --- terminal-accounting: scheduler statuses x journal last word
    for loop in loops:
        if loop.status not in TERMINAL_STATUSES:
            violations.append(
                f"terminal-accounting: loop {loop.agent} ended "
                f"{loop.status!r}, not a terminal state")
    by_agent_end: dict[str, list[str]] = {}
    for rec in records:
        if rec.get("kind") == REC_LOOP_END:
            by_agent_end.setdefault(str(rec.get("agent", "")), []).append(
                str(rec.get("status", "")))
    for loop in loops:
        ends = by_agent_end.get(loop.agent, [])
        if loop.status in TERMINAL_STATUSES and ends and \
                ends[-1] != loop.status:
            violations.append(
                f"terminal-accounting: journal says {loop.agent} ended "
                f"{ends[-1]!r} but the scheduler says {loop.status!r}")

    # --- exit-accounted-once: no (agent, iteration) journaled twice
    seen_exits: dict[tuple[str, int], int] = {}
    for rec in records:
        if rec.get("kind") == REC_EXITED:
            key = (str(rec.get("agent", "")), int(rec.get("iteration", -1)))
            seen_exits[key] = seen_exits.get(key, 0) + 1
    for (agent, iteration), n in sorted(seen_exits.items()):
        if n > 1:
            violations.append(
                f"exit-accounted-once: {agent} iteration {iteration} "
                f"accounted {n} times")

    # --- duplicate-create: daemon-side creates vs write-ahead records
    placements: dict[tuple[str, str], int] = {}   # (agent, worker) -> n
    for rec in records:
        if rec.get("kind") == REC_PLACEMENT:
            key = (str(rec.get("agent", "")), str(rec.get("worker", "")))
            placements[key] = placements.get(key, 0) + 1
        elif rec.get("kind") == REC_POOL_ADD:
            key = (str(rec.get("agent", "")), str(rec.get("worker", "")))
            placements[key] = placements.get(key, 0) + 1
    name_to_agent = {}
    for (agent, _w) in placements:
        name_to_agent[container_name(project, agent)] = agent
    for worker, api in _daemon_view(driver):
        creates: dict[str, int] = {}
        for (args, _kw) in api.calls_named("container_create"):
            cname = str(args[0]) if args else ""
            creates[cname] = creates.get(cname, 0) + 1
        for cname, n in sorted(creates.items()):
            agent = name_to_agent.get(cname)
            if agent is None:
                continue        # not this run's container
            allowed = placements.get((agent, worker.id), 0)
            if n > allowed:
                violations.append(
                    f"duplicate-create: {worker.id} executed {n} creates "
                    f"for {agent} but only {allowed} journaled "
                    "placement(s) authorized one")

    # --- leaked-container: nothing labeled with the run id survives
    for worker, api in _daemon_view(driver):
        for c in list(api.containers.values()):
            if c.labels.get(consts.LABEL_LOOP) == run_id:
                violations.append(
                    f"leaked-container: {worker.id} still holds "
                    f"{c.name} ({c.state}) after cleanup"
                    + (" [warm-pool]" if consts.LABEL_WARMPOOL in c.labels
                       else ""))

    # --- admission-cap: daemon-side concurrency high-water vs the bucket
    if cap > 0:
        all_workers = getattr(driver, "all_workers", None)
        audit_workers = (all_workers() if all_workers is not None
                         else driver.workers())
        # the SLO loop may legitimately scale a worker's bucket above
        # the static cap; journaled REC_CAPACITY_TOKENS records bound
        # how far (the audit stays falsifiable -- an unjournaled
        # overshoot is still a violation)
        cap_by_worker: dict[str, int] = {}
        for rec in records:
            if rec.get("kind") == REC_CAPACITY_TOKENS:
                wid = str(rec.get("worker", ""))
                c = int(rec.get("cap", 0))
                cap_by_worker[wid] = max(cap_by_worker.get(wid, cap), c)
        for worker, gate in zip(audit_workers, driver.gates):
            allowed = max(cap, cap_by_worker.get(worker.id, cap))
            if gate.launch_hwm > allowed:
                violations.append(
                    f"admission-cap: {worker.id} daemon saw "
                    f"{gate.launch_hwm} concurrent launches "
                    f"(cap {allowed})")

    # --- worktree-isolation: one agent, one (path, branch); no sharing.
    # Folded from the write-ahead ``seed_worktree`` records: an agent
    # that re-attaches after kill/resume journals the same claim (WAL
    # dedup), so >1 distinct claim per agent, or any path/branch shared
    # across agents, means two containers could write the same tree.
    claims: dict[str, set[tuple[str, str]]] = {}
    for rec in records:
        if rec.get("kind") == REC_SEED_WORKTREE:
            agent = str(rec.get("agent", ""))
            claims.setdefault(agent, set()).add(
                (str(rec.get("path", "")), str(rec.get("branch", ""))))
    for agent, pairs in sorted(claims.items()):
        if len(pairs) > 1:
            violations.append(
                f"worktree-isolation: {agent} journaled {len(pairs)} "
                f"distinct worktree claims: {sorted(pairs)}")
    by_path: dict[str, str] = {}
    by_branch: dict[str, str] = {}
    for agent, pairs in sorted(claims.items()):
        for path, branch in sorted(pairs):
            if path and path in by_path and by_path[path] != agent:
                violations.append(
                    f"worktree-isolation: path {path} claimed by both "
                    f"{by_path[path]} and {agent} (cross-agent writes)")
            elif path:
                by_path[path] = agent
            if branch and branch in by_branch and by_branch[branch] != agent:
                violations.append(
                    f"worktree-isolation: branch {branch} claimed by both "
                    f"{by_branch[branch]} and {agent}")
            elif branch:
                by_branch[branch] = agent

    # --- stranded-by-drain: a capacity scale-down must never strand a
    # journaled run.  Fold the record stream in order, tracking which
    # loops and pool members are live on which worker at every point --
    # the SAME liveness rule the controller's journal-replay gate uses
    # (non-terminal loops count; done/failed do not; pending/ready pool
    # members count) -- and require that every ``drain done`` record
    # lands at a point where its victim hosts nothing live.
    placed_on: dict[str, str] = {}      # agent -> worker
    live_agents: set[str] = set()
    pool_on: dict[str, str] = {}        # pool member -> worker, while live
    for rec in records:
        kind = rec.get("kind", "")
        agent = str(rec.get("agent", ""))
        if kind == REC_PLACEMENT and agent:
            placed_on[agent] = str(rec.get("worker", ""))
            live_agents.add(agent)
        elif kind == REC_MIGRATED and agent:
            placed_on[agent] = str(rec.get("dst",
                                           placed_on.get(agent, "")))
        elif kind == REC_LOOP_END and agent:
            if str(rec.get("status", "")) in ("done", "failed"):
                live_agents.discard(agent)
            # "stopped" stays live: the run resumes onto that worker
        elif kind in (REC_POOL_ADD, REC_POOL_READY) and agent:
            pool_on[agent] = str(rec.get("worker", pool_on.get(agent, "")))
        elif kind in (REC_POOL_ADOPT, REC_POOL_REMOVE) and agent:
            pool_on.pop(agent, None)
        elif kind == REC_CAPACITY_SCALE \
                and str(rec.get("action", "")) == "drain" \
                and str(rec.get("phase", "")) == "done":
            wid = str(rec.get("worker", ""))
            stranded = sorted(
                [a for a in live_agents if placed_on.get(a) == wid]
                + [p for p, w in pool_on.items() if w == wid])
            for victim in stranded:
                violations.append(
                    f"stranded-by-drain: capacity drained {wid} while "
                    f"the journal shows {victim} still live on it")

    # --- spurious-quarantine: untouched workers end healthy
    if health is not None and unfaulted:
        for wid in sorted(unfaulted):
            state = health.state(wid)
            if state != BREAKER_CLOSED:
                violations.append(
                    f"spurious-quarantine: {wid} was never faulted but "
                    f"its breaker reads {state!r}")

    # --- sentinel-observe-only (counter half): a scenario that ran with
    # the sentinel attached must show ZERO mutations in its audit --
    # the sentinel has no code path that could increment these, and the
    # invariant keeps it that way
    if sentinel is not None:
        for name, count in sorted(sentinel.audit().items()):
            if count:
                violations.append(
                    f"sentinel-observe-only: sentinel performed "
                    f"{count} {name}")

    # --- workerd-reconcile: a healed link leaves nothing undelivered.
    # ``workerd`` rows come from the runner's audit (worker, alive,
    # channel_live, undelivered).  A dead daemon / never-healed channel
    # is the DEGRADE case, covered by the drain + accounting checks
    # above; only a live channel owes an empty buffer.
    for row in workerd or []:
        if row.get("alive") and row.get("channel_live") \
                and int(row.get("undelivered", 0)) > 0:
            violations.append(
                f"workerd-reconcile: {row.get('worker')} channel healed "
                f"but {row['undelivered']} event(s) were never delivered "
                "(lost exits)")

    # --- shipper-*: the telemetry shipper's bounded-ingestion contract
    # (docs/fleet-console.md#degrade-matrix).  ``shipper`` is the
    # runner's audit dict (shipper.stats() + down_injected +
    # indexed_docs from the fake index).  Three falsifiable halves:
    # accounting (every ingested doc is flushed, dropped, or still
    # buffered -- nothing vanishes uncounted, which is exactly what a
    # lossy drop path that forgets to count would violate), delivery
    # (every doc the sink ACKED is actually in the index -- catches a
    # corrupt bulk payload read as success), and bounded (the buffer
    # never exceeded its cap, so a down index cannot grow memory).
    if shipper is not None:
        accounted = (shipper["flushed_docs"] + shipper["dropped_docs"]
                     + shipper["pending_docs"] + shipper["open_docs"])
        if accounted != shipper["ingested_docs"]:
            violations.append(
                f"shipper-accounting: {shipper['ingested_docs']} doc(s) "
                f"ingested but only {accounted} accounted "
                f"(flushed {shipper['flushed_docs']} + dropped "
                f"{shipper['dropped_docs']} + buffered "
                f"{shipper['pending_docs'] + shipper['open_docs']})")
        if shipper["flushed_docs"] != shipper.get("indexed_docs", 0):
            violations.append(
                f"shipper-delivery: sink acked {shipper['flushed_docs']} "
                f"doc(s) but the index holds "
                f"{shipper.get('indexed_docs', 0)}")
        if shipper["pending_batches"] > shipper["max_batches"]:
            violations.append(
                f"shipper-bounded: {shipper['pending_batches']} pending "
                f"batch(es) exceed the {shipper['max_batches']}-batch "
                "buffer cap")
        if shipper.get("down_injected") and shipper["failed_flushes"] == 0 \
                and shipper["dropped_docs"] == 0 \
                and shipper["ingested_docs"] > 0:
            violations.append(
                "shipper-backpressure: the index went down but the "
                "shipper recorded neither a failed flush nor a drop -- "
                "the fault never reached the sink path")

    # --- ref-isolation-at-proxy: branch-per-agent isolation, audited
    # against the UPSTREAM's acknowledged log (docs/git-policy.md).
    # ``gitguard`` is the runner's audit dict: run/branch_prefix name
    # the namespace scheme, ``acknowledged`` is (ts, identity_header,
    # ref) per update the upstream actually applied, ``decisions`` is
    # (ts, decision_doc) off the proxy, ``downed_at`` when (if ever)
    # the proxy was killed.  Three falsifiable halves: nothing landed
    # out of namespace, the proxy never SAID allow out of namespace
    # (catches a verdict/forward mismatch the first half would miss
    # when the upstream also refuses), and nothing at all landed after
    # the kill (fail-closed, never fail-open).
    if gitguard is not None:
        from ..gitguard.refpolicy import AgentIdentity, RefPolicy

        policy = RefPolicy(
            run=str(gitguard.get("run", "")),
            branch_prefix=str(gitguard.get("branch_prefix", "loop")))
        integration = policy.integration_ref()

        def in_namespace(ident_header: str, ref: str) -> bool:
            ident = AgentIdentity.from_header(ident_header)
            if ident is None:
                return False
            if ref == integration:
                return ident.merge_queue
            ns = policy.namespace(ident)
            return ref == ns or ref.startswith(ns + "/")

        downed_at = gitguard.get("downed_at")
        for ts, ident_header, ref in gitguard.get("acknowledged") or []:
            if not in_namespace(str(ident_header), str(ref)):
                violations.append(
                    f"ref-isolation-at-proxy: upstream acknowledged "
                    f"{ref} pushed by {ident_header!r} -- an "
                    "out-of-namespace update landed")
            if downed_at is not None and ts > downed_at:
                violations.append(
                    f"ref-isolation-at-proxy: upstream acknowledged "
                    f"{ref} AFTER the guard was killed -- a dead guard "
                    "must fail closed, not open")
        # decision docs carry (run, agent) but not role, so the
        # integration ref is checked by the acknowledged-log half
        # above (only the merge-queue role may land it); here an allow
        # verdict must name the integration ref or the agent's own
        # namespace -- anything else is a verdict the policy can never
        # legitimately produce
        for _ts, doc in gitguard.get("decisions") or []:
            if doc.get("verdict") != "allow":
                continue
            ident_header = "/".join(
                p for p in (doc.get("run", ""), doc.get("agent", ""))
                if p)
            ref = str(doc.get("ref", ""))
            if ref and ref != integration \
                    and not in_namespace(ident_header, ref):
                violations.append(
                    f"ref-isolation-at-proxy: proxy journaled an allow "
                    f"verdict for out-of-namespace ref {ref} "
                    f"(identity {ident_header!r})")

    # --- no-silent-drop / replay-integrity: the storage-fault contract
    # (docs/durability.md).  ``storage`` is the runner's audit dict:
    # ``fired`` counts faults the FaultFS shims actually raised,
    # ``faults``/``events`` what the scheduler surfaced (its counter
    # and storage.fault bus frames across generations), ``dropped``/
    # ``durability`` the journal's own accounting, ``verify`` the
    # checksum scan of the final journal, ``torn_injected`` whether
    # the plan corrupted bytes on purpose, and ``folded_run_id`` what
    # the verified-prefix fold thinks the run is.
    if storage is not None:
        fired = int(storage.get("fired", 0))
        if fired and not int(storage.get("faults", 0)):
            violations.append(
                f"no-silent-drop: {fired} injected storage fault(s) "
                "fired but the scheduler counted none")
        if fired and not int(storage.get("events", 0)):
            violations.append(
                f"no-silent-drop: {fired} injected storage fault(s) "
                "fired but no storage.fault event reached the bus")
        if int(storage.get("dropped", 0)) \
                and storage.get("durability") == "ok":
            violations.append(
                f"no-silent-drop: {storage.get('dropped')} journal "
                "record(s) dropped but durability still reads ok")
        verify = storage.get("verify") or {}
        if int(verify.get("corrupt", 0)) \
                and not storage.get("torn_injected"):
            violations.append(
                f"replay-integrity: journal verify found "
                f"{verify.get('corrupt')} corrupt record(s) without a "
                "torn-record injection")
        folded = storage.get("folded_run_id")
        if folded is not None and folded != run_id:
            violations.append(
                "replay-integrity: the checksummed fold lost the run "
                f"header (folded {folded!r}, expected {run_id!r})")

    # --- span-tree: flight record parses; kill-free runs close every root
    from ..monitor.ledger import read_rotated_lines

    fpath = Path(flight_path(cfg.logs_dir, run_id))
    if fpath.exists():
        try:
            spans = load_spans(read_rotated_lines(fpath))
        except Exception as e:      # noqa: BLE001 -- corruption IS a finding
            violations.append(f"span-tree: flight record unreadable: {e}")
            spans = []
        if spans and kills == 0:
            for tree in build_trees(spans):
                rec = tree.record
                if rec.name in STANDALONE_SPANS:
                    continue    # run-level spans (sentinel ticks) are
                    #             legitimate non-iteration roots
                if rec.name != SPAN_ITERATION:
                    violations.append(
                        f"span-tree: {rec.agent} span {rec.name!r} has no "
                        "iteration root (writer died mid-flush?)")
                elif rec.status not in ("ok", "failed", "orphaned",
                                        "stopped"):
                    violations.append(
                        f"span-tree: {rec.agent} iteration root ended "
                        f"with status {rec.status!r}")

    # --- trace-completeness: the cross-process merge resolves every
    # iteration to a ROOTED tree whose remote segments are complete or
    # explicitly gap-marked (docs/tracing.md#chaos).  Kills loosen the
    # bare-root audit exactly as span-tree loosens (a SIGKILLed writer
    # legitimately loses its unflushed tail), but never the shape rule:
    # a remote segment that DID survive must merge gap-marked or
    # hosted, never as a broken tree.
    try:
        from ..tracing.merge import merge_run
        from ..tracing.names import SPAN_LOOPD_SUBMIT, SPAN_ROUTER_SUBMIT

        merged = merge_run(Path(cfg.logs_dir), run_id)
    except Exception as e:      # noqa: BLE001 -- a merge crash IS a finding
        violations.append(f"trace-completeness: merge failed: {e}")
        merged = None
    if merged is not None and merged.spans:
        # legitimate top-of-chain roots: the hop a submit REALLY started
        # at (router when federated, loopd when daemon-direct, iteration
        # when in-process) plus standalone run-level spans and the
        # merge's own gap placeholders
        root_ok = {SPAN_ITERATION, SPAN_ROUTER_SUBMIT, SPAN_LOOPD_SUBMIT}

        def _walk(nodes):
            for n in nodes:
                yield n
                yield from _walk(n.children)

        for root in merged.roots:
            rec = root.record
            if (rec.name in root_ok or rec.name in STANDALONE_SPANS
                    or rec.attrs.get("gap")):
                continue
            if kills == 0:
                violations.append(
                    f"trace-completeness: span {rec.name!r} "
                    f"({rec.agent or rec.worker}) merges as a bare root "
                    "-- its upstream segment is missing and not "
                    "gap-marked")
        for node in _walk(merged.roots):
            rec = node.record
            if rec.name != SPAN_ITERATION:
                continue
            via = any(c.record.attrs.get("workerd") for c in node.children)
            resolved = any(c.record.name.startswith("workerd.")
                           or c.record.attrs.get("gap")
                           for c in node.children)
            if via and not resolved:
                violations.append(
                    f"trace-completeness: {rec.agent} iteration "
                    f"{rec.attrs.get('iteration')} launched via workerd "
                    "but its remote segment is neither present nor "
                    "gap-marked")
    return violations


# ------------------------------------------------------- observe-only twin


def scheduling_outcome(driver, cfg, run_id: str, loops=None) -> dict:
    """The scheduling-outcome fingerprint the observe-only invariant
    compares: journaled placements per agent, daemon-side create counts
    per worker, and terminal statuses.  Everything the sentinel could
    conceivably have perturbed if it were not observe-only."""
    from ..loop.journal import REC_PLACEMENT, RunJournal, journal_path

    # agent and container names embed the run id (deterministic per
    # (run, slot)); the twin runs under two ids, so names normalize to
    # their slot before comparison
    def norm(name: str) -> str:
        return name.replace(run_id[:6], "RUN") if run_id else name

    records = RunJournal.read(journal_path(cfg.logs_dir, run_id))
    placements: dict[str, list[str]] = {}
    for rec in records:
        if rec.get("kind") == REC_PLACEMENT:
            placements.setdefault(norm(str(rec.get("agent", ""))),
                                  []).append(str(rec.get("worker", "")))
    creates: dict[str, dict[str, int]] = {}
    for worker, api in zip(driver.workers(), driver.apis):
        counts: dict[str, int] = {}
        for (args, _kw) in api.calls_named("container_create"):
            cname = norm(str(args[0])) if args else ""
            counts[cname] = counts.get(cname, 0) + 1
        creates[worker.id] = counts
    statuses = {norm(l.agent): l.status for l in (loops or [])}
    return {"placements": placements, "creates": creates,
            "statuses": statuses}


def observe_only_violations(baseline: dict, with_sentinel: dict) -> list[str]:
    """Compare two fixed-seed runs' scheduling outcomes -- one without
    and one with the sentinel attached.  Any difference is a violation:
    an observe-only subsystem may add events, metrics, and spans, but
    never a placement, a create, or a status."""
    out: list[str] = []
    for field_name in ("placements", "creates", "statuses"):
        a, b = baseline.get(field_name), with_sentinel.get(field_name)
        if a != b:
            keys = sorted(set(a or {}) | set(b or {}))
            diff = [k for k in keys if (a or {}).get(k) != (b or {}).get(k)]
            out.append(
                f"sentinel-observe-only: {field_name} differ with the "
                f"sentinel attached (changed: {', '.join(diff[:6])}"
                + ("..." if len(diff) > 6 else "") + ")")
    return out
