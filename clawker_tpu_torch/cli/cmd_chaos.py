"""``chaos run|replay|plan``: the port's copy of
``clawker_tpu/cli/cmd_chaos.py``: the soak, whose sentinel scenarios and
observe-only twin score on the GPU.  ``run`` resolves the sentinel's
device as ``loop`` does (exit 1 before any scenario without a GPU unless
``CLAWKER_TORCH_DEVICE=cpu``); ``replay`` does so for a sentinel plan.
"""

from __future__ import annotations

import json
import click

from .factory import _bring_up, _device, _factory


@click.group("chaos")
def chaos_group():
    """Deterministic chaos injection against the loop scheduler's
    robustness stack (breakers/failover, journal/--resume, admission,
    warm pools)."""


@chaos_group.command("run")
@click.option("--scenarios", "-n", type=int, default=None,
              help="Seeded scenarios to execute "
                   "(default: settings chaos.scenarios).")
@click.option("--seed", "-s", type=int, default=None,
              help="Soak seed: scenario i replays as (seed, i) "
                   "(default: settings chaos.seed).")
@click.option("--parallel", "-p", type=int, default=None,
              help="Agent loops per scenario (default: settings "
                   "chaos.parallel).")
@click.option("--workers", "-w", type=int, default=None,
              help="Fake pod size per scenario (default: settings "
                   "chaos.workers).")
@click.option("--iterations", type=int, default=None,
              help="Iteration budget per loop (default: settings "
                   "chaos.iterations).")
@click.option("--keep-going", is_flag=True,
              help="Run every scenario even after a failure "
                   "(default: stop and shrink the first).")
@click.option("--no-shrink", is_flag=True,
              help="Skip minimal-repro shrinking of failing schedules.")
@click.option("--json", "as_json", is_flag=True, help="Report as JSON.")
@click.pass_context
def chaos_run(ctx, scenarios, seed, parallel, workers, iterations,
              keep_going, no_shrink, as_json):
    """Run a seeded chaos soak and audit fleet invariants.

    Every scenario builds a fresh fake pod, executes its generated
    fault schedule (kill/resume cycles included), and cross-audits
    engine state vs journal replay vs telemetry.  Exit is non-zero on
    any invariant violation; the report names the exact
    ``chaos replay --seed S --scenario I`` repro and, unless
    --no-shrink, the minimal failing schedule.
    """
    from ..chaos.runner import run_soak

    f = _factory(ctx)
    # the sentinel scenarios and the observe-only twin score on the GPU:
    # without one (and without CLAWKER_TORCH_DEVICE=cpu) no scenario runs
    device = _device("chaos run")
    _bring_up("chaos run", device)
    cs = f.config.settings.chaos
    scenarios = scenarios if scenarios is not None else cs.scenarios
    seed = seed if seed is not None else cs.seed

    def progress(result):
        if not as_json:
            mark = "ok" if result.ok else "FAIL"
            click.echo(
                f"scenario {result.scenario}: {mark} "
                f"({result.wall_s:.2f}s, {result.injected} fault(s), "
                f"{result.kills} kill(s), gen {result.generations})",
                err=True)

    report = run_soak(
        scenarios, seed,
        n_workers=workers if workers is not None else cs.workers,
        n_loops=parallel if parallel is not None else cs.parallel,
        iterations=(iterations if iterations is not None
                    else cs.iterations),
        shrink=not no_shrink, keep_going=keep_going,
        on_progress=progress, cfg=f.config, device=device)
    if as_json:
        click.echo(json.dumps(report, indent=2))
    else:
        click.echo(
            f"chaos: {report['passed']}/{report['scenarios']} scenario(s) "
            f"passed (seed {report['seed']}, {report['injected']} "
            f"injection(s), {report['kills']} kill/resume cycle(s), "
            f"{report['wall_s']}s)")
        for fail in report["failures"]:
            click.echo(f"FAILED scenario {fail['scenario']}:", err=True)
            for v in fail["violations"]:
                click.echo(f"  - {v}", err=True)
            click.echo(f"  repro: {fail['repro']}", err=True)
            if "minimal_plan" in fail:
                click.echo("  minimal schedule: "
                           + json.dumps(fail["minimal_plan"]["events"]),
                           err=True)
    if not report["ok"]:
        raise SystemExit(1)


@chaos_group.command("replay")
@click.option("--seed", "-s", type=int, default=None,
              help="Seed of the soak that found the failure.")
@click.option("--scenario", "-i", type=int, default=0,
              help="Scenario index within the soak (default 0).")
@click.option("--workers", "-w", type=int, default=None,
              help="Fleet shape of the soak that found the failure "
                   "(default: settings chaos.workers).")
@click.option("--parallel", "-p", type=int, default=None,
              help="Loops per scenario of that soak (default: settings "
                   "chaos.parallel).")
@click.option("--iterations", type=int, default=None,
              help="Iteration budget of that soak (default: settings "
                   "chaos.iterations).")
@click.option("--plan", "plan_file", type=click.Path(exists=True),
              default=None,
              help="Replay a saved plan JSON instead of (seed, scenario).")
@click.option("--json", "as_json", is_flag=True, help="Result as JSON.")
@click.pass_context
def chaos_replay(ctx, seed, scenario, workers, parallel, iterations,
                 plan_file, as_json):
    """Deterministically re-execute one scenario.

    Either --seed/--scenario (regenerates the exact schedule the soak
    ran -- pass the soak's --workers/--parallel/--iterations too if it
    used a non-default fleet shape, as the schedule depends on it) or
    --plan FILE (a saved or hand-edited schedule).  Exit is non-zero
    when an invariant is violated.
    """
    from ..chaos.plan import FaultPlan, generate_plan
    from ..chaos.runner import run_plan

    f = _factory(ctx)
    cs = f.config.settings.chaos
    if plan_file is not None:
        plan = FaultPlan.load(plan_file)
    elif seed is not None:
        plan = generate_plan(
            seed, scenario,
            n_workers=workers if workers is not None else cs.workers,
            n_loops=parallel if parallel is not None else cs.parallel,
            iterations=(iterations if iterations is not None
                        else cs.iterations))
    else:
        raise click.UsageError("need --seed (with --scenario) or --plan")
    # a sentinel plan scores on the GPU: without one (and without
    # CLAWKER_TORCH_DEVICE=cpu) it exits 1 before the scenario runs
    kw = {}
    if plan.sentinel:
        kw["device"] = _device("chaos replay")
        _bring_up("chaos replay", kw["device"])
    result = run_plan(plan, cfg=f.config, **kw)
    if as_json:
        click.echo(json.dumps({**result.to_doc(),
                               "plan": plan.to_doc()}, indent=2))
    else:
        click.echo(f"scenario ({plan.seed}, {plan.scenario}): "
                   + ("ok" if result.ok else "FAILED"))
        for v in result.violations:
            click.echo(f"  - {v}", err=True)
    if not result.ok:
        raise SystemExit(1)


@chaos_group.command("plan")
@click.option("--seed", "-s", type=int, required=True,
              help="Soak seed to generate from.")
@click.option("--scenario", "-i", type=int, default=0,
              help="Scenario index (default 0).")
@click.option("--workers", "-w", type=int, default=None,
              help="Fleet shape the soak used (default: settings "
                   "chaos.workers; the schedule depends on it).")
@click.option("--parallel", "-p", type=int, default=None,
              help="Loops per scenario (default: settings chaos.parallel).")
@click.option("--iterations", type=int, default=None,
              help="Iteration budget (default: settings chaos.iterations).")
@click.option("--out", "out_file", type=click.Path(), default=None,
              help="Write the plan JSON here instead of stdout "
                   "(editable; replay with --plan).")
@click.pass_context
def chaos_plan(ctx, seed, scenario, workers, parallel, iterations,
               out_file):
    """Print (or save) the fault schedule for one (seed, scenario).

    The schedule is exactly what ``chaos run``/``chaos replay`` would
    execute under the same fleet shape -- save it, edit the events, and
    replay the edited plan to bisect a failure by hand.
    """
    from ..chaos.plan import generate_plan

    f = _factory(ctx)
    cs = f.config.settings.chaos
    plan = generate_plan(
        seed, scenario,
        n_workers=workers if workers is not None else cs.workers,
        n_loops=parallel if parallel is not None else cs.parallel,
        iterations=(iterations if iterations is not None
                    else cs.iterations))
    if out_file:
        path = plan.save(out_file)
        click.echo(f"wrote {path}")
    else:
        click.echo(plan.to_json(), nl=False)


def register(root: click.Group) -> None:
    root.add_command(chaos_group)
