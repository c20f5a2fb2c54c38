"""Deterministic chaos injection + fleet invariant checking.

The port's copy of ``clawker_tpu/chaos``: the plans, the invariant
checker and the soak runner, whose sentinel scenarios and observe-only
twin score on the card (``device``), with the reference's exports.
The federation audit (``invariants.cross_pod_exactly_once``) waits
for ``federation/`` (ROADMAP §1 item 13).

PRs 3-7 built the robustness layers one at a time (breakers/failover,
the run journal + ``--resume`` adoption, admission backpressure, warm
pools); this package proves the COMPOSITION survives compound faults.
Three pieces (docs/chaos.md):

- :mod:`.plan` -- a seeded, serializable **fault plan**: a schedule of
  injection events (worker kill/wedge/flap/slow-loris, engine 5xx /
  ECONNRESET bursts, probe drops, CLI SIGKILL at named crash seams with
  journal torn-tail truncation) generated deterministically from
  ``(seed, scenario)`` so every failure found in soak is a one-command
  repro.
- :mod:`.invariants` -- the post-scenario **cross-audit** of engine
  state vs journal replay vs telemetry: zero duplicate creates per
  (run, slot), zero leaked containers after cleanup (warm-pool members
  included), admission high-water <= cap per worker, no spurious
  quarantine, every loop terminally accounted exactly once, every exit
  accounted exactly once, span trees complete.
- :mod:`.runner` -- the **soak runner** behind ``clawker chaos run``:
  executes N seeded scenarios against a fake pod with kill/resume
  cycles, and shrinks a failing schedule to a minimal repro before
  reporting.

:mod:`.seams` holds the named crash-seam registry the scheduler fires
through (``loop/scheduler.py``): the enumerable replacement for ad-hoc
``kill()`` stubbing in crash tests.
"""

from .plan import EVENT_KINDS, FaultEvent, FaultPlan, generate_plan
from .seams import NULL_SEAMS, SEAM_NAMES, SeamAbort, SeamRegistry

__all__ = [
    "EVENT_KINDS", "FaultEvent", "FaultPlan", "generate_plan",
    "check_invariants",
    "ChaosController", "ChaosRunner", "ScenarioResult", "run_soak",
    "shrink_plan",
    "NULL_SEAMS", "SEAM_NAMES", "SeamAbort", "SeamRegistry",
]

_LAZY = {
    # the runner and invariant checker import the loop package, which
    # itself imports .seams at module load: resolving these lazily
    # keeps that edge acyclic
    "ChaosController": "runner", "ChaosRunner": "runner",
    "ScenarioResult": "runner", "run_soak": "runner", "shrink_plan": "runner",
    "check_invariants": "invariants",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
