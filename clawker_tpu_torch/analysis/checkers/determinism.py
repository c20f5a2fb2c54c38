"""Checker: chaos plan generation must be a pure function of its seed.

``generate_plan(seed, scenario)`` is the root of every chaos guarantee:
a soak failure replays from its (seed, i) pair ONLY if the schedule is
a pure function of the pair (docs/chaos.md#determinism).  One
``time.time()`` or module-level ``random.random()`` in a generation
path and the fixed-seed soak stops being fixed -- failures stop
replaying, shrunk repros stop reproducing, and the 25-scenario gate
starts flaking.

Flagged anywhere in chaos/plan.py: wall-clock reads (``time.time``,
``time.monotonic``, ``time.perf_counter``, ``datetime.now/utcnow``,
``date.today``) and any use of the module-level ``random`` instance
(``random.random()``, ``random.choice`` ...).  Constructing a seeded
``random.Random(seed)`` is the sanctioned pattern and stays legal.

The port's copy of ``clawker_tpu/analysis/checkers/determinism.py``, whole.
"""

from __future__ import annotations

import ast

from ..core import Checker, Finding, RepoContext, SourceFile, register_checker
from ._util import dotted

SCOPED_FILES = ("clawker_tpu_torch/chaos/plan.py",)

CLOCKS = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "date.today", "datetime.date.today",
}
# random.Random / random.SystemRandom construction is fine (seeded
# instances are the whole point); everything else on the module is the
# shared global generator
RANDOM_OK = {"Random", "SystemRandom", "seed"}


@register_checker
class ChaosDeterminismChecker(Checker):
    id = "chaos-determinism"
    doc = ("no wall-clock reads or module-level random in chaos plan "
           "generation -- schedules must replay from (seed, scenario)")

    def interested(self, rel: str) -> bool:
        return rel in SCOPED_FILES

    def check(self, src: SourceFile, ctx: RepoContext) -> list[Finding]:
        assert src.tree is not None
        findings: list[Finding] = []
        for n in ast.walk(src.tree):
            if not isinstance(n, ast.Attribute):
                continue
            name = dotted(n)
            if name in CLOCKS:
                findings.append(Finding(
                    checker=self.id, path=src.rel, line=n.lineno,
                    message=(f"wall-clock read `{name}` in chaos plan "
                             f"generation -- schedules must be pure "
                             f"functions of (seed, scenario) "
                             f"(docs/chaos.md#determinism)")))
            elif name.startswith("random.") \
                    and name.split(".")[1] not in RANDOM_OK:
                findings.append(Finding(
                    checker=self.id, path=src.rel, line=n.lineno,
                    message=(f"module-level `{name}` in chaos plan "
                             f"generation -- use a Random(seed) instance "
                             f"(docs/chaos.md#determinism)")))
        return findings
