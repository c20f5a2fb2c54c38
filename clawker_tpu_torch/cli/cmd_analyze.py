"""``clawker analyze``: first-party static architectural-invariant checks.

Net-new verb (docs/static-analysis.md).  Walks the package with the
stdlib ``ast`` module and runs the registered checkers -- write-ahead
discipline, import layering + sentinel observe-only, no blocking calls
under locks, AF_UNIX socket hardening, seam/metric registry parity,
chaos plan determinism.  Pre-existing findings live in the committed
grandfather baseline (analysis-baseline-torch.json); NEW findings exit 2.

Thin shim over ``clawker_tpu_torch.analysis.runner.main`` so the same engine
also runs bare (``python -m clawker_tpu_torch.analysis``) on hosts without
the CLI deps installed.

The port's copy of ``clawker_tpu/cli/cmd_analyze.py``, whole.
"""

from __future__ import annotations

import click

from ..errors import ExitError


@click.command("analyze")
@click.option("--json", "as_json", is_flag=True,
              help="Stable JSON report on stdout (CI consumption).")
@click.option("--baseline", "baseline_path", type=click.Path(), default=None,
              help="Baseline file (default: "
                   "<root>/analysis-baseline-torch.json).")
@click.option("--baseline-update", is_flag=True,
              help="Rewrite the baseline to the current findings "
                   "(grandfather new ones, expire stale entries).")
@click.option("--root", "root_path", type=click.Path(exists=True),
              default=None,
              help="Repo root to analyze (default: the repo this package "
                   "lives in).")
@click.option("--checker", "checkers", multiple=True, metavar="ID",
              help="Run only this checker (repeatable; see "
                   "--list-checkers).")
@click.option("--list-checkers", is_flag=True,
              help="List registered checkers and exit.")
def analyze(as_json, baseline_path, baseline_update, root_path, checkers,
            list_checkers):
    """Run the static architectural-invariant checkers.

    Exit 0 when every finding is grandfathered in the committed
    baseline, 2 when a NEW finding exists -- the CI gate.  Checker
    catalogue, the baseline workflow, and how to add a checker:
    docs/static-analysis.md.
    """
    from ..analysis.runner import main as run_main

    argv: list[str] = []
    if as_json:
        argv.append("--json")
    if baseline_path:
        argv += ["--baseline", baseline_path]
    if baseline_update:
        argv.append("--baseline-update")
    if root_path:
        argv += ["--root", root_path]
    for c in checkers:
        argv += ["--checker", c]
    if list_checkers:
        argv.append("--list-checkers")
    rc = run_main(argv)
    if rc:
        raise ExitError(rc)


def register(cli: click.Group) -> None:
    cli.add_command(analyze)
