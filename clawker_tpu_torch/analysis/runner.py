"""`clawker analyze` engine-room: argparse front-end + report rendering.

This module is the pure-stdlib entrypoint (``python -m
clawker_tpu_torch.analysis``) so the analyzer runs in <2s on a bare host with
no click/JAX/device libs installed; cli/cmd_analyze.py is a thin click
shim over :func:`main` for the integrated CLI.

Exit codes (CI contract, docs/static-analysis.md):
  0  clean -- no findings outside the committed baseline
  2  new findings
  1  internal error

(Stale baseline entries never change the exit code; they are surfaced
in the report and the tier-1 repo-clean test asserts there are none.)

The port's copy of ``clawker_tpu/analysis/runner.py``, whole.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .baseline import BASELINE_NAME, Baseline
from .core import CHECKERS, AnalysisReport, run_analysis


def default_root() -> Path:
    """The repo this package was imported from: the parent of the
    ``clawker_tpu_torch`` package directory."""
    return Path(__file__).resolve().parents[2]


def render_text(report: AnalysisReport, *, baseline_path: Path) -> str:
    lines: list[str] = []
    for f in report.new:
        lines.append(f.render())
    if report.grandfathered:
        lines.append(f"{len(report.grandfathered)} grandfathered finding(s) "
                     f"in {baseline_path.name} (fix and --baseline-update "
                     f"to shrink)")
    if report.suppressed:
        lines.append(f"{len(report.suppressed)} suppressed by "
                     f"`analyze: allow` justification(s)")
    for fp in report.stale_baseline:
        lines.append(f"stale baseline entry {fp}: nothing matches it "
                     f"anymore -- run --baseline-update to expire it")
    verdict = "ok" if not report.new else f"{len(report.new)} NEW finding(s)"
    lines.append(
        f"analyze: {verdict} ({report.files_scanned} file(s), "
        f"{len(report.checkers)} checker(s), {report.wall_s:.2f}s)")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clawker analyze",
        description=("Static architectural-invariant checks "
                     "(docs/static-analysis.md)."))
    p.add_argument("--root", default=None,
                   help="Repo root to analyze (default: the repo this "
                        "package lives in).")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="Stable JSON report on stdout (CI consumption).")
    p.add_argument("--baseline", default=None,
                   help=f"Baseline file (default: <root>/{BASELINE_NAME}).")
    p.add_argument("--baseline-update", action="store_true",
                   help="Rewrite the baseline to the current findings "
                        "(grandfather new ones, expire stale entries) "
                        "and exit 0.")
    p.add_argument("--checker", action="append", default=None,
                   metavar="ID", help="Run only this checker (repeatable).")
    p.add_argument("--list-checkers", action="store_true",
                   help="List registered checkers and exit.")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_checkers:
        from .core import _load_checkers

        _load_checkers()
        for cid in sorted(CHECKERS):
            print(f"{cid:24s} {CHECKERS[cid].doc}")
        return 0
    root = Path(args.root).resolve() if args.root else default_root()
    if not (root / "clawker_tpu_torch").is_dir():
        print(f"error: {root} has no clawker_tpu_torch package",
              file=sys.stderr)
        return 1
    baseline_path = (Path(args.baseline) if args.baseline
                     else root / BASELINE_NAME)
    baseline = Baseline.load(baseline_path)
    only = set(args.checker) if args.checker else None
    if only:
        from .core import _load_checkers

        _load_checkers()
        unknown = only - set(CHECKERS)
        if unknown:
            print(f"error: unknown checker(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 1
    report = run_analysis(root, baseline=baseline, only=only)
    if args.baseline_update:
        # a scoped (--checker) run only re-learns the selected
        # checkers' entries: every other checker's grandfathered
        # findings were never re-checked and must survive the rewrite
        kept = ([] if only is None else
                [e for e in baseline.entries()
                 if e.get("checker") not in only])
        nb = Baseline(kept + baseline.updated_from(report).entries())
        nb.save(baseline_path)
        grew = len(report.new)
        expired = len(baseline) - (len(nb) - grew)
        print(f"wrote {baseline_path} ({len(nb)} grandfathered finding(s), "
              f"{grew} added, {expired} expired)")
        if grew:
            # growing the baseline disarms the gate for those findings:
            # say so where whoever reads the diff will see it
            print(f"warning: {grew} NEW finding(s) were grandfathered -- "
                  f"each needs an in-code justification comment "
                  f"(docs/static-analysis.md#baseline-workflow)",
                  file=sys.stderr)
        return 0
    if args.as_json:
        sys.stdout.write(report.to_json())
    else:
        print(render_text(report, baseline_path=baseline_path))
    return report.exit_code
