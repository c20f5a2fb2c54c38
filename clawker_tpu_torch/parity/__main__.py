"""``python -m clawker_tpu_torch.parity`` -- print the reference parity scorecard.

Runs the 22 e2e scenarios from :mod:`clawker_tpu_torch.parity.scenarios` plus
the 30-technique capture-graded adversarial corpus
(:mod:`clawker_tpu_torch.parity.redteam`) against the virtual-internet World +
the real FirewallHandler, and prints the ``N/22 PASS`` + ``M/30
techniques / K captures`` headlines BASELINE.md's firewall-parity metric
is scored on.  Exit code 0 only on a full pass.

``--json`` emits the machine-readable scorecard instead.

The port's copy of ``clawker_tpu/parity/__main__.py``, whole.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

from .redteam import run_corpus
from .scenarios import SCENARIOS, run_all


def default_parity_jobs() -> int:
    """Bounded worker-pool size for the parallel parity suite."""
    import os

    return max(2, min(8, os.cpu_count() or 4))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clawker_tpu_torch.parity")
    ap.add_argument("--json", action="store_true", help="emit JSON scorecard")
    ap.add_argument("--workdir", help="keep scenario artifacts here")
    ap.add_argument("--jobs", "-j", type=int, default=0,
                    help="fan independent scenario/corpus cases across N "
                         "worker processes (0 = auto, 1 = serial)")
    args = ap.parse_args(argv)
    jobs = args.jobs if args.jobs > 0 else default_parity_jobs()

    t0 = time.monotonic()
    if args.workdir:
        base = Path(args.workdir)
        base.mkdir(parents=True, exist_ok=True)
        rows = run_all(base, jobs=jobs)
        red = run_corpus(base / "redteam", jobs=jobs)
    else:
        with tempfile.TemporaryDirectory(prefix="clawker-parity-") as td:
            rows = run_all(Path(td), jobs=jobs)
            red = run_corpus(Path(td) / "redteam", jobs=jobs)
    wall_s = time.monotonic() - t0
    passed = sum(1 for r in rows if r["pass"])
    all_ok = passed == len(rows) and red["passed"] == red["total"] \
        and red["captures"] == 0

    if args.json:
        print(json.dumps({"passed": passed, "total": len(rows),
                          "wall_s": round(wall_s, 3), "scenarios": rows,
                          "redteam": red}))
        return 0 if all_ok else 1

    print("e2e scenarios (reference test/e2e/firewall_test.go):")
    for r in rows:
        mark = "PASS" if r["pass"] else "FAIL"
        detail = "" if r["pass"] else f"  {r['evidence'].get('error', '')}"
        print(f"  [{mark}] {r['name']:<40} {r['ms']:>6} ms{detail}")
    print(f"\n{passed}/{len(rows)} PASS")
    print("\nadversarial corpus (reference test/adversarial, capture-graded):")
    for t in red["techniques"]:
        mark = "PASS" if t["pass"] else "FAIL"
        tag = {"socket": "sock", "twin": "twin", "mixed": "mix "}[t["grading"]]
        print(f"  [{mark}] ({tag}) {t['technique']:<34} {t['detail'][:72]}")
        kr = t.get("kernel_regrade")
        if kr is not None:
            kmark = ("SKIP" if kr.get("skipped")
                     else "PASS" if kr["pass"] else "FAIL")
            print(f"         [kernel {kmark}] {kr['detail'][:68]}")
    print(f"\n{red['passed']}/{red['total']} techniques contained, "
          f"{red['captures']} captures  (total {wall_s:.1f}s)")
    print("grading: (sock) observed on real sockets in the World; "
          "(twin) kernel-twin verdict with synthesized capture; "
          "(mix) twin verdict gating a socket drive.")
    if red.get("kernel_regrade_available"):
        print(f"kernel regrade: twin/mixed techniques re-graded on the REAL "
              f"kernel (verifier-loaded programs, scratch cgroup): "
              f"{', '.join(red['kernel_regraded'])}")
    elif red.get("kernel_regrade_error"):
        print(f"kernel regrade: CRASHED ({red['kernel_regrade_error']}); "
              "twin rows retain twin fidelity.")
    else:
        print("kernel regrade: unavailable on this host (bpf(2)/cgroup-v2); "
              "twin rows retain twin fidelity.")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
