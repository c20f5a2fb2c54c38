"""Grandfather baseline: pre-existing findings that don't block the gate.

``analysis-baseline-torch.json`` (repo root) pins the findings that existed
when a checker first shipped.  The gate fails only on findings NOT in
the baseline, so a new checker can land with the codebase imperfect and
still stop the *next* regression.  Policy (docs/static-analysis.md):
every baselined finding must carry an in-code justification comment
near the site, and the baseline should only ever shrink --
``--baseline-update`` drops entries nothing matches anymore (expiry)
and reports LOUDLY when it grows the file (the runner prints the added
count, and the tier-1 repo-clean test caps the committed list at 15),
so disarming the gate is always a visible diff, never a silent one.

Fingerprints are line-number-free -- sha1 over
``checker | path | message`` -- so editing code ABOVE a grandfathered
site doesn't churn the baseline, while moving the finding to another
file or changing what it says does.

The port's copy of ``clawker_tpu/analysis/baseline.py``, whole, but for
``BASELINE_NAME``: the root's ``analysis-baseline.json`` is the
reference's, and holds the reference's paths.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

BASELINE_NAME = "analysis-baseline-torch.json"


def fingerprint(checker: str, path: str, message: str,
                occurrence: int = 0) -> str:
    """``occurrence`` disambiguates identical (checker, path, message)
    findings in one file: without it, a NEW second instance of a
    baselined defect would collide with the grandfathered entry and
    silently pass the gate.  0 keeps the historical value, so existing
    baseline files stay valid."""
    key = f"{checker}|{path}|{message}"
    if occurrence:
        key += f"|{occurrence}"
    return hashlib.sha1(key.encode()).hexdigest()[:16]


class Baseline:
    """An in-memory set of grandfathered findings, JSON round-trippable."""

    def __init__(self, entries: list[dict] | None = None):
        # fingerprint -> entry doc {fingerprint, checker, path, message}
        self._entries: dict[str, dict] = {}
        for e in entries or []:
            fp = e.get("fingerprint") or fingerprint(
                e.get("checker", ""), e.get("path", ""), e.get("message", ""))
            self._entries[fp] = {
                "fingerprint": fp,
                "checker": e.get("checker", ""),
                "path": e.get("path", ""),
                "message": e.get("message", ""),
            }

    def __contains__(self, fp: str) -> bool:
        return fp in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def fingerprints(self) -> list[str]:
        return sorted(self._entries)

    def entries(self) -> list[dict]:
        return [self._entries[fp] for fp in sorted(self._entries)]

    def add(self, finding) -> None:
        self._entries[finding.fingerprint] = {
            "fingerprint": finding.fingerprint,
            "checker": finding.checker,
            "path": finding.path,
            "message": finding.message,
        }

    def remove(self, fp: str) -> None:
        self._entries.pop(fp, None)

    # ------------------------------------------------------------- disk

    @classmethod
    def load(cls, path: Path | str) -> "Baseline":
        p = Path(path)
        if not p.is_file():
            return cls()
        doc = json.loads(p.read_text(encoding="utf-8"))
        return cls(doc.get("findings", []))

    def save(self, path: Path | str) -> Path:
        p = Path(path)
        doc = {
            "version": 1,
            "comment": ("Grandfathered static-analysis findings "
                        "(docs/static-analysis.md). Every entry must have "
                        "an in-code justification comment at the site; "
                        "regenerate with `clawker analyze --baseline-update`."),
            "findings": self.entries(),
        }
        p.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n",
                     encoding="utf-8")
        return p

    def updated_from(self, report) -> "Baseline":
        """The baseline ``--baseline-update`` writes: current active
        findings keep (or gain) entries, stale entries expire."""
        nb = Baseline()
        for f in report.findings:
            nb.add(f)
        return nb
