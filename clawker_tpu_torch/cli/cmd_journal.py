"""``journal verify RUN [--repair] [--json]``: the port's copy of
``clawker_tpu/cli/cmd_journal.py`` (exit 0 clean, 2 on corruption).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import click

from .factory import _factory


@click.group("journal")
def journal_group():
    """Inspect and repair run journals (docs/durability.md)."""


def _quarantine_and_rewrite(path: Path) -> dict:
    """Move every damaged line to ``<path>.quarantine`` (appended, with
    a line-number prefix) and atomically rewrite the journal with the
    intact lines verbatim -- kept records are NOT re-encoded, so a
    repair never invents bytes the writer didn't fsync."""
    from ..monitor.ledger import classify_line

    kept: list[str] = []
    bad: list[tuple[int, str]] = []
    with path.open("r", encoding="utf-8", errors="replace") as fh:
        lines = fh.read().splitlines()
    for i, line in enumerate(lines, start=1):
        status, _ = classify_line(line)
        if status == "blank":
            continue
        if status in ("ok", "legacy"):
            kept.append(line)
        else:
            bad.append((i, line))
    if bad:
        sidecar = path.with_name(path.name + ".quarantine")
        with sidecar.open("a", encoding="utf-8") as fh:
            for i, line in bad:
                fh.write(f"{i}:{line}\n")
    tmp = path.with_name(path.name + ".repair")
    with tmp.open("w", encoding="utf-8") as fh:
        fh.write("".join(l + "\n" for l in kept))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return {"kept": len(kept), "quarantined": len(bad)}


@journal_group.command("verify")
@click.argument("run")
@click.option("--repair", is_flag=True,
              help="Quarantine damaged lines to a .quarantine sidecar "
                   "and atomically rewrite the journal with the intact "
                   "records.")
@click.option("--json", "as_json", is_flag=True,
              help="Integrity report as JSON.")
@click.pass_context
def journal_verify(ctx, run, repair, as_json):
    """Checksum-scan RUN's journal (a run id, unambiguous prefix, or a
    journal file path).

    Exit 0 when every record verifies (legacy pre-checksum records and
    a single torn final record are tolerated), exit 2 on corruption.
    With ``--repair`` the damaged lines move to a sidecar and the exit
    reflects the REWRITTEN journal.
    """
    from ..monitor.ledger import verify_jsonl
    from .cmd_loop import _resolve_journal

    path = _resolve_journal(_factory(ctx), run)
    report = verify_jsonl(path)
    repaired = None
    if repair and not report.ok:
        repaired = _quarantine_and_rewrite(path)
        report = verify_jsonl(path)
    if as_json:
        doc = report.to_doc()
        if repaired is not None:
            doc["repaired"] = repaired
        click.echo(json.dumps(doc, indent=2))
    else:
        click.echo(f"{path.name}: {report.total} record(s) -- "
                   f"{report.verified} verified, {report.legacy} legacy, "
                   f"{report.corrupt} corrupt"
                   + (", torn tail" if report.torn_tail else ""))
        if repaired is not None:
            click.echo(f"repaired: kept {repaired['kept']}, quarantined "
                       f"{repaired['quarantined']} -> "
                       f"{path.name}.quarantine")
        if not report.ok:
            click.echo(f"first corrupt record at line "
                       f"{report.first_corrupt_line} -- resume folds only "
                       "the prefix above it (docs/durability.md#verify)",
                       err=True)
    if not report.ok:
        raise SystemExit(2)


def register(root: click.Group) -> None:
    root.add_command(journal_group)
