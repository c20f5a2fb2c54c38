"""Crash-tolerant JSONL: the record framing, the readers, and the flight
recorder.

The port's copy of the JSONL half of ``clawker_tpu/monitor/ledger.py``
(``encode_record``, ``classify_line``, ``IntegrityReport``,
``parse_jsonl``, ``read_jsonl``, ``read_verified_prefix``,
``verify_jsonl``, ``TailState``, ``tail_jsonl``, ``flight_path``,
``read_rotated_lines``, ``FlightRecorder``): the run journal and the
flight recorder write through ``encode_record``, and each package reads
what the other wrote.
The monitoring-units ledger and the rotation-aware tail (``tail_rotated``,
for the fleet console) are not ported yet.

**Flight recorder** -- the post-mortem half of the telemetry subsystem:
an append-only JSONL ledger of one loop run's trace spans (and any
other typed record a subsystem wants preserved), written as events
happen so a crashed run leaves a readable record up to the crash.
Records may land out of order (lane threads, waiter threads, the run
loop all append).
"""

from __future__ import annotations

import json
import os
import re
import threading
import zlib
from dataclasses import dataclass
from pathlib import Path

FLIGHT_DIR = "flight"           # under Config.logs_dir

# --------------------------------------------------------------------------
# record integrity (docs/durability.md): every JSONL record written by
# this module's writers carries a CRC32 of its serialized body as a
# reserved trailing field `"c"`.  One writer, one verifier: the run
# journal, the flight recorder, and the capacity WAL all encode through
# encode_record(), so a flipped bit degrades identically everywhere --
# flagged, never silently folded into a wrong RunImage.  Checksum-less
# legacy records (pre-checksum journals) stay first-class readable.
# --------------------------------------------------------------------------

CRC_FIELD = "c"                 # reserved record field: 8 hex CRC32 chars
_CRC_RE = re.compile(r'(,?)"c":"([0-9a-f]{8})"\}$')


def encode_record(record: dict) -> str:
    """Serialize one record to its checksummed JSONL line (no newline).

    The CRC32 covers the serialized body *without* the checksum field,
    which is spliced on as the final member -- verifiers strip the
    fixed-shape suffix and recompute, no re-serialization ambiguity."""
    body = json.dumps(record, separators=(",", ":"), default=str)
    if not body.endswith("}"):          # non-object: nothing to protect
        return body
    crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    sep = "" if body == "{}" else ","
    return f'{body[:-1]}{sep}"{CRC_FIELD}":"{crc:08x}"}}'


def classify_line(line: str) -> tuple[str, dict | None]:
    """Classify one JSONL line: ``("ok", doc)`` checksum verified,
    ``("legacy", doc)`` parseable pre-checksum record, ``("mismatch",
    None)`` parseable but the checksum disagrees (a flipped bit),
    ``("garbled", None)`` unparseable (a torn write -- or worse, which
    only its position can tell), ``("blank", None)``.  The checksum
    field is stripped from returned docs -- folds and span-loaders
    must never see the transport framing."""
    line = line.strip()
    if not line:
        return "blank", None
    m = _CRC_RE.search(line)
    if m is not None:
        body = line[:m.start()] + "}"
        try:
            doc = json.loads(line)
        except ValueError:
            return "garbled", None
        if not isinstance(doc, dict):
            return "garbled", None
        want = int(m.group(2), 16)
        if (zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF) != want:
            return "mismatch", None
        doc.pop(CRC_FIELD, None)
        return "ok", doc
    try:
        doc = json.loads(line)
    except ValueError:
        return "garbled", None
    if not isinstance(doc, dict):
        return "garbled", None
    return "legacy", doc


@dataclass
class IntegrityReport:
    """What a verifying read saw: counts per classify_line() verdict.

    ``torn_tail`` is the FINAL non-blank line failing to parse -- the
    signature of a writer killed mid-line, tolerated everywhere.
    ``corrupt`` is everything else: a mid-file unparseable line or any
    checksum mismatch -- evidence of real damage, never tolerated
    silently (``clawker journal verify`` exits 2 on it)."""

    path: str = ""
    total: int = 0              # non-blank lines seen
    verified: int = 0           # checksum present and matched
    legacy: int = 0             # parseable, no checksum field
    corrupt: int = 0            # mismatch / mid-file garbage
    torn_tail: bool = False     # final line truncated (crash tail)
    first_corrupt_line: int = 0  # 1-based line number of first damage

    @property
    def ok(self) -> bool:
        return self.corrupt == 0

    def to_doc(self) -> dict:
        return {"path": self.path, "total": self.total,
                "verified": self.verified, "legacy": self.legacy,
                "corrupt": self.corrupt, "torn_tail": self.torn_tail,
                "first_corrupt_line": self.first_corrupt_line,
                "ok": self.ok}


def parse_jsonl(lines, report: IntegrityReport | None = None) -> list[dict]:
    """Every parseable JSON object in ``lines``, skipping blanks,
    corrupt lines, and non-objects.  THE tolerant parse for the
    flight-record format -- ``telemetry.load_spans`` and
    :meth:`FlightRecorder.read` both ride it, so a crashed writer's
    truncated tail degrades identically everywhere.  Checksummed
    records are verified (a mismatch is SKIPPED like a torn line, and
    counted when a ``report`` is passed); the checksum field never
    reaches callers."""
    out: list[dict] = []
    last_garbled = False
    for line in lines:
        status, doc = classify_line(line)
        if status == "blank":
            continue
        last_garbled = status == "garbled"
        if report is not None:
            report.total += 1
            if status == "ok":
                report.verified += 1
            elif status == "legacy":
                report.legacy += 1
            else:
                report.corrupt += 1
                if not report.first_corrupt_line:
                    report.first_corrupt_line = report.total
        if doc is not None:
            out.append(doc)
    if report is not None and last_garbled and report.corrupt:
        # an unparseable FINAL line is the crash-tail signature, not
        # damage (a parseable final line with a bad checksum still is)
        report.corrupt -= 1
        report.torn_tail = True
        if report.first_corrupt_line == report.total:
            report.first_corrupt_line = 0
    return out


def read_jsonl(path: Path,
               report: IntegrityReport | None = None) -> list[dict]:
    """Crash-tolerant JSONL *file* read: every parseable record in
    ``path``, skipping blanks, corrupt lines, and the truncated tail a
    writer that died mid-line leaves behind.  THE shared tail-reader for
    every append-only crash-evidence format (the flight recorder and the
    loop run journal both ride it), so a torn write degrades identically
    everywhere instead of each reader inventing its own tolerance.
    Pass a ``report`` to count checksum verdicts."""
    if report is not None:
        report.path = str(path)
    try:
        text = Path(path).read_text(encoding="utf-8")
    except OSError:
        return []
    return parse_jsonl(text.splitlines(), report)


def read_verified_prefix(path: Path) -> tuple[list[dict], IntegrityReport]:
    """The longest verified prefix of a checksummed JSONL file, for
    folds whose CORRECTNESS rides the records (the run-journal durable
    replay): unlike :func:`read_jsonl`, a damaged mid-file record does
    not skip-and-continue -- the fold STOPS at the last verified record
    before it and the report flags the damage, so ``--resume``
    reconciles from truth rather than from records that survived a
    corruption by accident.  A torn final line is still tolerated."""
    report = IntegrityReport(path=str(path))
    try:
        text = Path(path).read_text(encoding="utf-8")
    except OSError:
        return [], report
    lines = text.splitlines()
    last_nonblank = -1
    for i, line in enumerate(lines):
        if line.strip():
            last_nonblank = i
    out: list[dict] = []
    for i, line in enumerate(lines):
        status, doc = classify_line(line)
        if status == "blank":
            continue
        report.total += 1
        if status == "ok":
            report.verified += 1
            out.append(doc)
        elif status == "legacy":
            report.legacy += 1
            out.append(doc)
        else:
            if status == "garbled" and i == last_nonblank:
                report.torn_tail = True
            else:
                report.corrupt += 1
                report.first_corrupt_line = report.total
            break
    return out, report


def verify_jsonl(path: Path) -> IntegrityReport:
    """Full-file integrity scan (``journal verify``): every line
    classified, nothing skipped early.  A truncated final line reads as
    ``torn_tail`` (a crash artifact, exit 0); anything else
    unverifiable counts as ``corrupt`` (exit 2)."""
    report = IntegrityReport(path=str(path))
    try:
        text = Path(path).read_text(encoding="utf-8")
    except OSError:
        return report
    parse_jsonl(text.splitlines(), report)
    return report


@dataclass
class TailState:
    """Cursor for :func:`tail_jsonl`: byte offset of everything consumed,
    the carried possibly-partial last line, and how many times the file
    was observed truncated/rotated (the anomaly watch compares
    ``resets`` to know when to drop its record window)."""

    offset: int = 0
    carry: bytes = b""
    resets: int = 0
    ino: int = -1               # st_ino of the generation being tailed


def tail_jsonl(path: Path, state: TailState) -> list[dict]:
    """Incremental crash-tolerant JSONL tail: every parseable record
    appended past ``state.offset``; a torn write is SKIPPED, never
    fatal.  A partial trailing line is carried in ``state`` and
    completed by a later append; truncation/rotation resets the cursor
    (and bumps ``state.resets``) so the stream replays from the top.
    Cost is O(new bytes); a missing/unreadable file reads as no news.
    """
    path = Path(path)
    try:
        st = path.stat()
    except OSError:
        return []
    size = st.st_size
    # rotated/truncated: start over.  Size alone cannot tell -- a
    # rotation of fixed-width records can land the new generation at
    # EXACTLY the stale offset -- so the cursor also pins the inode.
    if size < state.offset or (state.ino >= 0 and st.st_ino != state.ino):
        state.offset = 0
        state.carry = b""
        state.resets += 1
    state.ino = st.st_ino
    if size == state.offset:
        return []
    try:
        with open(path, "rb") as f:
            f.seek(state.offset)
            chunk = f.read(size - state.offset)
    except OSError:
        return []
    state.offset += len(chunk)
    data = state.carry + chunk
    lines = data.split(b"\n")
    state.carry = lines.pop()       # possibly-partial last line
    return parse_jsonl(
        line.decode("utf-8", "replace") for line in lines)


def flight_path(logs_dir: Path, run_id: str) -> Path:
    """Canonical flight-recorder path for one loop run."""
    return Path(logs_dir) / FLIGHT_DIR / f"loop-{run_id}.jsonl"


def rotated_path(path: Path) -> Path:
    """The previous generation a size-capped recorder rotated out."""
    return Path(str(path) + ".1")


def read_rotated_lines(path: Path) -> list[str]:
    """Raw lines across the rotation boundary: the ``.1`` generation
    first (older records), then the current file.  Missing files read
    as empty, so the helper serves unrotated recorders unchanged."""
    lines: list[str] = []
    for p in (rotated_path(path), Path(path)):
        try:
            lines.extend(p.read_text(encoding="utf-8").splitlines())
        except OSError:
            continue
    return lines


class FlightRecorder:
    """Append-only JSONL record sink for one run.

    Writes are line-atomic under one lock and flushed per record: the
    recorder exists exactly for the runs that die unexpectedly, so
    buffering records in memory would lose the most interesting tail.
    A recorder whose directory cannot be created degrades to a no-op --
    telemetry must never fail the run it is recording.

    ``max_bytes`` bounds the file for daemon-lifetime recorders (and
    long daemon-hosted runs): when an append would pass the cap, the
    current file rotates to ``<path>.1`` (replacing any prior ``.1``)
    and a fresh generation starts, so the newest records are always in
    a readable, bounded pair of files.  Readers cross the boundary via
    :func:`read_rotated_lines`.  0 = unbounded.
    """

    def __init__(self, path: Path, *, max_bytes: int = 0):
        self.path = Path(path)
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self.dropped = 0
        self.rotations = 0
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
            self._size = self.path.stat().st_size
        except OSError:
            self._fh = None

    def _rotate_locked(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass
        try:
            os.replace(self.path, rotated_path(self.path))
        except OSError:
            pass        # rotation is best-effort; keep appending
        try:
            self._fh = open(self.path, "a", encoding="utf-8")
            self._size = self.path.stat().st_size
            self.rotations += 1
        except OSError:
            self._fh = None

    def append(self, record: dict) -> None:
        if self._fh is None:
            self.dropped += 1
            return
        line = encode_record(record)
        with self._lock:
            if self._fh is None:
                self.dropped += 1
                return
            if (self.max_bytes and self._size
                    and self._size + len(line) + 1 > self.max_bytes):
                self._rotate_locked()
                if self._fh is None:
                    self.dropped += 1
                    return
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
                self._size += len(line) + 1
            except OSError:
                self.dropped += 1

    def close(self) -> None:
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    @staticmethod
    def read(path: Path) -> list[dict]:
        """Every parseable record in the file, skipping a truncated tail
        (the writer may have died mid-line)."""
        return read_jsonl(path)
