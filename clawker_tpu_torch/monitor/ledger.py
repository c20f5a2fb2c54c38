"""Crash-tolerant JSONL tail reader for the anomaly watch.

A copy of the reader half of ``clawker_tpu/monitor/ledger.py``
(``classify_line``, ``parse_jsonl``, ``TailState``, ``tail_jsonl``): the
port imports nothing of the reference package, and the watch must
degrade on a torn netlogger line exactly as the reference does.  The
tests hold the two readers to the same records and the same resets.
"""

from __future__ import annotations

import json
import re
import zlib
from dataclasses import dataclass
from pathlib import Path

CRC_FIELD = "c"                 # reserved record field: 8 hex CRC32 chars
_CRC_RE = re.compile(r'(,?)"c":"([0-9a-f]{8})"\}$')


def classify_line(line: str) -> tuple[str, dict | None]:
    """Classify one JSONL line: ``("ok", doc)`` checksum verified,
    ``("legacy", doc)`` parseable pre-checksum record, ``("mismatch",
    None)`` parseable but the checksum disagrees (a flipped bit),
    ``("garbled", None)`` unparseable (a torn write -- or worse, which
    only its position can tell), ``("blank", None)``.  The checksum
    field is stripped from returned docs."""
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


def parse_jsonl(lines) -> list[dict]:
    """Every parseable JSON object in ``lines``, skipping blanks,
    corrupt lines (torn writes, checksum mismatches) and non-objects."""
    out: list[dict] = []
    for line in lines:
        _, doc = classify_line(line)
        if doc is not None:
            out.append(doc)
    return out


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
