"""Atomic file writes.

A copy of ``atomic_write`` from ``clawker_tpu/util/fs.py``: the sentinel
persists its state file through it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path


def atomic_write(path: Path | str, data: bytes | str, mode: int = 0o644) -> None:
    """Write ``data`` to ``path`` atomically (temp file + fsync + rename).

    Readers never observe a partially written file; on crash the old content
    survives intact.
    """
    path = Path(path)
    if isinstance(data, str):
        data = data.encode("utf-8")
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
