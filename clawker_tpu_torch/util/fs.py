"""Filesystem primitives: atomic writes, advisory locks, safe tree ops.

The port's copy of ``clawker_tpu/util/fs.py``, whole.

Parity reference: internal/storage atomic temp+rename write path and flock
discipline (SURVEY.md 2.5).
"""

from __future__ import annotations

import contextlib
import errno
import fcntl
import os
import tempfile
from pathlib import Path
from typing import Iterator


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


@contextlib.contextmanager
def file_lock(path: Path | str, *, shared: bool = False, timeout_s: float | None = None) -> Iterator[None]:
    """Advisory flock on a sidecar ``<path>.lock`` file.

    Exclusive by default; ``shared=True`` takes a read lock.  ``timeout_s``
    bounds the wait (polling, since flock has no native timeout).
    """
    import time

    lock_path = Path(str(path) + ".lock")
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    op = fcntl.LOCK_SH if shared else fcntl.LOCK_EX
    try:
        if timeout_s is None:
            fcntl.flock(fd, op)
        else:
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    fcntl.flock(fd, op | fcntl.LOCK_NB)
                    break
                except OSError as e:
                    if e.errno not in (errno.EACCES, errno.EAGAIN):
                        raise
                    if time.monotonic() >= deadline:
                        raise TimeoutError(f"lock {lock_path} busy after {timeout_s}s") from e
                    time.sleep(0.02)
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def ensure_dir(path: Path | str, mode: int = 0o755) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    with contextlib.suppress(OSError):
        p.chmod(mode)
    return p


def is_within(root: Path, candidate: Path) -> bool:
    """True if ``candidate`` resolves inside ``root`` (symlink-safe containment).

    Used by the bundle install pipeline to reject symlink escapes
    (reference: internal/bundle install.go symlink-safe install).
    """
    try:
        candidate.resolve().relative_to(root.resolve())
        return True
    except ValueError:
        return False
