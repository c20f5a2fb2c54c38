"""Attach/stream plumbing: the hot TTY copy loop.

The port's copy of ``clawker_tpu/runtime/attach.py``, whole.

Parity reference: internal/docker/pty.go (raw-mode attach) and the stream
select in internal/cmd/container/run/run.go:331-527 (attachThenStart,
waitForContainerExit).
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
from typing import BinaryIO, Iterator


@contextlib.contextmanager
def raw_terminal(fd: int) -> Iterator[None]:
    """Put a real TTY into raw mode for the duration of an attach."""
    import termios
    import tty as tty_mod

    saved = termios.tcgetattr(fd)
    try:
        tty_mod.setraw(fd)
        yield
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)


def pump_streams(
    stream,
    stdin: BinaryIO | None,
    stdout: BinaryIO,
    *,
    stderr: BinaryIO | None = None,
) -> None:
    """Copy stdin -> stream and stream -> stdout until the container side
    closes.  The writer runs on a daemon thread (it may block on a read of a
    terminal forever); the reader runs inline so returning means output is
    fully drained.
    """

    def feed() -> None:
        assert stdin is not None
        try:
            while True:
                chunk = stdin.read(4096)
                if not chunk:
                    break
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                stream.write(chunk)
        except (OSError, ValueError):
            pass
        finally:
            with contextlib.suppress(Exception):
                stream.close_write()

    t = None
    if stdin is not None:
        t = threading.Thread(target=feed, daemon=True, name="attach-stdin")
        t.start()
    err = stderr or stdout
    for fd, payload in stream.frames():
        out = stdout if fd != 2 else err
        out.write(payload)
        with contextlib.suppress(Exception):
            out.flush()


def wire_resize(engine, container_ref: str) -> None:
    """Forward terminal size now and on SIGWINCH (real TTY sessions only)."""
    if not sys.stdout.isatty():
        return

    def push(*_args) -> None:
        with contextlib.suppress(Exception):
            cols, rows = os.get_terminal_size()
            engine.resize_container(container_ref, rows, cols)

    push()
    with contextlib.suppress(ValueError):  # not main thread
        signal.signal(signal.SIGWINCH, push)
