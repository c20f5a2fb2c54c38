"""IOStreams: the one object that knows what the terminal can do.

The port's copy of ``clawker_tpu/ui/iostreams.py``, whole.

Parity reference: internal/iostreams/iostreams.go -- TTY detection
(:209/:221/:239), color capability (:254-:273), terminal width (:200),
spinner progress indicator (:334-:365), pager (:384), alt screen (:159),
prompt capability (:449), and the Test() quad-buffer constructor (:140).
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
import sys
import threading
from typing import IO

from .colors import ColorScheme

SPINNER_FRAMES = "⠋⠙⠹⠸⠼⠴⠦⠧⠇⠏"
SPINNER_INTERVAL_S = 0.08


class IOStreams:
    def __init__(
        self,
        stdin: IO | None = None,
        stdout: IO | None = None,
        stderr: IO | None = None,
        *,
        env: dict[str, str] | None = None,
    ):
        self.stdin = stdin if stdin is not None else sys.stdin
        self.stdout = stdout if stdout is not None else sys.stdout
        self.stderr = stderr if stderr is not None else sys.stderr
        self.env = dict(os.environ if env is None else env)
        self._color_override: bool | None = None
        self._never_prompt = False
        self._spinner_disabled = bool(self.env.get("CLAWKER_NO_SPINNER"))
        self._spinner_thread: threading.Thread | None = None
        self._spinner_stop: threading.Event | None = None
        self._spinner_label = ""
        self._pager_proc: subprocess.Popen | None = None
        self._pager_saved_stdout: IO | None = None
        self._alt_screen = False

    # ------------------------------------------------------------ test seam

    @classmethod
    def test(cls, stdin_data: str = "") -> tuple[
            "IOStreams", io.StringIO, io.StringIO, io.StringIO]:
        """Quad-buffer constructor (iostreams.go:140 Test()): returns
        (streams, in, out, err) with no TTY, no color, no env leakage."""
        fin = io.StringIO(stdin_data)
        fout, ferr = io.StringIO(), io.StringIO()
        s = cls(fin, fout, ferr, env={})
        return s, fin, fout, ferr

    # ------------------------------------------------------------------ tty

    @staticmethod
    def _isatty(stream) -> bool:
        try:
            return bool(stream.isatty())
        except (AttributeError, ValueError):
            return False

    def is_stdin_tty(self) -> bool:
        return self._isatty(self.stdin)

    def is_stdout_tty(self) -> bool:
        return self._isatty(self.stdout)

    def is_stderr_tty(self) -> bool:
        return self._isatty(self.stderr)

    def is_interactive(self) -> bool:
        return self.is_stdin_tty() and self.is_stdout_tty()

    def can_prompt(self) -> bool:
        return self.is_interactive() and not self._never_prompt

    def set_never_prompt(self, v: bool) -> None:
        self._never_prompt = v

    def terminal_width(self, default: int = 80) -> int:
        if not self.is_stdout_tty():
            return default
        try:
            return shutil.get_terminal_size((default, 24)).columns
        except (ValueError, OSError):
            return default

    # ---------------------------------------------------------------- color

    def color_enabled(self) -> bool:
        if self._color_override is not None:
            return self._color_override
        if self.env.get("NO_COLOR"):           # no-color.org contract
            return False
        if self.env.get("CLICOLOR_FORCE", "0") != "0":
            return True
        if self.env.get("CLICOLOR") == "0":
            return False
        if self.env.get("TERM") == "dumb":
            return False
        return self.is_stdout_tty()

    def set_color_enabled(self, v: bool | None) -> None:
        self._color_override = v

    def is_256_color(self) -> bool:
        term = self.env.get("TERM", "")
        return "256color" in term or self.is_truecolor()

    def is_truecolor(self) -> bool:
        return self.env.get("COLORTERM", "") in ("truecolor", "24bit")

    def colors(self) -> ColorScheme:
        return ColorScheme(enabled=self.color_enabled())

    # -------------------------------------------------------------- spinner

    def start_progress(self, label: str = "") -> None:
        """Spinner on stderr while a long op runs; silently a no-op when
        stderr is not a TTY (logs stay clean in pipes/CI)."""
        if self._spinner_disabled or not self.is_stderr_tty():
            self._spinner_label = label
            return
        self.stop_progress()
        self._spinner_label = label
        self._spinner_stop = threading.Event()

        def spin(stop: threading.Event) -> None:
            i = 0
            while not stop.wait(SPINNER_INTERVAL_S):
                frame = SPINNER_FRAMES[i % len(SPINNER_FRAMES)]
                self.stderr.write(f"\r\x1b[2K{frame} {self._spinner_label}")
                self.stderr.flush()
                i += 1
            self.stderr.write("\r\x1b[2K")
            self.stderr.flush()

        self._spinner_thread = threading.Thread(
            target=spin, args=(self._spinner_stop,), name="spinner", daemon=True)
        self._spinner_thread.start()

    def progress_label(self, label: str) -> None:
        self._spinner_label = label

    def stop_progress(self) -> None:
        if self._spinner_stop is not None:
            self._spinner_stop.set()
        if self._spinner_thread is not None:
            self._spinner_thread.join(1.0)
        self._spinner_thread = None
        self._spinner_stop = None

    def run_with_progress(self, label: str, fn):
        """RunWithProgress (iostreams.go:365): spinner around a callable."""
        self.start_progress(label)
        try:
            return fn()
        finally:
            self.stop_progress()

    # ---------------------------------------------------------------- pager

    def pager_command(self) -> str:
        return self.env.get("CLAWKER_PAGER") or self.env.get("PAGER") or ""

    def start_pager(self) -> None:
        """Route stdout through the user's pager (iostreams.go:384); no-op
        without a TTY or configured pager."""
        cmd = self.pager_command()
        if not cmd or not self.is_stdout_tty() or self._pager_proc is not None:
            return
        env = dict(os.environ)
        env.setdefault("LESS", "FRX")   # quit-if-one-screen, keep colors
        try:
            proc = subprocess.Popen(
                cmd, shell=True, stdin=subprocess.PIPE, stdout=self.stdout,
                env=env, text=True,
            )
        except OSError:
            return
        self._pager_proc = proc
        self._pager_saved_stdout = self.stdout
        self.stdout = proc.stdin

    def stop_pager(self) -> None:
        if self._pager_proc is None:
            return
        try:
            self.stdout.close()
        except OSError:
            pass
        self.stdout = self._pager_saved_stdout
        self._pager_saved_stdout = None
        try:
            self._pager_proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self._pager_proc.kill()
        self._pager_proc = None

    # ----------------------------------------------------------- alt screen

    def start_alt_screen(self) -> None:
        if self.is_stdout_tty() and not self._alt_screen:
            self.stdout.write("\x1b[?1049h")
            self.stdout.flush()
            self._alt_screen = True

    def stop_alt_screen(self) -> None:
        if self._alt_screen:
            self.stdout.write("\x1b[?1049l")
            self.stdout.flush()
            self._alt_screen = False

    # ---------------------------------------------------------------- print

    def println(self, *parts: str) -> None:
        self.stdout.write(" ".join(parts) + "\n")

    def eprintln(self, *parts: str) -> None:
        self.stderr.write(" ".join(parts) + "\n")
