"""Prompter: String/Confirm/Select over IOStreams.

The port's copy of ``clawker_tpu/ui/prompter.py``, whole.

Parity reference: internal/prompter/ (605 LoC; survey 2.4).  Every prompt
refuses politely when the streams cannot prompt (non-TTY or
--no-input), raising instead of hanging a pipeline.
"""

from __future__ import annotations

from ..errors import ClawkerError
from .iostreams import IOStreams


class PromptError(ClawkerError):
    pass


class Prompter:
    def __init__(self, streams: IOStreams):
        self.streams = streams

    def _require_tty(self, what: str) -> None:
        if not self.streams.can_prompt():
            raise PromptError(
                f"cannot prompt for {what}: not an interactive terminal "
                "(pass the value via flags instead)"
            )

    def _readline(self) -> str:
        line = self.streams.stdin.readline()
        if line == "":
            raise PromptError("stdin closed mid-prompt")
        return line.rstrip("\n")

    def string(self, message: str, *, default: str = "") -> str:
        self._require_tty(message)
        cs = self.streams.colors()
        suffix = f" [{default}]" if default else ""
        self.streams.stderr.write(cs.bold(message) + suffix + ": ")
        self.streams.stderr.flush()
        val = self._readline().strip()
        return val or default

    def confirm(self, message: str, *, default: bool = False) -> bool:
        self._require_tty(message)
        cs = self.streams.colors()
        hint = "[Y/n]" if default else "[y/N]"
        while True:
            self.streams.stderr.write(f"{cs.bold(message)} {hint} ")
            self.streams.stderr.flush()
            val = self._readline().strip().lower()
            if not val:
                return default
            if val in ("y", "yes"):
                return True
            if val in ("n", "no"):
                return False

    def select(self, message: str, options: list[str], *, default: int = 0) -> int:
        self._require_tty(message)
        if not options:
            raise PromptError("select: no options")
        cs = self.streams.colors()
        self.streams.eprintln(cs.bold(message))
        for i, opt in enumerate(options):
            marker = ">" if i == default else " "
            self.streams.eprintln(f" {marker} {i + 1}. {opt}")
        while True:
            self.streams.stderr.write(f"choice [1-{len(options)}]: ")
            self.streams.stderr.flush()
            val = self._readline().strip()
            if not val:
                return default
            if val.isdigit() and 1 <= int(val) <= len(options):
                return int(val) - 1
