"""ColorScheme: semantic ANSI styling that collapses to plain text.

The port's copy of ``clawker_tpu/ui/colors.py``, whole.

Parity reference: internal/iostreams/colorscheme.go + styles.go.  Every
method returns the input unchanged when colors are disabled, so call
sites never branch.
"""

from __future__ import annotations

from dataclasses import dataclass

RESET = "\x1b[0m"

_CODES = {
    "bold": "1",
    "dim": "2",
    "red": "31",
    "green": "32",
    "yellow": "33",
    "blue": "34",
    "magenta": "35",
    "cyan": "36",
    "gray": "90",
    "invert": "7",
}


@dataclass
class ColorScheme:
    enabled: bool = False

    def _wrap(self, code: str, s: str) -> str:
        if not self.enabled or not s:
            return s
        return f"\x1b[{code}m{s}{RESET}"

    def bold(self, s: str) -> str:
        return self._wrap(_CODES["bold"], s)

    def dim(self, s: str) -> str:
        return self._wrap(_CODES["dim"], s)

    def red(self, s: str) -> str:
        return self._wrap(_CODES["red"], s)

    def green(self, s: str) -> str:
        return self._wrap(_CODES["green"], s)

    def yellow(self, s: str) -> str:
        return self._wrap(_CODES["yellow"], s)

    def blue(self, s: str) -> str:
        return self._wrap(_CODES["blue"], s)

    def magenta(self, s: str) -> str:
        return self._wrap(_CODES["magenta"], s)

    def cyan(self, s: str) -> str:
        return self._wrap(_CODES["cyan"], s)

    def invert(self, s: str) -> str:
        return self._wrap(_CODES["invert"], s)

    def gray(self, s: str) -> str:
        return self._wrap(_CODES["gray"], s)

    # semantic marks (colorscheme.go SuccessIcon/WarningIcon/FailureIcon)
    def success_icon(self) -> str:
        return self.green("✓") if self.enabled else "+"

    def warning_icon(self) -> str:
        return self.yellow("!") if self.enabled else "!"

    def failure_icon(self) -> str:
        return self.red("✗") if self.enabled else "x"

    def status(self, state: str) -> str:
        """One token colored by convention: running=cyan, done=green,
        failed=red, pending/other=gray."""
        colors = {"running": self.cyan, "done": self.green,
                  "failed": self.red, "stopped": self.yellow}
        return colors.get(state, self.gray)(state)


def visible_len(s: str) -> int:
    """Length without ANSI escapes (layout must align styled cells)."""
    n, i = 0, 0
    while i < len(s):
        if s[i] == "\x1b":
            j = s.find("m", i)
            if j < 0:
                break
            i = j + 1
        else:
            n += 1
            i += 1
    return n
