"""Dotenv parsing: ``--env-file`` support for agent containers.

The port's copy of ``clawker_tpu/util/dotenv.py``, whole.

Semantics (reference: internal/dotenv, a godotenv derivative -- behavior
re-derived, not translated):

- ``KEY=VALUE`` lines; optional ``export `` prefix; ``#`` comments
  (full-line, or trailing after an unquoted value).
- Double-quoted values process ``\\n``/``\\t``/``\\"``/``\\\\`` escapes
  and expand variables; single-quoted values are literal; unquoted
  values are trimmed and expanded.
- ``$VAR`` / ``${VAR}`` expansion resolves earlier keys in the same
  file first, then the lookup function (default: process env); unknown
  variables expand to "" (godotenv behavior).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Callable

from ..errors import ClawkerError

_LINE = re.compile(
    r"""^\s*(?:export\s+)?(?P<key>[A-Za-z_][A-Za-z0-9_.]*)\s*=\s*(?P<rest>.*)$""")
_VAR = re.compile(r"\$(?:\{(?P<braced>[A-Za-z_][A-Za-z0-9_]*)\}"
                  r"|(?P<bare>[A-Za-z_][A-Za-z0-9_]*))")

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "$": "$"}


class DotenvError(ClawkerError):
    pass


def _expand(value: str, env: dict[str, str],
            lookup: Callable[[str], str | None]) -> str:
    def sub(m: re.Match) -> str:
        name = m.group("braced") or m.group("bare")
        if name in env:
            return env[name]
        got = lookup(name)
        return got if got is not None else ""
    return _VAR.sub(sub, value)


def _unescape(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            out.append(_ESCAPES.get(value[i + 1], "\\" + value[i + 1]))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def parse(text: str, *, lookup: Callable[[str], str | None] | None = None,
          source: str = "<dotenv>") -> dict[str, str]:
    lookup = lookup if lookup is not None else os.environ.get
    out: dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(raw)
        if m is None:
            raise DotenvError(f"{source}:{lineno}: not KEY=VALUE: {line!r}")
        key, rest = m.group("key"), m.group("rest").strip()
        if rest.startswith('"'):
            end = _closing_quote(rest, '"')
            if end < 0:
                raise DotenvError(f"{source}:{lineno}: unterminated double quote")
            # \$ must survive as a literal dollar: protect it BEFORE
            # anything else or pa\$\$wd would expand the unescaped "$wd".
            # Escapes are processed on the LITERAL source text, and only
            # THEN variables expand -- godotenv order: a referenced var
            # whose value contains a literal backslash sequence (e.g.
            # "\\n") must come through verbatim, not escape-processed.
            inner = rest[1:end].replace("\\$", "\x00")
            value = _expand(_unescape(inner), out, lookup).replace("\x00", "$")
        elif rest.startswith("'"):
            end = rest.find("'", 1)
            if end < 0:
                raise DotenvError(f"{source}:{lineno}: unterminated single quote")
            value = rest[1:end]          # literal: no escapes, no expansion
        else:
            # unquoted: strip trailing comment, then expand
            hash_pos = rest.find(" #")
            if rest.startswith("#"):
                rest = ""
            elif hash_pos >= 0:
                rest = rest[:hash_pos]
            value = _expand(rest.strip(), out, lookup)
        out[key] = value
    return out


def _closing_quote(s: str, q: str) -> int:
    i = 1
    while i < len(s):
        if s[i] == "\\":
            i += 2
            continue
        if s[i] == q:
            return i
        i += 1
    return -1


def parse_file(path: str | Path, *,
               lookup: Callable[[str], str | None] | None = None) -> dict[str, str]:
    p = Path(path)
    try:
        text = p.read_text(encoding="utf-8")
    except OSError as e:
        raise DotenvError(f"env file {p}: {e}") from None
    return parse(text, lookup=lookup, source=str(p))
