"""Structured logging: stderr + rotating file lane, optional OTLP lane later.

A copy of ``clawker_tpu/logsetup.py``: the port imports nothing of the
reference package.  Loggers share the reference's ``clawker.*`` names.

Parity reference: internal/logger (zerolog + lumberjack rotation + optional
OTLP, SURVEY.md 2.11).  Python build: stdlib logging with a JSON-lines file
handler under the XDG state dir.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import time
from pathlib import Path

_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"


class JsonLinesFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if isinstance(extra, dict):
            out.update(extra)
        return json.dumps(out, separators=(",", ":"))


def setup(level: str = "info", *, log_file: Path | None = None, stderr: bool = True) -> logging.Logger:
    root = logging.getLogger("clawker")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()
    if stderr:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(h)
    if log_file is not None:
        log_file.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=10 * 1024 * 1024, backupCount=3
        )
        fh.setFormatter(JsonLinesFormatter())
        root.addHandler(fh)
    root.propagate = False
    return root


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"clawker.{name}")
