"""Build-context tar assembly (deterministic).

Entries are emitted in sorted order with zeroed timestamps so an unchanged
context produces byte-identical tars -- the daemon's content-addressed
cache then short-circuits the whole build (reference: internal/bundler tar
context assembly, dockerfile.go:506-565).

The port's copy of ``clawker_tpu/bundler/context.py``, whole.
"""

from __future__ import annotations

import io
import tarfile


def build_context(files: dict[str, bytes]) -> bytes:
    """files: context-relative path -> content. Must include 'Dockerfile'."""
    from .dockerfile import CTX_SUPERVISOR

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name in sorted(files):
            data = files[name]
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            info.mtime = 0
            info.mode = 0o755 if name == CTX_SUPERVISOR else 0o644
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()
