"""In-container agentd payload assembly: native supervisor + Python zipapp.

Parity reference: clawkerd/embed/embed.go -- the reference embeds one static
Go binary and the bundler copies it into every agent image as the cache
tail.  This build's daemon is two artifacts: the dependency-free C++
``clawker-supervisord`` (PID 1; native/agentsup) and ``clawker-agentd.pyz``,
a stdlib-only zipapp holding the session daemon (clawker_tpu_torch/agentd plus
the tiny modules it imports).  Both are assembled deterministically so the image
layer cache keys on content.

The port's copy of ``clawker_tpu/bundler/payload.py``, whole: the pyz
carries the port's own modules under ``clawker_tpu_torch/``, none of which
loads torch.
"""

from __future__ import annotations

import io
import os
import zipfile
from pathlib import Path

ENV_SUPERVISOR_BIN = "CLAWKER_TPU_SUPERVISOR_BIN"

_PKG_ROOT = Path(__file__).resolve().parents[1]  # clawker_tpu_torch/

# The transitive closure of clawker_tpu_torch.agentd imports -- everything
# must be stdlib-only so the pyz runs on a bare python3 in any image.
_PYZ_MODULES = (
    "__init__.py",
    "consts.py",
    "errors.py",
    "agentd/__init__.py",
    "agentd/__main__.py",
    "agentd/daemon.py",
    "agentd/protocol.py",
    "agentd/register.py",
    "agentd/supervisor_client.py",
    # container side of the socket bridge (exec'd with the pyz on sys.path)
    "socketbridge/__init__.py",
    "socketbridge/protocol.py",
    "socketbridge/container.py",
)

_PYZ_MAIN = b"""\
from clawker_tpu_torch.agentd.daemon import main

raise SystemExit(main())
"""


def build_agentd_pyz() -> bytes:
    """Deterministic zipapp of the agentd subset (zeroed timestamps)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        entries = {"__main__.py": _PYZ_MAIN}
        for rel in _PYZ_MODULES:
            entries[f"clawker_tpu_torch/{rel}"] = (_PKG_ROOT / rel).read_bytes()
        for name in sorted(entries):
            info = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = 0o644 << 16
            zf.writestr(info, entries[name])
    return buf.getvalue()


def find_supervisor_binary() -> bytes | None:
    """The native clawker-supervisord build output (or env-pointed path)."""
    cand = os.environ.get(ENV_SUPERVISOR_BIN, "")
    paths = [Path(cand)] if cand else []
    paths.append(_PKG_ROOT.parent / "native" / "build" / "clawker-supervisord")
    for p in paths:
        if p.is_file():
            return p.read_bytes()
    return None


def agentd_payload() -> dict[str, bytes] | None:
    """Context files for the image tail, or None when the native binary is
    absent (image then runs its harness CMD directly, no supervision)."""
    from .dockerfile import CTX_AGENTD_PYZ, CTX_SUPERVISOR

    sup = find_supervisor_binary()
    if sup is None:
        return None
    return {
        CTX_SUPERVISOR: sup,
        CTX_AGENTD_PYZ: build_agentd_pyz(),
    }
