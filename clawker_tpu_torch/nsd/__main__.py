"""``python -m clawker_tpu_torch.nsd`` -- run the namespace container daemon.

Serves the Docker Engine API subset on a unix socket; point DOCKER_HOST
(or settings runtime.docker_host) at it and the ``local`` driver works
unchanged:

    python -m clawker_tpu_torch.nsd --socket /run/clawker/nsd.sock \
        --state-dir /var/lib/clawker-nsd

Root + cgroup-v2 + overlayfs are required (see package docstring).

The port's copy of ``clawker_tpu/nsd/__main__.py``, whole.
"""

from __future__ import annotations

import argparse
import os
import sys

from .server import serve


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clawker_tpu_torch.nsd")
    ap.add_argument("--socket", default=os.environ.get(
        "CLAWKER_TPU_NSD_SOCKET", "/run/clawker/nsd.sock"))
    ap.add_argument("--state-dir", default=os.environ.get(
        "CLAWKER_TPU_NSD_STATE", "/var/lib/clawker-nsd"))
    args = ap.parse_args(argv)
    if os.geteuid() != 0:
        print("nsd: must run as root (namespaces + overlay + cgroups)",
              file=sys.stderr)
        return 1
    print(f"nsd: serving {args.socket} (state {args.state_dir})",
          file=sys.stderr)
    serve(args.state_dir, args.socket)
    return 0


if __name__ == "__main__":
    sys.exit(main())
