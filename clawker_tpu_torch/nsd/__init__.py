"""nsd: a native namespace container daemon speaking the Docker API.

The e2e tier (tests/e2e) drives the real CLI against "one real local
daemon" -- the reference assumes dockerd.  TPU-VM worker images (and
this build environment) often have no Docker at all, but they DO have a
root Linux kernel, which is all a container runtime actually needs.
nsd serves the Docker Engine REST API subset the framework's client
(engine/httpapi.py) speaks, over a unix socket, backed by first
principles:

  rootfs     overlayfs upper/work per container over the host root
             (copy-on-write: container writes never touch the host)
  isolation  unshare(1): PID + mount + UTS + IPC namespaces; pivot_root
             into the merged rootfs; fresh /proc; host /dev bind
  cgroups    one cgroup-v2 dir per container (joined pre-exec, so the
             egress firewall's BPF programs attach to real containers)
  lifecycle  create/start/stop/kill/wait/rm/rename/inspect/list
  io         PTY or pipe pumping into stdcopy-framed logs; multi-client
             attach (before or after start); resize; exec via nsenter
  data       put/get archive against the merged rootfs; named volumes
             as bind-mounted directories; events stream

This is an e2e/dev runtime for disposable hosts (it runs containers as
root with the HOST filesystem as the read-only lower layer), not a
production substitute for the hardened docker/TPU-VM drivers -- the
point is that `CLAWKER_TPU_E2E=1 pytest tests/e2e` executes REAL
create/attach/exec/rm against a real kernel with zero external daemons.

Parity reference: the reference's e2e confidence comes from suites run
against dockerd (test/e2e/harness/factory.go:95); nsd replaces that
external dependency with ~1k lines of first-party runtime, the way the
rest of this framework replaces Ory/CoreDNS with first-party designs.

The port's copy of ``clawker_tpu/nsd/__init__.py``, whole.
"""

from .server import NsDaemon, serve  # noqa: F401
