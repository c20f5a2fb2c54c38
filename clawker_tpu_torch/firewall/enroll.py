"""Container enrollment: cgroup resolution + kernel program attachment.

The port's copy of ``clawker_tpu/firewall/enroll.py``, whole.

Enabling the firewall for a container means (1) resolving its cgroup
directory and kernel cgroup id, (2) attaching the nine fw programs to
that cgroup (via fwctl, BPF_F_ALLOW_MULTI), and (3) writing its
``ContainerPolicy`` into the containers map.  Both the resolver and the
attacher are seams with in-memory fakes so the whole handler surface is
unit-testable off-kernel.

Parity reference: controlplane/firewall/cgroup.go (container_id ->
cgroup path/id via Docker inspect on every call -- resolved fresh, never
cached, so container restarts can't leave a stale id: the drift guard
INV-B2-016) and ebpf/manager.go Install :605.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

from .. import logsetup
from ..errors import ClawkerError

log = logsetup.get("firewall.enroll")

CGROUP_ROOT = "/sys/fs/cgroup"


class EnrollError(ClawkerError):
    pass


class CgroupResolver:
    """container ref -> (cgroup_id, cgroup_path), resolved fresh."""

    def __init__(self, cgroup_root: str = CGROUP_ROOT):
        self.root = cgroup_root

    def resolve(self, engine, container_ref: str) -> tuple[int, str]:
        info = engine.inspect_container(container_ref)
        cid = info.get("Id") or container_ref
        if not (info.get("State") or {}).get("Running"):
            raise EnrollError(f"container {container_ref}: not running")
        candidates = [
            f"{self.root}/system.slice/docker-{cid}.scope",      # systemd driver
            f"{self.root}/docker/{cid}",                          # cgroupfs driver
            f"{self.root}/machine.slice/docker-{cid}.scope",
        ]
        # the first-party nsd daemon reports its cgroup dir directly
        nsd_dir = info.get("NsdCgroupDir")
        if nsd_dir:
            candidates.insert(0, nsd_dir)
        for path in candidates:
            if os.path.isdir(path):
                # kernel cgroup id == the directory inode on cgroup2
                return os.stat(path).st_ino, path
        raise EnrollError(
            f"container {container_ref}: no cgroup dir found (tried {candidates})"
        )


class FakeCgroupResolver(CgroupResolver):
    """Deterministic ids for tests: inode = stable hash of container id."""

    def resolve(self, engine, container_ref):
        info = engine.inspect_container(container_ref)
        cid = info.get("Id") or container_ref
        if not (info.get("State") or {}).get("Running"):
            raise EnrollError(f"container {container_ref}: not running")
        cgid = int.from_bytes(cid.encode()[:6], "big") or 1
        return cgid, f"/fake/cgroup/{cid}"


class Attacher:
    """Attach/detach the program set to a cgroup via the fwctl loader."""

    def __init__(self, fwctl: str = "clawker-fwctl", pin_dir: str = ""):
        self.fwctl = fwctl
        self.pin_dir = pin_dir

    def _run(self, *args: str) -> None:
        cmd = [self.fwctl, *args]
        if self.pin_dir:
            cmd += ["--pin-dir", self.pin_dir]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise EnrollError(f"fwctl {args[0]}: {e}") from None
        if res.returncode != 0:
            raise EnrollError(f"fwctl {args[0]}: {res.stderr.strip()}")

    def attach(self, cgroup_path: str) -> None:
        self._run("attach", "--cgroup", cgroup_path)

    def detach(self, cgroup_path: str) -> None:
        self._run("detach", "--cgroup", cgroup_path)


class KernelAttacher(Attacher):
    """In-process attach: the programs live in THIS process's verified
    FwKernel (firewall/fwprogs) -- no fwctl binary, no pinned object.
    The attacher owns the kernel handle; callers read/write policy
    through its LiveMaps."""

    def __init__(self, kern=None):
        from .fwprogs import FwKernel, LiveMaps

        self.kern = kern if kern is not None else FwKernel()
        self.maps = LiveMaps(self.kern)

    def attach(self, cgroup_path: str) -> None:
        try:
            self.kern.attach_cgroup(cgroup_path)
        except (OSError, ClawkerError) as e:
            raise EnrollError(f"attach {cgroup_path}: {e}") from None

    def detach(self, cgroup_path: str) -> None:
        self.kern.detach_cgroup(cgroup_path)

    def close(self) -> None:
        self.maps.close()
        self.kern.close()


class FakeAttacher(Attacher):
    def __init__(self):
        super().__init__(fwctl="fake-fwctl")
        self.attached: list[str] = []

    def attach(self, cgroup_path):
        if cgroup_path not in self.attached:
            self.attached.append(cgroup_path)

    def detach(self, cgroup_path):
        if cgroup_path in self.attached:
            self.attached.remove(cgroup_path)
