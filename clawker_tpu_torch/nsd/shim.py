"""nsd in-container bootstrap: runs as PID 1 inside the fresh namespaces.

Invoked by runtime.py as::

    unshare --fork --pid --mount --uts --ipc --kill-child \
        python -m clawker_tpu_torch.nsd.shim <config.json>

By the time this module runs, the kernel has already given us new PID /
mount / UTS / IPC namespaces.  The shim finishes the container: private
mount propagation, bind mounts (volumes + user binds) into the merged
overlay rootfs, fresh /proc, host /dev, pivot_root, hostname, env, cwd,
then exec of the container command -- which therefore IS PID 1's
process image, exactly like the reference's clawkerd-as-PID-1 model.

Everything here must stay dependency-free (json/os/ctypes only): it
executes before the container exists.  It loads no torch: the port's
package ``__init__`` is plain Python.

The port's copy of ``clawker_tpu/nsd/shim.py``, whole.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

MS_BIND = 0x1000
MS_REC = 0x4000
MS_PRIVATE = 0x40000
MS_RDONLY = 0x1
MS_REMOUNT = 0x20
MNT_DETACH = 0x2

_libc = ctypes.CDLL(None, use_errno=True)


def _mount(src: str, dst: str, fstype: str, flags: int, data: str = "") -> None:
    ret = _libc.mount(src.encode(), dst.encode(), fstype.encode() or None,
                      flags, data.encode() or None)
    if ret != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"mount {src} -> {dst} ({fstype}): {os.strerror(err)}")


def _umount2(target: str, flags: int) -> None:
    if _libc.umount2(target.encode(), flags) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"umount {target}: {os.strerror(err)}")


def _remount_ro(target: str) -> None:
    """Remount a just-bound target read-only, recursively where the
    kernel can.  MS_REMOUNT|MS_BIND with MS_REC needs Linux >= 4.10 (and
    some LTS kernels reject it with EINVAL regardless); on those the
    non-recursive remount still protects the bind itself -- better than
    aborting container start over an `:ro` option (ADVICE r5)."""
    import errno

    try:
        _mount("none", target, "", MS_BIND | MS_REMOUNT | MS_RDONLY | MS_REC)
    except OSError as e:
        if e.errno != errno.EINVAL:
            raise
        _mount("none", target, "", MS_BIND | MS_REMOUNT | MS_RDONLY)


def _pivot_root(new_root: str, put_old: str) -> None:
    SYS_pivot_root = 155  # x86_64
    if _libc.syscall(SYS_pivot_root, new_root.encode(), put_old.encode()) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"pivot_root: {os.strerror(err)}")


def main(argv: list[str]) -> int:
    cfg = json.loads(open(argv[0], encoding="utf-8").read())
    merged = cfg["merged"]

    # 1. nothing we mount may leak back to the host
    _mount("none", "/", "", MS_REC | MS_PRIVATE)

    # 2. essential kernel filesystems inside the new rootfs
    _mount("proc", os.path.join(merged, "proc"), "proc", 0)
    _mount("/dev", os.path.join(merged, "dev"), "", MS_BIND | MS_REC)
    try:
        # /sys NON-recursively (host cgroupfs and friends stay OUT of
        # the container) and read-only: a root process writing host
        # cgroup.procs through a recursive RW bind could move itself
        # out of its enforcement cgroup (docker mounts sysfs ro too)
        sys_dst = os.path.join(merged, "sys")
        _mount("/sys", sys_dst, "", MS_BIND)
        _mount("none", sys_dst, "", MS_BIND | MS_REMOUNT | MS_RDONLY)
    except OSError:
        pass  # sysfs is a nicety, not a requirement

    # 3. volumes + user binds ("src:dst[:opts]")
    for bind in cfg.get("binds", []):
        parts = bind.split(":")
        if len(parts) < 2:
            continue
        src, dst = parts[0], parts[1]
        opts = parts[2] if len(parts) > 2 else ""
        target = os.path.join(merged, dst.lstrip("/"))
        if os.path.isdir(src):
            os.makedirs(target, exist_ok=True)
        else:
            os.makedirs(os.path.dirname(target), exist_ok=True)
            if not os.path.exists(target):
                open(target, "a").close()
        _mount(src, target, "", MS_BIND | MS_REC)
        if "ro" in opts.split(","):
            _remount_ro(target)

    # 4. become the rootfs
    old = os.path.join(merged, ".old_root")
    os.makedirs(old, exist_ok=True)
    os.chdir(merged)
    _pivot_root(".", ".old_root")
    os.chdir("/")
    _umount2("/.old_root", MNT_DETACH)
    try:
        os.rmdir("/.old_root")
    except OSError:
        pass

    # 5. identity + environment
    hostname = cfg.get("hostname", "")
    if hostname:
        _libc.sethostname(hostname.encode(), len(hostname))
    env = dict(cfg.get("env") or {})
    env.setdefault("PATH", "/usr/local/sbin:/usr/local/bin:/usr/sbin:"
                           "/usr/bin:/sbin:/bin")
    env.setdefault("HOSTNAME", hostname)
    workdir = cfg.get("workdir") or "/"
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    if cfg.get("tty"):
        import fcntl
        import termios

        try:
            fcntl.ioctl(0, termios.TIOCSCTTY, 1)
        except OSError:
            pass

    argv_out = cfg["cmd"]
    try:
        os.execvpe(argv_out[0], argv_out, env)
    except OSError as e:
        sys.stderr.write(f"nsd shim: exec {argv_out[0]!r}: {e}\n")
        return 127


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
