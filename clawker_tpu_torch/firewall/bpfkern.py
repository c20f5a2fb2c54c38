"""bpf(2) program/map lifecycle: create, load (verifier), attach, drain.

The port's copy of ``clawker_tpu/firewall/bpfkern.py``, whole.

bpfsys.py covers the *map data plane* against pinned objects (lookup/
update/delete over /sys/fs/bpf) and needs no privileges beyond the pin
directory.  This module is the *control plane*: creating maps, running
assembled programs (bpfasm.py) through the in-kernel verifier, attaching
them to cgroup-v2 directories with BPF_F_ALLOW_MULTI, pinning, and
consuming the events ringbuf via mmap.  Everything is raw syscalls over
ctypes -- no libbpf, no ELF -- because the programs are assembled in
process against live map fds (see fwprogs.py).

Parity reference: the reference does load/attach through cilium/ebpf
(controlplane/firewall/ebpf/manager.go:120 loadPrograms, :246 Attach)
with BPF_F_ALLOW_MULTI on the container cgroup.  The verifier-log
plumbing here replaces bpf2go's compile-time guarantees: every load
returns the kernel's own verification transcript, which scripts/
bpfgate.py commits as the audit artifact.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
from pathlib import Path

# one syscall layer: the wrapper, attach/detach and the pin commands live
# in bpfsys (the data-plane module); this module adds only the
# control-plane commands on top of it
from .bpfsys import (  # noqa: F401  (re-exported for callers)
    BPF_PROG_ATTACH,
    BPF_PROG_DETACH,
    BpfError,
    _bpf,
    prog_detach,
)

# commands (uapi/linux/bpf.h enum bpf_cmd)
BPF_MAP_CREATE = 0
BPF_PROG_LOAD = 5
BPF_OBJ_PIN = 6
BPF_OBJ_GET = 7

# map types
BPF_MAP_TYPE_HASH = 1
BPF_MAP_TYPE_ARRAY = 2
BPF_MAP_TYPE_LRU_HASH = 9
BPF_MAP_TYPE_RINGBUF = 27

# program types
BPF_PROG_TYPE_CGROUP_SOCK = 9
BPF_PROG_TYPE_CGROUP_SOCK_ADDR = 18

# attach types (enum bpf_attach_type)
BPF_CGROUP_INET_SOCK_CREATE = 2
BPF_CGROUP_INET4_CONNECT = 10
BPF_CGROUP_INET6_CONNECT = 11
BPF_CGROUP_UDP4_SENDMSG = 14
BPF_CGROUP_UDP6_SENDMSG = 15
BPF_CGROUP_UDP4_RECVMSG = 19
BPF_CGROUP_UDP6_RECVMSG = 20
BPF_CGROUP_INET4_GETPEERNAME = 29
BPF_CGROUP_INET6_GETPEERNAME = 30

BPF_F_ALLOW_MULTI = 2

_PAGE = mmap.PAGESIZE

# ringbuf record header flags
_RB_BUSY = 1 << 31
_RB_DISCARD = 1 << 30
_RB_HDR_SZ = 8


BpfKernError = BpfError  # historical alias; one error type for bpf(2)


class VerifierError(BpfError):
    """PROG_LOAD rejected: carries the kernel verifier's transcript."""

    def __init__(self, msg: str, log: str):
        super().__init__(f"{msg}\n--- verifier log ---\n{log.strip()}")
        self.log = log


def map_create(map_type: int, key_size: int, value_size: int,
               max_entries: int, name: str = "") -> int:
    nm = name.encode()[:15]
    attr = struct.pack("<IIIIIII16s", map_type, key_size, value_size,
                       max_entries, 0, 0, 0, nm)
    return _bpf(BPF_MAP_CREATE, attr)


def prog_load(prog_type: int, insns: bytes, *, expected_attach_type: int = 0,
              name: str = "", license_: str = "GPL",
              log_level: int = 1, log_size: int = 1 << 20) -> tuple[int, str]:
    """Load a program through the kernel verifier.

    Returns (prog_fd, verifier_log).  Raises VerifierError with the
    transcript on rejection -- the transcript is the evidence artifact,
    so it is always requested (log_level>=1) even on success.
    """
    if len(insns) % 8:
        raise BpfKernError("instruction stream not a multiple of 8 bytes")
    insn_buf = ctypes.create_string_buffer(insns, len(insns))
    lic = license_.encode() + b"\x00"
    lic_buf = ctypes.create_string_buffer(lic, len(lic))
    # log_level 0 must pass a NULL buffer (the kernel rejects buf-without-level)
    log_buf = ctypes.create_string_buffer(log_size if log_level else 1)
    nm = name.encode()[:15]
    attr = struct.pack(
        "<IIQQIIQII16sII",
        prog_type, len(insns) // 8, ctypes.addressof(insn_buf),
        ctypes.addressof(lic_buf), log_level,
        log_size if log_level else 0,
        ctypes.addressof(log_buf) if log_level else 0,
        0, 0, nm, 0, expected_attach_type,
    )
    try:
        # insn_buf/lic_buf/log_buf stay referenced by this frame across
        # the syscall, so their addresses inside attr remain valid
        fd = _bpf(BPF_PROG_LOAD, attr)
    except VerifierError:
        raise
    except BpfError as e:
        raise VerifierError(str(e), log_buf.value.decode(errors="replace")) from e
    return fd, log_buf.value.decode(errors="replace")


def prog_attach(prog_fd: int, cgroup_fd: int, attach_type: int,
                flags: int = BPF_F_ALLOW_MULTI) -> None:
    """Attach with BPF_F_ALLOW_MULTI by default (the reference manager's
    mode, manager.go:246) -- bpfsys.prog_attach is the flags-explicit
    primitive underneath."""
    from .bpfsys import prog_attach as _raw_attach

    _raw_attach(prog_fd, cgroup_fd, attach_type, flags)


def obj_pin(fd: int, path: str | Path) -> None:
    p = str(path).encode() + b"\x00"
    pbuf = ctypes.create_string_buffer(p, len(p))
    attr = struct.pack("<QII", ctypes.addressof(pbuf), fd, 0)
    _bpf(BPF_OBJ_PIN, attr)


# ---------------------------------------------------------------------------
# ringbuf consumer (mmap, matching kernel/bpf/ringbuf.c layout)
# ---------------------------------------------------------------------------


class RingBufReader:
    """Single-consumer reader over a BPF_MAP_TYPE_RINGBUF fd.

    Layout: consumer page (RW mmap at offset 0, consumer_pos at byte 0);
    producer page + double-mapped data (RO mmap at offset PAGE).  Records
    carry an 8-byte header: u32 len (bit31 busy / bit30 discard), u32
    pg_off; lengths are 8-byte aligned for position advance.
    """

    def __init__(self, fd: int, size: int):
        self.size = size
        self._cons = mmap.mmap(fd, _PAGE, prot=mmap.PROT_READ | mmap.PROT_WRITE,
                               flags=mmap.MAP_SHARED, offset=0)
        self._data = mmap.mmap(fd, _PAGE + 2 * size, prot=mmap.PROT_READ,
                               flags=mmap.MAP_SHARED, offset=_PAGE)

    def close(self) -> None:
        self._cons.close()
        self._data.close()

    def _producer_pos(self) -> int:
        return struct.unpack_from("<Q", self._data, 0)[0]

    def _consumer_pos(self) -> int:
        return struct.unpack_from("<Q", self._cons, 0)[0]

    def drain(self, max_records: int = 4096) -> list[bytes]:
        """Consume available records (skipping discarded ones)."""
        out: list[bytes] = []
        cons = self._consumer_pos()
        while len(out) < max_records:
            prod = self._producer_pos()
            if cons >= prod:
                break
            off = _PAGE + (cons & (self.size - 1))
            hdr = struct.unpack_from("<I", self._data, off)[0]
            if hdr & _RB_BUSY:
                break  # producer still writing this record
            ln = hdr & ~(_RB_BUSY | _RB_DISCARD)
            if not hdr & _RB_DISCARD:
                out.append(bytes(self._data[off + _RB_HDR_SZ:
                                            off + _RB_HDR_SZ + ln]))
            cons += (ln + _RB_HDR_SZ + 7) & ~7
            struct.pack_into("<Q", self._cons, 0, cons)
        return out


# ---------------------------------------------------------------------------
# cgroup v2 helpers
# ---------------------------------------------------------------------------


def cgroup2_root() -> Path | None:
    """Find a writable cgroup-v2 mount (unified hierarchy)."""
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3 and parts[2] == "cgroup2":
                    p = Path(parts[1])
                    if os.access(p, os.W_OK):
                        return p
    except OSError:
        return None
    return None


def cgroup_id(path: str | Path) -> int:
    """cgroup id as the kernel reports it to bpf_get_current_cgroup_id:
    the inode number of the cgroup-v2 directory."""
    return os.stat(path).st_ino


def kernel_available() -> bool:
    """Probe: can this process reach the verifier and a cgroup-v2 dir?
    Loads a two-insn program; cheap enough to call from test gates."""
    if cgroup2_root() is None:
        return False
    try:
        from .bpfasm import Asm
        a = Asm("probe")
        a.ret_imm(1)
        fd, _ = prog_load(BPF_PROG_TYPE_CGROUP_SOCK, a.assemble(),
                          expected_attach_type=BPF_CGROUP_INET_SOCK_CREATE,
                          name="probe", log_level=0)
        os.close(fd)
        return True
    except (BpfKernError, OSError):
        return False
