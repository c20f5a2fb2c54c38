"""Raw bpf(2) map access via ctypes: no libbpf needed for map operations.

The port's copy of ``clawker_tpu/firewall/bpfsys.py``, whole.

Userspace components that only read/write PINNED maps (the DNS gate
caching resolutions, the handler enrolling cgroups, route sync, GC) need
four syscall commands -- OBJ_GET, MAP_LOOKUP/UPDATE/DELETE_ELEM plus
GET_NEXT_KEY -- none of which require ELF loading.  Program load/attach
(which does need ELF + relocation handling) stays in the native loader
(native/ebpf/fwctl.c, built with libbpf on the target host during
provisioning).  This split means the Python side works on any kernel with
a pinned map directory and zero native Python dependencies.

Parity reference: the reference does all of this through cilium/ebpf in
Go (controlplane/firewall/ebpf/manager.go OpenPinned :182 + map ops);
the syscall-level rewrite is the TPU-VM-friendly equivalent -- the gate
runs inside a container with /sys/fs/bpf bind-mounted, same as the
reference's CoreDNS container.
"""

from __future__ import annotations

import ctypes
import os
import platform
import struct
import subprocess
import time
from pathlib import Path

from .. import consts
from ..errors import ClawkerError
from .maps import (
    MAP_BYPASS,
    MAP_CONTAINERS,
    MAP_DNS_CACHE,
    MAP_ROUTES,
    MAP_TCP_FLOWS,
    MAP_UDP_FLOWS,
    FirewallMaps,
)
from .model import ContainerPolicy, DnsEntry, EgressEvent, RouteKey, RouteVal, UdpFlow

# bpf(2) command numbers (uapi/linux/bpf.h)
BPF_MAP_LOOKUP_ELEM = 1
BPF_MAP_UPDATE_ELEM = 2
BPF_MAP_DELETE_ELEM = 3
BPF_MAP_GET_NEXT_KEY = 4
BPF_OBJ_PIN = 6
BPF_OBJ_GET = 7
BPF_PROG_ATTACH = 8
BPF_PROG_DETACH = 9

BPF_ANY = 0

_SYSCALL_NR = {"x86_64": 321, "aarch64": 280, "arm64": 280}.get(platform.machine())

_libc = ctypes.CDLL(None, use_errno=True)


class BpfError(ClawkerError):
    pass


def _bpf(cmd: int, attr: bytes) -> int:
    if _SYSCALL_NR is None:
        raise BpfError(f"bpf syscall number unknown for {platform.machine()}")
    buf = ctypes.create_string_buffer(attr, len(attr))
    ret = _libc.syscall(_SYSCALL_NR, cmd, buf, len(attr))
    if ret < 0:
        err = ctypes.get_errno()
        raise BpfError(f"bpf(cmd={cmd}) failed: {os.strerror(err)}")
    return ret


def obj_get(pin_path: str | Path) -> int:
    """Open a pinned BPF object; returns its fd."""
    path = str(pin_path).encode() + b"\x00"
    path_buf = ctypes.create_string_buffer(path, len(path))
    attr = struct.pack("<QII", ctypes.addressof(path_buf), 0, 0)
    return _bpf(BPF_OBJ_GET, attr)


class BpfMap:
    """One BPF map: fixed key/value sizes, bytes in / bytes out.  Opened
    from a pin path, or wrapped around an already-live fd (the assembled
    in-process loader, fwprogs.FwKernel, hands fds straight over)."""

    def __init__(self, pin_path: Path | None, key_size: int, value_size: int,
                 *, fd: int | None = None):
        if fd is None and pin_path is None:
            raise BpfError("BpfMap needs a pin_path or an fd")
        self.fd = fd if fd is not None else obj_get(pin_path)
        self.key_size = key_size
        self.value_size = value_size

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    @staticmethod
    def _attr(fd: int, kbuf, value, flags: int = 0) -> bytes:
        # caller holds kbuf/value references across the syscall (thread-safe:
        # buffers live in the caller's frame, never on self)
        return struct.pack(
            "<IxxxxQQQ",
            fd,
            ctypes.addressof(kbuf),
            ctypes.addressof(value) if value is not None else 0,
            flags,
        )

    def lookup(self, key: bytes) -> bytes | None:
        kbuf = ctypes.create_string_buffer(key, self.key_size)
        vbuf = ctypes.create_string_buffer(self.value_size)
        try:
            _bpf(BPF_MAP_LOOKUP_ELEM, self._attr(self.fd, kbuf, vbuf))
        except BpfError:
            return None
        return vbuf.raw

    def update(self, key: bytes, value: bytes, flags: int = BPF_ANY) -> None:
        kbuf = ctypes.create_string_buffer(key, self.key_size)
        vbuf = ctypes.create_string_buffer(value, self.value_size)
        _bpf(BPF_MAP_UPDATE_ELEM, self._attr(self.fd, kbuf, vbuf, flags))

    def delete(self, key: bytes) -> bool:
        kbuf = ctypes.create_string_buffer(key, self.key_size)
        try:
            _bpf(BPF_MAP_DELETE_ELEM, self._attr(self.fd, kbuf, None))
            return True
        except BpfError:
            return False

    def keys(self) -> list[bytes]:
        out: list[bytes] = []
        kbuf = ctypes.create_string_buffer(self.key_size)
        nbuf = ctypes.create_string_buffer(self.key_size)
        # first key: NULL current-key pointer
        attr = struct.pack("<IxxxxQQQ", self.fd, 0, ctypes.addressof(nbuf), 0)
        try:
            _bpf(BPF_MAP_GET_NEXT_KEY, attr)
        except BpfError:
            return out
        while True:
            out.append(nbuf.raw)
            if len(out) > 1_000_000:
                raise BpfError("map iteration runaway")
            kbuf.raw = nbuf.raw
            attr = struct.pack(
                "<IxxxxQQQ", self.fd, ctypes.addressof(kbuf), ctypes.addressof(nbuf), 0
            )
            try:
                _bpf(BPF_MAP_GET_NEXT_KEY, attr)
            except BpfError:
                return out

    def items(self) -> list[tuple[bytes, bytes]]:
        out = []
        for k in self.keys():
            v = self.lookup(k)
            if v is not None:
                out.append((k, v))
        return out


def prog_attach(prog_fd: int, cgroup_fd: int, attach_type: int, flags: int = 0) -> None:
    attr = struct.pack("<IIII", cgroup_fd, prog_fd, attach_type, flags)
    _bpf(BPF_PROG_ATTACH, attr)


def prog_detach(prog_fd: int, cgroup_fd: int, attach_type: int) -> None:
    attr = struct.pack("<IIII", cgroup_fd, prog_fd, attach_type, 0)
    _bpf(BPF_PROG_DETACH, attr)


# --------------------------------------------------------------------------
# FirewallMaps over the pinned set
# --------------------------------------------------------------------------

def _ip_key(ip: str) -> bytes:
    import socket as _s

    return _s.inet_aton(ip)


class PinnedMaps(FirewallMaps):
    """FirewallMaps over /sys/fs/bpf pins.  Events are drained via the
    native loader CLI (ringbuf consumption needs mmap; `fwctl events`
    emits JSON lines), so this class degrades to no events when the
    native tool is absent rather than failing enforcement paths."""

    def __init__(self, pin_dir: str | Path = consts.BPF_PIN_DIR,
                 fwctl: str = "clawker-fwctl"):
        pin = Path(pin_dir)
        self.pin_dir = pin
        self.fwctl = fwctl
        self._maps: list[BpfMap] = []
        try:
            self.containers = self._open(pin / MAP_CONTAINERS, 8, ContainerPolicy.SIZE)
            self.bypass = self._open(pin / MAP_BYPASS, 8, 8)
            self.dns = self._open(pin / MAP_DNS_CACHE, 4, DnsEntry.SIZE)
            self.route_map = self._open(pin / MAP_ROUTES, RouteKey.SIZE, RouteVal.SIZE)
            self.udp = self._open(pin / MAP_UDP_FLOWS, 8, UdpFlow.SIZE)
            self.tcp = self._open(pin / MAP_TCP_FLOWS, 8, UdpFlow.SIZE)
        except BpfError:
            self.close()  # partial pin set: release what was opened
            raise

    def _open(self, path: Path, ksize: int, vsize: int) -> BpfMap:
        m = BpfMap(path, ksize, vsize)
        self._maps.append(m)
        return m

    def close(self) -> None:
        for m in self._maps:
            m.close()

    # containers --------------------------------------------------------
    def enroll(self, cgroup_id, policy):
        self.containers.update(struct.pack("<Q", cgroup_id), policy.pack())

    def unenroll(self, cgroup_id):
        self.containers.delete(struct.pack("<Q", cgroup_id))
        self.bypass.delete(struct.pack("<Q", cgroup_id))

    def lookup_container(self, cgroup_id):
        raw = self.containers.lookup(struct.pack("<Q", cgroup_id))
        return ContainerPolicy.unpack(raw) if raw else None

    def enrolled(self):
        return {
            struct.unpack("<Q", k)[0]: ContainerPolicy.unpack(v)
            for k, v in self.containers.items()
        }

    # bypass ------------------------------------------------------------
    # The Python API speaks unix seconds; the pinned map stores
    # CLOCK_BOOTTIME ns so the kernel's fw_bypass_active can enforce the
    # dead-man deadline itself (fail-closed even if every userspace
    # process dies the moment after granting the bypass).

    @staticmethod
    def _boottime_ns() -> int:
        return time.clock_gettime_ns(time.CLOCK_BOOTTIME)

    def _unix_to_boot_ns(self, deadline_unix: float) -> int:
        return self._boottime_ns() + int((deadline_unix - time.time()) * 1e9)

    def _boot_ns_to_unix(self, deadline_boot_ns: int) -> int:
        return int(time.time() + (deadline_boot_ns - self._boottime_ns()) / 1e9)

    def set_bypass(self, cgroup_id, deadline_unix):
        self.bypass.update(struct.pack("<Q", cgroup_id),
                           struct.pack("<Q", self._unix_to_boot_ns(deadline_unix)))

    def clear_bypass(self, cgroup_id):
        self.bypass.delete(struct.pack("<Q", cgroup_id))

    def bypassed(self, cgroup_id):
        raw = self.bypass.lookup(struct.pack("<Q", cgroup_id))
        if raw is None:
            return False
        return struct.unpack("<Q", raw)[0] > self._boottime_ns()

    def bypass_entries(self):
        return {
            struct.unpack("<Q", k)[0]: self._boot_ns_to_unix(struct.unpack("<Q", v)[0])
            for k, v in self.bypass.items()
        }

    # dns ---------------------------------------------------------------
    def cache_dns(self, ip, entry):
        self.dns.update(_ip_key(ip), entry.pack())

    def lookup_dns(self, ip):
        raw = self.dns.lookup(_ip_key(ip))
        return DnsEntry.unpack(raw) if raw else None

    def dns_entries(self):
        import socket as _s

        return {_s.inet_ntoa(k): DnsEntry.unpack(v) for k, v in self.dns.items()}

    def expire_dns(self, now_unix=None):
        now = int(now_unix if now_unix is not None else time.time())
        removed = 0
        for k, v in self.dns.items():
            if DnsEntry.unpack(v).expires_unix <= now:
                if self.dns.delete(k):
                    removed += 1
        return removed

    # routes ------------------------------------------------------------
    def sync_routes(self, table):
        """Swap-by-diff: upsert the new table, then delete keys not in it.
        BPF hash maps have no transactional replace; upsert-then-prune
        keeps every in-flight lookup hitting either old or new value,
        never a hole (reference: atomic global route_map swap,
        handler.go:1015)."""
        want = {k.pack(): v.pack() for k, v in table.items()}
        for k, v in want.items():
            self.route_map.update(k, v)
        for k in self.route_map.keys():
            if bytes(k) not in want:
                self.route_map.delete(k)

    def lookup_route(self, key):
        raw = self.route_map.lookup(key.pack())
        return RouteVal.unpack(raw) if raw else None

    def routes(self):
        return {RouteKey.unpack(k): RouteVal.unpack(v) for k, v in self.route_map.items()}

    # udp ---------------------------------------------------------------
    def record_udp_flow(self, cookie, flow):
        self.udp.update(struct.pack("<Q", cookie), flow.pack())

    def lookup_udp_flow(self, cookie):
        raw = self.udp.lookup(struct.pack("<Q", cookie))
        return UdpFlow.unpack(raw) if raw else None

    def record_tcp_flow(self, cookie, flow):
        self.tcp.update(struct.pack("<Q", cookie), flow.pack())

    def lookup_tcp_flow(self, cookie):
        raw = self.tcp.lookup(struct.pack("<Q", cookie))
        return UdpFlow.unpack(raw) if raw else None

    # events ------------------------------------------------------------
    def emit_event(self, ev):
        pass  # kernel-only producer on the real map set

    def drain_events(self, max_events=256):
        import json

        try:
            res = subprocess.run(
                [self.fwctl, "events", "--max", str(max_events),
                 "--pin-dir", str(self.pin_dir)],
                capture_output=True, timeout=10,
            )
        except (OSError, subprocess.TimeoutExpired):
            return []
        if res.returncode != 0:
            return []
        out = []
        for line in res.stdout.splitlines():
            try:
                d = json.loads(line)
                from .model import Action, Reason

                out.append(EgressEvent(
                    ts_ns=d["ts_ns"], cgroup_id=d["cgroup"], dst_ip=d["dst_ip"],
                    dst_port=d["dst_port"], zone_hash=d["zone"],
                    verdict=Action(d["verdict"]), proto=d["proto"],
                    reason=Reason(d["reason"]),
                ))
            except (ValueError, KeyError):
                continue
        return out

    # lifecycle ---------------------------------------------------------
    def flush_all(self):
        for m in self._maps:
            for k in m.keys():
                m.delete(k)
