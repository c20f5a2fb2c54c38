"""The port's firewall kernel half against the reference's, where no
bpf(2), cgroup or bpffs is needed.

Twins of tests/test_bpfasm.py's eleven cases; the nine programs
assembled over several map fd sets, byte for byte, with their
instruction counts and sha256 (and chip_smoke's ``BPF_PROGRAM_SHA256``
read from its source against the reference's digests); a recording
bpf(2) seam (``FakeBpf``) that both packages' ``bpfsys._bpf`` and
``bpfkern._bpf`` call (``bpfkern`` imports the name), under which
``create_maps``, ``FwKernel``'s nine loads, ``attach_cgroup`` and
``detach_all``, ``pin_all``, ``BpfMap``, ``PinnedMaps`` and ``LiveMaps``
issue the same commands with the same attr bytes (pointer fields and
cgroup fds masked; what they point at compared beside them);
``RingBufReader`` over chip_smoke's ``MemfdRing`` (records that wrap,
one discarded, one busy); ``pack_container_policy``; and ``Attacher``
over ``native/ebpf``'s recording ``fwctl-mock``.  The live kernel's
twins are in tests/test_torch_bpf_live.py.
"""

from __future__ import annotations

import ast
import contextlib
import ctypes
import dataclasses
import enum
import errno
import hashlib
import mmap
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import chip_smoke
import clawker_tpu.firewall.bpfasm as ref_bpfasm
import clawker_tpu.firewall.bpfkern as ref_bpfkern
import clawker_tpu.firewall.bpfsys as ref_bpfsys
import clawker_tpu.firewall.enroll as ref_enroll
import clawker_tpu.firewall.fwprogs as ref_fwprogs
import clawker_tpu.firewall.model as ref_model
import clawker_tpu_torch.firewall.bpfasm as port_bpfasm
import clawker_tpu_torch.firewall.bpfkern as port_bpfkern
import clawker_tpu_torch.firewall.bpfsys as port_bpfsys
import clawker_tpu_torch.firewall.enroll as port_enroll
import clawker_tpu_torch.firewall.fwprogs as port_fwprogs
import clawker_tpu_torch.firewall.model as port_model

PKGS = {
    "ref": SimpleNamespace(tag="ref", bpfasm=ref_bpfasm, bpfkern=ref_bpfkern,
                           bpfsys=ref_bpfsys, enroll=ref_enroll,
                           fwprogs=ref_fwprogs, model=ref_model),
    "port": SimpleNamespace(tag="port", bpfasm=port_bpfasm,
                            bpfkern=port_bpfkern, bpfsys=port_bpfsys,
                            enroll=port_enroll, fwprogs=port_fwprogs,
                            model=port_model),
}
ROOT = Path(__file__).resolve().parent.parent
EBPF_DIR = ROOT / "native" / "ebpf"
CC = shutil.which("cc") or shutil.which("gcc")
PROGRAMS = [spec[0] for spec in ref_fwprogs.PROGRAM_SPECS]
FD_SETS = [tuple(range(3, 11)), tuple(range(100, 108)),
           (7, 3, 1000, 65535, 42, 9, 11, 5)]


def both(fn):
    """``fn(m)`` in the reference, then in the port: -> (want, got)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def _units(code: bytes):
    return [code[i:i + 8] for i in range(0, len(code), 8)]


def norm(x):
    """Records, enums and containers of either package as plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                [norm(getattr(x, f.name)) for f in dataclasses.fields(x)])
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return sorted(([norm(k), norm(v)] for k, v in x.items()), key=repr)
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, bytes):
        return x.hex()
    return x


def raised(fn):
    """-> (error type's name, text) of what ``fn()`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the twin compares it
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------ tests/test_bpfasm.py


def test_mov_exit_encoding():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.ret_imm(0)
        return a.assemble()

    want, got = both(run)
    assert got == want
    u = _units(got)
    assert u[0] == bytes.fromhex("b700000000000000")
    assert u[1] == bytes.fromhex("9500000000000000")


def test_ldx_stx_encoding():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.ldx("w", m.bpfasm.R1, m.bpfasm.R10, -88)
        a.stx("dw", m.bpfasm.R10, -8, m.bpfasm.R1)
        return a.assemble()

    want, got = both(run)
    assert got == want
    u = _units(got)
    op, regs, off, imm = struct.unpack("<BBhi", u[0])
    assert op == 0x61 and regs == (10 << 4 | 1) and off == -88
    op, regs, off, imm = struct.unpack("<BBhi", u[1])
    assert op == 0x7B and regs == (1 << 4 | 10) and off == -8


def test_ld_map_fd_is_two_units_with_pseudo_src():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.ld_map_fd(m.bpfasm.R1, 42)
        return a.assemble()

    want, got = both(run)
    assert got == want
    u = _units(got)
    assert len(u) == 2
    op, regs, off, imm = struct.unpack("<BBhi", u[0])
    assert op == 0x18 and regs == (1 << 4 | 1) and imm == 42
    assert u[1] == b"\x00" * 8


def test_jump_offsets_resolve_over_ld_imm64():
    def run(m):
        A = m.bpfasm
        a = A.Asm("t")
        a.j_imm("jeq", A.R0, 0, "end")
        a.ld_map_fd(A.R1, 7)
        a.mov_imm(A.R2, 1)
        a.label("end")
        a.exit_()
        return a.assemble()

    want, got = both(run)
    assert got == want
    _, _, off, _ = struct.unpack("<BBhi", _units(got)[0])
    assert off == 3


def test_backward_jump_negative_offset():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.label("top")
        a.mov_imm(m.bpfasm.R0, 1)
        a.jmp("top")
        return a.assemble()

    want, got = both(run)
    assert got == want
    _, _, off, _ = struct.unpack("<BBhi", _units(got)[1])
    assert off == -2


def test_negative_imm_wraps_to_signed():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.mov32_imm(m.bpfasm.R0, 0xFFFFFFFF)
        return a.assemble()

    want, got = both(run)
    assert got == want
    _, _, _, imm = struct.unpack("<BBhi", _units(got)[0])
    assert imm == -1


def test_undefined_label_raises():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.jmp("nowhere")
        return raised(a.assemble)

    want, got = both(run)
    assert got == want and got[0] == "AsmError"


def test_duplicate_label_raises():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.label("x")
        return raised(lambda: a.label("x"))

    want, got = both(run)
    assert got == want and got[0] == "AsmError"


def test_endian_be_encoding():
    def run(m):
        a = m.bpfasm.Asm("t")
        a.endian_be(m.bpfasm.R1, 32)
        return a.assemble()

    want, got = both(run)
    assert got == want
    op, regs, off, imm = struct.unpack("<BBhi", got)
    assert op == 0xDC and regs == 1 and imm == 32


def test_all_nine_programs_assemble():
    def run(m):
        fds = m.fwprogs.FwMapFds(*range(3, 11))
        out = []
        for name, ptype, atype, build in m.fwprogs.PROGRAM_SPECS:
            asm = build(fds)
            code = asm.assemble()
            lookups = [u for u in _units(code)
                       if struct.unpack("<BBhi", u)[0] == 0x85
                       and struct.unpack("<BBhi", u)[3]
                       == m.bpfasm.FN_map_lookup_elem]
            out.append((name, ptype, atype, asm.insn_count, len(code),
                        len(lookups)))
        return out

    want, got = both(run)
    assert got == want and len(got) == 9
    for name, _, _, count, size, lookups in got:
        assert size % 8 == 0 and size > 0 and count == size // 8, name
        assert lookups, f"{name} never looks up a map"


def test_programs_are_deterministic():
    def run(m):
        fds = m.fwprogs.FwMapFds(*range(3, 11))
        return [(name, build(fds).assemble() == build(fds).assemble())
                for name, _, _, build in m.fwprogs.PROGRAM_SPECS]

    want, got = both(run)
    assert got == want and all(same for _, same in got)


# ----------------------------------------- the nine programs, byte for byte


def _program(m, name: str, fds: tuple) -> dict:
    spec = next(s for s in m.fwprogs.PROGRAM_SPECS if s[0] == name)
    asm = spec[3](m.fwprogs.FwMapFds(*fds))
    code = asm.assemble()
    return {"prog_type": spec[1], "attach_type": spec[2], "code": code,
            "insn_count": asm.insn_count,
            "sha256": hashlib.sha256(code).hexdigest()}


@pytest.mark.parametrize("fds", FD_SETS, ids=lambda f: f"fds{f[0]}-{f[-1]}")
@pytest.mark.parametrize("name", PROGRAMS)
def test_program_bytecode_matches_the_reference(name, fds):
    want, got = both(lambda m: _program(m, name, fds))
    assert got == want
    assert got["insn_count"] * 8 == len(got["code"])


def test_chip_smoke_digest_table_is_the_references():
    """chip_smoke's ``BPF_PROGRAM_SHA256``, read from its source, is the
    reference's assembly over ``FwMapFds(*range(3, 11))``."""
    tree = ast.parse(Path(chip_smoke.__file__).read_text())
    table = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", "") == "BPF_PROGRAM_SHA256"
                         for t in node.targets))
    want = {}
    for name in PROGRAMS:
        doc = _program(PKGS["ref"], name, tuple(range(3, 11)))
        want[name] = (doc["insn_count"], doc["sha256"])
    assert table == want
    assert table == chip_smoke.BPF_PROGRAM_SHA256


# ------------------------------------------------- the recording bpf(2)


# attr offsets of the pointer fields, by command
PTR_FIELDS = {1: (8, 16), 2: (8, 16), 3: (8, 16), 4: (8, 16),
              5: (8, 16, 32), 6: (0,), 7: (0,)}
FD_BASE = 700           # the seam's fds: memfds placed from here up
BPF_MAP_TYPE_RINGBUF = 27
NOW = 1_785_000_000.0   # PinnedMaps' clocks, pinned in both packages
BOOT_NS = 5_000_000_000_000


class FakeBpf:
    """bpf(2) for one package, recorded and emulated in memory.

    Each call records (command, attr bytes with nonzero pointer fields
    and cgroup fds masked, what those point at: instructions, license,
    keys, values, pin paths, the cgroup's path).  Objects get memfds
    placed at the same numbers in both runs (so the ``ld_map_fd``
    immediates agree and closing one closes nothing else); maps keep
    their entries in insertion order, the ring-buffer map's memfd is
    sized as the kernel maps it, pins make a file, PROG_LOAD writes a
    verifier line into the log buffer."""

    def __init__(self, m, root: Path):
        self.m, self.root = m, root
        self.calls: list = []
        self.objs: dict = {}
        self.pins: dict = {}
        self.next_fd = FD_BASE
        self.mine: list = []

    def norm(self, path: str) -> str:
        return path.replace(str(self.root), "<ROOT>")

    def _fd(self, obj, size: int = 0) -> int:
        raw = os.memfd_create("fakebpf")
        if size:
            os.ftruncate(raw, size)
        while True:
            n, self.next_fd = self.next_fd, self.next_fd + 1
            try:
                os.fstat(n)
            except OSError:
                break
        os.dup2(raw, n)
        os.close(raw)
        self.objs[n] = obj
        self.mine.append(n)
        return n

    def fail(self, cmd: int, err: int):
        raise self.m.bpfsys.BpfError(
            f"bpf(cmd={cmd}) failed: {os.strerror(err)}")

    def __call__(self, cmd: int, attr: bytes) -> int:
        masked = bytearray(attr)
        for off in PTR_FIELDS.get(cmd, ()):
            if struct.unpack_from("<Q", attr, off)[0]:
                masked[off:off + 8] = b"\xff" * 8
        seen: list = []
        if cmd in (8, 9):
            target = struct.unpack_from("<I", attr, 0)[0]
            masked[0:4] = b"\xff" * 4
            seen.append(self.norm(os.readlink(f"/proc/self/fd/{target}")))
        self.calls.append((cmd, bytes(masked).hex(), seen))
        return getattr(self, f"cmd{cmd}")(cmd, attr, seen)

    def cmd0(self, cmd, attr, seen):                   # MAP_CREATE
        mtype, ksize, vsize, n = struct.unpack_from("<IIII", attr)
        size = (2 * mmap.PAGESIZE + 2 * n
                if mtype == BPF_MAP_TYPE_RINGBUF else 0)
        return self._fd({"key": ksize, "value": vsize, "data": {}}, size)

    def cmd5(self, cmd, attr, seen):                   # PROG_LOAD
        (_, cnt, insns, lic, level, log_size, log_buf, _, _, name, _,
         _) = struct.unpack("<IIQQIIQII16sII", attr)
        seen += [ctypes.string_at(insns, cnt * 8).hex(),
                 ctypes.string_at(lic).decode()]
        if level and log_buf:
            text = f"processed {cnt} insns\n".encode()
            ctypes.memmove(log_buf, text, min(len(text), log_size - 1))
        return self._fd({"prog": name})

    def _path(self, attr, seen) -> str:
        path = ctypes.string_at(struct.unpack_from("<Q", attr)[0]).decode()
        seen.append(self.norm(path))
        return path

    def cmd6(self, cmd, attr, seen):                   # OBJ_PIN
        path = self._path(attr, seen)
        self.pins[path] = self.objs[struct.unpack_from("<I", attr, 8)[0]]
        Path(path).touch()
        return 0

    def cmd7(self, cmd, attr, seen):                   # OBJ_GET
        path = self._path(attr, seen)
        if path not in self.pins:
            self.fail(cmd, errno.ENOENT)
        return self._fd(self.pins[path])

    def _elem(self, attr, seen):
        fd, kp, vp, _ = struct.unpack("<IxxxxQQQ", attr)
        obj = self.objs[fd]
        key = ctypes.string_at(kp, obj["key"]) if kp else None
        seen.append(key.hex() if key is not None else None)
        return obj, key, vp

    def cmd1(self, cmd, attr, seen):                   # MAP_LOOKUP_ELEM
        obj, key, vp = self._elem(attr, seen)
        if key not in obj["data"]:
            self.fail(cmd, errno.ENOENT)
        ctypes.memmove(vp, obj["data"][key], obj["value"])
        return 0

    def cmd2(self, cmd, attr, seen):                   # MAP_UPDATE_ELEM
        obj, key, vp = self._elem(attr, seen)
        value = ctypes.string_at(vp, obj["value"])
        seen.append(value.hex())
        obj["data"][key] = value
        return 0

    def cmd3(self, cmd, attr, seen):                   # MAP_DELETE_ELEM
        obj, key, _ = self._elem(attr, seen)
        if obj["data"].pop(key, None) is None:
            self.fail(cmd, errno.ENOENT)
        return 0

    def cmd4(self, cmd, attr, seen):                   # MAP_GET_NEXT_KEY
        obj, key, vp = self._elem(attr, seen)
        keys = list(obj["data"])
        at = keys.index(key) + 1 if key in keys else 0
        if at >= len(keys):
            self.fail(cmd, errno.ENOENT)
        ctypes.memmove(vp, keys[at], obj["key"])
        return 0

    def cmd8(self, cmd, attr, seen):                   # PROG_ATTACH
        return 0

    cmd9 = cmd8                                        # PROG_DETACH

    def close(self) -> None:
        for n in self.mine:
            with contextlib.suppress(OSError):
                if os.readlink(f"/proc/self/fd/{n}").startswith(
                        "/memfd:fakebpf"):
                    os.close(n)


@contextlib.contextmanager
def seam(m, root: Path):
    """``m``'s bpf(2) (both names) and ``bpfsys``'s clocks replaced."""
    fake = FakeBpf(m, root)
    saved = [(m.bpfsys, "_bpf", m.bpfsys._bpf),
             (m.bpfkern, "_bpf", m.bpfkern._bpf),
             (m.bpfsys, "time", m.bpfsys.time)]
    m.bpfsys._bpf = m.bpfkern._bpf = fake
    m.bpfsys.time = SimpleNamespace(
        time=lambda: NOW, CLOCK_BOOTTIME=time.CLOCK_BOOTTIME,
        clock_gettime_ns=lambda clock: BOOT_NS)
    try:
        yield fake
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
        fake.close()


def seamed(tmp_path: Path, drive):
    """``drive(m, root)`` under each package's seam: -> (want, got), each
    (the recorded calls, what ``drive`` observed)."""
    def run(m):
        root = tmp_path / m.tag
        root.mkdir()
        with seam(m, root) as fake:
            obs = drive(m, root)
        return fake.calls, norm(obs)
    return both(run)


def _maps_fields(fds) -> list:
    return [getattr(fds, f.name) for f in dataclasses.fields(fds)]


def test_create_maps_issues_the_same_commands(tmp_path):
    def drive(m, root):
        fds = m.fwprogs.create_maps()
        out = _maps_fields(fds)
        fds.close()
        return out, _maps_fields(fds)

    want, got = seamed(tmp_path, drive)
    assert got == want
    calls, (fds, closed) = got
    assert [c[0] for c in calls] == [0] * 8
    assert fds == list(range(FD_BASE, FD_BASE + 8)) and closed == [-1] * 8


def test_fwkernel_loads_the_nine_programs_alike(tmp_path):
    def drive(m, root):
        with m.fwprogs.FwKernel() as kern:
            return [(p.name, p.fd, p.attach_type, p.insn_count, p.sha256,
                     p.verifier_log) for p in kern.progs.values()]

    want, got = seamed(tmp_path, drive)
    assert got == want
    calls, progs = got
    assert [c[0] for c in calls] == [0] * 8 + [5] * 9
    assert [p[0] for p in progs] == PROGRAMS
    # the instructions each load passed are the programs the fds make
    for (_, _, seen), (name, *_ , sha, log) in zip(calls[8:], progs):
        assert hashlib.sha256(bytes.fromhex(seen[0])).hexdigest() == sha
        assert seen[1] == "GPL" and log.startswith("processed ")


def test_attach_cgroup_and_detach_alike(tmp_path):
    def drive(m, root):
        cg, cg2 = root / "cg", root / "cg2"
        cg.mkdir()
        cg2.mkdir()
        kern = m.fwprogs.FwKernel()
        try:
            out = [kern.attach_cgroup(str(cg)) == os.stat(cg).st_ino,
                   kern.attach_cgroup(str(cg)) == os.stat(cg).st_ino,
                   kern.attach_cgroup(str(cg2)) == os.stat(cg2).st_ino,
                   kern.detach_cgroup(str(cg2)), kern.detach_cgroup(str(cg2)),
                   len(kern._attached)]
            kern.detach_all()
            return out + [len(kern._attached), kern._by_path]
        finally:
            kern.close()

    want, got = seamed(tmp_path, drive)
    assert got == want
    calls, obs = got
    assert obs == [True, True, True, True, False, 9, 0, []]
    cmds = [c[0] for c in calls[17:]]
    # re-attach: the new set lands before the old one leaves
    assert cmds == [8] * 9 + [8] * 9 + [9] * 9 + [8] * 9 + [9] * 9 + [9] * 9
    assert {c[2][0] for c in calls[17:]} == {"<ROOT>/cg", "<ROOT>/cg2"}


def test_pin_all_alike(tmp_path):
    def drive(m, root):
        pins = root / "pins"
        with m.fwprogs.FwKernel() as kern:
            kern.pin_all(str(pins))
            kern.pin_all(str(pins))       # stale pins are replaced
        return sorted(p.name for p in pins.iterdir())

    want, got = seamed(tmp_path, drive)
    assert got == want
    calls, names = got
    assert len(names) == 17 and "prog_fw_connect4" in names
    assert [c[0] for c in calls[17:]] == [6] * 34


def test_bpfmap_lookup_update_delete_keys_alike(tmp_path):
    def drive(m, root):
        with m.fwprogs.FwKernel() as kern:
            bm = m.bpfsys.BpfMap(None, 8, 8, fd=kern.maps.bypass)
            k1, k2 = struct.pack("<Q", 1), struct.pack("<Q", 2)
            out = [bm.keys(), bm.lookup(k1)]
            bm.update(k1, struct.pack("<Q", 11))
            bm.update(k2, struct.pack("<Q", 22))
            bm.update(k1, struct.pack("<Q", 33))
            out += [bm.lookup(k1), bm.keys(), bm.items(), bm.delete(k1),
                    bm.delete(k1), bm.keys()]
            return out

    want, got = seamed(tmp_path, drive)
    assert got == want
    assert got[1][1] is None and got[1][-1] == [struct.pack("<Q", 2).hex()]


def _maps_ops(m, maps) -> list:
    """Enroll, bypass, DNS and routes through a ``PinnedMaps``-shaped
    store; -> what each read returned."""
    M = m.model
    pol = M.ContainerPolicy(envoy_ip="10.0.0.2", dns_ip="10.0.0.3",
                            hostproxy_ip="10.0.0.4", hostproxy_port=18374,
                            flags=M.FLAG_ENFORCE | M.FLAG_HOSTPROXY,
                            net_ip="10.0.0.0", net_prefix=24)
    maps.enroll(7001, pol)
    maps.enroll(7002, M.ContainerPolicy(envoy_ip="10.0.0.2",
                                        dns_ip="10.0.0.3"))
    out = [maps.lookup_container(7001), maps.lookup_container(9),
           maps.enrolled()]
    maps.set_bypass(7001, NOW + 30)
    maps.set_bypass(7002, NOW - 1)
    out += [maps.bypassed(7001), maps.bypassed(7002), maps.bypassed(9),
            maps.bypass_entries()]
    maps.clear_bypass(7002)
    maps.cache_dns("203.0.113.7", M.DnsEntry(0x5151, int(NOW) + 300))
    maps.cache_dns("203.0.113.8", M.DnsEntry(0x6262, int(NOW) - 1))
    out += [maps.lookup_dns("203.0.113.7"), maps.lookup_dns("198.18.0.1"),
            maps.dns_entries(), maps.expire_dns(NOW), maps.dns_entries()]
    key = M.RouteKey(0x5151, 443, M.PROTO_TCP)
    maps.sync_routes({key: M.RouteVal(M.Action.REDIRECT, "127.0.0.1", 10000),
                      M.RouteKey(0x6262, 0, M.PROTO_TCP):
                          M.RouteVal(M.Action.DENY)})
    maps.sync_routes({key: M.RouteVal(M.Action.ALLOW)})
    out += [maps.lookup_route(key), maps.routes()]
    maps.unenroll(7001)
    out.append(maps.enrolled())
    maps.flush_all()
    out += [maps.enrolled(), maps.routes(), maps.drain_events()]
    return out


def test_pinned_maps_alike(tmp_path):
    def drive(m, root):
        pins = root / "pins"
        with m.fwprogs.FwKernel() as kern:
            kern.pin_all(str(pins))
        missing = raised(lambda: m.bpfsys.PinnedMaps(root / "none"))
        pm = m.bpfsys.PinnedMaps(pins, fwctl=str(root / "no-fwctl"))
        try:
            return [missing] + _maps_ops(m, pm)
        finally:
            pm.close()

    want, got = seamed(tmp_path, drive)
    assert got == want
    calls, obs = got
    assert obs[0] == ["BpfError", "bpf(cmd=7) failed: No such file or "
                                  "directory"]
    assert obs[-1] == []                 # no fwctl: no events, no failure


def test_live_maps_alike(tmp_path):
    def drive(m, root):
        with m.fwprogs.FwKernel() as kern:
            lm = m.fwprogs.LiveMaps(kern)
            try:
                return _maps_ops(m, lm)
            finally:
                lm.close()

    want, got = seamed(tmp_path, drive)
    assert got == want
    # no pin, no OBJ_GET: the facade writes through the kernel's own fds
    assert {c[0] for c in got[0]} == {0, 1, 2, 3, 4, 5}


# ----------------------------------------------------- the ring buffer


@pytest.mark.parametrize("max_records", [4096, 1, 3, 4, 7])
def test_ringbuf_reader_over_a_memfd_ring(max_records):
    """``chip_smoke.ring_sample``: eight records packed by the package's
    ``EgressEvent`` from 88 bytes before the end of a lap (the second
    one's payload wraps), the fourth discarded, then a busy one.  Each
    package's ``RingBufReader`` returns the same records and leaves the
    consumer position at the same place."""
    def run(m):
        ring, kept, busy = chip_smoke.ring_sample(m.model)
        try:
            reader = m.bpfkern.RingBufReader(ring.fd, ring.size)
            try:
                raw = reader.drain(max_records)
                again = reader.drain(max_records)
            finally:
                reader.close()
            return (norm([m.model.EgressEvent.unpack(r) for r in raw]),
                    norm(kept), busy, ring.consumer(), len(again))
        finally:
            ring.close()

    want, got = both(run)
    assert got == want
    decoded, kept, busy, consumer, _ = got
    assert decoded == kept[:max_records]
    if max_records >= len(kept):
        assert consumer == busy


def test_ringbuf_reader_over_an_empty_ring():
    def run(m):
        ring = chip_smoke.MemfdRing(start=chip_smoke.BPF_RING_BYTES * 2)
        try:
            reader = m.bpfkern.RingBufReader(ring.fd, ring.size)
            try:
                return reader.drain(), ring.consumer()
            finally:
                reader.close()
        finally:
            ring.close()

    want, got = both(run)
    assert got == want == ([], chip_smoke.BPF_RING_BYTES * 2)


@pytest.mark.parametrize("args", [
    (0x0200000A, 0x0300000A, 0, 0, 1, 0, 0),
    (0x0100007F, 0x0100007F, 0x0400000A, 0x7A47, 3, 0x0000000A, 24),
    (0xFFFFFFFF, 0, 0xFFFFFFFF, 0xFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 32),
])
def test_pack_container_policy(args):
    want, got = both(lambda m: m.fwprogs.pack_container_policy(*args))
    assert got == want and len(got) == port_model.ContainerPolicy.SIZE


# ------------------------------------------------ Attacher over fwctl-mock


@pytest.fixture(scope="module")
def fwctl_mock(tmp_path_factory):
    """``make -C native/ebpf fwctl-mock`` into a directory of this
    module's own, so a concurrent build of the tree's copy is never
    read half-written."""
    if CC is None:
        pytest.skip("no host C compiler")
    build = tmp_path_factory.mktemp("ebpf")
    subprocess.run(["make", "-C", str(EBPF_DIR), "fwctl-mock",
                    f"BUILD={build}"], check=True, capture_output=True)
    return str(build / "fwctl-mock")


@pytest.mark.parametrize("case", [
    ("attach", "", {}), ("detach", "", {}), ("attach", "/p", {}),
    ("attach", "", {"FWCTL_MOCK_ATTACH_FAIL": "fw_sendmsg4"}),
    ("attach", "", {"FWCTL_MOCK_NO_PINS": "1"}),
], ids=["attach", "detach", "attach-pin-dir", "attach-fails", "no-pins"])
def test_attacher_over_fwctl_mock(case, fwctl_mock, tmp_path, monkeypatch):
    """Both packages' ``Attacher`` run the same ``fwctl`` command lines,
    the mock records the same libbpf calls, and a failure raises the
    same ``EnrollError`` text."""
    verb, pin_dir, env = case
    for k in [k for k in os.environ if k.startswith("FWCTL_MOCK")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cg = tmp_path / "cg"
    cg.mkdir()

    def run(m):
        seen = []

        def recording_run(cmd, **kw):
            res = subprocess.run(cmd, **kw)
            seen.append((cmd, res.returncode,
                         [line for line in res.stdout.splitlines()
                          if line.startswith("MOCK: ")]))
            return res

        monkeypatch.setattr(m.enroll, "subprocess", SimpleNamespace(
            run=recording_run, TimeoutExpired=subprocess.TimeoutExpired))
        att = m.enroll.Attacher(fwctl=fwctl_mock, pin_dir=pin_dir)
        err = raised(lambda: getattr(att, verb)(str(cg)))
        return seen, err

    want, got = both(run)
    assert got == want
    (cmd, rc, mock), = got[0]
    assert cmd[:3] == [fwctl_mock, verb, "--cgroup"]
    if env:
        assert rc == 1 and got[1][0] == "EnrollError"
    else:
        assert rc == 0 and got[1] is None
        assert len([l for l in mock if l.startswith(f"MOCK: {verb} ")]) == 9
