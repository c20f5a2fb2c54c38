"""eBPF instruction assembler: build kernel-loadable bytecode in Python.

The port's copy of ``clawker_tpu/firewall/bpfasm.py``, whole.

The TPU-VM build environment has no clang (and no BPF-target compiler at
all), but program load needs only bytes: the bpf(2) PROG_LOAD command
takes an array of `struct bpf_insn` and runs it through the in-kernel
verifier.  This module is a small assembler for that instruction set --
labels, 32/64-bit ALU, byte-swap, memory access, map-fd relocation
(BPF_PSEUDO_MAP_FD ld_imm64) and helper calls -- so the nine firewall
programs (fwprogs.py) can be emitted directly from the same Python
process that manages the maps, and verified by the *real* kernel
verifier instead of a host-compiled twin.

Parity reference: the reference compiles
controlplane/firewall/ebpf/bpf/clawker.c with a pinned clang toolchain
(Dockerfile.controlplane) and embeds the object via bpf2go.  Re-designed
here: the programs are assembled at load time against live map fds, which
removes the ELF/relocation step entirely -- there is no .o artifact to
drift from the loader, and the emitted bytecode is content-hashed for the
audit trail (scripts/bpfgate.py).

Encoding reference: Documentation/bpf/standardization/instruction-set.rst
(public kernel docs).  Each insn is 8 bytes:
  opcode:8  dst_reg:4 src_reg:4  off:16  imm:32   (little-endian)
ld_imm64 is two units with the second unit's imm holding the high word.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# registers
R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10 = range(11)

# instruction classes
BPF_LD = 0x00
BPF_LDX = 0x01
BPF_ST = 0x02
BPF_STX = 0x03
BPF_ALU = 0x04
BPF_JMP = 0x05
BPF_JMP32 = 0x06
BPF_ALU64 = 0x07

# size modifiers
_SIZE = {"w": 0x00, "h": 0x08, "b": 0x10, "dw": 0x18}

# mode modifiers
BPF_IMM = 0x00
BPF_MEM = 0x60

# source
BPF_K = 0x00
BPF_X = 0x08

# alu ops
_ALU_OPS = {
    "add": 0x00, "sub": 0x10, "mul": 0x20, "div": 0x30, "or": 0x40,
    "and": 0x50, "lsh": 0x60, "rsh": 0x70, "neg": 0x80, "mod": 0x90,
    "xor": 0xA0, "mov": 0xB0, "arsh": 0xC0,
}
BPF_END = 0xD0
BPF_TO_LE = 0x00
BPF_TO_BE = 0x08

# jump ops
_JMP_OPS = {
    "ja": 0x00, "jeq": 0x10, "jgt": 0x20, "jge": 0x30, "jset": 0x40,
    "jne": 0x50, "jsgt": 0x60, "jsge": 0x70, "jlt": 0xA0, "jle": 0xB0,
    "jslt": 0xC0, "jsle": 0xD0,
}
BPF_CALL = 0x80
BPF_EXIT = 0x90

# ld_imm64 pseudo source registers
BPF_PSEUDO_MAP_FD = 1

# helper function ids (uapi/linux/bpf.h __BPF_FUNC_MAPPER)
FN_map_lookup_elem = 1
FN_map_update_elem = 2
FN_map_delete_elem = 3
FN_ktime_get_ns = 5
FN_get_socket_cookie = 46
FN_get_current_cgroup_id = 80
FN_ktime_get_boot_ns = 125
FN_ringbuf_reserve = 131
FN_ringbuf_submit = 132
FN_ringbuf_discard = 133


def _s32(v: int) -> int:
    """Clamp an immediate into the signed 32-bit range struct.pack wants."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


@dataclass
class _Insn:
    opcode: int
    dst: int = 0
    src: int = 0
    off: int = 0
    imm: int = 0
    target: str | None = None  # symbolic jump target, resolved at assemble()

    def pack(self) -> bytes:
        return struct.pack(
            "<BBhi", self.opcode, (self.src << 4) | self.dst, self.off,
            _s32(self.imm),
        )


class AsmError(Exception):
    pass


@dataclass
class Asm:
    """One program under construction.  Emitter methods append
    instructions; jump targets are labels resolved by assemble()."""

    name: str = "prog"
    _insns: list[_Insn] = field(default_factory=list)
    _labels: dict[str, int] = field(default_factory=dict)

    # -- structure ----------------------------------------------------
    def label(self, name: str) -> None:
        if name in self._labels:
            raise AsmError(f"{self.name}: duplicate label {name}")
        self._labels[name] = len(self._insns)

    def __len__(self) -> int:
        return len(self._insns)

    # -- ALU ----------------------------------------------------------
    def _alu(self, cls: int, op: str, dst: int, *, src: int | None = None,
             imm: int = 0) -> None:
        code = cls | _ALU_OPS[op] | (BPF_X if src is not None else BPF_K)
        self._insns.append(_Insn(code, dst, src or 0, 0, imm if src is None else 0))

    def mov_imm(self, dst: int, imm: int) -> None:
        self._alu(BPF_ALU64, "mov", dst, imm=imm)

    def mov_reg(self, dst: int, src: int) -> None:
        self._alu(BPF_ALU64, "mov", dst, src=src)

    def mov32_imm(self, dst: int, imm: int) -> None:
        self._alu(BPF_ALU, "mov", dst, imm=imm)

    def alu64_imm(self, op: str, dst: int, imm: int) -> None:
        self._alu(BPF_ALU64, op, dst, imm=imm)

    def alu64_reg(self, op: str, dst: int, src: int) -> None:
        self._alu(BPF_ALU64, op, dst, src=src)

    def alu32_imm(self, op: str, dst: int, imm: int) -> None:
        self._alu(BPF_ALU, op, dst, imm=imm)

    def alu32_reg(self, op: str, dst: int, src: int) -> None:
        self._alu(BPF_ALU, op, dst, src=src)

    def endian_be(self, dst: int, bits: int) -> None:
        """Convert dst to big-endian (on LE hosts: byte swap low `bits`)."""
        self._insns.append(_Insn(BPF_ALU | BPF_END | BPF_TO_BE, dst, 0, 0, bits))

    # -- memory -------------------------------------------------------
    def ldx(self, size: str, dst: int, src: int, off: int) -> None:
        self._insns.append(_Insn(BPF_LDX | _SIZE[size] | BPF_MEM, dst, src, off))

    def stx(self, size: str, dst: int, off: int, src: int) -> None:
        self._insns.append(_Insn(BPF_STX | _SIZE[size] | BPF_MEM, dst, src, off))

    def st_imm(self, size: str, dst: int, off: int, imm: int) -> None:
        self._insns.append(_Insn(BPF_ST | _SIZE[size] | BPF_MEM, dst, 0, off, imm))

    def ld_map_fd(self, dst: int, fd: int) -> None:
        """ld_imm64 with the map-fd pseudo relocation: the kernel replaces
        the fd with the map pointer at load time."""
        self._insns.append(
            _Insn(BPF_LD | _SIZE["dw"] | BPF_IMM, dst, BPF_PSEUDO_MAP_FD, 0, fd))
        self._insns.append(_Insn(0, 0, 0, 0, 0))  # second half of the pair

    # -- control ------------------------------------------------------
    def jmp(self, target: str) -> None:
        self._insns.append(_Insn(BPF_JMP | _JMP_OPS["ja"], 0, 0, 0, 0, target))

    def j_imm(self, op: str, reg: int, imm: int, target: str) -> None:
        self._insns.append(
            _Insn(BPF_JMP | _JMP_OPS[op] | BPF_K, reg, 0, 0, imm, target))

    def j_reg(self, op: str, reg: int, src: int, target: str) -> None:
        self._insns.append(
            _Insn(BPF_JMP | _JMP_OPS[op] | BPF_X, reg, src, 0, 0, target))

    def call(self, helper: int) -> None:
        self._insns.append(_Insn(BPF_JMP | BPF_CALL, 0, 0, 0, helper))

    def exit_(self) -> None:
        self._insns.append(_Insn(BPF_JMP | BPF_EXIT))

    def ret_imm(self, imm: int) -> None:
        self.mov_imm(R0, imm)
        self.exit_()

    # -- assembly -----------------------------------------------------
    def assemble(self) -> bytes:
        out = bytearray()
        for idx, ins in enumerate(self._insns):
            if ins.target is not None:
                if ins.target not in self._labels:
                    raise AsmError(f"{self.name}: undefined label {ins.target}")
                ins = _Insn(ins.opcode, ins.dst, ins.src,
                            self._labels[ins.target] - idx - 1, ins.imm)
            out += ins.pack()
        return bytes(out)

    @property
    def insn_count(self) -> int:
        return len(self._insns)
