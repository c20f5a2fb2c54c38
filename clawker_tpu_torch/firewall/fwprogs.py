"""The nine egress-firewall programs, assembled for the real kernel.

The port's copy of ``clawker_tpu/firewall/fwprogs.py``, whole.

This is the in-kernel enforcement path built with bpfasm.py: the same
decision procedure as the executable spec (policy.py decide, step
numbers in comments match) and the C twin (native/ebpf/fw.c), emitted
as verifier-ready bytecode against live map fds.  Loading happens at
runtime through bpfkern.prog_load, so the *kernel verifier* -- not a
host-compiled simulation -- is the gate every program passes before it
can enforce (scripts/bpfgate.py commits the transcripts).

Program set (fw.c:1-10, reference clawker.c:121-394):

  fw_connect4 / fw_connect6        TCP/UDP connect() policy + rewrite
  fw_sendmsg4 / fw_sendmsg6        unconnected-UDP sendto() policy
  fw_recvmsg4 / fw_recvmsg6        reverse-NAT of redirected UDP replies
  fw_getpeername4 / fw_getpeername6  apps see the dst they aimed at
  fw_sock_create                   SOCK_RAW / SOCK_PACKET deny

Frame layout (all programs share it; r10 = frame pointer):

  fp-8   u64 cgroup id (key slot for cg-keyed lookups)
  fp-16  u64 socket cookie / bypass-deadline scratch
  fp-20  u32 dns_cache key (dst ip)
  fp-32  route key (12B: zone @-32, port @-24, proto @-22, pad @-21)
  fp-48  verdict (16B: action @-48, reason @-47, rport @-46, rip @-44,
                  zone @-40) -- mirrors struct fw_verdict
  fp-56  udp_flow value (ip @-56, port @-52, pad @-50)
  fp-64  u64 ktime scratch (rate-limit window 'now')
  fp-80  fw_rl fresh value (window @-80, count @-72, pad @-68)
  fp-88  decision inputs: dst u32 @-88, dport u16 @-84, proto u8 @-82

Registers: r6 = ctx, r7 = cgroup id, r8 = container policy pointer,
r9 = ringbuf record pointer inside the emit block.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass

from . import bpfkern as K
from . import bpfsys as _bpfsys
from .bpfasm import (
    FN_get_current_cgroup_id,
    FN_get_socket_cookie,
    FN_ktime_get_boot_ns,
    FN_ktime_get_ns,
    FN_map_delete_elem,
    FN_map_lookup_elem,
    FN_map_update_elem,
    FN_ringbuf_reserve,
    FN_ringbuf_submit,
    R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10,
    Asm,
)

# actions / reasons / flags -- model.py Action/Reason, fw_maps.h defines
ALLOW, DENY, REDIRECT, REDIRECT_DNS = 0, 1, 2, 3
(R_UNMANAGED, R_BYPASS, R_LOOPBACK, R_DNS, R_ENVOY, R_HOSTPROXY, R_ROUTE,
 R_NO_ROUTE, R_NO_DNS_ENTRY, R_RAW_SOCKET, R_IPV6, R_MONITOR,
 R_INTRA_NET) = range(13)
F_ENFORCE, F_HOSTPROXY = 1, 2
PROTO_TCP, PROTO_UDP = 6, 17

HTONS_53 = 0x3500           # port 53 as a __be16 value on a LE host
V4MAPPED_W2 = 0xFFFF0000    # ::ffff: prefix word as loaded LE
V6_LOOPBACK_W3 = 0x01000000  # ::1 last word as loaded LE

RL_WINDOW_NS = 100_000_000
RL_BURST = 64
EVENT_SZ = 40
RING_SZ = 1 << 19

# bpf_sock_addr field offsets (uapi layout; fw.c:35-45 local decl)
CTX_USER_IP4 = 4
CTX_USER_IP6 = 8            # [4]__u32 at 8,12,16,20
CTX_USER_PORT = 24
CTX_PROTOCOL = 36
# struct bpf_sock offsets (sock_create)
SK_TYPE = 8
SOCK_RAW, SOCK_PACKET = 3, 10

# container policy field offsets (struct fw_container / ContainerPolicy.FMT)
POL_ENVOY_IP = 0
POL_DNS_IP = 4
POL_HOSTPROXY_IP = 8
POL_HOSTPROXY_PORT = 12
POL_FLAGS = 16
POL_NET_IP = 20
POL_NET_PREFIX = 24


@dataclass
class FwMapFds:
    """Live map fds shared by all nine programs (fw.c map section)."""

    containers: int
    bypass: int
    dns_cache: int
    routes: int
    udp_flows: int
    tcp_flows: int
    events: int
    ratelimit: int

    def close(self) -> None:
        for name, fd in list(self.__dict__.items()):
            if isinstance(fd, int) and fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
                setattr(self, name, -1)  # idempotent: never re-close a
                # number the OS may have reallocated


def create_maps() -> FwMapFds:
    """Create the live map set (sizes from fw_maps.h / model.py)."""
    return FwMapFds(
        containers=K.map_create(K.BPF_MAP_TYPE_HASH, 8, 28, 1024, "containers"),
        bypass=K.map_create(K.BPF_MAP_TYPE_HASH, 8, 8, 1024, "bypass"),
        dns_cache=K.map_create(K.BPF_MAP_TYPE_LRU_HASH, 4, 16, 65536, "dns_cache"),
        routes=K.map_create(K.BPF_MAP_TYPE_HASH, 12, 8, 16384, "routes"),
        udp_flows=K.map_create(K.BPF_MAP_TYPE_LRU_HASH, 8, 8, 4096, "udp_flows"),
        tcp_flows=K.map_create(K.BPF_MAP_TYPE_LRU_HASH, 8, 8, 4096, "tcp_flows"),
        events=K.map_create(K.BPF_MAP_TYPE_RINGBUF, 0, 0, RING_SZ, "events"),
        ratelimit=K.map_create(K.BPF_MAP_TYPE_LRU_HASH, 8, 16, 1024, "ratelimit"),
    )


# ---------------------------------------------------------------------------
# shared emitters.  Each is inlined at most once per program; label names
# are fixed because every program gets its own Asm namespace.
# ---------------------------------------------------------------------------


def _zero_verdict(a: Asm) -> None:
    a.st_imm("dw", R10, -48, 0)   # action/reason/rport/rip
    a.st_imm("dw", R10, -40, 0)   # zone_hash


def _set_verdict(a: Asm, action: int, reason: int) -> None:
    a.st_imm("b", R10, -48, action)
    a.st_imm("b", R10, -47, reason)


def _lookup(a: Asm, map_fd: int, key_off: int) -> None:
    """r0 = map_lookup_elem(map, fp+key_off); clobbers r1-r5."""
    a.ld_map_fd(R1, map_fd)
    a.mov_reg(R2, R10)
    a.alu64_imm("add", R2, key_off)
    a.call(FN_map_lookup_elem)


def _emit_bypass_check(a: Asm, m: FwMapFds, *, active: str, inactive: str,
                       pfx: str) -> None:
    """fw_bypass_active (fw.c:76-87): dead-man enforced in-kernel -- an
    expired entry is deleted on first touch (fail-closed)."""
    _lookup(a, m.bypass, -8)
    a.j_imm("jeq", R0, 0, inactive)
    a.ldx("dw", R1, R0, 0)
    a.stx("dw", R10, -16, R1)          # save deadline across the helper call
    a.call(FN_ktime_get_boot_ns)
    a.ldx("dw", R1, R10, -16)
    a.j_reg("jle", R0, R1, active)     # now <= deadline
    a.ld_map_fd(R1, m.bypass)          # expired: delete, enforcement resumes
    a.mov_reg(R2, R10)
    a.alu64_imm("add", R2, -8)
    a.call(FN_map_delete_elem)
    a.jmp(inactive)
    _ = pfx


def _emit_event_block(a: Asm, m: FwMapFds) -> None:
    """fw_emit + fw_rl_admit (fw.c:133-175), label "emit", falling through
    to whatever the caller emits next.  Reads cg from r7/fp-8, verdict from
    fp-48, dst/dport/proto from fp-88/-84/-82.  Clobbers r0-r5, r9."""
    a.label("emit")
    # -- rate limit (windowed counter; racy reset is fine for telemetry)
    a.call(FN_ktime_get_ns)
    a.stx("dw", R10, -64, R0)
    _lookup(a, m.ratelimit, -8)
    a.j_imm("jeq", R0, 0, "rl_fresh")
    a.ldx("dw", R1, R0, 0)             # window_start
    a.ldx("dw", R2, R10, -64)          # now
    a.mov_reg(R3, R2)
    a.alu64_reg("sub", R3, R1)
    a.mov_imm(R4, RL_WINDOW_NS)
    a.j_reg("jgt", R3, R4, "rl_reset")
    a.ldx("w", R1, R0, 8)              # count
    a.j_imm("jge", R1, RL_BURST, "skip_emit")
    a.alu64_imm("add", R1, 1)
    a.stx("w", R0, 8, R1)
    a.jmp("rl_admitted")
    a.label("rl_reset")
    a.stx("dw", R0, 0, R2)
    a.st_imm("w", R0, 8, 1)
    a.jmp("rl_admitted")
    a.label("rl_fresh")
    a.ldx("dw", R1, R10, -64)
    a.stx("dw", R10, -80, R1)
    a.st_imm("w", R10, -72, 1)
    a.st_imm("w", R10, -68, 0)
    a.ld_map_fd(R1, m.ratelimit)
    a.mov_reg(R2, R10)
    a.alu64_imm("add", R2, -8)
    a.mov_reg(R3, R10)
    a.alu64_imm("add", R3, -80)
    a.mov_imm(R4, 0)
    a.call(FN_map_update_elem)
    a.label("rl_admitted")
    # -- reserve + fill struct fw_event (40B)
    a.ld_map_fd(R1, m.events)
    a.mov_imm(R2, EVENT_SZ)
    a.mov_imm(R3, 0)
    a.call(FN_ringbuf_reserve)
    a.j_imm("jeq", R0, 0, "skip_emit")
    a.mov_reg(R9, R0)
    a.call(FN_ktime_get_ns)
    a.stx("dw", R9, 0, R0)             # ts_ns
    a.stx("dw", R9, 8, R7)             # cgroup_id
    a.ldx("dw", R1, R10, -40)
    a.stx("dw", R9, 16, R1)            # zone_hash
    a.ldx("w", R1, R10, -88)
    a.stx("w", R9, 24, R1)             # dst_ip
    a.ldx("h", R1, R10, -84)
    a.stx("h", R9, 28, R1)             # dst_port
    a.ldx("b", R1, R10, -48)
    a.stx("b", R9, 30, R1)             # verdict
    a.ldx("b", R1, R10, -82)
    a.stx("b", R9, 31, R1)             # proto
    a.ldx("b", R1, R10, -47)
    a.stx("b", R9, 32, R1)             # reason
    for off in range(33, 40):
        a.st_imm("b", R9, off, 0)
    a.mov_reg(R1, R9)
    a.mov_imm(R2, 0)
    a.call(FN_ringbuf_submit)
    a.label("skip_emit")


def _emit_decide(a: Asm, m: FwMapFds) -> None:
    """fw_decide (fw.c:181-294) == policy.py decide, step for step.
    Inputs: r7/fp-8 cg, r8 pol, fp-88/-84/-82 dst/dport/proto.  Every
    path ends at label "emit" (event paths) or "dispatch" (quiet allows)
    with the verdict at fp-48."""
    _zero_verdict(a)
    # 2. bypass
    _emit_bypass_check(a, m, active="d_bypass", inactive="d_nobypass", pfx="d")
    a.label("d_bypass")
    _set_verdict(a, ALLOW, R_BYPASS)
    a.jmp("emit")
    a.label("d_nobypass")
    # 3. loopback: first octet 127 (low byte of the be32 as loaded)
    a.ldx("w", R1, R10, -88)
    a.alu64_imm("and", R1, 0xFF)
    a.j_imm("jne", R1, 127, "d_notlo")
    _set_verdict(a, ALLOW, R_LOOPBACK)
    a.jmp("dispatch")
    a.label("d_notlo")
    # 4. all DNS flows terminate at our gate
    a.ldx("h", R1, R10, -84)
    a.j_imm("jne", R1, HTONS_53, "d_notdns")
    a.ldx("w", R2, R8, POL_DNS_IP)
    a.ldx("w", R1, R10, -88)
    a.j_reg("jne", R1, R2, "d_dnsredir")
    _set_verdict(a, ALLOW, R_DNS)
    a.jmp("dispatch")
    a.label("d_dnsredir")
    _set_verdict(a, REDIRECT_DNS, R_DNS)
    a.stx("w", R10, -44, R2)           # redirect_ip = dns_ip
    a.st_imm("h", R10, -46, HTONS_53)
    a.jmp("emit")
    a.label("d_notdns")
    # 5. the proxy itself
    a.ldx("w", R2, R8, POL_ENVOY_IP)
    a.ldx("w", R1, R10, -88)
    a.j_reg("jne", R1, R2, "d_notenvoy")
    _set_verdict(a, ALLOW, R_ENVOY)
    a.jmp("dispatch")
    a.label("d_notenvoy")
    # 6. host side-channel
    a.ldx("w", R2, R8, POL_FLAGS)
    a.j_imm("jset", R2, F_HOSTPROXY, "d_hp")
    a.jmp("d_intra")
    a.label("d_hp")
    a.ldx("w", R2, R8, POL_HOSTPROXY_IP)
    a.ldx("w", R1, R10, -88)
    a.j_reg("jne", R1, R2, "d_intra")
    a.ldx("h", R2, R8, POL_HOSTPROXY_PORT)
    a.ldx("h", R1, R10, -84)
    a.j_reg("jne", R1, R2, "d_intra")
    _set_verdict(a, ALLOW, R_HOSTPROXY)
    a.jmp("dispatch")
    a.label("d_intra")
    # 6b. intra-network bypass (gateway exclusion: dns/hostproxy ips)
    a.ldx("w", R2, R8, POL_NET_PREFIX)
    a.j_imm("jeq", R2, 0, "d_step7")
    a.j_imm("jgt", R2, 32, "d_step7")
    a.ldx("w", R1, R10, -88)
    a.ldx("w", R3, R8, POL_DNS_IP)
    a.j_reg("jeq", R1, R3, "d_step7")
    a.ldx("w", R3, R8, POL_HOSTPROXY_IP)
    a.j_reg("jeq", R1, R3, "d_step7")
    a.mov32_imm(R4, 0xFFFFFFFF)
    a.j_imm("jeq", R2, 32, "d_mask")
    a.mov32_imm(R5, 0xFFFFFFFF)
    a.alu32_reg("rsh", R5, R2)
    a.alu32_reg("xor", R4, R5)         # mask = ~(0xffffffff >> prefix)
    a.label("d_mask")
    a.endian_be(R1, 32)                # dst -> host order
    a.alu32_reg("and", R1, R4)
    a.ldx("w", R3, R8, POL_NET_IP)
    a.endian_be(R3, 32)
    a.alu32_reg("and", R3, R4)
    a.j_reg("jne", R1, R3, "d_step7")
    _set_verdict(a, ALLOW, R_INTRA_NET)
    a.jmp("dispatch")
    a.label("d_step7")
    # 7. ip-literal egress: no resolution through the gate
    a.ldx("w", R1, R10, -88)
    a.stx("w", R10, -20, R1)
    _lookup(a, m.dns_cache, -20)
    a.j_imm("jne", R0, 0, "d_havedns")
    a.ldx("w", R2, R8, POL_FLAGS)
    a.j_imm("jset", R2, F_ENFORCE, "d_nd_enf")
    _set_verdict(a, ALLOW, R_MONITOR)
    a.jmp("emit")
    a.label("d_nd_enf")
    _set_verdict(a, DENY, R_NO_DNS_ENTRY)
    a.jmp("emit")
    a.label("d_havedns")
    a.ldx("dw", R1, R0, 0)             # dns->zone_hash
    a.stx("dw", R10, -40, R1)          # verdict.zone_hash
    # 8. zone route: exact port first, then any-port
    a.stx("dw", R10, -32, R1)
    a.ldx("h", R1, R10, -84)
    a.stx("h", R10, -24, R1)
    a.ldx("b", R1, R10, -82)
    a.stx("b", R10, -22, R1)
    a.st_imm("b", R10, -21, 0)
    _lookup(a, m.routes, -32)
    a.j_imm("jne", R0, 0, "d_haveroute")
    a.st_imm("h", R10, -24, 0)
    _lookup(a, m.routes, -32)
    a.j_imm("jne", R0, 0, "d_haveroute")
    # 9. resolved zone, but proto/port not ruled
    a.ldx("w", R2, R8, POL_FLAGS)
    a.j_imm("jset", R2, F_ENFORCE, "d_nr_enf")
    _set_verdict(a, ALLOW, R_MONITOR)
    a.jmp("emit")
    a.label("d_nr_enf")
    _set_verdict(a, DENY, R_NO_ROUTE)
    a.jmp("emit")
    a.label("d_haveroute")
    a.ldx("b", R1, R0, 0)              # rt->action
    a.stx("b", R10, -48, R1)
    a.st_imm("b", R10, -47, R_ROUTE)
    a.ldx("h", R1, R0, 2)              # rt->redirect_port
    a.stx("h", R10, -46, R1)
    a.ldx("w", R1, R0, 4)              # rt->redirect_ip
    a.stx("w", R10, -44, R1)
    a.jmp("emit")


def _emit_prologue(a: Asm, m: FwMapFds) -> None:
    """ctx -> r6, cgroup id -> r7/fp-8, policy -> r8; unenrolled cgroups
    pass through untouched (fw.c step 1)."""
    a.mov_reg(R6, R1)
    a.call(FN_get_current_cgroup_id)
    a.mov_reg(R7, R0)
    a.stx("dw", R10, -8, R7)
    _lookup(a, m.containers, -8)
    a.j_imm("jne", R0, 0, "enrolled")
    a.ret_imm(1)
    a.label("enrolled")
    a.mov_reg(R8, R0)


def _emit_note_flow_and_rewrite(a: Asm, m: FwMapFds, ip_ctx_off: int) -> None:
    """fw_note_flow + redirect rewrite (fw.c:298-311, 330-335), labels
    "redirect"/"do_rewrite"; falls through to label "ok_exit" emitted by
    the caller."""
    a.label("redirect")
    a.mov_reg(R1, R6)
    a.call(FN_get_socket_cookie)
    a.j_imm("jeq", R0, 0, "do_rewrite")
    a.stx("dw", R10, -16, R0)
    a.ldx("w", R1, R10, -88)
    a.stx("w", R10, -56, R1)
    a.ldx("h", R1, R10, -84)
    a.stx("h", R10, -52, R1)
    a.st_imm("h", R10, -50, 0)
    a.ldx("b", R1, R10, -82)
    a.j_imm("jeq", R1, PROTO_UDP, "nf_udp")
    a.ld_map_fd(R1, m.tcp_flows)
    a.jmp("nf_upd")
    a.label("nf_udp")
    a.ld_map_fd(R1, m.udp_flows)
    a.label("nf_upd")
    a.mov_reg(R2, R10)
    a.alu64_imm("add", R2, -16)
    a.mov_reg(R3, R10)
    a.alu64_imm("add", R3, -56)
    a.mov_imm(R4, 0)
    a.call(FN_map_update_elem)
    a.label("do_rewrite")
    a.ldx("w", R1, R10, -44)
    a.stx("w", R6, ip_ctx_off, R1)
    a.ldx("h", R1, R10, -46)
    a.stx("w", R6, CTX_USER_PORT, R1)


def _emit_dispatch(a: Asm, m: FwMapFds, ip_ctx_off: int) -> None:
    """Verdict -> program return value (fw_egress4 switch, fw.c:327-338)."""
    a.label("dispatch")
    a.ldx("b", R1, R10, -48)
    a.j_imm("jeq", R1, ALLOW, "ok_exit")
    a.j_imm("jeq", R1, REDIRECT, "redirect")
    a.j_imm("jeq", R1, REDIRECT_DNS, "redirect")
    a.ret_imm(0)                       # FW_EPERM
    _emit_note_flow_and_rewrite(a, m, ip_ctx_off)
    a.label("ok_exit")
    a.ret_imm(1)


# ---------------------------------------------------------------------------
# program builders
# ---------------------------------------------------------------------------


def prog_egress4(m: FwMapFds, name: str, proto_from_ctx: bool) -> Asm:
    """fw_connect4 / fw_sendmsg4 (fw.c:341-353)."""
    a = Asm(name)
    _emit_prologue(a, m)
    a.ldx("w", R1, R6, CTX_USER_IP4)
    a.stx("w", R10, -88, R1)
    a.ldx("w", R1, R6, CTX_USER_PORT)
    a.stx("h", R10, -84, R1)
    if proto_from_ctx:
        a.ldx("w", R1, R6, CTX_PROTOCOL)
        a.j_imm("jeq", R1, PROTO_UDP, "p_udp")
        a.st_imm("b", R10, -82, PROTO_TCP)
        a.jmp("p_done")
        a.label("p_udp")
        a.st_imm("b", R10, -82, PROTO_UDP)
        a.label("p_done")
    else:
        a.st_imm("b", R10, -82, PROTO_UDP)
    _emit_decide(a, m)
    _emit_event_block(a, m)
    _emit_dispatch(a, m, CTX_USER_IP4)
    return a


def prog_ingress4(m: FwMapFds, name: str, include_tcp: bool) -> Asm:
    """fw_recvmsg4 / fw_getpeername4 (fw.c:359-395): reverse-NAT.  These
    attach points must return 1 (the kernel pins the range), so every
    path allows."""
    a = Asm(name)
    _emit_prologue(a, m)
    a.mov_reg(R1, R6)
    a.call(FN_get_socket_cookie)
    a.j_imm("jeq", R0, 0, "out")
    a.stx("dw", R10, -16, R0)
    _lookup(a, m.udp_flows, -16)
    a.j_imm("jne", R0, 0, "have_flow")
    if include_tcp:
        _lookup(a, m.tcp_flows, -16)
        a.j_imm("jne", R0, 0, "have_flow")
    a.jmp("out")
    a.label("have_flow")
    a.mov_reg(R9, R0)
    a.ldx("w", R1, R6, CTX_USER_IP4)
    a.ldx("w", R2, R8, POL_DNS_IP)
    a.j_reg("jeq", R1, R2, "rewrite")
    a.ldx("w", R2, R8, POL_ENVOY_IP)
    a.j_reg("jne", R1, R2, "out")
    a.label("rewrite")
    a.ldx("w", R1, R9, 0)              # f->orig_ip
    a.stx("w", R6, CTX_USER_IP4, R1)
    a.ldx("h", R1, R9, 4)              # f->orig_port
    a.stx("w", R6, CTX_USER_PORT, R1)
    a.label("out")
    a.ret_imm(1)
    return a


def prog_egress6(m: FwMapFds, name: str, proto_from_ctx: bool) -> Asm:
    """fw_connect6 / fw_sendmsg6 (fw.c:416-476): v4-mapped routes through
    the v4 decision; native v6 is denied (the data plane is v4-only)."""
    a = Asm(name)
    _emit_prologue(a, m)
    a.ldx("w", R1, R6, CTX_USER_PORT)
    a.stx("h", R10, -84, R1)
    if proto_from_ctx:
        a.ldx("w", R1, R6, CTX_PROTOCOL)
        a.j_imm("jeq", R1, PROTO_UDP, "p_udp")
        a.st_imm("b", R10, -82, PROTO_TCP)
        a.jmp("p_done")
        a.label("p_udp")
        a.st_imm("b", R10, -82, PROTO_UDP)
        a.label("p_done")
    else:
        a.st_imm("b", R10, -82, PROTO_UDP)
    # break-glass bypass must open v6 too (fw.c:428-436)
    _emit_bypass_check(a, m, active="v6_bypass", inactive="v6_nobypass", pfx="v6")
    a.label("v6_bypass")
    _zero_verdict(a)
    _set_verdict(a, ALLOW, R_BYPASS)
    a.st_imm("w", R10, -88, 0)
    a.jmp("emit")
    a.label("v6_nobypass")
    a.ldx("w", R1, R6, CTX_USER_IP6)       # w0
    a.ldx("w", R2, R6, CTX_USER_IP6 + 4)   # w1
    a.ldx("w", R3, R6, CTX_USER_IP6 + 8)   # w2
    a.ldx("w", R4, R6, CTX_USER_IP6 + 12)  # w3
    # ::1 loopback
    a.mov_reg(R5, R1)
    a.alu64_reg("or", R5, R2)
    a.alu64_reg("or", R5, R3)
    a.j_imm("jne", R5, 0, "v6_notlo")
    a.j_imm("jeq", R4, V6_LOOPBACK_W3, "v6_ok")
    a.label("v6_notlo")
    # ::ffff:a.b.c.d?
    a.j_imm("jne", R1, 0, "v6_deny")
    a.j_imm("jne", R2, 0, "v6_deny")
    a.mov32_imm(R5, V4MAPPED_W2)
    a.j_reg("jne", R3, R5, "v6_deny")
    a.stx("w", R10, -88, R4)               # dst = mapped v4
    _emit_decide(a, m)
    a.label("v6_deny")
    _zero_verdict(a)
    _set_verdict(a, DENY, R_IPV6)
    a.st_imm("w", R10, -88, 0)
    a.jmp("emit")
    a.label("v6_ok")
    a.ret_imm(1)
    _emit_event_block(a, m)
    _emit_dispatch(a, m, CTX_USER_IP6 + 12)
    return a


def prog_ingress6(m: FwMapFds, name: str, include_tcp: bool) -> Asm:
    """fw_recvmsg6 / fw_getpeername6 (fw.c:478-516): reverse-NAT on the
    v4-mapped last word."""
    a = Asm(name)
    _emit_prologue(a, m)
    a.ldx("w", R1, R6, CTX_USER_IP6)
    a.j_imm("jne", R1, 0, "out")
    a.ldx("w", R1, R6, CTX_USER_IP6 + 4)
    a.j_imm("jne", R1, 0, "out")
    a.ldx("w", R1, R6, CTX_USER_IP6 + 8)
    a.mov32_imm(R2, V4MAPPED_W2)
    a.j_reg("jne", R1, R2, "out")
    a.mov_reg(R1, R6)
    a.call(FN_get_socket_cookie)
    a.j_imm("jeq", R0, 0, "out")
    a.stx("dw", R10, -16, R0)
    _lookup(a, m.udp_flows, -16)
    a.j_imm("jne", R0, 0, "have_flow")
    if include_tcp:
        _lookup(a, m.tcp_flows, -16)
        a.j_imm("jne", R0, 0, "have_flow")
    a.jmp("out")
    a.label("have_flow")
    a.mov_reg(R9, R0)
    a.ldx("w", R1, R6, CTX_USER_IP6 + 12)
    a.ldx("w", R2, R8, POL_DNS_IP)
    a.j_reg("jeq", R1, R2, "rewrite")
    a.ldx("w", R2, R8, POL_ENVOY_IP)
    a.j_reg("jne", R1, R2, "out")
    a.label("rewrite")
    a.ldx("w", R1, R9, 0)
    a.stx("w", R6, CTX_USER_IP6 + 12, R1)
    a.ldx("h", R1, R9, 4)
    a.stx("w", R6, CTX_USER_PORT, R1)
    a.label("out")
    a.ret_imm(1)
    return a


def prog_sock_create(m: FwMapFds, name: str = "fw_sock_create") -> Asm:
    """fw_sock_create (fw.c:526-546): SOCK_RAW/SOCK_PACKET deny for
    enrolled cgroups (no ICMP exfil, no packet crafting)."""
    a = Asm(name)
    _emit_prologue(a, m)
    _emit_bypass_check(a, m, active="sc_ok", inactive="sc_nobypass", pfx="sc")
    a.label("sc_nobypass")
    a.ldx("w", R1, R6, SK_TYPE)
    a.j_imm("jeq", R1, SOCK_RAW, "sc_deny")
    a.j_imm("jeq", R1, SOCK_PACKET, "sc_deny")
    a.label("sc_ok")
    a.ret_imm(1)
    a.label("sc_deny")
    _zero_verdict(a)
    _set_verdict(a, DENY, R_RAW_SOCKET)
    a.st_imm("w", R10, -88, 0)
    a.st_imm("h", R10, -84, 0)
    a.st_imm("b", R10, -82, 0)
    a.jmp("emit")
    _emit_event_block(a, m)
    a.ret_imm(0)
    return a


# ---------------------------------------------------------------------------
# the program set + kernel owner
# ---------------------------------------------------------------------------

# (name, prog_type, expected/attach type, builder kwargs)
PROGRAM_SPECS = (
    ("fw_connect4", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR, K.BPF_CGROUP_INET4_CONNECT,
     lambda m: prog_egress4(m, "fw_connect4", proto_from_ctx=True)),
    ("fw_sendmsg4", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR, K.BPF_CGROUP_UDP4_SENDMSG,
     lambda m: prog_egress4(m, "fw_sendmsg4", proto_from_ctx=False)),
    ("fw_recvmsg4", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR, K.BPF_CGROUP_UDP4_RECVMSG,
     lambda m: prog_ingress4(m, "fw_recvmsg4", include_tcp=False)),
    ("fw_getpeername4", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR,
     K.BPF_CGROUP_INET4_GETPEERNAME,
     lambda m: prog_ingress4(m, "fw_getpeername4", include_tcp=True)),
    ("fw_connect6", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR, K.BPF_CGROUP_INET6_CONNECT,
     lambda m: prog_egress6(m, "fw_connect6", proto_from_ctx=True)),
    ("fw_sendmsg6", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR, K.BPF_CGROUP_UDP6_SENDMSG,
     lambda m: prog_egress6(m, "fw_sendmsg6", proto_from_ctx=False)),
    ("fw_recvmsg6", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR, K.BPF_CGROUP_UDP6_RECVMSG,
     lambda m: prog_ingress6(m, "fw_recvmsg6", include_tcp=False)),
    ("fw_getpeername6", K.BPF_PROG_TYPE_CGROUP_SOCK_ADDR,
     K.BPF_CGROUP_INET6_GETPEERNAME,
     lambda m: prog_ingress6(m, "fw_getpeername6", include_tcp=True)),
    ("fw_sock_create", K.BPF_PROG_TYPE_CGROUP_SOCK, K.BPF_CGROUP_INET_SOCK_CREATE,
     lambda m: prog_sock_create(m)),
)


@dataclass
class LoadedProg:
    name: str
    fd: int
    attach_type: int
    insn_count: int
    sha256: str
    verifier_log: str


class FwKernel:
    """Owner of the live enforcement plane: maps + verified programs.

    Mirrors the reference manager's Install path
    (controlplane/firewall/ebpf/manager.go:120 loadPrograms, :246 Attach
    with BPF_F_ALLOW_MULTI) minus the ELF step: programs are assembled
    against this instance's map fds and verified at construction.
    """

    def __init__(self, log_level: int = 1):
        self.maps = create_maps()
        self.progs: dict[str, LoadedProg] = {}
        self._attached: list[tuple[int, int, int]] = []  # prog_fd, cg_fd, type
        self._by_path: dict[str, int] = {}               # cgroup path -> cg_fd
        try:
            for name, ptype, atype, build in PROGRAM_SPECS:
                asm = build(self.maps)
                code = asm.assemble()
                fd, log = K.prog_load(ptype, code, expected_attach_type=atype,
                                      name=name, log_level=log_level)
                self.progs[name] = LoadedProg(
                    name=name, fd=fd, attach_type=atype,
                    insn_count=asm.insn_count,
                    sha256=hashlib.sha256(code).hexdigest(), verifier_log=log)
        except Exception:
            self.close()
            raise

    def attach_cgroup(self, cgroup_path: str) -> int:
        """Attach all nine programs to a cgroup-v2 dir; returns its id.
        Idempotent per path: a re-enable (restart, or same live cgroup)
        attaches the NEW set first -- BPF_F_ALLOW_MULTI allows the
        overlap -- and only then detaches the old one, so there is no
        unenforced window, no leaked fd, no stranded program set."""
        prior = self._by_path.pop(str(cgroup_path), None)
        cg_fd = os.open(cgroup_path, os.O_RDONLY | os.O_DIRECTORY)
        done: list[tuple[int, int, int]] = []
        try:
            for p in self.progs.values():
                K.prog_attach(p.fd, cg_fd, p.attach_type)
                done.append((p.fd, cg_fd, p.attach_type))
        except Exception:
            # partial attach: detach what landed before closing the fd so
            # no program keeps enforcing without a handle to remove it
            for prog_fd, fd, atype in done:
                try:
                    K.prog_detach(prog_fd, fd, atype)
                except K.BpfError:
                    pass
            os.close(cg_fd)
            raise
        self._attached.extend(done)
        self._by_path[str(cgroup_path)] = cg_fd
        if prior is not None:
            self._detach_fd(prior)
        return K.cgroup_id(cgroup_path)

    def _detach_fd(self, cg_fd: int) -> None:
        remaining = []
        for prog_fd, fd, atype in self._attached:
            if fd != cg_fd:
                remaining.append((prog_fd, fd, atype))
                continue
            try:
                K.prog_detach(prog_fd, fd, atype)
            except K.BpfError:
                pass
        self._attached = remaining
        try:
            os.close(cg_fd)
        except OSError:
            pass

    def detach_cgroup(self, cgroup_path: str) -> bool:
        """Detach the program set from one cgroup (drain/disable path)."""
        cg_fd = self._by_path.pop(str(cgroup_path), None)
        if cg_fd is None:
            return False
        self._detach_fd(cg_fd)
        return True

    def detach_all(self) -> None:
        self._by_path.clear()
        seen_cg = set()
        for prog_fd, cg_fd, atype in self._attached:
            try:
                K.prog_detach(prog_fd, cg_fd, atype)
            except K.BpfKernError:
                pass
            seen_cg.add(cg_fd)
        self._attached.clear()
        for cg_fd in seen_cg:
            try:
                os.close(cg_fd)
            except OSError:
                pass

    def event_reader(self) -> K.RingBufReader:
        return K.RingBufReader(self.maps.events, RING_SZ)

    def pin_all(self, pin_dir: str) -> None:
        """Pin every map (by ABI name) and program (``prog_<name>``) into
        a bpffs directory: other processes -- PinnedMaps consumers, the
        raw-syscall fwctl -- then reach this kernel state by path."""
        from pathlib import Path as _P

        d = _P(pin_dir)
        d.mkdir(parents=True, exist_ok=True)
        from .maps import (
            MAP_BYPASS, MAP_CONTAINERS, MAP_DNS_CACHE, MAP_EVENTS,
            MAP_RATELIMIT, MAP_ROUTES, MAP_TCP_FLOWS, MAP_UDP_FLOWS,
        )

        by_name = {
            MAP_CONTAINERS: self.maps.containers, MAP_BYPASS: self.maps.bypass,
            MAP_DNS_CACHE: self.maps.dns_cache, MAP_ROUTES: self.maps.routes,
            MAP_UDP_FLOWS: self.maps.udp_flows, MAP_TCP_FLOWS: self.maps.tcp_flows,
            MAP_EVENTS: self.maps.events, MAP_RATELIMIT: self.maps.ratelimit,
        }
        # stale pins from a previous kernel would SHADOW this one: map
        # writes would land in the dead kernel's maps while the live
        # programs enforce from these -- always replace
        for name, fd in by_name.items():
            path = d / name
            path.unlink(missing_ok=True)
            K.obj_pin(fd, path)
        for name, p in self.progs.items():
            path = d / f"prog_{name}"
            path.unlink(missing_ok=True)
            K.obj_pin(p.fd, path)

    def close(self) -> None:
        self.detach_all()
        for p in self.progs.values():
            if p.fd >= 0:
                try:
                    os.close(p.fd)
                except OSError:
                    pass
                p.fd = -1
        self.progs.clear()
        self.maps.close()

    def __enter__(self) -> "FwKernel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LiveMaps(_bpfsys.PinnedMaps):
    """FirewallMaps over a FwKernel's live fds: the same facade the DNS
    gate / handler / netlogger write through (maps.py), but every
    operation lands in the actual kernel maps and drain_events consumes
    the real ringbuf via mmap."""

    def __init__(self, kern: FwKernel):
        from .model import ContainerPolicy, DnsEntry, RouteKey, RouteVal, UdpFlow

        m = kern.maps
        self.pin_dir = None
        self.fwctl = ""
        BpfMap = _bpfsys.BpfMap
        self.containers = BpfMap(None, 8, ContainerPolicy.SIZE, fd=m.containers)
        self.bypass = BpfMap(None, 8, 8, fd=m.bypass)
        self.dns = BpfMap(None, 4, DnsEntry.SIZE, fd=m.dns_cache)
        self.route_map = BpfMap(None, RouteKey.SIZE, RouteVal.SIZE, fd=m.routes)
        self.udp = BpfMap(None, 8, UdpFlow.SIZE, fd=m.udp_flows)
        self.tcp = BpfMap(None, 8, UdpFlow.SIZE, fd=m.tcp_flows)
        # _maps drives the inherited flush_all(); close() is overridden so
        # the shared fds (owned by FwKernel) are never closed from here
        self._maps = [self.containers, self.bypass, self.dns, self.route_map,
                      self.udp, self.tcp]
        self._reader = kern.event_reader()

    def close(self):
        # map fds belong to FwKernel; only the ringbuf mmaps are ours
        self._reader.close()

    def drain_events(self, max_events=256):
        from .model import EgressEvent

        out = []
        for raw in self._reader.drain(max_events):
            if len(raw) == EgressEvent.SIZE:
                out.append(EgressEvent.unpack(raw))
        return out


def pack_container_policy(envoy_ip: int, dns_ip: int, hostproxy_ip: int,
                          hostproxy_port_be: int, flags: int, net_ip: int,
                          net_prefix: int) -> bytes:
    """Raw fw_container pack for callers already holding be32/be16 ints."""
    return struct.pack("<IIIHHIII", envoy_ip, dns_ip, hostproxy_ip,
                       hostproxy_port_be, 0, flags, net_ip, net_prefix)
