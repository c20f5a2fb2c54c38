"""Firewall data model: map records, verdicts, events.

The port's copy of ``clawker_tpu/firewall/model.py``, whole.

This is the single source of truth for the kernel<->userspace ABI.  The
eBPF programs (native/ebpf/fw.c) define the same structs in C; every
record here documents its wire layout and the two are kept in lock-step
by tests (tests/test_firewall_policy.py struct-size pins).

Parity reference: the reference keeps this ABI in
controlplane/firewall/ebpf/bpf/common.h (container_config, dns_val,
route_key/route_val, pinned map set -- SURVEY.md 2.2).  The layout here is
re-designed: IPv4 addresses and ports are stored in NETWORK byte order
exactly as `bpf_sock_addr` presents them (user_ip4/user_port are __be32/
__be16), so the kernel programs compare and rewrite without byte swaps;
UDP reverse-NAT is keyed by socket cookie instead of a flow tuple.
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass
from enum import IntEnum

# ---------------------------------------------------------------------------
# actions / verdicts (route_val.action and event.verdict share the space)
# ---------------------------------------------------------------------------


class Action(IntEnum):
    ALLOW = 0
    DENY = 1
    REDIRECT = 2        # rewrite dst to redirect_ip:redirect_port (Envoy)
    REDIRECT_DNS = 3    # rewrite dst to the container's DNS gate :53


class Reason(IntEnum):
    """Why a verdict was reached (event enrichment + tests)."""

    UNMANAGED = 0
    BYPASS = 1
    LOOPBACK = 2
    DNS = 3
    ENVOY = 4
    HOSTPROXY = 5
    ROUTE = 6
    NO_ROUTE = 7
    NO_DNS_ENTRY = 8
    RAW_SOCKET = 9
    IPV6 = 10
    MONITOR = 11
    INTRA_NET = 12


# protocol discriminator used in route keys / events
PROTO_TCP = 6
PROTO_UDP = 17

# container policy flags
FLAG_ENFORCE = 1 << 0        # deny on no-route (else monitor-only: allow + event)
FLAG_HOSTPROXY = 1 << 1      # allow hostproxy_ip:hostproxy_port


def ip4_to_be(ip: str) -> int:
    """Dotted quad -> u32 in network byte order (as __be32 in the kernel)."""
    return struct.unpack("<I", socket.inet_aton(ip))[0]


def be_to_ip4(v: int) -> str:
    return socket.inet_ntoa(struct.pack("<I", v))


def port_to_be(port: int) -> int:
    """Host port -> u16 big-endian value (as __be16 in bpf_sock_addr)."""
    return struct.unpack("<H", struct.pack(">H", port))[0]


def be_to_port(v: int) -> int:
    return struct.unpack(">H", struct.pack("<H", v))[0]


# ---------------------------------------------------------------------------
# map records.  Every record packs/unpacks itself; the struct formats are
# the ABI (little-endian field order; ip/port fields pre-swapped to network
# order as documented above).
# ---------------------------------------------------------------------------


@dataclass
class ContainerPolicy:
    """containers map value: per-cgroup enforcement profile.

    C twin: struct fw_container (native/ebpf/fw_maps.h).
    """

    envoy_ip: str = "0.0.0.0"
    dns_ip: str = "0.0.0.0"
    hostproxy_ip: str = "0.0.0.0"
    hostproxy_port: int = 0
    flags: int = FLAG_ENFORCE
    net_ip: str = "0.0.0.0"   # sandbox bridge subnet base
    net_prefix: int = 0       # prefix length; 0 = no intra-net allowance

    # envoy_ip, dns_ip, hostproxy_ip (be32 each), hp_port(be16), pad,
    # flags, net_ip(be32), net_prefix
    FMT = "<IIIHHIII"
    SIZE = struct.calcsize(FMT)  # 28

    def pack(self) -> bytes:
        return struct.pack(
            self.FMT,
            ip4_to_be(self.envoy_ip),
            ip4_to_be(self.dns_ip),
            ip4_to_be(self.hostproxy_ip),
            port_to_be(self.hostproxy_port),
            0,
            self.flags,
            ip4_to_be(self.net_ip),
            self.net_prefix,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "ContainerPolicy":
        e, d, h, hp, _, flags, n, npfx = struct.unpack(cls.FMT, raw)
        return cls(be_to_ip4(e), be_to_ip4(d), be_to_ip4(h), be_to_port(hp),
                   flags, be_to_ip4(n), npfx)


@dataclass
class DnsEntry:
    """dns_cache map value: what zone produced this resolved IP.

    C twin: struct fw_dns (key = __be32 resolved ip).
    """

    zone_hash: int
    expires_unix: int

    FMT = "<QQ"
    SIZE = struct.calcsize(FMT)  # 16

    def pack(self) -> bytes:
        return struct.pack(self.FMT, self.zone_hash, self.expires_unix)

    @classmethod
    def unpack(cls, raw: bytes) -> "DnsEntry":
        return cls(*struct.unpack(cls.FMT, raw))


@dataclass(frozen=True)
class RouteKey:
    """routes map key: (zone, dst port, proto).  port 0 = any port.

    C twin: struct fw_route_key (packed, 12 bytes).
    """

    zone_hash: int
    port: int   # host order here; packed as __be16
    proto: int  # PROTO_TCP | PROTO_UDP

    FMT = "<QHBx"
    SIZE = struct.calcsize(FMT)  # 12

    def pack(self) -> bytes:
        return struct.pack(self.FMT, self.zone_hash, port_to_be(self.port), self.proto)

    @classmethod
    def unpack(cls, raw: bytes) -> "RouteKey":
        z, p, pr = struct.unpack(cls.FMT, raw)
        return cls(z, be_to_port(p), pr)


@dataclass
class RouteVal:
    """routes map value.  For Action.REDIRECT the kernel rewrites the
    destination to redirect_ip:redirect_port (an Envoy listener).

    C twin: struct fw_route.
    """

    action: Action
    redirect_ip: str = "0.0.0.0"
    redirect_port: int = 0

    FMT = "<BxHI"
    SIZE = struct.calcsize(FMT)  # 8

    def pack(self) -> bytes:
        return struct.pack(
            self.FMT, int(self.action), port_to_be(self.redirect_port),
            ip4_to_be(self.redirect_ip),
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "RouteVal":
        a, p, ip = struct.unpack(cls.FMT, raw)
        return cls(Action(a), be_to_ip4(ip), be_to_port(p))


@dataclass
class UdpFlow:
    """udp_flows map value (key = u64 socket cookie): the destination the
    app originally aimed at, so recvmsg/getpeername can reverse the NAT.

    C twin: struct fw_udp_flow.
    """

    orig_ip: str
    orig_port: int

    FMT = "<IHxx"
    SIZE = struct.calcsize(FMT)  # 8

    def pack(self) -> bytes:
        return struct.pack(self.FMT, ip4_to_be(self.orig_ip), port_to_be(self.orig_port))

    @classmethod
    def unpack(cls, raw: bytes) -> "UdpFlow":
        ip, p = struct.unpack(cls.FMT, raw)
        return cls(be_to_ip4(ip), be_to_port(p))


@dataclass
class EgressEvent:
    """events ringbuf record: one per kernel decision (rate-limited).

    C twin: struct fw_event.
    """

    ts_ns: int
    cgroup_id: int
    dst_ip: str
    dst_port: int
    zone_hash: int
    verdict: Action
    proto: int
    reason: Reason

    FMT = "<QQQIHBBB7x"
    SIZE = struct.calcsize(FMT)  # 40

    def pack(self) -> bytes:
        return struct.pack(
            self.FMT, self.ts_ns, self.cgroup_id, self.zone_hash,
            ip4_to_be(self.dst_ip), port_to_be(self.dst_port),
            int(self.verdict), self.proto, int(self.reason),
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "EgressEvent":
        ts, cg, zone, ip, port, verdict, proto, reason = struct.unpack(cls.FMT, raw)
        return cls(ts, cg, be_to_ip4(ip), be_to_port(port), zone,
                   Action(verdict), proto, Reason(reason))


@dataclass
class Verdict:
    """The outcome of one policy decision (userspace representation)."""

    action: Action
    reason: Reason
    redirect_ip: str = ""
    redirect_port: int = 0
    zone_hash: int = 0

    @property
    def allowed(self) -> bool:
        return self.action is not Action.DENY
