"""The port's firewall model, maps and policy oracle against the C side
of the map ABI and against the kernel programs compiled for the host.

Twins of tests/test_ebpf_abi.py's six cases, held against the port's
``firewall/model.py`` and ``maps.ALL_MAPS``: ``native/ebpf/fw_maps.h``
compiled with the host compiler gives the sizes and offsets of every
shared struct, and the port's pack formats must give the same; the
``fw.c`` syntax gate; ``fwctl.c``'s map list and ``fw.c``'s map symbols
against ``ALL_MAPS``; the verdict and reason ``#define``s against the
port's enums.

Then tests/test_fw_kernel.py's cases that compare with the policy
oracle (the intra-net prefix edges and the 300-trial differential),
plus its decide-step scenarios: ``native/ebpf/fw_harness.c`` (the real
``fw.c`` over emulated maps) compiled into a temporary directory and
driven through ``ctypes`` with records the port's model packs, against
the port's ``policy`` over the port's ``FakeMaps``; and the port's
oracle against the reference's on the same inputs.  Skipped, as the
reference's are, only without a host C compiler.
"""

from __future__ import annotations

import ctypes
import random
import shutil
import socket
import struct
import subprocess
from pathlib import Path

import pytest

import clawker_tpu.firewall.maps as ref_maps
import clawker_tpu.firewall.model as ref_model
import clawker_tpu.firewall.policy as ref_policy
import clawker_tpu_torch.firewall.maps as port_maps
import clawker_tpu_torch.firewall.model as port_model
import clawker_tpu_torch.firewall.policy as port_policy

EBPF_DIR = Path(__file__).resolve().parent.parent / "native" / "ebpf"
CC = shutil.which("cc") or shutil.which("gcc")
pytestmark = pytest.mark.skipif(CC is None, reason="no host C compiler")

M = port_model

LAYOUT = r"""
#include <stdio.h>
#include <stddef.h>
#include "fw_maps.h"
#define S(name, ctype) printf(name " %zu\n", sizeof(struct ctype));
#define O(name, ctype, field) printf(name " %zu\n", offsetof(struct ctype, field));
int main(void) {
    S("sizeof_container", fw_container)
    S("sizeof_dns", fw_dns)
    S("sizeof_route_key", fw_route_key)
    S("sizeof_route", fw_route)
    S("sizeof_udp_flow", fw_udp_flow)
    S("sizeof_event", fw_event)
    O("off_container_flags", fw_container, flags)
    O("off_container_hp_port", fw_container, hostproxy_port)
    O("off_route_key_proto", fw_route_key, proto)
    O("off_route_redirect_ip", fw_route, redirect_ip)
    O("off_event_zone", fw_event, zone_hash)
    O("off_event_verdict", fw_event, verdict)
    O("off_event_reason", fw_event, reason)
    return 0;
}
"""


@pytest.fixture(scope="module")
def c_layout(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("abi")
    (tmp / "abi.c").write_text(LAYOUT)
    subprocess.run([CC, "-I", str(EBPF_DIR), "-o", str(tmp / "abi"),
                    str(tmp / "abi.c")], check=True, capture_output=True)
    out = subprocess.run([str(tmp / "abi")], check=True, capture_output=True,
                         text=True).stdout
    return {line.split()[0]: int(line.split()[1])
            for line in out.splitlines() if line.strip()}


def _offset(fmt: str, fields: int) -> int:
    """Byte offset of field ``fields`` (0-based) of a ``struct`` format
    whose codes are single letters or ``x`` pads."""
    return struct.calcsize(fmt[:1 + fields])


# ------------------------------------------------------------------- ABI


def test_struct_sizes_match(c_layout):
    sizes = {"sizeof_container": "ContainerPolicy", "sizeof_dns": "DnsEntry",
             "sizeof_route_key": "RouteKey", "sizeof_route": "RouteVal",
             "sizeof_udp_flow": "UdpFlow", "sizeof_event": "EgressEvent"}
    for key, cls in sizes.items():
        assert c_layout[key] == getattr(M, cls).SIZE \
            == getattr(ref_model, cls).SIZE, cls


def test_field_offsets_match(c_layout):
    """Offsets read from the port's own little-endian pack formats."""
    assert M.ContainerPolicy.FMT == ref_model.ContainerPolicy.FMT
    # "<IIIHHIII": envoy, dns, hostproxy ip, hostproxy port, pad, flags
    assert c_layout["off_container_hp_port"] == \
        _offset(M.ContainerPolicy.FMT, 3)
    assert c_layout["off_container_flags"] == \
        _offset(M.ContainerPolicy.FMT, 5)
    # "<QHBx": zone, port, proto
    assert c_layout["off_route_key_proto"] == _offset(M.RouteKey.FMT, 2)
    # "<BxHI": action, pad, port, redirect ip
    assert c_layout["off_route_redirect_ip"] == _offset(M.RouteVal.FMT, 3)
    # "<QQQIHBBB7x": ts, cgroup, zone, ip, port, verdict, proto, reason
    fmt = M.EgressEvent.FMT
    assert c_layout["off_event_zone"] == _offset(fmt, 2)
    assert c_layout["off_event_verdict"] == _offset(fmt, 5)
    assert c_layout["off_event_reason"] == _offset(fmt, 7)


def test_fw_c_host_syntax_gate():
    res = subprocess.run(["make", "-C", str(EBPF_DIR), "check"],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


def test_fwctl_map_list_matches_all_maps():
    """fwctl.c's MAPS[] is the port's ALL_MAPS, in order."""
    text = (EBPF_DIR / "fwctl.c").read_text()
    start = text.index("MAPS[] = {")
    names = tuple(text[start:text.index("}", start)].split('"')[1::2])
    assert names == port_maps.ALL_MAPS == ref_maps.ALL_MAPS


def test_fw_c_defines_every_map():
    text = (EBPF_DIR / "fw.c").read_text()
    for name in port_maps.ALL_MAPS:
        assert f'}} {name} SEC(".maps")' in text, name


def test_action_reason_constants_match():
    """fw_maps.h's #defines against the port's enums."""
    text = (EBPF_DIR / "fw_maps.h").read_text()

    def defined(name: str) -> int:
        for line in text.splitlines():
            parts = line.split()
            if len(parts) >= 3 and parts[0] == "#define" and parts[1] == name:
                return int(parts[2].rstrip("u").rstrip("l"), 0)
        raise AssertionError(f"{name} not defined in fw_maps.h")

    for action in M.Action:
        assert defined(f"FW_{action.name}") == int(action), action
    for reason in M.Reason:
        assert defined(f"FW_R_{reason.name}") == int(reason), reason
    assert [(a.name, int(a)) for a in M.Action] == \
        [(a.name, int(a)) for a in ref_model.Action]
    assert [(r.name, int(r)) for r in M.Reason] == \
        [(r.name, int(r)) for r in ref_model.Reason]


# ------------------------------------------------- the kernel on the host

# map ids (fw_harness.c's enum)
M_CONTAINERS, M_BYPASS, M_DNS, M_ROUTES, M_UDP, M_TCP, M_RL = range(7)
OK, EPERM = 1, 0
SOCK_STREAM, SOCK_DGRAM = 1, 2
AF_INET = 2


class SockAddr(ctypes.Structure):
    """bpf_sock_addr as fw.c declares it (the UAPI subset)."""

    _fields_ = [("user_family", ctypes.c_uint32),
                ("user_ip4", ctypes.c_uint32),
                ("user_ip6", ctypes.c_uint32 * 4),
                ("user_port", ctypes.c_uint32),
                ("family", ctypes.c_uint32),
                ("type", ctypes.c_uint32),
                ("protocol", ctypes.c_uint32),
                ("msg_src_ip4", ctypes.c_uint32),
                ("msg_src_ip6", ctypes.c_uint32 * 4)]


@pytest.fixture(scope="module")
def fw(tmp_path_factory):
    """fw_harness.c built as the Makefile's ``harness`` target builds it,
    into a temporary directory."""
    so = tmp_path_factory.mktemp("fwh") / "fw_harness.so"
    subprocess.run([CC, "-shared", "-fPIC", "-O1", "-Wall", "-Wextra",
                    "-Wno-unused-variable", "-I", str(EBPF_DIR), "-o",
                    str(so), str(EBPF_DIR / "fw_harness.c")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.fwh_map_update.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.fwh_set_cgroup.argtypes = [ctypes.c_uint64]
    lib.fwh_set_cookie.argtypes = [ctypes.c_uint64]
    lib.fwh_set_time_ns.argtypes = [ctypes.c_uint64]
    lib.fwh_pop_event.argtypes = [ctypes.c_void_p]
    lib.fwh_run_connect4.argtypes = [ctypes.POINTER(SockAddr)]
    lib.fwh_run_connect4.restype = ctypes.c_int
    return lib


class Kern:
    """The harness with records packed by the port's model."""

    def __init__(self, lib):
        self.lib = lib
        lib.fwh_reset()
        # a fresh rate-limit window for every scenario
        lib.fwh_set_time_ns(0)

    def enroll(self, cg: int, pol) -> None:
        assert self.lib.fwh_map_update(M_CONTAINERS, struct.pack("<Q", cg),
                                       pol.pack()) == 0

    def cache_dns(self, ip: str, entry) -> None:
        assert self.lib.fwh_map_update(M_DNS, socket.inet_aton(ip),
                                       entry.pack()) == 0

    def add_route(self, rk, rv) -> None:
        assert self.lib.fwh_map_update(M_ROUTES, rk.pack(), rv.pack()) == 0

    def connect4(self, cg: int, ip: str, port: int, *, udp=False, cookie=1):
        self.lib.fwh_set_cgroup(cg)
        self.lib.fwh_set_cookie(cookie)
        ctx = SockAddr(user_family=AF_INET, user_ip4=M.ip4_to_be(ip),
                       user_port=M.port_to_be(port), family=AF_INET,
                       type=SOCK_DGRAM if udp else SOCK_STREAM,
                       protocol=M.PROTO_UDP if udp else M.PROTO_TCP)
        rc = self.lib.fwh_run_connect4(ctypes.byref(ctx))
        return (rc, M.be_to_ip4(ctx.user_ip4),
                M.be_to_port(ctx.user_port & 0xFFFF))

    def events(self) -> list[tuple[int, int, int]]:
        """(verdict, reason, zone) of each event the programs emitted,
        unpacked by the port's ``EgressEvent``."""
        out = []
        buf = ctypes.create_string_buffer(M.EgressEvent.SIZE)
        while self.lib.fwh_pop_event(buf):
            ev = M.EgressEvent.unpack(buf.raw)
            out.append((int(ev.verdict), int(ev.reason), ev.zone_hash))
        return out


def oracle_events(fm) -> list[tuple[int, int, int]]:
    return [(int(e.verdict), int(e.reason), e.zone_hash)
            for e in fm.drain_events()]


def expected_rc(v) -> tuple:
    return OK if v.action is not M.Action.DENY else EPERM


def _policy(m, **kw):
    base = {"envoy_ip": "172.28.0.2", "dns_ip": "172.28.0.1",
            "hostproxy_ip": "172.28.0.1", "hostproxy_port": 18374,
            "flags": m.FLAG_ENFORCE | m.FLAG_HOSTPROXY}
    return m.ContainerPolicy(**{**base, **kw})


CG = 4242
ZONE = 0xDEAD
# decide-step scenarios of tests/test_fw_kernel.py: (policy overrides,
# dns entries, routes, connects (ip, port, udp))
SCENARIOS = {
    "unenrolled": (None, {}, {}, [("8.8.8.8", 443, False)]),
    "ip-literal-denied": ({}, {}, {}, [("8.8.4.4", 443, False)]),
    "monitor-mode": ({"flags": 0, "hostproxy_ip": "0.0.0.0",
                      "hostproxy_port": 0}, {}, {}, [("8.8.4.4", 443, False)]),
    "loopback": ({}, {}, {}, [("127.0.0.1", 9999, False)]),
    "intra-net": ({"net_ip": "172.28.0.0", "net_prefix": 24}, {}, {},
                  [("172.28.0.77", 8080, False), ("172.28.1.77", 8080, False),
                   ("172.28.0.1", 9999, False)]),
    "dns-to-gate": ({}, {}, {}, [("8.8.8.8", 53, True),
                                 ("172.28.0.1", 53, True)]),
    "envoy-and-hostproxy": ({}, {}, {}, [("172.28.0.2", 10000, False),
                                         ("172.28.0.1", 18374, False),
                                         ("172.28.0.1", 2222, False)]),
    "route-redirect": ({}, {"93.184.216.34": ZONE},
                       {(ZONE, 443, "tcp"): ("REDIRECT", "172.28.0.2", 10000)},
                       [("93.184.216.34", 443, False)]),
    "any-port-route": ({}, {"1.2.3.4": ZONE},
                       {(ZONE, 0, "tcp"): ("ALLOW", "0.0.0.0", 0)},
                       [("1.2.3.4", 8443, False), ("1.2.3.4", 8443, True)]),
    "unruled-port": ({}, {"4.4.4.4": ZONE},
                     {(ZONE, 443, "tcp"): ("ALLOW", "0.0.0.0", 0)},
                     [("4.4.4.4", 443, False), ("4.4.4.4", 22, False)]),
}


def _oracle_run(m, maps_mod, policy_mod, scenario) -> list:
    pol_kw, dns, routes, connects = scenario
    fm = maps_mod.FakeMaps()
    if pol_kw is not None:
        fm.enroll(CG, _policy(m, **pol_kw))
    for ip, zone in dns.items():
        fm.cache_dns(ip, m.DnsEntry(zone, 2**40))
    fm.sync_routes({
        m.RouteKey(z, p, m.PROTO_TCP if pr == "tcp" else m.PROTO_UDP):
        m.RouteVal(m.Action[a], redirect_ip=ip, redirect_port=port)
        for (z, p, pr), (a, ip, port) in routes.items()})
    out = []
    for ip, port, udp in connects:
        v = policy_mod.connect4(fm, CG, ip, port,
                                m.PROTO_UDP if udp else m.PROTO_TCP,
                                sock_cookie=1)
        out.append([v.action.name, v.reason.name, v.redirect_ip,
                    v.redirect_port, oracle_events(fm)])
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_decide_steps_match_the_kernel(fw, name):
    """Each decide-step scenario through the kernel programs and through
    the port's oracle (and the reference's, which must agree): the
    kernel's return code, rewritten destination and events are the
    oracle's verdict."""
    scenario = SCENARIOS[name]
    got = _oracle_run(M, port_maps, port_policy, scenario)
    assert got == _oracle_run(ref_model, ref_maps, ref_policy, scenario)
    pol_kw, dns, routes, connects = scenario
    k = Kern(fw)
    if pol_kw is not None:
        k.enroll(CG, _policy(M, **pol_kw))
    for ip, zone in dns.items():
        k.cache_dns(ip, M.DnsEntry(zone, 2**62))
    for (z, p, pr), (a, ip, port) in routes.items():
        k.add_route(M.RouteKey(z, p, M.PROTO_TCP if pr == "tcp"
                               else M.PROTO_UDP),
                    M.RouteVal(M.Action[a], redirect_ip=ip,
                               redirect_port=port))
    for (ip, port, udp), (action, _, rip, rport, events) in zip(connects,
                                                                 got):
        rc, out_ip, out_port = k.connect4(CG, ip, port, udp=udp)
        assert rc == (EPERM if action == "DENY" else OK), (name, ip, port)
        if action in ("REDIRECT", "REDIRECT_DNS"):
            assert (out_ip, out_port) == (rip, rport), (name, ip, port)
        else:
            assert (out_ip, out_port) == (ip, port), (name, ip, port)
        assert k.events() == events, (name, ip, port)


def test_intra_net_prefix_edge_cases_match_oracle(fw):
    """Prefix-mask boundaries (0 disabled, /31, /32, a host-order base,
    /1) agree between the kernel and the port's oracle, and the port's
    oracle agrees with the reference's."""
    probes = ["172.28.0.76", "172.28.0.77", "172.28.0.78", "172.28.1.77",
              "8.8.4.4", "0.0.0.0", "255.255.255.255"]
    cases = [("0.0.0.0", 0), ("172.28.0.0", 0), ("172.28.0.76", 31),
             ("172.28.0.77", 32), ("172.28.0.77", 24), ("172.28.0.0", 1)]
    for net_ip, net_prefix in cases:
        kw = {"envoy_ip": "172.29.0.2", "dns_ip": "172.29.0.1",
              "hostproxy_ip": "0.0.0.0", "hostproxy_port": 0,
              "net_ip": net_ip, "net_prefix": net_prefix}
        k = Kern(fw)
        k.enroll(CG, M.ContainerPolicy(flags=M.FLAG_ENFORCE, **kw))
        fm, rfm = port_maps.FakeMaps(), ref_maps.FakeMaps()
        fm.enroll(CG, M.ContainerPolicy(flags=M.FLAG_ENFORCE, **kw))
        rfm.enroll(CG, ref_model.ContainerPolicy(
            flags=ref_model.FLAG_ENFORCE, **kw))
        for ip in probes:
            rc, *_ = k.connect4(CG, ip, 8080)
            v = port_policy.connect4(fm, CG, ip, 8080, sock_cookie=1)
            w = ref_policy.connect4(rfm, CG, ip, 8080, sock_cookie=1)
            assert (v.action.name, v.reason.name) == \
                (w.action.name, w.reason.name)
            assert rc == expected_rc(v), (
                f"net={net_ip}/{net_prefix} ip={ip}: kernel rc={rc} "
                f"oracle={v.action.name}/{v.reason.name}")
    k = Kern(fw)
    k.enroll(CG, M.ContainerPolicy(
        envoy_ip="172.29.0.2", dns_ip="172.29.0.1", hostproxy_ip="0.0.0.0",
        hostproxy_port=0, flags=M.FLAG_ENFORCE, net_ip="172.28.0.0",
        net_prefix=0))
    assert k.connect4(CG, "172.28.0.77", 8080)[0] == EPERM


def test_differential_against_policy_oracle(fw):
    """300 seeded scenarios: the kernel and the port's oracle give the
    same verdict stream (return code, rewrite, events), and the port's
    oracle the reference's verdicts."""
    rng = random.Random(1234)
    ips = ["8.8.8.8", "127.0.0.1", "172.28.0.1", "172.28.0.2",
           "93.184.216.34", "1.2.3.4", "4.4.4.4", "10.0.0.7"]
    ports = [53, 80, 443, 22, 8443, 18374]
    zones = {"93.184.216.34": 0xA1, "1.2.3.4": 0xB2, "4.4.4.4": 0xC3}
    for trial in range(300):
        flags = rng.choice([0, M.FLAG_ENFORCE,
                            M.FLAG_ENFORCE | M.FLAG_HOSTPROXY])
        net_ip, net_prefix = rng.choice([("0.0.0.0", 0), ("10.0.0.0", 24),
                                         ("172.28.0.0", 16)])
        kw = {"flags": flags, "net_ip": net_ip, "net_prefix": net_prefix}
        k = Kern(fw)
        k.enroll(CG, _policy(M, **kw))
        fm, rfm = port_maps.FakeMaps(), ref_maps.FakeMaps()
        fm.enroll(CG, _policy(M, **kw))
        rfm.enroll(CG, _policy(ref_model, **kw))
        for ip, zh in zones.items():
            if rng.random() < 0.7:
                k.cache_dns(ip, M.DnsEntry(zh, 2**62))
                fm.cache_dns(ip, M.DnsEntry(zh, 2**40))
                rfm.cache_dns(ip, ref_model.DnsEntry(zh, 2**40))
        routes, ref_routes = {}, {}
        for zh in (0xA1, 0xB2, 0xC3):
            if rng.random() < 0.7:
                port, proto = rng.choice([0, 443, 53, 22]), \
                    rng.choice([M.PROTO_TCP, M.PROTO_UDP])
                action = rng.choice([("ALLOW", "0.0.0.0", 0),
                                     ("DENY", "0.0.0.0", 0),
                                     ("REDIRECT", "172.28.0.2", 10000)])
                for m, table in ((M, routes), (ref_model, ref_routes)):
                    table[m.RouteKey(zh, port, proto)] = m.RouteVal(
                        m.Action[action[0]], redirect_ip=action[1],
                        redirect_port=action[2])
                k.add_route(M.RouteKey(zh, port, proto),
                            routes[M.RouteKey(zh, port, proto)])
        fm.sync_routes(routes)
        rfm.sync_routes(ref_routes)
        for _ in range(10):
            ip, port = rng.choice(ips), rng.choice(ports)
            udp = rng.random() < 0.4
            proto = M.PROTO_UDP if udp else M.PROTO_TCP
            v = port_policy.decide(fm, CG, ip, port, proto)
            w = ref_policy.decide(rfm, CG, ip, port, proto)
            ctxt = f"trial={trial} ip={ip} port={port} proto={proto}"
            assert (v.action.name, v.reason.name, v.redirect_ip,
                    v.redirect_port) == (w.action.name, w.reason.name,
                                         w.redirect_ip, w.redirect_port), ctxt
            rc, out_ip, out_port = k.connect4(CG, ip, port, udp=udp)
            assert rc == expected_rc(v), ctxt
            if v.action in (M.Action.REDIRECT, M.Action.REDIRECT_DNS):
                assert (out_ip, out_port) == (v.redirect_ip,
                                              v.redirect_port), ctxt
            else:
                assert (out_ip, out_port) == (ip, port), ctxt
            assert [e[:2] for e in k.events()] == \
                [e[:2] for e in oracle_events(fm)], ctxt
            rfm.drain_events()
