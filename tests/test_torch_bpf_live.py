"""The port's firewall kernel half against the reference's on the live
kernel: real verifier, real cgroup, real sockets.

Twins of tests/test_bpf_live.py's 17 cases, of
tests/test_dnsgate_kernel.py's DNS -> cache -> route -> enforce loop and
of tests/test_fwctl_raw.py's two cases, gated as those files gate
themselves, by the reference's own probe.  Each twin runs the
reference's side and then the port's in this process, each side in a
``LiveSandbox`` of its own (cgroup ``clawker-twin-<side>-<pid>``) or,
for the native tool's cases, a pin directory of its own
(``/sys/fs/bpf/clawker-test-<side>-<pid>``), and compares what it
observes: return codes and errno names, the peer a redirect landed on,
and the events' fields but their timestamps, with each cgroup id read
as "the sandbox's own".  ``tests/test_fwctl_raw.py`` is red on some
hosts that pass this file's gate; its twins assert only that the port
ends as the reference does, step by step.  Where a case needs port 53
and another process holds it, the side waits for it, then skips as the
reference does.  The random sweep of tests/test_bpf_differential.py is
in tests/test_torch_bpf_differential.py.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import struct
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.config.schema as ref_schema
import clawker_tpu.firewall.bpfasm as ref_bpfasm
import clawker_tpu.firewall.bpfkern as ref_bpfkern
import clawker_tpu.firewall.bpflive as ref_bpflive
import clawker_tpu.firewall.bpfsys as ref_bpfsys
import clawker_tpu.firewall.dnsgate as ref_dnsgate
import clawker_tpu.firewall.fwprogs as ref_fwprogs
import clawker_tpu.firewall.hashes as ref_hashes
import clawker_tpu.firewall.model as ref_model
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.firewall.bpfasm as port_bpfasm
import clawker_tpu_torch.firewall.bpfkern as port_bpfkern
import clawker_tpu_torch.firewall.bpflive as port_bpflive
import clawker_tpu_torch.firewall.bpfsys as port_bpfsys
import clawker_tpu_torch.firewall.dnsgate as port_dnsgate
import clawker_tpu_torch.firewall.fwprogs as port_fwprogs
import clawker_tpu_torch.firewall.hashes as port_hashes
import clawker_tpu_torch.firewall.model as port_model

PKGS = {
    "ref": SimpleNamespace(tag="ref", bpfasm=ref_bpfasm, bpfkern=ref_bpfkern,
                           bpflive=ref_bpflive, bpfsys=ref_bpfsys,
                           dnsgate=ref_dnsgate, fwprogs=ref_fwprogs,
                           hashes=ref_hashes, model=ref_model,
                           schema=ref_schema),
    "port": SimpleNamespace(tag="port", bpfasm=port_bpfasm,
                            bpfkern=port_bpfkern, bpflive=port_bpflive,
                            bpfsys=port_bpfsys, dnsgate=port_dnsgate,
                            fwprogs=port_fwprogs, hashes=port_hashes,
                            model=port_model, schema=port_schema),
}
EBPF_DIR = Path(__file__).resolve().parent.parent / "native" / "ebpf"
BPFFS = Path("/sys/fs/bpf")
PORT_53_WAIT_S = 10.0


def _raw_capable() -> bool:
    return (ref_bpfkern.kernel_available() and BPFFS.is_dir()
            and os.access(BPFFS, os.W_OK))


pytestmark = pytest.mark.skipif(
    not ref_bpfkern.kernel_available(),
    reason="bpf(2) PROG_LOAD or writable cgroup-v2 unavailable",
)
needs_bpffs = pytest.mark.skipif(not _raw_capable(),
                                 reason="needs bpf(2) + writable bpffs")


@pytest.fixture(scope="module")
def sandboxes():
    made = {}
    try:
        for tag, m in PKGS.items():
            made[tag] = m.bpflive.LiveSandbox(f"clawker-twin-{tag}")
        yield made
    finally:
        for sb in made.values():
            sb.close()


def _enforcing(m):
    return m.model.ContainerPolicy(envoy_ip="127.0.0.1", dns_ip="127.0.0.1",
                                   flags=m.model.FLAG_ENFORCE)


@pytest.fixture()
def enrolled(sandboxes):
    """Both sandboxes enforcing with loopback gate/proxy; fresh maps per
    test."""
    for tag, m in PKGS.items():
        sandboxes[tag].enroll(_enforcing(m))
    yield sandboxes
    for sb in sandboxes.values():
        sb.maps.flush_all()
        sb.maps.drain_events(4096)


def twin(sandboxes, fn):
    """``fn(m, sandbox)`` for the reference, then the port: -> (want,
    got)."""
    return (fn(PKGS["ref"], sandboxes["ref"]),
            fn(PKGS["port"], sandboxes["port"]))


def events(sb, max_events: int = 4096) -> list:
    """The sandbox's drained events, each as (verdict, reason, dst ip,
    dst port, proto, zone hash, from the sandbox's own cgroup)."""
    return [[e.verdict.name, e.reason.name, e.dst_ip, e.dst_port, e.proto,
             e.zone_hash, e.cgroup_id == sb.cgroup_id]
            for e in sb.maps.drain_events(max_events)]


def _tcp(m, sb, ip, port, timeout=1.0):
    return sb.run_in_cgroup(m.bpflive.probe_tcp_connect, ip, port, timeout)


def _bound(make):
    """``make()`` binds port 53: retried while another process holds it,
    then the reference's skip."""
    deadline = time.monotonic() + PORT_53_WAIT_S
    while True:
        try:
            return make()
        except OSError:
            if time.monotonic() > deadline:
                pytest.skip("port 53 unavailable")
            time.sleep(0.05)


class TestVerifier:
    def test_all_nine_programs_pass_the_kernel_verifier(self, sandboxes):
        def run(m, sb):
            return [[name, p.attach_type, p.insn_count, p.fd > 0,
                     "processed" in p.verifier_log]
                    for name, p in sb.kern.progs.items()]

        want, got = twin(sandboxes, run)
        assert got == want and len(got) == 9
        assert all(ok and logged for *_, ok, logged in got)

    def test_verifier_rejects_a_broken_program(self):
        def run(m):
            A, K = m.bpfasm, m.bpfkern
            fd = K.map_create(K.BPF_MAP_TYPE_HASH, 8, 8, 4, "tiny")
            try:
                a = A.Asm("bad")
                a.st_imm("dw", A.R10, -8, 0)
                a.ld_map_fd(A.R1, fd)
                a.mov_reg(A.R2, A.R10)
                a.alu64_imm("add", A.R2, -8)
                a.call(A.FN_map_lookup_elem)
                a.j_imm("jeq", A.R0, 0, "out")
                a.ldx("dw", A.R1, A.R0, 64)   # value is 8 bytes: OOB
                a.label("out")
                a.ret_imm(1)
                try:
                    prog, _ = K.prog_load(
                        K.BPF_PROG_TYPE_CGROUP_SOCK, a.assemble(),
                        expected_attach_type=K.BPF_CGROUP_INET_SOCK_CREATE)
                except K.VerifierError as e:
                    return ["VerifierError",
                            "invalid access to map value" in e.log]
                os.close(prog)
                return ["loaded", False]
            finally:
                os.close(fd)

        want, got = run(PKGS["ref"]), run(PKGS["port"])
        assert got == want == ["VerifierError", True]


class TestEnforcement:
    def test_unenrolled_cgroup_passes_through(self, sandboxes):
        def run(m, sb):
            sb.maps.flush_all()
            return sb.run_in_cgroup(m.bpflive.probe_raw_socket)

        want, got = twin(sandboxes, run)
        assert got == want and got["result"] == "created"

    def test_loopback_always_allowed(self, enrolled):
        def run(m, sb):
            srv = m.bpflive.TcpEcho()
            srv.start()
            try:
                r = _tcp(m, sb, "127.0.0.1", srv.port)
                return [r["result"], r.get("peer") == ["127.0.0.1", srv.port]]
            finally:
                srv.stop()

        want, got = twin(enrolled, run)
        assert got == want == ["connected", True]

    def test_ip_literal_denied_with_eperm(self, enrolled):
        def run(m, sb):
            return _tcp(m, sb, "10.99.0.1", 443), events(sb)

        want, got = twin(enrolled, run)
        assert got == want
        r, evs = got
        assert r["result"] == "eperm"
        assert ["DENY", "NO_DNS_ENTRY", "10.99.0.1", 443, 6, 0, True] in evs

    def test_monitor_mode_allows_and_logs(self, sandboxes):
        def run(m, sb):
            sb.enroll(m.model.ContainerPolicy(envoy_ip="127.0.0.1",
                                              dns_ip="127.0.0.1", flags=0))
            r = _tcp(m, sb, "10.99.0.2", 443, timeout=0.5)
            evs = events(sb)
            sb.maps.flush_all()
            return r["result"] == "eperm", evs

        want, got = twin(sandboxes, run)
        assert got == want
        denied, evs = got
        assert not denied and any(e[1] == "MONITOR" for e in evs)

    def test_route_deny_beats_resolution(self, enrolled):
        def run(m, sb):
            M = m.model
            z = 0x5151
            sb.maps.cache_dns("203.0.113.7",
                              M.DnsEntry(z, int(time.time()) + 300))
            sb.maps.sync_routes({M.RouteKey(z, 0, M.PROTO_TCP):
                                 M.RouteVal(M.Action.DENY)})
            return _tcp(m, sb, "203.0.113.7", 8443), events(sb)

        want, got = twin(enrolled, run)
        assert got == want
        r, evs = got
        assert r["result"] == "eperm"
        assert any(e[0] == "DENY" and e[1] == "ROUTE" for e in evs)

    def test_redirect_lands_on_proxy_and_getpeername_lies(self, enrolled):
        def run(m, sb):
            M = m.model
            srv = m.bpflive.TcpEcho()
            srv.start()
            z = 0x6262
            sb.maps.cache_dns("93.184.216.34",
                              M.DnsEntry(z, int(time.time()) + 300))
            sb.maps.sync_routes({M.RouteKey(z, 443, M.PROTO_TCP):
                                 M.RouteVal(M.Action.REDIRECT, "127.0.0.1",
                                            srv.port)})
            try:
                r = _tcp(m, sb, "93.184.216.34", 443)
            finally:
                srv.stop()
            return r, events(sb)

        want, got = twin(enrolled, run)
        assert got == want
        r, evs = got
        # connected to the local proxy double, yet getpeername reports the
        # destination the app aimed at (fw_getpeername4 rewrite)
        assert r == {"result": "connected", "peer": ["93.184.216.34", 443]}
        assert any(e[0] == "REDIRECT" and e[1] == "ROUTE" for e in evs)

    def test_dns_redirect_and_reverse_nat(self, enrolled):
        def run(m, sb):
            gate = _bound(lambda: m.bpflive.UdpResponder(port=53))
            gate.start()
            try:
                r = sb.run_in_cgroup(m.bpflive.probe_udp_exchange,
                                     "8.8.8.8", 53)
            finally:
                gate.stop()
            return r, [g.decode() for g in gate.received]

        want, got = twin(enrolled, run)
        assert got == want
        r, received = got
        # the reply came from 127.0.0.1:53, but recvmsg4's reverse NAT
        # presents the original destination
        assert r["result"] == "reply" and r["src"] == ["8.8.8.8", 53]
        assert received == ["ping"]

    def test_udp_literal_denied(self, enrolled):
        def run(m, sb):
            return sb.run_in_cgroup(m.bpflive.probe_udp_exchange,
                                    "10.99.0.3", 9999)

        want, got = twin(enrolled, run)
        assert got == want and got["result"] == "eperm"

    def test_raw_socket_denied_only_inside(self, enrolled):
        def run(m, sb):
            inside = sb.run_in_cgroup(m.bpflive.probe_raw_socket)
            outside = m.bpflive.probe_raw_socket()
            return inside, outside, events(sb)

        want, got = twin(enrolled, run)
        assert got == want
        inside, outside, evs = got
        assert inside["result"] == "eperm" and outside["result"] == "created"
        assert any(e[1] == "RAW_SOCKET" for e in evs)

    def test_native_ipv6_denied_v4mapped_follows_v4(self, enrolled):
        def run(m, sb):
            r6 = sb.run_in_cgroup(m.bpflive.probe_tcp_connect6,
                                  "2001:db8::1", 443)
            evs = events(sb)
            srv = m.bpflive.TcpEcho()
            srv.start()
            try:
                mapped = sb.run_in_cgroup(m.bpflive.probe_tcp_connect6,
                                          "::ffff:127.0.0.1", srv.port)
            finally:
                srv.stop()
            return r6, evs, mapped["result"]

        want, got = twin(enrolled, run)
        assert got == want
        r6, evs, mapped = got
        assert r6["result"] == "eperm" and any(e[1] == "IPV6" for e in evs)
        assert mapped == "connected"     # v4-mapped loopback: the v4 rules

    def test_bypass_deadline_opens_then_recloses(self, enrolled):
        def run(m, sb):
            sb.maps.set_bypass(sb.cgroup_id, time.time() + 30)
            opened = _tcp(m, sb, "10.99.0.1", 443, 0.3)["result"] != "eperm"
            sb.maps.clear_bypass(sb.cgroup_id)
            return opened, _tcp(m, sb, "10.99.0.1", 443)

        want, got = twin(enrolled, run)
        assert got == want
        assert got[0] and got[1]["result"] == "eperm"

    def test_expired_bypass_is_deleted_in_kernel(self, enrolled):
        """The dead-man: an expired entry denies and the program itself
        deletes it on first touch."""
        def run(m, sb):
            sb.maps.set_bypass(sb.cgroup_id, time.time() - 1)
            return _tcp(m, sb, "10.99.0.1", 443), sb.maps.bypass_entries()

        want, got = twin(enrolled, run)
        assert got == want
        assert got[0]["result"] == "eperm" and got[1] == {}

    def test_hostproxy_allowance_is_port_scoped(self, enrolled):
        def run(m, sb):
            M = m.model
            sb.enroll(M.ContainerPolicy(
                envoy_ip="192.0.2.1", dns_ip="192.0.2.2",
                hostproxy_ip="192.0.2.3", hostproxy_port=18374,
                flags=M.FLAG_ENFORCE | M.FLAG_HOSTPROXY))
            probe = m.bpflive.probe_udp_exchange
            return (sb.run_in_cgroup(probe, "192.0.2.3", 18374, b"x", 0.2),
                    sb.run_in_cgroup(probe, "192.0.2.3", 18999, b"x", 0.2))

        want, got = twin(enrolled, run)
        assert got == want
        ok, bad = got
        assert ok["result"] in ("sent-no-reply", "reply")
        assert bad["result"] == "eperm"

    def test_intra_net_bypass_excludes_gateway(self, enrolled):
        def run(m, sb):
            sb.enroll(m.model.ContainerPolicy(
                envoy_ip="192.0.2.1", dns_ip="198.51.100.1",
                flags=m.model.FLAG_ENFORCE, net_ip="198.51.100.0",
                net_prefix=24))
            probe = m.bpflive.probe_udp_exchange
            return (sb.run_in_cgroup(probe, "198.51.100.9", 4317, b"x", 0.2),
                    sb.run_in_cgroup(probe, "198.51.100.1", 8080, b"x", 0.2))

        want, got = twin(enrolled, run)
        assert got == want
        sibling, gateway = got
        assert sibling["result"] in ("sent-no-reply", "reply")
        assert gateway["result"] == "eperm"

    def test_events_carry_cgroup_and_zone(self, enrolled):
        def run(m, sb):
            M = m.model
            z = 0x7777
            sb.maps.cache_dns("203.0.113.9",
                              M.DnsEntry(z, int(time.time()) + 300))
            sb.maps.sync_routes({M.RouteKey(z, 0, M.PROTO_TCP):
                                 M.RouteVal(M.Action.DENY)})
            _tcp(m, sb, "203.0.113.9", 443)
            return events(sb)

        want, got = twin(enrolled, run)
        assert got == want
        route = [e for e in got if e[1] == "ROUTE"]
        assert route and route[0][6] and route[0][5] == 0x7777


# ------------------------------------- tests/test_dnsgate_kernel.py


ALLOWED_IP = "198.51.100.44"


def _upstream_stub(m):
    """The gate's upstream: any ``*.allowed.example`` A query answers
    ``ALLOWED_IP``, anything else NXDOMAIN."""
    def forward(data: bytes, resolvers, *, tcp: bool):
        q = m.dnsgate.parse_query(data)
        if not q.qname.endswith("allowed.example"):
            return (struct.pack(">HHHHHH", q.qid, 0x8180 | 3, 1, 0, 0, 0)
                    + q.raw_question)
        hdr = struct.pack(">HHHHHH", q.qid, 0x8180, 1, 1, 0, 0)
        answer = (struct.pack(">HHHIH", 0xC00C, 1, 1, 120, 4)
                  + socket.inet_aton(ALLOWED_IP))
        return hdr + q.raw_question + answer
    return forward


def _query(m, qid: int, name: str) -> bytes:
    return (struct.pack(">HHHHHH", qid, 0x0100, 1, 0, 0, 0)
            + m.dnsgate._encode_name(name) + struct.pack(">HH", 1, 1))


def _probe_resolve_then_connect(m, expect_ip: str) -> dict:
    """Runs inside the enforced cgroup: resolve through a hardcoded
    public resolver (the kernel must gate it), connect to the answer,
    then the denied zone's query and connect."""
    out = {}
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(2.0)
    s.sendto(_query(m, 0x7777, "api.allowed.example"), ("8.8.8.8", 53))
    try:
        reply, src = s.recvfrom(4096)
        out["reply_src"] = list(src)
        out["ips"] = [ip for ip, _ in m.dnsgate.parse_a_records(reply)]
    except OSError as e:
        out["resolve_err"] = str(e)
        s.close()
        return out
    s.close()
    t = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    t.settimeout(2.0)
    try:
        t.connect((expect_ip, 443))
        peer = t.getpeername()
        out["connect"] = "connected"
        out["peer"] = [peer[0], peer[1]]
    except OSError as e:
        out["connect"] = f"errno-{e.errno}"
    finally:
        t.close()
    s2 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s2.settimeout(2.0)
    s2.sendto(_query(m, 0x7778, "c2.evil.example"), ("8.8.8.8", 53))
    try:
        reply, _ = s2.recvfrom(4096)
        out["denied_rcode"] = struct.unpack(">H", reply[2:4])[0] & 0xF
    except OSError:
        out["denied_rcode"] = -1
    s2.close()
    b = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    b.settimeout(1.0)
    try:
        b.connect(("203.0.113.66", 443))
        out["denied_connect"] = "connected"
    except OSError as e:
        out["denied_connect"] = f"errno-{e.errno}"
    finally:
        b.close()
    return out


def _dns_loop(m) -> tuple:
    M = m.model
    with m.bpflive.LiveSandbox(f"dnsloop-twin-{m.tag}") as sb:
        def started():
            gate = m.dnsgate.DnsGate(
                m.dnsgate.ZonePolicy.from_rules([m.schema.EgressRule(
                    dst="*.allowed.example", proto="https")]),
                sb.maps, host="127.0.0.1", port=53)
            gate._forward = _upstream_stub(m)
            gate.start()
            return gate

        gate = _bound(started)
        envoy = m.bpflive.TcpEcho()
        envoy.start()
        try:
            sb.enroll(_enforcing(m))
            sb.maps.sync_routes({
                M.RouteKey(m.hashes.zone_hash("allowed.example"), 443,
                           M.PROTO_TCP):
                    M.RouteVal(M.Action.REDIRECT, "127.0.0.1", envoy.port)})
            out = sb.run_in_cgroup(_probe_resolve_then_connect, m, ALLOWED_IP)
            entry = sb.maps.lookup_dns(ALLOWED_IP)
            time.sleep(0.1)
            kinds = sorted({(e[0], e[1]) for e in events(sb, 512)})
            return out, entry is not None and entry.zone_hash \
                == m.hashes.zone_hash("allowed.example"), kinds
        finally:
            envoy.stop()
            gate.stop()


def test_dns_cache_route_enforce_loop_on_real_kernel():
    want, got = _dns_loop(PKGS["ref"]), _dns_loop(PKGS["port"])
    assert got == want
    out, cached, kinds = got
    assert out.get("reply_src") == ["8.8.8.8", 53], out
    assert out.get("ips") == [ALLOWED_IP], out
    assert out.get("connect") == "connected", out
    assert out.get("peer") == [ALLOWED_IP, 443], out
    assert out.get("denied_rcode") == 3, out
    assert out.get("denied_connect") == "errno-1", out
    assert cached
    assert {("REDIRECT_DNS", "DNS"), ("REDIRECT", "ROUTE"),
            ("DENY", "NO_DNS_ENTRY")} <= set(kinds)


# ------------------------------------------- tests/test_fwctl_raw.py


@pytest.fixture(scope="module")
def raw_binary(tmp_path_factory):
    """``make -C native/ebpf fwctl-raw`` into a directory of this
    module's own: -> (the binary, the build's return code)."""
    build = tmp_path_factory.mktemp("ebpf")
    res = subprocess.run(["make", "-C", str(EBPF_DIR), "fwctl-raw",
                          f"BUILD={build}"], capture_output=True, text=True)
    return str(build / "fwctl-raw"), res.returncode


def _native(binary: str, *args: str):
    return subprocess.run([binary, *args], capture_output=True, text=True)


def _raw_side(m, tag: str, body) -> list:
    """A ``FwKernel`` pinned into ``/sys/fs/bpf/clawker-test-<side>-<pid>``
    and a scratch cgroup ``fwctlraw-<tag>-<side>-<pid>``, both removed
    after ``body(kern, pin, cg, obs)`` ran: -> the observations, the
    first step that raises ending them with its type and text (paths
    read <PIN> and <CG>)."""
    pid = os.getpid()
    pin = BPFFS / f"clawker-test-{m.tag}-{pid}"
    cg = m.bpfkern.cgroup2_root() / f"fwctlraw-{tag}-{m.tag}-{pid}"
    obs: list = []
    kern = None
    try:
        kern = m.fwprogs.FwKernel()
        kern.pin_all(str(pin))
        obs.append("pinned")
        cg.mkdir(exist_ok=True)
        body(kern, pin, cg, obs)
    except Exception as e:  # noqa: BLE001 - the twin compares it
        text = str(e).replace(str(pin), "<PIN>").replace(str(cg), "<CG>")
        obs.append(["raised", type(e).__name__, text])
    finally:
        if pin.is_dir():
            for f in list(pin.iterdir()):
                f.unlink()
            pin.rmdir()
        if kern is not None:
            kern.close()
        with contextlib.suppress(OSError):
            cg.rmdir()
    return obs


def _raw_attach_enforce(m, binary: str) -> list:
    """tests/test_fwctl_raw.py's first case through ``m``: the native
    tool attaches by pin path, a probe child is denied, ``status`` sees
    the enrollment, ``events`` drains the deny, ``detach`` restores
    egress."""
    def body(kern, pin, cg, obs):
        maps = m.fwprogs.LiveMaps(kern)
        try:
            res = _native(binary, "attach", "--cgroup", str(cg),
                          "--pin-dir", str(pin))
            obs.append(["attach", res.returncode,
                        json.loads(res.stdout).get("programs")
                        if res.returncode == 0 else None])
            cg_id = os.stat(cg).st_ino
            maps.enroll(cg_id, _enforcing(m))
            sb = SimpleNamespace(cg_dir=cg)
            run = m.bpflive.LiveSandbox.run_in_cgroup
            out = run(sb, m.bpflive.probe_tcp_connect, "10.99.0.9", 443, 1.0)
            obs.append(["probe", out])
            res = _native(binary, "status", "--pin-dir", str(pin))
            st = json.loads(res.stdout) if res.returncode == 0 else {}
            obs.append(["status", res.returncode,
                        any(e["cgroup"] == cg_id
                            for e in st.get("enrolled", []))])
            res = _native(binary, "events", "--max", "64", "--pin-dir",
                          str(pin))
            evs = [json.loads(line) for line in res.stdout.splitlines()]
            obs.append(["events", res.returncode,
                        [[e["dst_ip"], e["dst_port"], e["verdict"]]
                         for e in evs if e["cgroup"] == cg_id]])
            res = _native(binary, "detach", "--cgroup", str(cg),
                          "--pin-dir", str(pin))
            obs.append(["detach", res.returncode])
            out = run(sb, m.bpflive.probe_tcp_connect, "10.99.0.9", 443, 0.4)
            obs.append(["after detach", out["result"] == "eperm"])
        finally:
            maps.close()

    return _raw_side(m, "attach", body)


def _raw_pinnedmaps_drain(m, binary: str) -> list:
    """tests/test_fwctl_raw.py's second case through ``m``: ``PinnedMaps``
    opens the pins, enrolls through them, and drains the ring through the
    native tool."""
    def body(kern, pin, cg, obs):
        pm = m.bpfsys.PinnedMaps(pin, fwctl=binary)
        try:
            cg_id = kern.attach_cgroup(str(cg))
            pm.enroll(cg_id, _enforcing(m))
            sb = SimpleNamespace(cg_dir=cg)
            out = m.bpflive.LiveSandbox.run_in_cgroup(
                sb, m.bpflive.probe_raw_socket)
            obs.append(["probe", out])
            time.sleep(0.1)
            obs.append(["events", sorted({e.reason.name
                                          for e in pm.drain_events(128)})])
            pm.unenroll(cg_id)
            obs.append(["detached", kern.detach_cgroup(str(cg))])
        finally:
            pm.close()

    return _raw_side(m, "pm", body)


@needs_bpffs
def test_attach_enforce_events_via_native_tool(raw_binary):
    binary, built = raw_binary
    want = [built] + _raw_attach_enforce(PKGS["ref"], binary)
    got = [built] + _raw_attach_enforce(PKGS["port"], binary)
    assert got == want


@needs_bpffs
def test_pinnedmaps_drain_events_via_native_tool(raw_binary):
    binary, built = raw_binary
    want = [built] + _raw_pinnedmaps_drain(PKGS["ref"], binary)
    got = [built] + _raw_pinnedmaps_drain(PKGS["port"], binary)
    assert got == want
