"""The random sweep of tests/test_bpf_differential.py through both
packages on the live kernel.

The same seed draws the same worlds (policies, DNS entries, routes) and
destinations in each package; each world goes into that package's
policy oracle (``FakeMaps`` + ``policy.connect4``) and into a
``LiveSandbox`` of its own (cgroup ``bpfdiff-twin-<side>-<pid>``), and a
probe child's real ``connect()`` in the enrolled cgroup is the kernel's
verdict.  Every case's verdict in the port's kernel equals the
reference kernel's, the port's oracle's and the reference oracle's.
Gated as the reference's file is, by the reference's own probe.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import pytest

import clawker_tpu.firewall.bpfkern as ref_bpfkern
import clawker_tpu.firewall.bpflive as ref_bpflive
import clawker_tpu.firewall.hashes as ref_hashes
import clawker_tpu.firewall.maps as ref_maps
import clawker_tpu.firewall.model as ref_model
import clawker_tpu.firewall.policy as ref_policy
import clawker_tpu_torch.firewall.bpflive as port_bpflive
import clawker_tpu_torch.firewall.hashes as port_hashes
import clawker_tpu_torch.firewall.maps as port_maps
import clawker_tpu_torch.firewall.model as port_model
import clawker_tpu_torch.firewall.policy as port_policy

PKGS = {
    "ref": SimpleNamespace(tag="ref", bpflive=ref_bpflive, hashes=ref_hashes,
                           maps=ref_maps, model=ref_model, policy=ref_policy),
    "port": SimpleNamespace(tag="port", bpflive=port_bpflive,
                            hashes=port_hashes, maps=port_maps,
                            model=port_model, policy=port_policy),
}
CASES = 60
SEED = 0xC1A0

pytestmark = pytest.mark.skipif(
    not ref_bpfkern.kernel_available(),
    reason="bpf(2) PROG_LOAD or writable cgroup-v2 unavailable")


def _random_world(m, rng: random.Random):
    M = m.model
    pol = M.ContainerPolicy(
        envoy_ip=f"192.0.2.{rng.randint(1, 40)}",
        dns_ip=f"192.0.2.{rng.randint(41, 80)}",
        hostproxy_ip=f"192.0.2.{rng.randint(81, 120)}",
        hostproxy_port=rng.choice([18374, 8080]),
        flags=(M.FLAG_ENFORCE if rng.random() < 0.8 else 0)
        | (M.FLAG_HOSTPROXY if rng.random() < 0.5 else 0),
        net_ip=f"10.{rng.randint(0, 200)}.0.0",
        net_prefix=rng.choice([0, 8, 16, 24, 31, 32]),
    )
    routes = {}
    dns = {}
    for _ in range(rng.randint(1, 4)):
        zh = m.hashes.zone_hash(f"z{rng.randint(0, 999)}.example")
        ip = f"203.0.113.{rng.randint(1, 250)}"
        dns[ip] = M.DnsEntry(zone_hash=zh,
                             expires_unix=int(time.time()) + 600)
        if rng.random() < 0.8:
            port = rng.choice([0, 443, 8443])
            action = rng.choice([M.Action.ALLOW, M.Action.DENY,
                                 M.Action.REDIRECT])
            routes[M.RouteKey(zh, port, M.PROTO_TCP)] = M.RouteVal(
                action, redirect_ip="127.0.0.1",
                redirect_port=rng.randint(20000, 40000))
    return pol, dns, routes


def _destinations(rng: random.Random, pol, dns) -> list:
    out = [("127.0.0.1", 9999),
           (pol.envoy_ip, rng.choice([443, 10000])),
           (pol.dns_ip, 53),
           (pol.hostproxy_ip, pol.hostproxy_port),
           (pol.hostproxy_ip, pol.hostproxy_port + 1),
           (f"10.{rng.randint(0, 200)}.{rng.randint(0, 3)}.9", 445),
           ("198.18.0.1", 443)]
    for ip in dns:
        out.append((ip, rng.choice([443, 8443, 2222])))
    rng.shuffle(out)
    return out[:6]


def _sweep(m) -> list:
    """-> [destination, oracle's action and reason, kernel denied]."""
    rng = random.Random(SEED)
    verdicts = []
    with m.bpflive.LiveSandbox(f"bpfdiff-twin-{m.tag}") as sb:
        while len(verdicts) < CASES:
            pol, dns, routes = _random_world(m, rng)
            oracle = m.maps.FakeMaps()
            oracle.enroll(sb.cgroup_id, pol)
            sb.maps.enroll(sb.cgroup_id, pol)
            for ip, entry in dns.items():
                oracle.cache_dns(ip, entry)
                sb.maps.cache_dns(ip, entry)
            oracle.sync_routes(routes)
            sb.maps.sync_routes(routes)
            for ip, port in _destinations(rng, pol, dns):
                want = m.policy.connect4(oracle, sb.cgroup_id, ip, port)
                got = sb.run_in_cgroup(m.bpflive.probe_tcp_connect, ip, port,
                                       0.25)
                verdicts.append([f"{ip}:{port}", want.action.name,
                                 want.reason.name, got["result"] == "eperm"])
            sb.maps.flush_all()
            sb.maps.drain_events(4096)
    return verdicts


def test_oracle_matches_real_kernel_over_random_worlds_in_both():
    want, got = _sweep(PKGS["ref"]), _sweep(PKGS["port"])
    assert len(got) >= CASES
    assert got == want
    mismatches = [v for v in got if v[3] != (v[1] == "DENY")]
    assert not mismatches, "\n".join(map(str, mismatches[:10]))
