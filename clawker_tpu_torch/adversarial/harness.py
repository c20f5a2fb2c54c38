"""Adversarial harness: the egress surface payloads attack, and the
capture database the report is graded from.

``EgressSurface`` wires the real enforcement components -- FakeMaps with
kernel semantics, the policy oracle, the DNS gate's serve_packet path,
and the production route builder -- exactly as the firewall handler
does, so a payload that slips through here is a real semantic hole, not
a test-double artifact.

Outcome taxonomy:
- CAPTURED:  the attempt was denied / answered NXDOMAIN (the attacker
  endpoint saw nothing).
- CONTAINED: traffic reached a clawker-controlled chokepoint (Envoy,
  the DNS gate, loopback) that applies its own policy -- never the
  attacker directly.
- ESCAPED:   bytes would have reached an attacker-controlled endpoint.
  Any ESCAPED fails the suite.

The port's copy of ``clawker_tpu/adversarial/harness.py``, whole.
"""

from __future__ import annotations

import json
import sqlite3
import time
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

from ..config.schema import EgressRule
from ..firewall import policy as policy_mod
from ..firewall.dnsgate import (
    RCODE_NOERROR,
    RCODE_NXDOMAIN,
    DnsGate,
    ZonePolicy,
    parse_a_records,
)
from ..firewall.maps import FakeMaps
from ..firewall.model import (
    FLAG_ENFORCE,
    FLAG_HOSTPROXY,
    PROTO_TCP,
    PROTO_UDP,
    Action,
    ContainerPolicy,
    DnsEntry,
)

CG = 0xC0FFEE          # the sandboxed agent's cgroup
ENVOY_IP = "10.77.0.2"
DNS_IP = "10.77.0.1"   # gate on the gateway
HOSTPROXY_IP = "10.77.0.1"
HOSTPROXY_PORT = 18374


class Outcome(str, Enum):
    CAPTURED = "captured"
    CONTAINED = "contained"
    ESCAPED = "escaped"


@dataclass
class Attempt:
    payload: str
    technique: str
    detail: str
    outcome: Outcome


class CaptureDB:
    """Sqlite record of every attempt (reference: the attacker server's
    capture DB the operator grades from)."""

    def __init__(self, path: Path | str = ":memory:"):
        self.conn = sqlite3.connect(str(path))
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS attempts ("
            " ts REAL, payload TEXT, technique TEXT, detail TEXT, outcome TEXT)"
        )

    def record(self, attempt: Attempt) -> None:
        self.conn.execute(
            "INSERT INTO attempts VALUES (?, ?, ?, ?, ?)",
            (time.time(), attempt.payload, attempt.technique, attempt.detail,
             attempt.outcome.value),
        )
        self.conn.commit()

    def escapes(self) -> list[tuple]:
        return list(self.conn.execute(
            "SELECT payload, technique, detail FROM attempts WHERE outcome = ?",
            (Outcome.ESCAPED.value,),
        ))

    def counts(self) -> dict[str, int]:
        return dict(self.conn.execute(
            "SELECT outcome, COUNT(*) FROM attempts GROUP BY outcome"))

    def close(self) -> None:
        self.conn.close()


class EgressSurface:
    """The sandbox, as a payload sees it."""

    def __init__(self, rules: list[EgressRule], *,
                 resolutions: dict[str, str] | None = None):
        self.rules = rules
        self.maps = FakeMaps()
        self.maps.enroll(CG, ContainerPolicy(
            envoy_ip=ENVOY_IP, dns_ip=DNS_IP,
            hostproxy_ip=HOSTPROXY_IP, hostproxy_port=HOSTPROXY_PORT,
            flags=FLAG_ENFORCE | FLAG_HOSTPROXY,
        ))
        # production route construction, not a test re-derivation
        from ..firewall.envoy import generate_envoy_config

        bundle = generate_envoy_config(rules)
        self.maps.sync_routes(policy_mod.build_routes(
            rules, envoy_ip=ENVOY_IP, tls_port=10000,
            tcp_ports=bundle.tcp_ports,
        ))
        # DNS gate with a canned upstream: allowed domains resolve to the
        # address in ``resolutions`` (attacker-controlled hosts resolve
        # nowhere -- the gate never forwards them)
        self.resolutions = resolutions or {}
        self.gate = DnsGate(ZonePolicy.from_rules(rules), self.maps,
                            host="127.0.0.1", port=0)
        self._cookie = 0

    # -- resolution ----------------------------------------------------

    def dns_query(self, qname: str, qtype: int = 1) -> tuple[int, list[str]]:
        """Query through the REAL gate path; returns (rcode, ips)."""
        from ..firewall.dnsgate import _encode_name
        import struct as _struct

        hdr = _struct.pack(">HHHHHH", 0x0101, 0x0100, 1, 0, 0, 0)
        q = hdr + _encode_name(qname) + _struct.pack(">HH", qtype, 1)

        def forward(data, resolvers, *, tcp):
            ip = self.resolutions.get(qname.lower().rstrip("."))
            if ip is None:
                return None
            # upstream-shaped answer
            import socket as _s

            reply_hdr = _struct.pack(">HHHHHH", 0x0101, 0x8180, 1, 1, 0, 0)
            body = data[12:]
            body += _struct.pack(">HHHIH", 0xC00C, 1, 1, 120, 4) + _s.inet_aton(ip)
            return reply_hdr + body

        self.gate._forward = forward  # type: ignore[method-assign]
        reply = self.gate.serve_packet(q)
        if reply is None:
            return -1, []
        rcode = _struct.unpack(">H", reply[2:4])[0] & 0xF
        return rcode, [ip for ip, _ in parse_a_records(reply)]

    # -- kernel hooks --------------------------------------------------

    def cookie(self) -> int:
        self._cookie += 1
        return self._cookie

    def connect(self, ip: str, port: int, proto: int = PROTO_TCP):
        return policy_mod.connect4(self.maps, CG, ip, port, proto,
                                   sock_cookie=self.cookie())

    def sendmsg(self, ip: str, port: int):
        return policy_mod.sendmsg4(self.maps, CG, self.cookie(), ip, port)

    def connect6(self, ip6: str, port: int):
        return policy_mod.connect6(self.maps, CG, ip6, port)

    def raw_socket(self):
        return policy_mod.sock_create(self.maps, CG, 2, policy_mod.SOCK_RAW)

    def packet_socket(self):
        return policy_mod.sock_create(self.maps, CG, 2, policy_mod.SOCK_PACKET)

    # -- grading -------------------------------------------------------

    def grade_verdict(self, v, dst_ip: str) -> tuple[Outcome, str]:
        """Where would the bytes have gone?"""
        if v.action is Action.DENY:
            return Outcome.CAPTURED, f"denied ({v.reason.name})"
        if v.action in (Action.REDIRECT, Action.REDIRECT_DNS):
            target = v.redirect_ip
            if target in (ENVOY_IP, DNS_IP):
                return Outcome.CONTAINED, f"redirected to chokepoint {target}"
            return Outcome.ESCAPED, f"redirected to uncontrolled {target}"
        # ALLOW: direct path to dst
        if dst_ip.startswith("127.") or dst_ip in (ENVOY_IP, DNS_IP):
            return Outcome.CONTAINED, f"allowed to chokepoint/loopback {dst_ip}"
        if dst_ip == HOSTPROXY_IP:
            return Outcome.CONTAINED, "allowed to host proxy (audited channel)"
        return Outcome.ESCAPED, f"allowed direct to {dst_ip}"


@dataclass
class Report:
    total: int = 0
    captured: int = 0
    contained: int = 0
    escaped: int = 0
    escapes: list[tuple] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.escaped == 0

    def to_json(self) -> str:
        return json.dumps({
            "total": self.total, "captured": self.captured,
            "contained": self.contained, "escaped": self.escaped,
            "escapes": [list(e) for e in self.escapes], "pass": self.ok,
        }, indent=2)


def run_corpus(db: CaptureDB | None = None, *, rules=None) -> Report:
    """Run every payload class; any ESCAPED outcome fails."""
    from .payloads import CORPUS, default_rules, default_resolutions

    rules = rules if rules is not None else default_rules()
    surface = EgressSurface(rules, resolutions=default_resolutions())
    db = db or CaptureDB()
    report = Report()
    for payload in CORPUS:
        for attempt in payload(surface):
            db.record(attempt)
            report.total += 1
            if attempt.outcome is Outcome.CAPTURED:
                report.captured += 1
            elif attempt.outcome is Outcome.CONTAINED:
                report.contained += 1
            else:
                report.escaped += 1
    report.escapes = db.escapes()
    return report
