"""Firewall map store: one interface, a userspace fake and pinned-BPF real.

The port's copy of ``clawker_tpu/firewall/maps.py``, whole.

``FirewallMaps`` is the seam every firewall component writes through: the
DNS gate caches resolutions, route sync swaps the global route table, the
handler enrolls/bypasses containers, and the netlogger drains events.  In
tests (and the policy oracle) the store is ``FakeMaps`` -- plain dicts with
kernel-map semantics (LRU bound on udp_flows; events drop NEW records when
the ring is full, matching kernel ringbuf reserve-failure behavior).
On a real host ``PinnedMaps`` (bpfsys.py) operates on the maps the loader
pinned under /sys/fs/bpf/clawker-tpu.

Parity reference: pinned map set in controlplane/firewall/ebpf/bpf/common.h
:162-380 (container_map, bypass_map, dns_cache, route_map, udp_flow_map,
metrics_map, events_ringbuf) and the manager ops over them
(ebpf/manager.go Install/Remove/SyncRoutes/UpdateDNSCache/FlushAll).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Iterator

from .model import ContainerPolicy, DnsEntry, EgressEvent, RouteKey, RouteVal, UdpFlow

# Pin-file names under the pin root (BPF_PIN_DIR); the C object's map
# names match these so libbpf pins land on the same paths.
MAP_CONTAINERS = "containers"
MAP_BYPASS = "bypass"
MAP_DNS_CACHE = "dns_cache"
MAP_ROUTES = "routes"
MAP_UDP_FLOWS = "udp_flows"
MAP_TCP_FLOWS = "tcp_flows"
MAP_EVENTS = "events"
MAP_RATELIMIT = "ratelimit"

# The single source of truth for the pinned set; fwctl.c's MAPS[] is
# pinned against this list by tests/test_ebpf_abi.py.
ALL_MAPS = (MAP_CONTAINERS, MAP_BYPASS, MAP_DNS_CACHE, MAP_ROUTES,
            MAP_UDP_FLOWS, MAP_TCP_FLOWS, MAP_EVENTS, MAP_RATELIMIT)

UDP_FLOWS_MAX = 4096
EVENTS_RING_MAX = 8192


class FirewallMaps:
    """Kernel-state facade.  All addresses/ports in host (string/int) form;
    packing to the wire ABI happens at the edge (bpfsys / fake)."""

    # containers --------------------------------------------------------
    def enroll(self, cgroup_id: int, policy: ContainerPolicy) -> None:
        raise NotImplementedError

    def unenroll(self, cgroup_id: int) -> None:
        raise NotImplementedError

    def lookup_container(self, cgroup_id: int) -> ContainerPolicy | None:
        raise NotImplementedError

    def enrolled(self) -> dict[int, ContainerPolicy]:
        raise NotImplementedError

    # bypass ------------------------------------------------------------
    def set_bypass(self, cgroup_id: int, deadline_unix: int) -> None:
        raise NotImplementedError

    def clear_bypass(self, cgroup_id: int) -> None:
        raise NotImplementedError

    def bypassed(self, cgroup_id: int) -> bool:
        raise NotImplementedError

    def bypass_entries(self) -> dict[int, int]:
        raise NotImplementedError

    # dns cache ---------------------------------------------------------
    def cache_dns(self, ip: str, entry: DnsEntry) -> None:
        raise NotImplementedError

    def lookup_dns(self, ip: str) -> DnsEntry | None:
        raise NotImplementedError

    def dns_entries(self) -> dict[str, DnsEntry]:
        raise NotImplementedError

    def expire_dns(self, now_unix: int | None = None) -> int:
        """GC expired dns_cache entries; returns count removed."""
        raise NotImplementedError

    # routes ------------------------------------------------------------
    def sync_routes(self, table: dict[RouteKey, RouteVal]) -> None:
        """Atomically replace the global route table (reference:
        Handler.SyncRoutes handler.go:1015 atomic swap)."""
        raise NotImplementedError

    def lookup_route(self, key: RouteKey) -> RouteVal | None:
        raise NotImplementedError

    def routes(self) -> dict[RouteKey, RouteVal]:
        raise NotImplementedError

    # reverse-NAT flows -------------------------------------------------
    # (two LRUs so TCP connect churn can never evict live UDP entries)
    def record_udp_flow(self, cookie: int, flow: UdpFlow) -> None:
        raise NotImplementedError

    def lookup_udp_flow(self, cookie: int) -> UdpFlow | None:
        raise NotImplementedError

    def record_tcp_flow(self, cookie: int, flow: UdpFlow) -> None:
        raise NotImplementedError

    def lookup_tcp_flow(self, cookie: int) -> UdpFlow | None:
        raise NotImplementedError

    # events ------------------------------------------------------------
    def emit_event(self, ev: EgressEvent) -> None:
        raise NotImplementedError

    def drain_events(self, max_events: int = 256) -> list[EgressEvent]:
        raise NotImplementedError

    # lifecycle ---------------------------------------------------------
    def flush_all(self) -> None:
        """Remove every entry from every map (reference: FlushAll
        ebpf/manager.go:420 -- used on drain so state never goes stale)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class FakeMaps(FirewallMaps):
    """In-memory twin of the pinned maps, with kernel-map semantics."""

    def __init__(self):
        self._lock = threading.RLock()
        self._containers: dict[int, ContainerPolicy] = {}
        self._bypass: dict[int, int] = {}
        self._dns: dict[str, DnsEntry] = {}
        self._routes: dict[RouteKey, RouteVal] = {}
        self._udp: OrderedDict[int, UdpFlow] = OrderedDict()
        self._tcp: OrderedDict[int, UdpFlow] = OrderedDict()
        self._events: list[EgressEvent] = []
        self.events_dropped = 0

    def enroll(self, cgroup_id, policy):
        with self._lock:
            self._containers[cgroup_id] = policy

    def unenroll(self, cgroup_id):
        with self._lock:
            self._containers.pop(cgroup_id, None)
            self._bypass.pop(cgroup_id, None)

    def lookup_container(self, cgroup_id):
        with self._lock:
            return self._containers.get(cgroup_id)

    def enrolled(self):
        with self._lock:
            return dict(self._containers)

    def set_bypass(self, cgroup_id, deadline_unix):
        with self._lock:
            self._bypass[cgroup_id] = deadline_unix

    def clear_bypass(self, cgroup_id):
        with self._lock:
            self._bypass.pop(cgroup_id, None)

    def bypassed(self, cgroup_id):
        # deadline-aware, like the kernel's fw_bypass_active: an expired
        # entry never grants bypass even before GC removes it
        with self._lock:
            deadline = self._bypass.get(cgroup_id)
            if deadline is None:
                return False
            if deadline <= time.time():
                del self._bypass[cgroup_id]
                return False
            return True

    def bypass_entries(self):
        with self._lock:
            return dict(self._bypass)

    def cache_dns(self, ip, entry):
        with self._lock:
            self._dns[ip] = entry

    def lookup_dns(self, ip):
        with self._lock:
            return self._dns.get(ip)

    def dns_entries(self):
        with self._lock:
            return dict(self._dns)

    def expire_dns(self, now_unix=None):
        now = int(now_unix if now_unix is not None else time.time())
        with self._lock:
            stale = [ip for ip, e in self._dns.items() if e.expires_unix <= now]
            for ip in stale:
                del self._dns[ip]
            return len(stale)

    def sync_routes(self, table):
        with self._lock:
            self._routes = dict(table)

    def lookup_route(self, key):
        with self._lock:
            return self._routes.get(key)

    def routes(self):
        with self._lock:
            return dict(self._routes)

    def record_udp_flow(self, cookie, flow):
        with self._lock:
            self._udp[cookie] = flow
            self._udp.move_to_end(cookie)
            while len(self._udp) > UDP_FLOWS_MAX:  # LRU eviction
                self._udp.popitem(last=False)

    def lookup_udp_flow(self, cookie):
        with self._lock:
            return self._udp.get(cookie)

    def record_tcp_flow(self, cookie, flow):
        with self._lock:
            self._tcp[cookie] = flow
            self._tcp.move_to_end(cookie)
            while len(self._tcp) > UDP_FLOWS_MAX:
                self._tcp.popitem(last=False)

    def lookup_tcp_flow(self, cookie):
        with self._lock:
            return self._tcp.get(cookie)

    def emit_event(self, ev):
        with self._lock:
            if len(self._events) >= EVENTS_RING_MAX:
                self.events_dropped += 1
                return
            self._events.append(ev)

    def drain_events(self, max_events=256):
        with self._lock:
            out, self._events = self._events[:max_events], self._events[max_events:]
            return out

    def flush_all(self):
        with self._lock:
            self._containers.clear()
            self._bypass.clear()
            self._dns.clear()
            self._routes.clear()
            self._udp.clear()
            self._tcp.clear()
            self._events.clear()


def iter_expired_bypass(maps: FirewallMaps, now_unix: int | None = None) -> Iterator[int]:
    """Cgroups whose bypass dead-man deadline has passed (reference:
    CleanupStaleBypass ebpf/manager.go:367)."""
    now = int(now_unix if now_unix is not None else time.time())
    for cg, deadline in maps.bypass_entries().items():
        if deadline <= now:
            yield cg
