"""Netlogger: kernel egress events -> enriched structured log records.

The port's copy of ``clawker_tpu/monitor/netlogger.py``, whole.

Drains the firewall events ring (FirewallMaps.drain_events: the fwctl
JSON lane on real hosts, the in-memory ring in tests), enriches each
record -- cgroup id back to the enrolled container, zone hash back to
the matched zone apex -- and emits JSON lines to the egress log file
plus, when the monitor stack is up, OTLP/HTTP log records to the
collector (landing in the ``clawker-otlp`` index with
``service.name=ebpf-egress`` as the discriminator).

Parity reference: controlplane/firewall/ebpf/netlogger (ringbuf drain ->
OTLP, enrichment by cgroup_id via enrollment + docker labels).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

from .. import logsetup
from ..firewall.maps import FirewallMaps
from ..firewall.model import Action, Reason

log = logsetup.get("monitor.netlogger")


class NetLogger:
    def __init__(
        self,
        maps: FirewallMaps,
        *,
        out_path: Path,
        resolve_cgroup=None,          # cgroup_id -> container name ("" unknown)
        resolve_zone=None,            # zone_hash -> apex ("" unknown)
        otlp_endpoint: str = "",      # http://host:4318 -- optional lane
        lane=None,                    # controlplane.otel.OtlpLane (carries
        #                               the mTLS material when the
        #                               collector requires client certs)
        poll_s: float = 1.0,
    ):
        self.maps = maps
        self.out_path = Path(out_path)
        self.resolve_cgroup = resolve_cgroup or (lambda cg: "")
        self.resolve_zone = resolve_zone or (lambda zh: "")
        self.otlp_endpoint = otlp_endpoint.rstrip("/")
        self.poll_s = poll_s
        self.emitted = 0
        self._lane = lane
        if self._lane is not None:
            self.otlp_endpoint = self._lane.endpoint
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- records

    def enrich(self, ev) -> dict:
        return {
            "@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "service": "ebpf-egress",
            "cgroup_id": ev.cgroup_id,
            "container": self.resolve_cgroup(ev.cgroup_id),
            "dst_ip": ev.dst_ip,
            "dst_port": ev.dst_port,
            "proto": ev.proto,
            "verdict": Action(ev.verdict).name,
            "reason": Reason(ev.reason).name,
            "zone": self.resolve_zone(ev.zone_hash),
            "zone_hash": str(ev.zone_hash),
        }

    def drain_once(self) -> int:
        events = self.maps.drain_events(max_events=512)
        if not events:
            return 0
        records = [self.enrich(ev) for ev in events]
        self.out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.out_path, "a", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        if self.otlp_endpoint:
            self._ship_otlp(records)
        self.emitted += len(records)
        return len(records)

    def _ship_otlp(self, records: list[dict]) -> None:
        """Ship on the ebpf-egress subsystem lane (controlplane/otel)."""
        from ..controlplane.otel import OtlpLane

        if self._lane is None:
            self._lane = OtlpLane(self.otlp_endpoint, "ebpf-egress")
        self._lane.ship(records, severity_of=lambda rec: (
            "WARN" if rec.get("verdict") == "DENY" else "INFO"))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="netlogger",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.drain_once()
            except Exception as e:  # drain must never die silently mid-flight
                log.error("event=netlogger_drain_failed error=%s", e)
            self._stop.wait(self.poll_s)
        try:
            self.drain_once()  # final sweep so shutdown loses nothing
        except Exception:
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)


def handler_resolvers(handler, *, cache_ttl_s: float = 5.0):
    """Enrichment closures over a FirewallHandler's state.

    Both lookups are dict-cached with a short TTL: enrichment runs per
    event (up to 512/poll), and rebuilding the maps per event would mean
    a rules-file read + hash sweep for every record."""
    from ..firewall.hashes import zone_hash as _zh

    state = {"at": 0.0, "cgroups": {}, "zones": {}}

    def _refresh():
        now = time.monotonic()
        if now - state["at"] < cache_ttl_s:
            return
        state["cgroups"] = {
            e.cgroup_id: e.container_id for e in handler.enrollments.values()
        }
        zones = {}
        for rule in handler.effective_rules():
            apex = rule.dst[2:] if rule.dst.startswith("*.") else rule.dst
            zones[_zh(apex)] = apex
        state["zones"] = zones
        state["at"] = now

    def resolve_cgroup(cg: int) -> str:
        _refresh()
        return state["cgroups"].get(cg, "")

    def resolve_zone(zh: int) -> str:
        if not zh:
            return ""
        _refresh()
        return state["zones"].get(zh, "")

    return resolve_cgroup, resolve_zone
