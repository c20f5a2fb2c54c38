"""The control-plane daemon: subsystem orchestration, healthz, drain.

Parity reference: internal/controlplane/cmd.go:921 run -- boot logging,
topics, enforcement build, gRPC stack (AdminService + AgentService),
docker-events feeder, workers, agent dialer, healthz aggregate (:441), and
the ordered drain sequence (:306, ordering INV-B2-007): action queue close
-> server stop -> firewall stack stop -> feeder cancel -> clean exit 0.
Resilience contract: nothing on the serve path may crash the daemon
("CP crashing is a SECURITY incident", reference root CLAUDE.md) -- every
worker thread is exception-recovered and subsystem failure degrades with a
structured ``<subsystem>_unavailable`` log, never an exit.

The port's copy of ``clawker_tpu/controlplane/daemon.py``, whole.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from .. import consts, logsetup
from ..firewall import pki
from .adminapi import AdminServer
from .agentservice import AgentService
from .dialer import Dialer, DialerConfig, engine_endpoint_resolver, engine_profile_builder
from .dockerevents import ContainerStateRepo, DockerEvent, Feeder
from .pubsub import Topic
from .registry import Registry
from .watcher import AgentWatcher

log = logsetup.get("cp.daemon")

CP_COMMON_NAME = "clawker-controlplane"


def ensure_cp_material(pki_dir: Path) -> tuple[Path, Path, Path]:
    """CP identity on disk: (cert, key, ca) paths, minted once from the CA.

    The CP cert carries both server and client EKU (it serves Admin/Agent
    listeners *and* dials agentd), CN pinned to ``clawker-controlplane``
    (agentd verifies the CN -- reference: clawkerd listener CP CN pin).
    """
    ca = pki.ensure_ca(pki_dir)
    cert_p, key_p, ca_p = pki_dir / "cp.crt", pki_dir / "cp.key", pki_dir / "ca.crt"
    if not (cert_p.exists() and key_p.exists()):
        pair = pki.generate_cp_cert(ca)
        cert_p.write_bytes(pair.cert_pem)
        key_p.touch(mode=0o600)
        key_p.write_bytes(pair.key_pem)
    if not ca_p.exists():
        ca_p.write_bytes(ca.cert_pem)
    return cert_p, key_p, ca_p


@dataclass
class CPConfig:
    pki_dir: Path
    registry_path: Path
    host: str = "0.0.0.0"
    admin_port: int = consts.CP_ADMIN_PORT
    agent_port: int = consts.CP_AGENT_PORT
    health_port: int = consts.CP_HEALTH_PORT
    cp_host: str = ""                    # address agentd uses to Register back
    watch_interval_s: float = 30.0
    drain_to_zero: bool = False
    drain_grace_polls: int = 2
    dns_gc_interval_s: float = 30.0      # dns_cache/bypass map GC ticker


@dataclass
class Subsystems:
    """What the daemon wired; exposed for healthz/status and tests."""

    topic: Topic[DockerEvent] | None = None
    repo: ContainerStateRepo | None = None
    feeder: Feeder | None = None
    dialer: Dialer | None = None
    agent_service: AgentService | None = None
    admin: AdminServer | None = None
    watcher: AgentWatcher | None = None
    registry: Registry | None = None
    unavailable: list[str] = field(default_factory=list)


class ControlPlaneDaemon:
    def __init__(self, cfg: CPConfig, engine, firewall=None, netlogger=None):
        self.cfg = cfg
        self.engine = engine
        self.firewall = firewall          # FirewallHandler | None
        self.netlogger = netlogger        # monitor.netlogger.NetLogger | None
        self.subs = Subsystems()
        self._stop = threading.Event()
        self._gc_thread: threading.Thread | None = None
        self._drained_to_zero = False
        self._healthz: ThreadingHTTPServer | None = None
        self._healthz_thread: threading.Thread | None = None
        self.health_bound_port = 0
        self.started_at = 0.0

    # ---------------------------------------------------------------- boot

    def start(self) -> None:
        self.started_at = time.time()
        cert, key, ca = ensure_cp_material(self.cfg.pki_dir)
        registry = Registry(self.cfg.registry_path)
        self.subs.registry = registry

        # topics + docker-events feeder (cmd.go:768 buildTopics, :489 startFeeder)
        topic: Topic[DockerEvent] = Topic("docker-events")
        repo = ContainerStateRepo()
        feeder = Feeder(self.engine, topic, repo)
        self.subs.topic, self.subs.repo, self.subs.feeder = topic, repo, feeder

        # grpc-equivalent stack (cmd.go:609 buildGRPCStack)
        agent_service = AgentService(
            registry, cert_file=cert, key_file=key, ca_file=ca,
            host=self.cfg.host, port=self.cfg.agent_port,
        )
        admin = AdminServer(
            cert_file=cert, key_file=key, ca_file=ca,
            host=self.cfg.host, port=self.cfg.admin_port,
        )
        admin.register("ListAgents", self._handle_list_agents)
        admin.register("Status", self._handle_status)
        if self.firewall is not None:
            # enforcement build (cmd.go:517 buildEnforcement): verbs only
            # exist when the handler does -- absent = 501, fail-closed
            self.firewall.register_on(admin)
            try:
                cleared = self.firewall.clear_expired_bypass()
                if cleared:
                    log.info("cleared %d stale bypass entries", cleared)
            except Exception as e:
                log.error("event=firewall_bypass_gc_failed error=%s", e)
        self.subs.agent_service, self.subs.admin = agent_service, admin

        # agent dialer (cmd.go:847 startAgentDialer)
        dialer = Dialer(
            DialerConfig(
                cert_file=cert, key_file=key, ca_file=ca,
                cp_host=self.cfg.cp_host,
                cp_agent_port=0,      # patched after bind below
            ),
            registry,
            engine_endpoint_resolver(self.engine),
            engine_profile_builder(self.engine),
        )
        self.subs.dialer = dialer

        # watcher (watcher.go; drain-to-zero cmd.go:306)
        watcher = AgentWatcher(
            self.engine,
            interval_s=self.cfg.watch_interval_s,
            drain_grace_polls=self.cfg.drain_grace_polls,
            on_drained=self._on_drained_to_zero if self.cfg.drain_to_zero else None,
        )
        self.subs.watcher = watcher

        # bring-up order: listeners first (agents may register the moment
        # the feeder reconciles), then feeder, dialer, watcher
        for name, fn in (
            ("agent_service", agent_service.start),
            ("admin", admin.start),
        ):
            try:
                fn()
            except Exception as e:
                # fail-closed subsystems degrade loudly, the daemon survives
                log.error("event=%s_unavailable error=%s", name, e)
                self.subs.unavailable.append(name)
        dialer.cfg.cp_agent_port = agent_service.bound_port or self.cfg.agent_port
        feeder.start()
        dialer.start(topic, repo)
        watcher.start()
        if self.netlogger is not None:   # workers (cmd.go:812 startWorkers)
            try:
                self.netlogger.start()
            except Exception as e:
                log.error("event=netlogger_unavailable error=%s", e)
                self.subs.unavailable.append("netlogger")
        if self.firewall is not None and self.cfg.dns_gc_interval_s > 0:
            # periodic dns_cache + bypass GC (reference: ebpf/dns_gc.go
            # ticker) -- TTL expiry is enforced ONLY here, the kernel skips
            # expires_unix at lookup by design
            self._gc_thread = threading.Thread(
                target=self._gc_loop, name="dns-gc", daemon=True
            )
            self._gc_thread.start()
        self._start_healthz()
        log.info(
            "control plane up: admin=:%s agent=:%s health=:%s",
            admin.bound_port, agent_service.bound_port, self.health_bound_port,
        )

    def _gc_loop(self) -> None:
        """Recovered worker: tick map GC until drain (serve-path contract:
        errors degrade with a structured log, never crash)."""
        while not self._stop.wait(self.cfg.dns_gc_interval_s):
            try:
                res = self.firewall.gc_tick()
                if res.get("dns_expired") or res.get("bypass_cleared"):
                    log.info(
                        "event=map_gc dns_expired=%d bypass_cleared=%d",
                        res.get("dns_expired", 0), res.get("bypass_cleared", 0),
                    )
            except Exception as e:
                log.error("event=map_gc_failed error=%s", e)

    # ------------------------------------------------------------- healthz

    def _start_healthz(self) -> None:
        outer = self

        class _Health(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                body = json.dumps(outer.health()).encode()
                ok = outer.healthy()
                self.send_response(200 if ok else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        try:
            self._healthz = ThreadingHTTPServer((self.cfg.host, self.cfg.health_port), _Health)
        except OSError as e:
            log.error("event=healthz_unavailable error=%s", e)
            self.subs.unavailable.append("healthz")
            return
        self.health_bound_port = self._healthz.server_address[1]
        self._healthz_thread = threading.Thread(
            target=self._healthz.serve_forever, name="healthz", daemon=True
        )
        self._healthz_thread.start()

    def health(self) -> dict:
        """Aggregate probe (reference: cmd.go:441 startHealthz, 7 probes)."""
        s = self.subs
        return {
            "admin": bool(s.admin and s.admin.bound_port),
            "agent_service": bool(s.agent_service and s.agent_service.bound_port),
            "feeder": bool(s.feeder and s.feeder._thread and s.feeder._thread.is_alive()),
            "watcher": bool(s.watcher and s.watcher._thread and s.watcher._thread.is_alive()),
            "watcher_blind": bool(s.watcher and s.watcher.consecutive_errors > 0),
            "registry": s.registry is not None,
            "unavailable": list(s.unavailable),
            "uptime_s": round(time.time() - self.started_at, 1),
        }

    def healthy(self) -> bool:
        h = self.health()
        return h["admin"] and h["agent_service"] and h["feeder"] and not h["unavailable"]

    # ------------------------------------------------------------- handlers

    def _handle_list_agents(self, req: dict) -> dict:
        assert self.subs.registry is not None
        records = self.subs.registry.list(req.get("project") or None)
        return {
            "agents": [
                {
                    "full_name": r.full_name, "project": r.project, "agent": r.agent,
                    "container_id": r.container_id, "state": r.state,
                    "initialized": r.initialized,
                    "registered": bool(r.registered_at), "worker": r.worker,
                    "last_seen": r.last_seen,
                }
                for r in records
            ]
        }

    def _handle_status(self, req: dict) -> dict:
        return {"health": self.health(), "healthy": self.healthy()}

    # ---------------------------------------------------------------- drain

    def request_stop(self) -> None:
        self._stop.set()

    def _on_drained_to_zero(self) -> None:
        self._drained_to_zero = True
        self.request_stop()

    def wait(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(1.0)

    def drain(self) -> None:
        """Ordered shutdown (reference: runDrainSequence cmd.go:306)."""
        s = self.subs
        log.info("drain: begin")
        self._stop.set()                 # stops the GC ticker
        if self._gc_thread is not None:
            self._gc_thread.join(2.0)
        for name, fn in (
            # firewall action queue closes FIRST (ordering INV-B2-007):
            # no mutation may land while listeners wind down
            ("firewall_queue", lambda: self.firewall and self.firewall.close()),
            ("admin", lambda: s.admin and s.admin.stop()),
            ("agent_service", lambda: s.agent_service and s.agent_service.stop()),
            ("watcher", lambda: s.watcher and s.watcher.stop()),
            ("dialer", lambda: s.dialer and s.dialer.stop()),
            # drain-to-zero (no agents left): tear the data plane down and
            # flush maps; on any other exit the pinned maps keep enforcing
            # the last rule set (fail-closed)
            # netlogger stops BEFORE teardown: teardown flushes the maps
            # (events ring included), so the final drain must land first
            ("netlogger", lambda: self.netlogger and self.netlogger.stop()),
            ("firewall_teardown",
             lambda: self.firewall and self._drained_to_zero
             and self.firewall.teardown()),
            ("feeder", lambda: s.feeder and s.feeder.stop()),
            ("registry", lambda: s.registry and s.registry.close()),
        ):
            try:
                fn()
            except Exception as e:
                log.warning("drain: %s stop failed: %s", name, e)
        if self._healthz is not None:
            self._healthz.shutdown()
            self._healthz.server_close()
        if self._healthz_thread is not None:
            self._healthz_thread.join(2.0)
        log.info("drain: complete")

    def run_forever(self) -> int:
        """Start, serve until SIGTERM/SIGINT (or drain-to-zero), drain."""
        signal.signal(signal.SIGTERM, lambda *_: self.request_stop())
        signal.signal(signal.SIGINT, lambda *_: self.request_stop())
        self.start()
        self.wait()
        self.drain()
        return 0
