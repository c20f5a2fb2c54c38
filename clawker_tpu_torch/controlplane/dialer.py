"""CP agent dialer: container-start events -> mTLS session -> plans.

Parity reference: controlplane/agent/dialer.go -- the CP dials each agent
container's agentd outbound (DialAgent :211, retry/backoff :703-829),
reconciles on boot with DialAllRunning, and drives the session:
Hello -> [unregistered] RegisterRequired -> InitPlan (skipped when the
Hello carries Initialized) -> AgentInitialized -> BootPlan -> AgentReady
(skipped when CmdRunning).  Plans and registry state are updated as the
flow progresses so reconnects are idempotent.

The port's copy of ``clawker_tpu/controlplane/dialer.py``, whole.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from .. import consts, logsetup
from ..errors import ClawkerError
from .dockerevents import ContainerStateRepo, DockerEvent
from .executor import AgentProfile, Executor, boot_plan, init_plan
from .pubsub import Topic
from .registry import Registry
from .session_client import SessionError, dial_with_retry

log = logsetup.get("cp.dialer")

# (host, port) agentd endpoint for a container id
EndpointResolver = Callable[[str], tuple[str, int]]
ProfileBuilder = Callable[[str], AgentProfile]


def engine_endpoint_resolver(engine) -> EndpointResolver:
    """Default resolver: the container's bridge IP from daemon inspect."""

    def resolve(container_id: str) -> tuple[str, int]:
        info = engine.inspect_container(container_id)
        net = info.get("NetworkSettings") or {}
        ip = net.get("IPAddress") or ""
        if not ip:
            for settings in (net.get("Networks") or {}).values():
                ip = settings.get("IPAddress") or ""
                if ip:
                    break
        if not ip:
            raise ClawkerError(f"container {container_id[:12]}: no IP address")
        return ip, consts.AGENTD_PORT

    return resolve


def engine_profile_builder(engine) -> ProfileBuilder:
    """Default profile builder from container inspect: labels, user, cmd."""

    def build(container_id: str) -> AgentProfile:
        info = engine.inspect_container(container_id)
        cfg = info.get("Config") or {}
        labels = cfg.get("Labels") or {}
        user = str(cfg.get("User") or "")
        uid = gid = 0
        if user:
            parts = user.split(":")
            try:
                uid = int(parts[0])
                gid = int(parts[1]) if len(parts) > 1 else uid
            except ValueError:
                pass  # named user: agentd resolves at spawn; plans run as root
        mounts = info.get("Mounts") or []
        docker_socket = any(m.get("Destination") == "/var/run/docker.sock" for m in mounts)
        return AgentProfile(
            project=labels.get(consts.LABEL_PROJECT, ""),
            agent=labels.get(consts.LABEL_AGENT, ""),
            uid=uid,
            gid=gid,
            workdir=cfg.get("WorkingDir") or consts.WORKSPACE_DIR,
            cmd=list(cfg.get("Cmd") or []),
            env={},
            docker_socket=docker_socket,
        )

    return build


@dataclass
class DialerConfig:
    cert_file: Path                 # CP client identity for the agentd session
    key_file: Path
    ca_file: Path
    cp_host: str = ""               # where agentd should Register back to
    cp_agent_port: int = consts.CP_AGENT_PORT
    dial_deadline_s: float = 30.0


class Dialer:
    """Watches container starts and drives each agent's session to ready."""

    def __init__(
        self,
        cfg: DialerConfig,
        registry: Registry,
        resolve: EndpointResolver,
        build_profile: ProfileBuilder,
    ):
        self.cfg = cfg
        self.registry = registry
        self.resolve = resolve
        self.build_profile = build_profile
        self._stop = threading.Event()
        self._consumer: threading.Thread | None = None
        self._workers: dict[str, threading.Thread] = {}   # live dials only
        self._inflight: set[str] = set()
        self._lock = threading.Lock()
        # observable results for tests/status: full_name -> outcome string
        self.outcomes: dict[str, str] = {}

    # ------------------------------------------------------------ lifecycle

    def start(self, topic: Topic[DockerEvent], repo: ContainerStateRepo) -> None:
        """Subscribe to start events and reconcile already-running agents."""
        sub = topic.subscribe("dialer")
        self._consumer = threading.Thread(
            target=self._consume, args=(sub,), name="dialer-events", daemon=True
        )
        self._consumer.start()
        for state in repo.running():
            if state.role == "agent":
                self._spawn_drive(state.container_id)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._lock:
            workers = list(self._workers.values())
        for t in workers:
            t.join(timeout)
        if self._consumer is not None:
            self._consumer.join(timeout)

    def _consume(self, sub) -> None:
        for ev in sub:
            if self._stop.is_set():
                return
            payload: DockerEvent = ev.payload
            if payload.action == "start" and payload.role == "agent":
                self._spawn_drive(payload.container_id)

    def _spawn_drive(self, container_id: str) -> None:
        t = threading.Thread(
            target=self._drive_recovered, args=(container_id,),
            name=f"dial-{container_id[:12]}", daemon=True,
        )
        with self._lock:
            if container_id in self._inflight:
                return
            self._inflight.add(container_id)
            self._workers[container_id] = t
        t.start()

    def _drive_recovered(self, container_id: str) -> None:
        # every dial worker is exception-recovered: a bad agent container
        # must never take the CP down (reference: "CP crashing is a SECURITY
        # incident", root CLAUDE.md; recoverGoroutine discipline)
        try:
            self.drive(container_id)
        except Exception as e:
            log.error("dial %s failed: %s", container_id[:12], e)
        finally:
            with self._lock:
                self._inflight.discard(container_id)
                self._workers.pop(container_id, None)

    # ------------------------------------------------------------ the flow

    def drive(self, container_id: str) -> str:
        """Run one container's session flow to ready; returns outcome."""
        profile = self.build_profile(container_id)
        full = profile.full_name
        if not profile.project:
            self.outcomes[container_id] = "unmanaged"
            return "unmanaged"
        host, port = self.resolve(container_id)
        record = self.registry.get(full)
        session = dial_with_retry(
            host,
            port,
            cert_file=self.cfg.cert_file,
            key_file=self.cfg.key_file,
            ca_file=self.cfg.ca_file,
            deadline_s=self.cfg.dial_deadline_s,
        )
        try:
            outcome = self._run_session(session, profile, record)
        except SessionError as e:
            self.registry.set_state(full, "error")
            self.outcomes[full] = f"error: {e}"
            raise
        finally:
            session.close()
        self.outcomes[full] = outcome
        return outcome

    def _run_session(self, session, profile: AgentProfile, record) -> str:
        full = profile.full_name
        hello = session.hello()
        registered = bool(record and record.registered_at)
        if not registered and self.cfg.cp_host:
            session.register_required(self.cfg.cp_host, self.cfg.cp_agent_port)
            log.info("agent %s registered", full)
        initialized = hello.initialized or bool(record and record.initialized)
        executor = Executor(session, full_name=full)
        if not initialized:
            res = executor.run_plan("init", init_plan(profile))
            if not res.ok:
                self.registry.set_state(full, "init-failed")
                return f"init-failed:{res.aborted_at}"
            session.agent_initialized()
            self.registry.mark_initialized(full)
            log.info("agent %s initialized", full)
        if not hello.cmd_running:
            res = executor.run_plan("boot", boot_plan(profile))
            if not res.ok:
                self.registry.set_state(full, "boot-failed")
                return f"boot-failed:{res.aborted_at}"
            pid = session.agent_ready(
                profile.cmd, uid=profile.uid, gid=profile.gid,
                env=profile.env, cwd=profile.workdir,
            )
            log.info("agent %s ready (pid %d)", full, pid)
        self.registry.set_state(full, "ready")
        return "ready"
