"""Reconnecting daemon-event feeder -> typed topic + container state repo.

Parity reference: controlplane/dockerevents (SURVEY.md 2.7) -- a
reconnecting ``Feeder`` turns the Docker events stream into a typed
``DockerEvent`` topic, and a container state repo reconciles against
``container_list`` on every (re)connect so subscribers observing through a
disconnect converge to daemon truth instead of missing transitions.

The port's copy of ``clawker_tpu/controlplane/dockerevents.py``, whole.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .. import consts, logsetup
from .pubsub import Topic

log = logsetup.get("cp.dockerevents")

# Daemon actions worth broadcasting; everything else is noise for the CP.
_CONTAINER_ACTIONS = {
    "create", "start", "die", "stop", "kill", "destroy", "pause", "unpause",
    "rename", "restart", "oom", "health_status",
}


@dataclass
class DockerEvent:
    """One normalized daemon event for a managed container."""

    action: str
    container_id: str
    name: str = ""
    project: str = ""
    agent: str = ""
    role: str = ""
    exit_code: int | None = None
    ts: float = field(default_factory=time.time)
    attributes: dict = field(default_factory=dict)

    @property
    def full_name(self) -> str:
        return f"{self.project}.{self.agent}" if self.project else self.name


def _normalize(raw: dict) -> DockerEvent | None:
    if raw.get("Type") != "container":
        return None
    action = str(raw.get("Action", ""))
    # health_status events arrive as "health_status: healthy"
    base_action = action.split(":", 1)[0].strip()
    if base_action not in _CONTAINER_ACTIONS:
        return None
    actor = raw.get("Actor") or {}
    attrs = dict(actor.get("Attributes") or {})
    ev = DockerEvent(
        action=base_action,
        container_id=str(actor.get("ID") or raw.get("id") or ""),
        name=attrs.get("name", ""),
        project=attrs.get(consts.LABEL_PROJECT, ""),
        agent=attrs.get(consts.LABEL_AGENT, ""),
        role=attrs.get(consts.LABEL_ROLE, ""),
        attributes=attrs,
    )
    if "exitCode" in attrs:
        try:
            ev.exit_code = int(attrs["exitCode"])
        except ValueError:
            pass
    if raw.get("time"):
        ev.ts = float(raw["time"])
    return ev


@dataclass
class ContainerState:
    """Last known state of one managed container."""

    container_id: str
    name: str
    project: str
    agent: str
    role: str
    running: bool
    labels: dict = field(default_factory=dict)


class ContainerStateRepo:
    """Event-driven mirror of managed-container state, reconciled on connect."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_id: dict[str, ContainerState] = {}

    def reconcile(self, summaries: list[dict]) -> None:
        with self._lock:
            self._by_id.clear()
            for s in summaries:
                labels = s.get("Labels") or {}
                names = s.get("Names") or [""]
                name = names[0].lstrip("/")
                self._by_id[s["Id"]] = ContainerState(
                    container_id=s["Id"],
                    name=name,
                    project=labels.get(consts.LABEL_PROJECT, ""),
                    agent=labels.get(consts.LABEL_AGENT, ""),
                    role=labels.get(consts.LABEL_ROLE, ""),
                    running=s.get("State") == "running",
                    labels=labels,
                )

    def apply(self, ev: DockerEvent) -> None:
        with self._lock:
            if ev.action == "destroy":
                self._by_id.pop(ev.container_id, None)
                return
            st = self._by_id.get(ev.container_id)
            if st is None:
                st = ContainerState(
                    container_id=ev.container_id,
                    name=ev.name,
                    project=ev.project,
                    agent=ev.agent,
                    role=ev.role,
                    running=False,
                    labels=dict(ev.attributes),
                )
                self._by_id[ev.container_id] = st
            if ev.action in ("start", "restart", "unpause"):
                st.running = True
            elif ev.action in ("die", "stop", "kill", "pause", "oom"):
                st.running = False
            if ev.action == "rename" and ev.name:
                st.name = ev.name

    def running(self) -> list[ContainerState]:
        with self._lock:
            return [s for s in self._by_id.values() if s.running]

    def get(self, container_id: str) -> ContainerState | None:
        with self._lock:
            return self._by_id.get(container_id)

    def all(self) -> list[ContainerState]:
        with self._lock:
            return list(self._by_id.values())


class Feeder:
    """Streams daemon events into a topic, reconnecting with backoff.

    On every (re)connect the state repo is reconciled from a full
    ``container_list`` before events flow, closing the blind window
    (reference: dockerevents reconcile-on-reconnect).
    """

    def __init__(
        self,
        engine,
        topic: Topic[DockerEvent],
        repo: ContainerStateRepo | None = None,
        *,
        backoff_s: float = 1.0,
        max_backoff_s: float = 30.0,
    ):
        self.engine = engine
        self.topic = topic
        self.repo = repo or ContainerStateRepo()
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.reconnects = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="dockerevents", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        # The events iterator may be blocked on the daemon; fakes unblock on
        # close, HTTP streams unblock on socket close via engine.close hooks.
        closer = getattr(self.engine.api, "close_events", None)
        if closer:
            closer()
        if self._thread is not None:
            self._thread.join(timeout)

    def _run(self) -> None:
        delay = self.backoff_s
        while not self._stop.is_set():
            try:
                # Subscribe first so events raised during the reconcile list
                # are buffered, not lost: no blind window between snapshot
                # and stream.
                stream = self.engine.events()
                self.repo.reconcile(self.engine.list_containers(all=True))
                delay = self.backoff_s  # healthy connect resets backoff
                for raw in stream:
                    if self._stop.is_set():
                        return
                    ev = _normalize(raw)
                    if ev is None:
                        continue
                    self.repo.apply(ev)
                    self.topic.publish(ev)
            except Exception as e:
                if self._stop.is_set():
                    return
                log.warning("event stream lost (%s); reconnecting in %.1fs", e, delay)
            if self._stop.is_set():
                return
            self.reconnects += 1
            self._stop.wait(delay)
            delay = min(delay * 2, self.max_backoff_s)
