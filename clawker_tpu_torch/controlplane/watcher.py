"""AgentWatcher: periodic daemon polls + drain-to-zero self-shutdown.

Parity reference: controlplane/agent/watcher.go -- 30s polls of managed
agent containers, a ``ListErrCeiling`` bound on how long the CP tolerates a
wedged daemon blinding it, and drain-to-zero: when no agent containers
remain for a full grace window the CP triggers its own drain sequence
(the CP container has no reason to outlive its last agent).

The port's copy of ``clawker_tpu/controlplane/watcher.py``, whole.
"""

from __future__ import annotations

import threading
from typing import Callable

from .. import consts, logsetup

log = logsetup.get("cp.watcher")

LIST_ERR_CEILING = 5


class AgentWatcher:
    def __init__(
        self,
        engine,
        *,
        interval_s: float = 30.0,
        drain_grace_polls: int = 2,
        on_drained: Callable[[], None] | None = None,
        on_blind: Callable[[], None] | None = None,
    ):
        self.engine = engine
        self.interval_s = interval_s
        self.drain_grace_polls = drain_grace_polls
        self.on_drained = on_drained
        self.on_blind = on_blind
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.polls = 0
        self.consecutive_errors = 0
        self.last_count = -1
        self._zero_streak = 0
        # drain-to-zero only arms after at least one agent has been seen:
        # a CP brought up ahead of a slow image pull must not self-terminate
        # before its first agent ever starts
        self._armed = False

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="agentwatcher", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def poll_once(self) -> int:
        """One poll; returns live agent count (or -1 on list failure)."""
        self.polls += 1
        try:
            containers = self.engine.list_containers(
                filters={"label": [f"{consts.LABEL_ROLE}=agent"]}
            )
        except Exception as e:
            self.consecutive_errors += 1
            log.warning(
                "agent list failed (%d/%d): %s",
                self.consecutive_errors, LIST_ERR_CEILING, e,
            )
            if self.consecutive_errors >= LIST_ERR_CEILING and self.on_blind:
                self.on_blind()
            return -1
        self.consecutive_errors = 0
        count = len(containers)
        self.last_count = count
        if count == 0:
            self._zero_streak += 1
            if self._armed and self._zero_streak >= self.drain_grace_polls and self.on_drained:
                log.info("drain-to-zero: no agents for %d polls", self._zero_streak)
                self.on_drained()
        else:
            self._armed = True
            self._zero_streak = 0
        return count

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:
                log.error("watcher poll crashed: %s", e)
            self._stop.wait(self.interval_s)
