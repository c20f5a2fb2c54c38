"""ActionQueue: every firewall mutation runs on one serialized thread.

The port's copy of ``clawker_tpu/firewall/queue.py``, whole.

Concurrent admin calls (Enable from two container starts, a Reload racing
an AddRules) would otherwise interleave stack restarts, map writes and
config regeneration.  The queue is the whole concurrency story: handlers
submit closures, FIFO order is execution order, and callers block on the
result so admin RPCs stay synchronous.

Parity reference: controlplane/firewall/queue.go (single-goroutine FIFO
through which Handler serializes all mutations).
"""

from __future__ import annotations

import queue as _queue
import threading
from concurrent.futures import Future
from typing import Callable, TypeVar

from ..errors import ClawkerError

T = TypeVar("T")


class QueueClosed(ClawkerError):
    pass


class ActionQueue:
    def __init__(self, name: str = "firewall"):
        self._q: _queue.Queue = _queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-actions", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # delivered to the caller, queue survives
                fut.set_exception(e)

    def submit(self, fn: Callable[[], T]) -> "Future[T]":
        if self._closed.is_set():
            raise QueueClosed("firewall action queue is closed (draining)")
        fut: Future = Future()
        self._q.put((fut, fn))
        return fut

    def run(self, fn: Callable[[], T], timeout: float = 120.0) -> T:
        """Submit and wait -- the synchronous path admin handlers use."""
        return self.submit(fn).result(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain what's queued (drain ordering:
        queue close happens FIRST in the CP drain sequence)."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._q.put(None)
        self._thread.join(timeout)
