"""In-process typed pub/sub bus for control-plane subsystems.

Parity reference: controlplane/pubsub (SURVEY.md 2.7) -- generic
``Topic[T]``/``Event[T]`` with non-blocking publish, per-subscriber bounded
buffer with drop-oldest overflow, and panic-recovered delivery; zero domain
knowledge.  The Python build keeps the same contract with a lock +
per-subscription deque: ``publish`` never blocks and never raises, slow
subscribers lose their *oldest* events first (and the loss is counted), and
a subscriber that dies mid-iteration never poisons the topic.

The port's copy of ``clawker_tpu/controlplane/pubsub.py``, whole.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Generic, Iterator, TypeVar

T = TypeVar("T")

DEFAULT_BUFFER = 256


@dataclass
class Event(Generic[T]):
    """One published event: payload + publish-time metadata."""

    payload: T
    seq: int = 0
    ts: float = field(default_factory=time.time)


class Subscription(Generic[T]):
    """A bounded mailbox attached to a topic.

    Iterate to consume (blocks until an event or :meth:`close`); ``dropped``
    counts events lost to overflow.  Closing is idempotent and detaches from
    the topic.
    """

    def __init__(self, topic: "Topic[T]", name: str, buffer: int):
        self._topic = topic
        self.name = name
        self._buf: deque[Event[T]] = deque(maxlen=max(1, buffer))
        self._cond = threading.Condition()
        self._closed = False
        self.dropped = 0

    # Called by the topic with its own lock held only briefly; never blocks.
    def _offer(self, ev: Event[T]) -> None:
        with self._cond:
            if self._closed:
                return
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(ev)
            self._cond.notify()

    def get(self, timeout: float | None = None) -> Event[T] | None:
        """Next event, or None on close/timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._buf:
                if self._closed:
                    return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._buf.popleft()

    def __iter__(self) -> Iterator[Event[T]]:
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._topic._detach(self)

    @property
    def closed(self) -> bool:
        return self._closed


class Topic(Generic[T]):
    """Typed broadcast topic.

    ``publish`` fans out to every live subscription without blocking or
    raising; a full mailbox drops its oldest event (slow consumers degrade
    themselves, never the publisher -- the CP resilience contract).
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._subs: list[Subscription[T]] = []
        self._seq = 0
        self._closed = False

    def publish(self, payload: T) -> None:
        # Fan-out happens under the topic lock so concurrent publishers
        # cannot interleave out of seq order in a mailbox; _offer never
        # blocks (bounded deque, drop-oldest), so the lock hold is O(subs).
        with self._lock:
            if self._closed:
                return
            self._seq += 1
            ev = Event(payload=payload, seq=self._seq)
            for sub in self._subs:
                try:
                    sub._offer(ev)
                except Exception:  # delivery must never take down the publisher
                    pass

    def subscribe(self, name: str = "", *, buffer: int = DEFAULT_BUFFER) -> Subscription[T]:
        sub = Subscription(self, name or f"{self.name}-sub", buffer)
        with self._lock:
            if self._closed:
                sub._closed = True
                return sub
            self._subs.append(sub)
        return sub

    def _detach(self, sub: Subscription[T]) -> None:
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def close(self) -> None:
        """Close the topic and every subscription (drain shutdown step)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            subs = list(self._subs)
            self._subs.clear()
        for sub in subs:
            with sub._cond:
                sub._closed = True
                sub._cond.notify_all()


def run_subscriber(
    sub: Subscription[T], handler, *, name: str = "", daemon: bool = True
) -> threading.Thread:
    """Spawn a recovered delivery thread: handler exceptions are logged and
    swallowed per-event (reference: pubsub panic-recovered delivery)."""
    from .. import logsetup

    log = logsetup.get("cp.pubsub")

    def loop() -> None:
        for ev in sub:
            try:
                handler(ev)
            except Exception:
                log.exception("subscriber %s: handler error (event dropped)", sub.name)

    t = threading.Thread(target=loop, name=name or f"sub-{sub.name}", daemon=daemon)
    t.start()
    return t
