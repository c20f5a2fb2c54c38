"""Named crash seams: the enumerable registry behind CLI-SIGKILL chaos.

The resume test suite used to reach its kill points by wrapping
scheduler internals ad hoc; every new crash test invented its own
monkeypatch.  The scheduler now FIRES a named seam at each journaled
state transition boundary (``self.seams.fire("launch.post_create")``)
and anything -- the chaos runner, a test, ``loop --chaos-plan`` -- arms
a hook on that name.  Un-armed seams cost one attribute read plus a
falsy check, so the registry stays on by default.

A hook that wants to simulate SIGKILL at its seam calls
``scheduler.kill()`` and raises :class:`SeamAbort`: kill() freezes all
scheduler bookkeeping the way process death would, and the raise aborts
the in-flight code path mid-operation -- the instruction pointer stops
exactly where SIGKILL would have stopped it.  ``SeamAbort`` derives
from ``BaseException`` on purpose: the scheduler's own error handling
(strand/fail accounting) must NOT observe it, because a killed process
does no accounting.

The port's copy of ``clawker_tpu/chaos/seams.py``, whole.
"""

from __future__ import annotations

import threading
from typing import Callable

# every seam the scheduler fires, in rough lifecycle order.  Adding a
# fire site means adding its name here: the chaos plan generator and
# `clawker chaos plan` enumerate this tuple.
SEAM_NAMES = (
    "run.post_placement",       # run header + placements journaled, no
    #                             launch submitted yet
    "launch.pre_create",        # placement WAL durable; engine create next
    "launch.post_create",       # engine returned a cid; REC_CREATED durable
    "launch.pre_start",         # container exists; engine start next
    "launch.post_start",        # REC_STARTED journaled, iteration running
    "iteration.post_exit",      # REC_EXITED journaled for an iteration
    "resume.pre_reconcile",     # resume generation built, nothing adopted
    "resume.post_adopt",        # one container adopted in place
    "pool.post_fill",           # a warm-pool member created (REC_POOL_READY)
    # loopd transition boundaries (docs/loopd.md): the daemon fires
    # these around run registration so daemon crashes are soak-testable
    # exactly like CLI crashes -- a kill here leaves a journaled run
    # whose submitting client may or may not have seen the ack
    "loopd.post_submit",        # run registered in the daemon's table,
    #                             ack NOT yet sent to the client
    "loopd.post_ack",           # ack sent; scheduler start + streaming
    #                             not begun
    # workerd data-plane boundaries (docs/workerd.md): an intent is
    # about to leave the scheduler for the worker-resident daemon, and
    # a partitioned channel has just re-synced -- the two places a
    # crash interleaves with remote execution
    "workerd.pre_dispatch",     # placement WAL durable; intent about to
    #                             enter the channel send queue
    "workerd.post_reconnect",   # channel healed + resync done; buffered
    #                             events about to replay
)


class SeamAbort(BaseException):
    """Raised by a crash hook to stop the in-flight path like SIGKILL
    would.  BaseException: must never be absorbed by ClawkerError /
    Exception handlers that would account the 'failure'."""


class SeamRegistry:
    """Arm/fire named crash seams.  Thread-safe; hooks fire at most once
    per arm (one SIGKILL per arm) unless re-armed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, Callable[[], None]] = {}
        self.fired: list[str] = []      # fire log, in order (tests/report)

    def arm(self, name: str, hook: Callable[[], None]) -> None:
        if name not in SEAM_NAMES:
            raise ValueError(
                f"unknown crash seam {name!r} (known: {', '.join(SEAM_NAMES)})")
        with self._lock:
            self._armed[name] = hook

    def disarm(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._armed.clear()
            else:
                self._armed.pop(name, None)

    def armed(self) -> list[str]:
        with self._lock:
            return sorted(self._armed)

    def fire(self, name: str) -> None:
        """Run (and consume) the hook armed on ``name``, if any.  The
        hook may raise :class:`SeamAbort`; anything else it raises
        propagates too -- a crash hook is test machinery, not a place
        to swallow bugs."""
        with self._lock:
            hook = self._armed.pop(name, None)
            if hook is not None:
                self.fired.append(name)
        if hook is not None:
            hook()


class _NullSeams:
    """The default, never-armed registry: fire() is one falsy check."""

    __slots__ = ()
    fired: list = []

    def arm(self, name: str, hook) -> None:
        raise RuntimeError(
            "cannot arm the shared null seam registry; construct the "
            "scheduler with seams=SeamRegistry()")

    def disarm(self, name: str | None = None) -> None:
        pass

    def armed(self) -> list:
        return []

    def fire(self, name: str) -> None:
        pass


NULL_SEAMS = _NullSeams()
