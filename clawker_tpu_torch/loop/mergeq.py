"""Merge queue: serial branch-per-agent landings for worktree swarms.

The port's copy of ``clawker_tpu/loop/mergeq.py``, whole.

At iteration end every agent's branch holds that iteration's work.  The
queue lands them ONE AT A TIME onto the run's integration branch
(``gitx.GitManager.merge_into``) -- serializing is what turns N
concurrent agents on one repo into a linear history instead of a merge
storm.  A landing that conflicts is not dropped: the losing entry is
resubmitted with a backoff (the scheduler feeds the admission
controller's ``retry_after_s`` in as the delay, so merge retries queue
behind real launches under pressure -- docs/loop-worktrees.md#merge-queue)
until ``max_attempts`` is exhausted, at which point it lands in
``report.failed`` for the operator.

Pure bookkeeping + git: no engine calls, no threads -- the scheduler
drives :meth:`MergeQueue.drain` from its run thread under ``_git_lock``,
the same lock every worktree provision takes, so the repo never sees a
merge race a ``worktree add``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..gitx.git import GitManager, MergeConflict


@dataclass
class MergeEntry:
    """One branch waiting to land."""

    agent: str
    branch: str
    attempts: int = 0
    not_before: float = 0.0     # monotonic clock gate (conflict backoff)


@dataclass
class MergeReport:
    """What one drain pass accomplished."""

    landed: list[tuple[str, str]] = field(default_factory=list)
    #                             (agent, outcome) -- outcome is the
    #                             merge_into verdict: clean | ff | merged
    resubmitted: list[str] = field(default_factory=list)
    #                             agents whose landing conflicted and
    #                             went back into the queue with backoff
    failed: list[str] = field(default_factory=list)
    #                             agents that exhausted max_attempts
    deferred: list[str] = field(default_factory=list)
    #                             agents still inside their backoff
    #                             window (not attempted this pass)


class MergeQueue:
    """FIFO of agent branches; conflict losers re-queue with backoff."""

    def __init__(self, *, retry_s: float = 0.5, max_attempts: int = 3,
                 clock=time.monotonic):
        self.retry_s = float(retry_s)
        self.max_attempts = max(1, int(max_attempts))
        self._clock = clock
        self._entries: list[MergeEntry] = []

    def submit(self, agent: str, branch: str, *, delay_s: float = 0.0) -> None:
        """Enqueue (or re-enqueue) one agent's branch.  A resubmit for an
        agent already queued replaces the stale entry -- the branch tip
        is what lands, so two entries would merge the same tip twice."""
        not_before = self._clock() + max(0.0, float(delay_s))
        for e in self._entries:
            if e.agent == agent:
                e.branch = branch
                e.not_before = not_before
                return
        self._entries.append(MergeEntry(agent=agent, branch=branch,
                                        not_before=not_before))

    def pending(self) -> list[str]:
        return [e.agent for e in self._entries]

    def drain(self, gm: GitManager, target: str, *,
              retry_delay=None, message_for=None) -> MergeReport:
        """Land every due entry serially; conflicts resubmit with backoff.

        ``retry_delay()`` supplies the conflict backoff (the scheduler
        passes the admission controller's ``retry_after_s`` here);
        falls back to the queue's own ``retry_s``.  Entries still inside
        their backoff window stay queued and are reported ``deferred``
        so the caller knows another pass is needed."""
        report = MergeReport()
        now = self._clock()
        due = [e for e in self._entries if e.not_before <= now]
        for entry in due:
            try:
                outcome = gm.merge_into(
                    target, entry.branch,
                    message=(message_for(entry.agent) if message_for
                             else f"land {entry.branch}"))
            except MergeConflict:
                entry.attempts += 1
                if entry.attempts >= self.max_attempts:
                    self._entries.remove(entry)
                    report.failed.append(entry.agent)
                    continue
                delay = (retry_delay() if retry_delay is not None
                         else self.retry_s)
                entry.not_before = self._clock() + max(0.0, float(delay))
                report.resubmitted.append(entry.agent)
                continue
            self._entries.remove(entry)
            report.landed.append((entry.agent, outcome))
        report.deferred = [e.agent for e in self._entries
                           if e.agent not in report.resubmitted
                           and e.agent not in report.failed]
        return report
