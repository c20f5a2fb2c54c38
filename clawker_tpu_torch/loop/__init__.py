"""Autonomous-loop scheduler: ``clawker loop --parallel N``.

The port's copy of ``clawker_tpu/loop``: the scheduler for the
in-process run, its write-ahead journal, the per-worker warm pool its
placements adopt from (``warmpool``), and the merge queue that lands a
worktree swarm's agent branches (``mergeq``).
"""

from .journal import RunImage, RunJournal, journal_path, replay
from .mergeq import MergeQueue
from .scheduler import AgentLoop, LaneRegistry, LoopScheduler, LoopSpec
from .warmpool import POOL_TENANT, PoolEntry, WarmPool

__all__ = ["AgentLoop", "LaneRegistry", "LoopScheduler", "LoopSpec",
           "MergeQueue", "POOL_TENANT", "PoolEntry", "WarmPool",
           "RunImage", "RunJournal", "journal_path", "replay"]
