"""Autonomous-loop scheduler: ``clawker loop --parallel N``.

The port's copy of ``clawker_tpu/loop``: the scheduler for the
in-process run, its write-ahead journal, and the per-worker warm pool
its placements adopt from (``warmpool``).  The merge queue
(``mergeq``) is not ported yet (ROADMAP §1 item 6).
"""

from .journal import RunImage, RunJournal, journal_path, replay
from .scheduler import AgentLoop, LaneRegistry, LoopScheduler, LoopSpec
from .warmpool import POOL_TENANT, PoolEntry, WarmPool

__all__ = ["AgentLoop", "LaneRegistry", "LoopScheduler", "LoopSpec",
           "POOL_TENANT", "PoolEntry", "WarmPool",
           "RunImage", "RunJournal", "journal_path", "replay"]
