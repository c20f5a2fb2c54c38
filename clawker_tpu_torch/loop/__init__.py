"""Autonomous-loop scheduler: ``clawker loop --parallel N``.

The port's copy of ``clawker_tpu/loop``: the scheduler for the
in-process run and its write-ahead journal.  The warm pool
(``warmpool``) and the merge queue (``mergeq``) are not ported yet
(ROADMAP §1).
"""

from .journal import RunImage, RunJournal, journal_path, replay
from .scheduler import AgentLoop, LaneRegistry, LoopScheduler, LoopSpec

__all__ = ["AgentLoop", "LaneRegistry", "LoopScheduler", "LoopSpec",
           "RunImage", "RunJournal", "journal_path", "replay"]
