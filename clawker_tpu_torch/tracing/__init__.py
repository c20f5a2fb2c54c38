"""Cross-process distributed tracing (docs/tracing.md).

The port's copy of ``clawker_tpu/tracing``:

- :mod:`~clawker_tpu_torch.tracing.context` -- the W3C-traceparent-style
  :class:`TraceContext` carried as frame fields (loopd's ``tp``,
  workerd's intents) and the thread's ambient context;
- :mod:`~clawker_tpu_torch.tracing.skew` -- per-channel clock-skew
  estimation, chained hop by hop into ``clock_offset_s`` / ``skew_s``;
- :mod:`~clawker_tpu_torch.tracing.merge` -- joins the router / loopd /
  workerd / scheduler flight recorders into one causal tree per
  iteration, a dead daemon's segment rendered as a ``gap`` span (the
  router's hop has no producer until federation, ROADMAP §1 item 13;
  its reader is here whole);
- :mod:`~clawker_tpu_torch.tracing.names` -- the span-name catalogue.
"""

from __future__ import annotations

from .context import TraceContext, current, use
from .merge import MergeResult, merge_records, merge_run
from .skew import ChannelClock

__all__ = [
    "TraceContext", "current", "use",
    "ChannelClock",
    "MergeResult", "merge_records", "merge_run",
]
