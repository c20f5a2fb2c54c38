"""Cross-process distributed tracing (docs/tracing.md).

The port's copy of ``clawker_tpu/tracing``, in part:

- :mod:`~clawker_tpu_torch.tracing.context` -- the W3C-traceparent-style
  :class:`TraceContext` carried as frame fields (loopd's ``tp``) and the
  thread's ambient context;
- :mod:`~clawker_tpu_torch.tracing.skew` -- per-channel clock-skew
  estimation, chained hop by hop into ``clock_offset_s`` / ``skew_s``;
- :mod:`~clawker_tpu_torch.tracing.names` -- the span-name catalogue.

``merge`` (the router / loopd / workerd / scheduler flight records
joined into one causal tree) waits for workerd and federation
(ROADMAP §1 items 4 and 13), the two hops it joins beyond loopd.
"""

from __future__ import annotations

from .context import TraceContext, current, use
from .skew import ChannelClock

__all__ = ["TraceContext", "current", "use", "ChannelClock"]
