"""Per-channel clock-skew estimation from round-trips we already pay.

Every daemon channel in the system performs round-trips as part of its
ordinary life -- the workerd hello handshake, loopd hello/ping, the
federation router's lease RPCs.  Each reply now carries the server's
wall clock (``ts``), which turns every such round-trip into one NTP-ish
offset sample for free::

    offset ~= server_ts - (t0 + t1) / 2

where t0/t1 are the client's send/receive times.  The midpoint model
assumes a symmetric path; asymmetry error is bounded by rtt/2, so the
estimator also tracks the smallest rtt seen (best sample quality) and
smooths the offset with an EWMA rather than trusting any single
round-trip (docs/tracing.md#clock-skew).

Offsets CHAIN: the router estimates loopd's offset, loopd estimates
workerd's, and each hop hands its *cumulative* offset downstream as a
frame field (``clock_offset_s``) on messages already being sent.  A
daemon stamps every span it records with ``skew_s`` = its cumulative
offset to the root clock, so the merge layer converts remote times with
one auditable subtraction -- the raw server timestamps stay in the
record, only the rendering shifts.

The port's copy of ``clawker_tpu/tracing/skew.py``, whole.
"""

from __future__ import annotations

import threading

DEFAULT_ALPHA = 0.25        # EWMA weight for new offset samples


class ChannelClock:
    """One channel's skew estimator: feed it (t0, server_ts, t1)
    samples, read ``offset_s`` (server clock minus client clock) and
    ``cumulative(upstream)`` (server clock minus ROOT clock, given the
    client's own offset to the root).  Thread-safe: the sampling side
    (connect/ping paths) and the reading side (span emission) race."""

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        self.alpha = alpha
        self._lock = threading.Lock()
        self.offset_s = 0.0
        self.rtt_s = 0.0            # smallest round-trip observed
        self.samples = 0

    def observe(self, t0: float, server_ts: float, t1: float) -> float:
        """One round-trip sample -> updated EWMA offset estimate.
        Degenerate samples (t1 < t0, zero server ts) are ignored --
        a channel must never un-learn its estimate off a bad frame."""
        if server_ts <= 0.0 or t1 < t0:
            return self.offset_s
        raw = server_ts - (t0 + t1) / 2.0
        rtt = t1 - t0
        with self._lock:
            if self.samples == 0:
                self.offset_s = raw
                self.rtt_s = rtt
            else:
                self.offset_s += self.alpha * (raw - self.offset_s)
                self.rtt_s = min(self.rtt_s, rtt)
            self.samples += 1
            return self.offset_s

    def cumulative(self, upstream_offset_s: float = 0.0) -> float:
        """Server-to-ROOT offset: the client's own offset to the root
        (0.0 when the client IS the root/viewer) plus this channel's
        estimate.  This is the value handed downstream as
        ``clock_offset_s`` and stamped on spans as ``skew_s``."""
        with self._lock:
            return upstream_offset_s + self.offset_s

    def stats(self) -> dict:
        with self._lock:
            return {"offset_s": round(self.offset_s, 6),
                    "rtt_s": round(self.rtt_s, 6),
                    "samples": self.samples}
