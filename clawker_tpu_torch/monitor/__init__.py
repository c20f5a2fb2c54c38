"""Observability stack: compose-rendered OTel/OpenSearch/Prometheus +
the kernel egress netlogger.

The port's copy of ``clawker_tpu/monitor/__init__.py``, whole.

Parity reference: internal/monitor (compose stack templates, monitoring
units, ledger -- SURVEY.md 2.11) and controlplane/firewall/ebpf/netlogger
(events ringbuf -> log records).
"""

from .events import EventBus, EventRecord

__all__ = ["EventBus", "EventRecord"]
