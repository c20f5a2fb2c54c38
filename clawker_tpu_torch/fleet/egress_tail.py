"""Where a worker's egress stream lives on the worker.

A copy of ``REMOTE_EGRESS_LOG`` from ``clawker_tpu/fleet/egress_tail.py``:
the sentinel's collector tails it over a worker's SSH mux.
"""

# Worker-side egress log location: the per-worker CP (systemd unit,
# fleet/provision.py) runs with default XDG dirs, so the path resolves
# through the remote shell, not ours.
REMOTE_EGRESS_LOG = (
    "${XDG_STATE_HOME:-$HOME/.local/state}/clawker-tpu/logs/ebpf-egress.jsonl")
