"""Zone-name hashing shared by the DNS gate, route sync, and the kernel.

The port's copy of ``clawker_tpu/firewall/hashes.py``, whole.

FNV-1a 64-bit over the lowercased zone apex (no trailing dot).  Chosen
because it is trivially implementable in eBPF (bounded loop over a fixed
buffer, no tables) and in Python; the C twin lives in
native/ebpf/fw_maps.h (fw_zone_hash) and tests pin known vectors so the
two can never drift.

Parity reference: the reference routes kernel decisions on a domain hash
written by its CoreDNS dnsbpf plugin (internal/dnsbpf/bpfmap.go:29-51);
the hash function itself is re-chosen here.
"""

from __future__ import annotations

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def zone_hash(zone: str) -> int:
    """FNV-1a 64 of the normalized zone name."""
    h = FNV_OFFSET
    for b in zone.strip().strip(".").lower().encode("ascii", "ignore"):
        h ^= b
        h = (h * FNV_PRIME) & _MASK
    return h
