"""Bridge wire protocol: length-prefixed frames over one byte stream.

Frame: ``!IBBH`` header (channel u32, kind u8, which u8, len u16) +
payload.  ``channel`` identifies one proxied connection; ``which`` names
the logical socket (SSH agent / GPG agent).  Stdlib-only: this module
ships in the agentd zipapp and runs on a bare python3 in any image.

Re-designed from the reference's muxrpc (internal/socketbridge
bridge.go:59): connections are symmetric byte pipes, so three frame
kinds suffice -- OPEN (container accepted a client), DATA, CLOSE.

The port's copy of ``clawker_tpu/socketbridge/protocol.py``, whole.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

HEADER = struct.Struct("!IBBH")
MAX_PAYLOAD = 0xFFFF

K_OPEN = 1
K_DATA = 2
K_CLOSE = 3

W_SSH = 1
W_GPG = 2

WHICH_NAMES = {W_SSH: "ssh", W_GPG: "gpg"}


def pack(channel: int, kind: int, which: int, payload: bytes = b"") -> bytes:
    assert len(payload) <= MAX_PAYLOAD
    return HEADER.pack(channel, kind, which, len(payload)) + payload


def read_frame(stream: BinaryIO) -> tuple[int, int, int, bytes] | None:
    """(channel, kind, which, payload), or None on EOF."""
    hdr = b""
    while len(hdr) < HEADER.size:
        chunk = stream.read(HEADER.size - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    channel, kind, which, length = HEADER.unpack(hdr)
    payload = b""
    while len(payload) < length:
        chunk = stream.read(length - len(payload))
        if not chunk:
            return None
        payload += chunk
    return channel, kind, which, payload


def chunked(channel: int, which: int, data: bytes):
    """Yield DATA frames for an arbitrarily large read."""
    for off in range(0, len(data), MAX_PAYLOAD):
        yield pack(channel, K_DATA, which, data[off:off + MAX_PAYLOAD])
