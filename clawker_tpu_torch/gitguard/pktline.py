"""git pkt-line codec: the framing layer under every smart transport.

The port's copy of ``clawker_tpu/gitguard/pktline.py``, whole.

Every smart-HTTP body -- ref advertisements, receive-pack command
lists, report-status responses -- is a sequence of *pkt-lines*: a
4-hex-digit length prefix covering itself plus the payload, or one of
three zero-payload control packets (protocol v2 added two):

    ``0000``  flush-pkt         end of a section / message
    ``0001``  delim-pkt         v2: separates command args from body
    ``0002``  response-end-pkt  v2: end of a stateless-RPC response

The codec here is deliberately strict where git clients are strict and
tolerant where proxies must be tolerant:

- **Oversized length headers** (``> 65520``, i.e. payload over
  ``MAX_PKT_PAYLOAD``) are a protocol violation git itself refuses;
  we raise :class:`PktError` so the filter fails closed instead of
  buffering an attacker-chosen length.
- **Torn frames** (a length prefix promising more bytes than the
  buffer holds) raise :class:`TruncatedPkt` carrying how many bytes
  were cleanly consumed, so a streaming caller can keep the tail and
  retry -- tolerance for re-framing, not for corruption.
- Lengths must be lowercase/uppercase hex only; ``0003`` is reserved
  and rejected (git treats 0003 as an error, not a 0-byte line).

Nothing in this module knows about HTTP, refs, or policy: it is the
leaf the protocol filter and the tests' adversarial corpus both sit on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

from ..errors import ClawkerError

# A pkt-line length header covers itself (4 bytes), so the max payload
# is 0xFFFF - 4.  git caps lines at 65520 total; larger is an error.
MAX_PKT_LEN = 65520
MAX_PKT_PAYLOAD = MAX_PKT_LEN - 4

FLUSH_PKT = b"0000"
DELIM_PKT = b"0001"
RESPONSE_END_PKT = b"0002"

# Packet kinds yielded by iter_pkts.
DATA = "data"
FLUSH = "flush"
DELIM = "delim"
RESPONSE_END = "response-end"

_CONTROL = {0: FLUSH, 1: DELIM, 2: RESPONSE_END}

# Sideband channel numbers (side-band-64k capability).
SIDEBAND_DATA = 1
SIDEBAND_PROGRESS = 2
SIDEBAND_ERROR = 3


class PktError(ClawkerError):
    """Malformed pkt-line framing (bad hex, oversized length, reserved)."""


class TruncatedPkt(PktError):
    """A frame's length header promises bytes the buffer does not hold.

    ``consumed`` is the offset of the start of the torn frame: every
    byte before it parsed cleanly, so a streaming caller may keep
    ``buf[consumed:]`` and retry once more bytes arrive.
    """

    def __init__(self, message: str, consumed: int):
        super().__init__(message)
        self.consumed = consumed


@dataclass(frozen=True)
class Pkt:
    """One parsed pkt-line: a control packet or a data payload."""

    kind: str           # DATA | FLUSH | DELIM | RESPONSE_END
    payload: bytes = b""

    @property
    def text(self) -> str:
        return self.payload.decode("utf-8", "replace").rstrip("\n")


def encode_pkt(payload: bytes | str) -> bytes:
    """Frame one payload as a pkt-line (length prefix + bytes)."""
    raw = payload.encode() if isinstance(payload, str) else payload
    if len(raw) > MAX_PKT_PAYLOAD:
        raise PktError(f"pkt-line payload {len(raw)} exceeds "
                       f"{MAX_PKT_PAYLOAD} bytes")
    return f"{len(raw) + 4:04x}".encode() + raw


def iter_pkts(buf: bytes, *, tolerate_truncated: bool = False,
              ) -> Iterator[Pkt]:
    """Yield every pkt-line in ``buf``; strict by default.

    With ``tolerate_truncated`` a torn trailing frame ends iteration
    silently (proxy streaming mode); otherwise it raises
    :class:`TruncatedPkt` with the clean-consumed offset.
    """
    off = 0
    n = len(buf)
    while off < n:
        if n - off < 4:
            if tolerate_truncated:
                return
            raise TruncatedPkt(
                f"torn pkt-line length header at offset {off}", off)
        head = buf[off:off + 4]
        try:
            length = int(head, 16)
        except ValueError:
            raise PktError(
                f"bad pkt-line length header {head!r} at offset {off}"
            ) from None
        if length in _CONTROL:
            yield Pkt(_CONTROL[length])
            off += 4
            continue
        if length == 3:
            raise PktError("reserved pkt-line length 0003")
        if length < 4:
            raise PktError(f"impossible pkt-line length {length:#06x}")
        if length > MAX_PKT_LEN:
            raise PktError(
                f"oversized pkt-line length {length} (> {MAX_PKT_LEN})")
        if off + length > n:
            if tolerate_truncated:
                return
            raise TruncatedPkt(
                f"torn pkt-line at offset {off}: header promises "
                f"{length} bytes, {n - off} remain", off)
        yield Pkt(DATA, buf[off + 4:off + length])
        off += length


def encode_sideband(band: int, data: bytes) -> bytes:
    """Wrap ``data`` in side-band-64k frames on channel ``band``.

    Splits at the 64k pkt boundary minus the 1-byte channel marker so
    arbitrarily long report-status payloads stay legal.
    """
    out = bytearray()
    limit = MAX_PKT_PAYLOAD - 1
    if not data:
        return encode_pkt(bytes([band]))
    for i in range(0, len(data), limit):
        out += encode_pkt(bytes([band]) + data[i:i + limit])
    return bytes(out)


def decode_sideband(body: bytes) -> tuple[bytes, bytes, bytes]:
    """Split a sideband-framed body into (data, progress, error) streams."""
    data, progress, error = bytearray(), bytearray(), bytearray()
    for pkt in iter_pkts(body, tolerate_truncated=True):
        if pkt.kind != DATA or not pkt.payload:
            continue
        band, rest = pkt.payload[0], pkt.payload[1:]
        if band == SIDEBAND_DATA:
            data += rest
        elif band == SIDEBAND_PROGRESS:
            progress += rest
        elif band == SIDEBAND_ERROR:
            error += rest
    return bytes(data), bytes(progress), bytes(error)
