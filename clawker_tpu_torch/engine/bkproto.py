"""Minimal protobuf wire codec for the BuildKit build trace.

With ``/build?version=2`` the daemon streams progress as JSON records
whose ``aux`` payload (under ``id: "moby.buildkit.trace"``) is a
base64-encoded protobuf ``StatusResponse``.  This module decodes exactly
that message family -- and encodes it, for recorded-transcript tests and
the fake daemon -- with a tiny generic wire-format codec instead of a
generated stub (no protoc dependency, and the message set is small and
frozen).

Message shapes (moby/buildkit api/services/control/control.proto):
  StatusResponse { Vertex vertexes=1; VertexStatus statuses=2;
                   VertexLog logs=3; }
  Vertex       { string digest=1; string inputs=2; string name=3;
                 bool cached=4; Timestamp started=5; Timestamp
                 completed=6; string error=7; }
  VertexStatus { string id=1; string vertex=2; string name=3;
                 int64 current=4; int64 total=5; }
  VertexLog    { string vertex=1; Timestamp timestamp=2;
                 int64 stream=3; bytes msg=4; }

Parity reference: pkg/whail/buildkit/progress.go (trace decoding into
vertex events) -- re-derived against the public BuildKit proto, not
translated.

The port's copy of ``clawker_tpu/engine/bkproto.py``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class WireError(ValueError):
    pass


# ------------------------------------------------------------ wire codec

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if i >= len(buf):
            raise WireError("truncated varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise WireError("varint too long")


def parse_fields(buf: bytes) -> dict[int, list]:
    """Generic wire parse: field number -> list of raw values (int for
    varint, bytes for length-delimited).  Unknown wire types error."""
    out: dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:           # varint
            val, i = _read_varint(buf, i)
        elif wt == 2:         # length-delimited
            ln, i = _read_varint(buf, i)
            if i + ln > len(buf):
                raise WireError(f"field {fno}: truncated bytes")
            val = buf[i:i + ln]
            i += ln
        elif wt == 1:         # fixed64 (not used by this message set)
            if i + 8 > len(buf):
                raise WireError(f"field {fno}: truncated fixed64")
            val = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wt == 5:         # fixed32
            if i + 4 > len(buf):
                raise WireError(f"field {fno}: truncated fixed32")
            val = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            raise WireError(f"unsupported wire type {wt} for field {fno}")
        out.setdefault(fno, []).append(val)
    return out


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def emit_field(fno: int, val) -> bytes:
    """Encode one field (int -> varint, bytes/str -> length-delimited)."""
    if isinstance(val, int):
        return _varint(fno << 3) + _varint(val)
    raw = val.encode() if isinstance(val, str) else bytes(val)
    return _varint((fno << 3) | 2) + _varint(len(raw)) + raw


# --------------------------------------------------------- typed decode

def _ts_seconds(raw: bytes) -> float:
    f = parse_fields(raw)
    return (f.get(1, [0])[0]) + (f.get(2, [0])[0]) / 1e9


@dataclass
class Vertex:
    digest: str = ""
    name: str = ""
    inputs: list[str] = field(default_factory=list)
    cached: bool = False
    started: float | None = None
    completed: float | None = None
    error: str = ""


@dataclass
class VertexStatus:
    id: str = ""
    vertex: str = ""
    current: int = 0
    total: int = 0


@dataclass
class VertexLog:
    vertex: str = ""
    stream: int = 1
    msg: bytes = b""


@dataclass
class StatusResponse:
    vertexes: list[Vertex] = field(default_factory=list)
    statuses: list[VertexStatus] = field(default_factory=list)
    logs: list[VertexLog] = field(default_factory=list)


def decode_status(buf: bytes) -> StatusResponse:
    top = parse_fields(buf)
    out = StatusResponse()
    for raw in top.get(1, []):
        f = parse_fields(raw)
        out.vertexes.append(Vertex(
            digest=f.get(1, [b""])[0].decode("utf-8", "replace"),
            inputs=[x.decode("utf-8", "replace") for x in f.get(2, [])],
            name=f.get(3, [b""])[0].decode("utf-8", "replace"),
            cached=bool(f.get(4, [0])[0]),
            started=_ts_seconds(f[5][0]) if 5 in f else None,
            completed=_ts_seconds(f[6][0]) if 6 in f else None,
            error=f.get(7, [b""])[0].decode("utf-8", "replace"),
        ))
    for raw in top.get(2, []):
        f = parse_fields(raw)
        out.statuses.append(VertexStatus(
            id=f.get(1, [b""])[0].decode("utf-8", "replace"),
            vertex=f.get(2, [b""])[0].decode("utf-8", "replace"),
            current=f.get(4, [0])[0],
            total=f.get(5, [0])[0],
        ))
    for raw in top.get(3, []):
        f = parse_fields(raw)
        out.logs.append(VertexLog(
            vertex=f.get(1, [b""])[0].decode("utf-8", "replace"),
            stream=f.get(3, [1])[0],
            msg=f.get(4, [b""])[0],
        ))
    return out


# --------------------------------------------------------- typed encode
# Used by tests and the fake daemon to produce recorded transcripts.

def _encode_ts(seconds: float) -> bytes:
    s = int(seconds)
    n = int((seconds - s) * 1e9)
    body = emit_field(1, s)
    if n:
        body += emit_field(2, n)
    return body


def encode_status(resp: StatusResponse) -> bytes:
    out = b""
    for v in resp.vertexes:
        body = emit_field(1, v.digest)
        for inp in v.inputs:
            body += emit_field(2, inp)
        body += emit_field(3, v.name)
        if v.cached:
            body += emit_field(4, 1)
        if v.started is not None:
            body += emit_field(5, _encode_ts(v.started))
        if v.completed is not None:
            body += emit_field(6, _encode_ts(v.completed))
        if v.error:
            body += emit_field(7, v.error)
        out += emit_field(1, body)
    for st in resp.statuses:
        body = emit_field(1, st.id) + emit_field(2, st.vertex)
        body += emit_field(4, st.current) + emit_field(5, st.total)
        out += emit_field(2, body)
    for lg in resp.logs:
        body = emit_field(1, lg.vertex) + emit_field(3, lg.stream)
        body += emit_field(4, lg.msg)
        out += emit_field(3, body)
    return out
