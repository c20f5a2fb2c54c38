"""Session wire protocol: length-prefixed JSON frames over (m)TLS.

Parity reference: api/clawkerd/v1/clawkerd.proto (SURVEY.md 2.12) -- the
reference streams a protobuf ``Command``/``Response`` oneof over gRPC; this
build keeps the exact message taxonomy (Hello/Shell/Stdin/CloseStdin/
Signal/RegisterRequired/AgentReady/AgentInitialized and HelloAck/Started/
OutputChunk/StageExit/Done/Error/RegisterDone) as JSON objects framed by a
4-byte big-endian length, which stdlib ``ssl`` sockets carry without a gRPC
dependency.

The port's copy of ``clawker_tpu/agentd/protocol.py``, whole: loopd's
socket speaks this framing.
"""

from __future__ import annotations

import base64
import json
import struct
import socket

from ..errors import ClawkerError

MAX_FRAME = 8 * 1024 * 1024


class ProtocolError(ClawkerError):
    pass


class ConnectionClosed(ProtocolError):
    pass


def write_msg(sock, msg: dict) -> None:
    data = json.dumps(msg, separators=(",", ":")).encode()
    if len(data) > MAX_FRAME:
        raise ProtocolError(f"frame too large: {len(data)}")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (ConnectionResetError, BrokenPipeError, socket.timeout) as e:
            raise ConnectionClosed(str(e)) from None
        if not chunk:
            raise ConnectionClosed("peer closed")
        buf += chunk
    return buf


def read_msg(sock) -> dict:
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise ProtocolError(f"frame too large: {length}")
    msg = json.loads(_recv_exact(sock, length))
    if not isinstance(msg, dict) or "type" not in msg:
        raise ProtocolError("malformed session message")
    return msg


def b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def unb64(s: str) -> bytes:
    return base64.b64decode(s)
