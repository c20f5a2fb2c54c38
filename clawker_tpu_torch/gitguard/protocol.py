"""Smart-HTTP protocol filter: advertisements in, verdicts out.

The port's copy of ``clawker_tpu/gitguard/protocol.py``, whole.

Three wire shapes matter to the proxy (git docs: http-protocol.txt,
pack-protocol.txt, protocol-v2.txt):

1. ``GET /info/refs?service=git-upload-pack|git-receive-pack`` -- the
   ref advertisement.  v0: a ``# service=`` header pkt, flush, then
   ``<sha> <ref>`` lines where the FIRST line carries ``\\0``-separated
   capabilities; hidden refs must be dropped *and* the capability
   suffix re-homed onto the first surviving line or the zero-id
   ``capabilities^{}`` placeholder.  v2: a capability listing; the ref
   filtering happens on the later ``ls-refs`` response instead.
2. ``POST /git-receive-pack`` -- a pkt-line command list
   ``<old-sha> <new-sha> <ref>`` (first line again carrying caps),
   flush, then the packfile.  The filter parses the commands, refuses
   a *smuggled second command list* (extra commands after the first
   flush), and never forwards a refused push.
3. The refusal itself -- report-status (``unpack ok`` / ``ng <ref>
   <reason>``), sideband-wrapped when the client asked for
   side-band-64k.  A git client parses this into ``! [remote
   rejected]`` lines; a bare TCP reset would instead retry or surface
   a useless curl error, so the guard always answers in-protocol.

Pure functions over bytes: the server owns sockets, this owns framing.
"""

from __future__ import annotations

from dataclasses import dataclass

from .pktline import (
    DATA,
    DELIM,
    FLUSH,
    FLUSH_PKT,
    Pkt,
    PktError,
    encode_pkt,
    encode_sideband,
    iter_pkts,
)
from .refpolicy import AgentIdentity, Decision, RefPolicy

GIT_UPLOAD_PACK = "git-upload-pack"
GIT_RECEIVE_PACK = "git-receive-pack"
SERVICES = (GIT_UPLOAD_PACK, GIT_RECEIVE_PACK)

ZERO_SHA = "0" * 40

# Capabilities gitguard itself understands in a receive-pack request.
# report-status / side-band are what we need to answer refusals; the
# rest pass through untouched on allowed pushes.
_SIDEBAND_CAPS = ("side-band-64k", "side-band")


@dataclass(frozen=True)
class RefUpdate:
    """One receive-pack command: update ``ref`` from old to new sha."""

    old_sha: str
    new_sha: str
    ref: str
    caps: tuple[str, ...] = ()

    @property
    def is_delete(self) -> bool:
        return self.new_sha == ZERO_SHA


@dataclass(frozen=True)
class PushRequest:
    """A parsed ``POST /git-receive-pack`` body."""

    commands: tuple[RefUpdate, ...]
    caps: tuple[str, ...]
    pack: bytes                 # packfile bytes after the flush (may be b"")

    @property
    def wants_sideband(self) -> bool:
        return any(c in self.caps for c in _SIDEBAND_CAPS)

    @property
    def wants_report_status(self) -> bool:
        return any(c.startswith("report-status") for c in self.caps)


def _split_ref_line(payload: bytes) -> tuple[str, tuple[str, ...]]:
    """Split ``<...> <ref>[\\0caps]`` payload -> (line-sans-caps, caps)."""
    raw = payload.rstrip(b"\n")
    if b"\x00" in raw:
        line, caps = raw.split(b"\x00", 1)
        return (line.decode("utf-8", "replace"),
                tuple(caps.decode("utf-8", "replace").split()))
    return raw.decode("utf-8", "replace"), ()


def filter_advertisement(body: bytes, service: str, policy: RefPolicy,
                         identity: AgentIdentity | None,
                         ) -> tuple[bytes, int]:
    """Rewrite an info/refs advertisement to the caller's visibility.

    Returns ``(new_body, hidden_count)``.  v2 advertisements (a
    capability listing with no ref lines) pass through unchanged --
    their refs travel in the later ``ls-refs`` response, which the
    server filters with :func:`filter_ls_refs`.  Peeled ``<ref>^{}``
    lines follow their parent's visibility.
    """
    pkts = list(iter_pkts(body))
    out = bytearray()
    hidden = 0
    caps: tuple[str, ...] = ()
    caps_homed = False
    saw_ref = False
    i = 0
    # Optional "# service=..." header pkt + flush (smart-HTTP GET only).
    if pkts and pkts[0].kind == DATA and pkts[0].payload.startswith(
            b"# service="):
        out += encode_pkt(pkts[0].payload)
        i = 1
        if i < len(pkts) and pkts[i].kind == FLUSH:
            out += FLUSH_PKT
            i += 1
    body_pkts = pkts[i:]
    if any(p.kind == DATA and p.payload.startswith(b"version 2")
           for p in body_pkts):
        # v2 capability advertisement: no refs here, nothing to hide.
        for p in body_pkts:
            out += _reencode(p)
        return bytes(out), 0
    kept: list[tuple[str, str]] = []       # (sha, ref) lines kept
    for p in body_pkts:
        if p.kind != DATA:
            continue
        line, line_caps = _split_ref_line(p.payload)
        if not caps and line_caps:
            caps = line_caps
        parts = line.split(" ", 1)
        if len(parts) != 2:
            raise PktError(f"malformed advertisement line {line!r}")
        sha, ref = parts
        saw_ref = True
        base_ref = ref[:-3] if ref.endswith("^{}") else ref
        if policy.may_read(identity, base_ref):
            kept.append((sha, ref))
        else:
            hidden += 1
    for sha, ref in kept:
        if not caps_homed:
            payload = f"{sha} {ref}".encode() + b"\x00" + \
                " ".join(caps).encode() + b"\n"
            caps_homed = True
        else:
            payload = f"{sha} {ref}\n".encode()
        out += encode_pkt(payload)
    if saw_ref and not kept:
        # Everything hidden: advertise the standard empty-repo
        # placeholder so the client sees "no refs" rather than an error.
        out += encode_pkt(
            f"{ZERO_SHA} capabilities^{{}}".encode() + b"\x00" +
            " ".join(caps).encode() + b"\n")
    out += FLUSH_PKT
    return bytes(out), hidden


def _reencode(p: Pkt) -> bytes:
    if p.kind == DATA:
        return encode_pkt(p.payload)
    if p.kind == FLUSH:
        return FLUSH_PKT
    if p.kind == DELIM:
        return b"0001"
    return b"0002"


def filter_ls_refs(body: bytes, policy: RefPolicy,
                   identity: AgentIdentity | None) -> tuple[bytes, int]:
    """Filter a protocol-v2 ``ls-refs`` response body.

    Each data pkt is ``<sha> <ref>[ attr...]``; hidden refs drop.
    """
    out = bytearray()
    hidden = 0
    for p in iter_pkts(body):
        if p.kind != DATA:
            out += _reencode(p)
            continue
        line = p.payload.rstrip(b"\n").decode("utf-8", "replace")
        parts = line.split(" ")
        ref = parts[1] if len(parts) > 1 else ""
        base_ref = ref[:-3] if ref.endswith("^{}") else ref
        if base_ref and not policy.may_read(identity, base_ref):
            hidden += 1
            continue
        out += encode_pkt(p.payload)
    return bytes(out), hidden


def parse_receive_commands(body: bytes) -> PushRequest:
    """Parse a receive-pack request body into commands + caps + pack.

    Raises :class:`PktError` on a smuggled second command list (data
    pkt-lines after the first flush that parse as commands -- the
    classic request-smuggling shape for this protocol), hostile ref
    names are NOT rejected here (policy owns that; parsing stays
    total so every command gets a per-ref ``ng`` answer).
    """
    commands: list[RefUpdate] = []
    caps: tuple[str, ...] = ()
    offset = 0
    n = len(body)
    saw_flush = False
    # Walk pkt-lines manually so we know the byte offset of the pack.
    while offset < n:
        head = body[offset:offset + 4]
        if len(head) < 4:
            raise PktError("torn receive-pack command list")
        try:
            length = int(head, 16)
        except ValueError:
            raise PktError(f"bad pkt-line length {head!r} in "
                           "receive-pack request") from None
        if length == 0:
            offset += 4
            saw_flush = True
            break
        if length < 4 or length > 65520:
            raise PktError(f"illegal pkt-line length {length} in "
                           "receive-pack request")
        payload = body[offset + 4:offset + length]
        if len(payload) != length - 4:
            raise PktError("torn receive-pack command list")
        offset += length
        line, line_caps = _split_ref_line(payload)
        if not commands and line_caps:
            caps = line_caps
        if line.startswith(("push-cert", "shallow ", "push-option")):
            # Not ref updates; keep position, pass through on allow.
            continue
        parts = line.split(" ")
        if len(parts) != 3:
            raise PktError(f"malformed receive-pack command {line!r}")
        commands.append(RefUpdate(old_sha=parts[0], new_sha=parts[1],
                                  ref=parts[2], caps=line_caps))
    if not saw_flush and commands:
        raise PktError("receive-pack command list missing flush")
    pack = body[offset:]
    # Smuggling check: the pack section must be a packfile (or empty /
    # a push-cert trailer), never a second pkt-line command list.
    if pack and pack[:4] != b"PACK":
        try:
            trailing = list(iter_pkts(pack, tolerate_truncated=True))
        except PktError:
            trailing = []           # not pkt-lines either; let policy/git cope
        for p in trailing:
            if p.kind != DATA:
                continue
            line, _ = _split_ref_line(p.payload)
            parts = line.split(" ")
            if len(parts) == 3 and len(parts[0]) == 40 \
                    and len(parts[1]) == 40:
                raise PktError("smuggled second command list after flush")
            break
    return PushRequest(commands=tuple(commands), caps=caps, pack=pack)


def refusal_response(push: PushRequest, verdicts: list[Decision],
                     *, unpack_error: str = "") -> bytes:
    """Build the report-status body refusing (part of) a push.

    gitguard never forwards a partially-allowed push: if any command is
    denied, every command answers ``ng`` -- denied refs with their
    policy reason, innocent riders with an atomic-refusal note -- under
    ``unpack ok`` (we never saw a corrupt pack; the *commands* were
    refused).  A malformed request instead reports ``unpack error``.
    Sideband-wrapped iff the client advertised side-band(-64k).
    """
    status = bytearray()
    if unpack_error:
        status += encode_pkt(f"unpack {unpack_error}\n")
    else:
        status += encode_pkt("unpack ok\n")
    denied = {d.ref: d for d in verdicts if not d.allowed}
    for cmd in push.commands:
        d = denied.get(cmd.ref)
        if d is not None:
            status += encode_pkt(f"ng {cmd.ref} {d.reason}\n")
        elif denied:
            status += encode_pkt(
                f"ng {cmd.ref} push refused: out-of-namespace ref in "
                "same push\n")
        else:
            status += encode_pkt(f"ok {cmd.ref}\n")
    if not push.commands and unpack_error:
        status += encode_pkt(f"ng refs/ {unpack_error}\n")
    status += FLUSH_PKT
    if push.wants_sideband:
        return encode_sideband(1, bytes(status)) + FLUSH_PKT
    return bytes(status)


def error_response(message: str) -> bytes:
    """A bare ``ERR`` pkt -- the in-protocol refusal for fetch paths."""
    return encode_pkt(f"ERR {message}\n") + FLUSH_PKT


def parse_upload_pack_wants(body: bytes) -> list[str]:
    """Collect ``want`` object ids from an upload-pack request (v0+v2)."""
    wants: list[str] = []
    for p in iter_pkts(body, tolerate_truncated=True):
        if p.kind != DATA:
            continue
        line = p.payload.rstrip(b"\n").decode("utf-8", "replace")
        if line.startswith("want "):
            parts = line.split(" ")
            if len(parts) >= 2:
                wants.append(parts[1])
    return wants
