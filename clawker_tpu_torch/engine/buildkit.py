"""BuildKit build lane: capability probe, trace decoding, legacy fallback.

The daemon advertises its default builder in ``/info`` (BuilderVersion
"2" = BuildKit).  On the BuildKit lane the progress stream carries
``aux`` records (``id: "moby.buildkit.trace"``) holding base64 protobuf
StatusResponses; this module decodes them (engine/bkproto.py) and
normalizes everything into the classic event dialect the bundler and
``ui/buildview.py`` already consume:

- ``{"stream": "#N <name>"}`` / ``"#N DONE <secs>s"`` / ``"#N CACHED"``
  / ``"#N ERROR <msg>"`` -- the plain-progress vertex lines buildview's
  ``_BK_VERTEX`` regex renders as tree nodes;
- ``{"stream": <log bytes>}`` for vertex logs;
- ``{"errorDetail": {"message": ...}}`` on failure.

If the daemon rejects the BuildKit request (older daemon, missing
session support), the builder transparently retries on the legacy
``/build`` lane -- capability probe + fallback, reference
pkg/whail/buildkit/{builder,solve,progress}.go semantics re-derived.

The port's copy of ``clawker_tpu/engine/buildkit.py``, whole.
"""

from __future__ import annotations

import base64
from typing import Iterator

from .. import logsetup
from .bkproto import StatusResponse, WireError, decode_status
from ..errors import DriverError

log = logsetup.get("engine.buildkit")

TRACE_ID = "moby.buildkit.trace"


def builder_version(api) -> str:
    """Capability probe: "2" when the daemon defaults to BuildKit."""
    try:
        return str(api.info().get("BuilderVersion") or "1")
    except (DriverError, AttributeError):
        return "1"


class TraceRenderer:
    """Decode trace StatusResponses into plain-progress vertex lines.

    Vertices are numbered in first-seen order (#1, #2, ...) the way the
    docker CLI's plain progress does, so downstream consumers key on a
    stable small integer instead of a digest."""

    def __init__(self):
        self._num: dict[str, int] = {}
        self._done: set[str] = set()
        self._started: dict[str, float] = {}

    def _n(self, digest: str) -> int:
        if digest not in self._num:
            self._num[digest] = len(self._num) + 1
        return self._num[digest]

    def render(self, resp: StatusResponse) -> Iterator[dict]:
        for v in resp.vertexes:
            n = self._n(v.digest)
            if v.started is not None and v.digest not in self._started:
                self._started[v.digest] = v.started
                yield {"stream": f"#{n} {v.name}\n"}
            if v.error:
                if v.digest not in self._done:
                    self._done.add(v.digest)
                    yield {"stream": f"#{n} ERROR {v.error}\n"}
                continue
            if v.cached and v.digest not in self._done:
                self._done.add(v.digest)
                if v.digest not in self._started:
                    yield {"stream": f"#{n} {v.name}\n"}
                yield {"stream": f"#{n} CACHED\n"}
                continue
            if v.completed is not None and v.digest not in self._done:
                self._done.add(v.digest)
                took = v.completed - (v.started or v.completed)
                yield {"stream": f"#{n} DONE {took:.1f}s\n"}
        for st in resp.statuses:
            n = self._n(st.vertex)
            if st.total:
                yield {"stream": f"#{n} {st.id} {st.current}/{st.total}\n"}
        for lg in resp.logs:
            n = self._n(lg.vertex)
            text = lg.msg.decode("utf-8", "replace").rstrip("\n")
            for line in text.splitlines():
                yield {"stream": f"#{n} {line}\n"}


def decode_stream(raw_events: Iterator[dict]) -> Iterator[dict]:
    """Normalize a version=2 progress stream: trace aux records become
    vertex lines; classic records pass through untouched."""
    renderer = TraceRenderer()
    for ev in raw_events:
        if ev.get("id") == TRACE_ID and "aux" in ev:
            try:
                resp = decode_status(base64.b64decode(ev["aux"]))
            except (WireError, ValueError, TypeError, AttributeError) as e:
                # type-confused wire data (e.g. a message field arriving
                # as varint) must degrade to a skipped record, never
                # abort the whole build stream
                log.warning("buildkit trace decode failed: %s", e)
                continue
            for out in renderer.render(resp):
                if out.get("stream"):
                    yield out
        else:
            yield ev


class Builder:
    """The build front door: probe once, prefer BuildKit, fall back."""

    def __init__(self, api):
        self.api = api
        self._version: str | None = None
        self.last_buildid = ""  # cancel handle for the in-flight solve

    def version(self) -> str:
        if self._version is None:
            self._version = builder_version(self.api)
        return self._version

    def build(self, context_tar: bytes, *,
              secrets: dict[str, bytes] | None = None,
              ssh_auth_sock: str = "", **kw) -> Iterator[dict]:
        """Build, preferring the BuildKit lane.

        ``secrets`` / ``ssh_auth_sock`` require the SESSION lane
        (`RUN --mount=type=secret|ssh`): a client session is attached via
        /session (engine/bksession) and the daemon dials back into it for
        secret bytes and agent round-trips during the solve.  Without
        them the plain version=2 lane is used; the legacy /build lane
        remains the capability fallback either way (a build that NEEDS a
        session fails loudly on daemons that cannot provide one).
        """
        wants_session = bool(secrets) or bool(ssh_auth_sock)
        if wants_session and not hasattr(self.api, "session_attach"):
            raise DriverError(
                "build needs secrets/ssh mounts, but this daemon API has "
                "no /session lane")
        if self.version() == "2" and hasattr(self.api, "image_build_buildkit"):
            import uuid

            self.last_buildid = uuid.uuid4().hex
            session = None
            extra: dict = {}
            try:
                if wants_session:
                    from .bksession import Session, SessionServices

                    session = Session(SessionServices(
                        secrets=secrets, ssh_auth_sock=ssh_auth_sock))
                    session.attach(self.api.session_attach(
                        session.headers(), session.method_headers()))
                    extra["session"] = session.session_id
                raw = self.api.image_build_buildkit(
                    context_tar, buildid=self.last_buildid, **extra, **kw)
                return self._stream_with_session(raw, session)
            except DriverError as e:
                if session is not None:
                    session.close()
                if wants_session:
                    raise  # secret/ssh builds must not silently downgrade
                # daemon advertised BuildKit but refused the request
                # (e.g. session required): fall back AND remember -- the
                # context tar is uploaded eagerly, so retrying the doomed
                # lane would double-upload every subsequent build
                log.warning("buildkit lane refused (%s); legacy fallback", e)
                self._version = "1"
                self.last_buildid = ""
            except BaseException:
                # any other failure (transient socket error, attach
                # crash): the loopback gRPC server and pumps must not
                # outlive the attempt
                if session is not None:
                    session.close()
                raise
        if wants_session:
            raise DriverError(
                "build needs secrets/ssh mounts, which require the BuildKit "
                "session lane; this daemon only offers the legacy builder")
        return self.api.image_build(context_tar, **kw)

    @staticmethod
    def _stream_with_session(raw: Iterator[dict], session) -> Iterator[dict]:
        """Decode the progress stream; the session lives until it ends."""
        try:
            yield from decode_stream(raw)
        finally:
            if session is not None:
                session.close()

    def cancel(self) -> None:
        """Cancel the in-flight BuildKit solve (no-op on the legacy lane)."""
        if self.last_buildid and hasattr(self.api, "build_cancel"):
            self.api.build_cancel(self.last_buildid)
