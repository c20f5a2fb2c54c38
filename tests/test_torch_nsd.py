"""nsd and the nsd driver against the reference's, on any host (tier A).

Twins of tests/test_nsd.py's API cases over the kernel-free double
(``clawker_tpu_torch.testenv.install_nsd_double``, first on ``PATH`` for
the test alone): each package's daemon serves its own socket under
``tmp_path`` from its own state dir, with no cgroup dir
(``_find_cgroup_root`` gives None; one case gives each a plain directory
under ``tmp_path`` as its cgroup root), and the same calls on both give
the same HTTP statuses and bodies (ids, times and each side's own
directories masked), stdcopy frames, exit codes, archive members, event
streams and socket modes.  Nothing here mounts, and nothing makes a
directory under the host's cgroup-v2: a daemon ``NsdDriver`` spawns
runs under ``python_without_cgroups``.  The double isolates nothing, so
the cases that assert isolation (PID/UTS, overlay writes that never
reach the host, the cgroup escape) are in tests/test_torch_nsd_live.py,
which runs on real namespaces where the reference's own probe says it
can.  Also here: the
seven twins of tests/test_nsd_ro.py, ``NsdDriver``'s probe, refusal and
spawn, and ``python -m clawker_tpu_torch.nsd`` as non-root.

The two daemons start one after the other: ``serve`` narrows the process
umask around ``bind``, and two binds at once could leave it narrowed for
every later test of the worker.  After every test the umask is what it
was and no process the test started is left.
"""

from __future__ import annotations

import dataclasses
import errno
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tarfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.engine.drivers.nsdriver as ref_nsdriver
import clawker_tpu.engine.httpapi as ref_httpapi
import clawker_tpu.errors as ref_errors
import clawker_tpu.nsd.runtime as ref_runtime
import clawker_tpu.nsd.server as ref_server
import clawker_tpu.nsd.shim as ref_shim
import clawker_tpu_torch.engine.drivers.nsdriver as port_nsdriver
import clawker_tpu_torch.engine.httpapi as port_httpapi
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.nsd.runtime as port_runtime
import clawker_tpu_torch.nsd.server as port_server
import clawker_tpu_torch.nsd.shim as port_shim
from clawker_tpu_torch.testenv import (
    install_nsd_double,
    python_without_cgroups,
)

PKGS = {
    "ref": SimpleNamespace(tag="ref", module="clawker_tpu.nsd",
                           nsdriver=ref_nsdriver, httpapi=ref_httpapi,
                           errors=ref_errors, runtime=ref_runtime,
                           server=ref_server, shim=ref_shim),
    "port": SimpleNamespace(tag="port", module="clawker_tpu_torch.nsd",
                            nsdriver=port_nsdriver, httpapi=port_httpapi,
                            errors=port_errors, runtime=port_runtime,
                            server=port_server, shim=port_shim),
}
IMAGE = "busybox:latest"
WAIT_S = 30.0           # the longest any one call of a case may block


# ------------------------------------------------------------- leftovers


def _children() -> set[int]:
    """Live (not zombie) children of this process."""
    me, out = os.getpid(), set()
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[1]) == me:
            out.add(int(d.name))
    return out


def wait_for(pred, timeout: float = 5.0, step: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return bool(pred())


@pytest.fixture(autouse=True)
def _no_leftovers():
    """The process umask is unchanged and no child this test started is
    left (5 s of grace for the ones already dying)."""
    umask = os.umask(0o022)
    os.umask(umask)
    before = _children()
    yield
    now = os.umask(umask)
    assert now == umask, f"umask {now:o} after the test, {umask:o} before"
    wait_for(lambda: not (_children() - before))
    assert not (_children() - before)


def bounded(fn, *args, timeout: float = WAIT_S, **kw):
    """``fn(*args, **kw)`` on a thread, failing the test instead of
    hanging the run when it does not return within ``timeout``."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn.__name__} blocked for {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


# ---------------------------------------------------------------- daemons


@dataclasses.dataclass
class Side:
    """One package's daemon, serving on its thread."""

    m: SimpleNamespace
    base: Path
    sock: Path
    daemon: object
    thread: threading.Thread
    api: object
    cgroup: Path | None = None   # the cgroup root it was given, if any


def serve(m, base: Path, **kw) -> Side:
    """``m``'s ``NsDaemon`` on ``base/run/nsd.sock`` from ``base/state``,
    returned once it listens: the socket bound at 0600 and the umask
    restored, so the next daemon may bind.  ``kw`` goes to ``NsDaemon``;
    its ``cgroup_root``, when set, is kept as ``Side.cgroup``."""
    sock = base / "run" / "nsd.sock"
    daemon = m.server.NsDaemon(base / "state", sock, **kw)
    t = threading.Thread(target=daemon.serve, daemon=True,
                         name=f"nsd-{m.tag}")
    t.start()
    assert wait_for(lambda: daemon._server_sock is not None
                    and (sock.stat().st_mode & 0o777) == 0o600), \
        f"{m.tag}: the daemon never listened on {sock}"
    api = m.httpapi.HTTPDockerAPI(m.httpapi.unix_socket_factory(sock))
    list(api.image_pull(IMAGE))
    cgroup = kw.get("cgroup_root")
    return Side(m, base, sock, daemon, t, api,
                Path(cgroup) if cgroup else None)


def stop(side: Side) -> None:
    side.api.close()
    side.daemon.shutdown()
    side.thread.join(5)
    assert not side.thread.is_alive(), f"{side.m.tag}: serve never ended"


@pytest.fixture
def double(tmp_path, monkeypatch):
    """The double first on this process's ``PATH``, for this test; none
    of its processes left after it."""
    d = install_nsd_double(tmp_path / "double")
    monkeypatch.setenv("PATH", d.env()["PATH"])
    yield d
    wait_for(lambda: not d.live_pids())
    assert not d.live_pids()


def _serve_both(tmp_path: Path, monkeypatch, cgroups: bool):
    """Both packages' daemons, started in turn; with ``cgroups``, each
    with a cgroup root of its own, a plain directory outside its base
    (its containers' ``cgroup.procs`` are then plain files)."""
    for m in PKGS.values():
        monkeypatch.setattr(m.server.NsDaemon, "_find_cgroup_root",
                            staticmethod(lambda: None))
    out: dict[str, Side] = {}
    try:
        for tag, m in PKGS.items():
            kw = ({"cgroup_root": str(tmp_path / f"cgroup-{tag}")}
                  if cgroups else {})
            out[tag] = serve(m, tmp_path / tag, **kw)
        yield out
    finally:
        for side in out.values():
            stop(side)


@pytest.fixture
def sides(tmp_path, double, monkeypatch):
    """Both packages' daemons over the double, with no cgroup root."""
    yield from _serve_both(tmp_path, monkeypatch, cgroups=False)


@pytest.fixture
def cgroup_sides(tmp_path, double, monkeypatch):
    """Both packages' daemons over the double, each with a cgroup root
    of its own, as tests/test_torch_nsd_live.py gives them."""
    yield from _serve_both(tmp_path, monkeypatch, cgroups=True)


# ----------------------------------------------------------------- twins

_HEX = re.compile(r"[0-9a-f]{12,64}")
_TIME = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")


def mask(obj, base: Path, cgroup: Path | None = None):
    """``obj`` with ids, times, pids, ``base`` and the ``cgroup`` root
    (each side's own, which inspect's ``NsdCgroupDir`` names) masked."""
    if isinstance(obj, dict):
        return {k: ("<pid>" if k == "Pid" and v
                    else "<time>" if k == "time" else mask(v, base, cgroup))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(mask(v, base, cgroup) for v in obj)
    if isinstance(obj, bytes):
        return mask(obj.decode("latin-1"), base, cgroup).encode("latin-1")
    if isinstance(obj, str):
        if cgroup is not None:
            obj = obj.replace(str(cgroup), "<cgroup>")
        return _HEX.sub("<hex>", _TIME.sub(
            "<time>", obj.replace(str(base), "<base>")))
    return obj


def twin(sides: dict, case, *args, **kw):
    """``case(side, *args, **kw)`` on the reference's side, then the
    port's: the port's result, masked, is the reference's; -> it."""
    got = {tag: mask(case(side, *args, **kw), side.base, side.cgroup)
           for tag, side in sides.items()}
    assert got["port"] == got["ref"]
    return got["ref"]


def http(side: Side, method: str, path: str, body=None, *,
         raw: bytes | None = None) -> tuple[int, object]:
    """One request on a fresh connection: -> (status, JSON body or the
    raw bytes where it is not JSON)."""
    payload = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else b"")
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(WAIT_S)
        s.connect(str(side.sock))
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: docker\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n".encode()
                  + payload)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    head, _, content = data.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    try:
        return status, json.loads(content) if content else None
    except ValueError:
        return status, content


class Events:
    """The daemon's ``/events`` stream, read on a thread until closed."""

    def __init__(self, side: Side):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(str(side.sock))
        self.sock.sendall(b"GET /events HTTP/1.1\r\nHost: docker\r\n\r\n")
        self.data = b""
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        # subscribed once the daemon answered the headers
        assert wait_for(lambda: b"\r\n\r\n" in self.data)

    def _read(self) -> None:
        while True:
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            self.data += chunk

    def close(self) -> list[dict]:
        """-> the events received: type, action and attributes."""
        self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()
        self.thread.join(5)
        body = self.data.partition(b"\r\n\r\n")[2]
        return [{k: ev[k] for k in ("Type", "Action", "status", "id",
                                    "Actor")}
                for ev in map(json.loads, body.splitlines())]


def demux(raw: bytes) -> list[tuple[int, bytes]]:
    """A stdcopy stream's frames."""
    out = []
    while raw:
        n = int.from_bytes(raw[4:8], "big")
        out.append((raw[0], raw[8:8 + n]))
        raw = raw[8 + n:]
    return out


def by_stream(frames) -> dict[int, bytes]:
    """Each stream's bytes, joined: two pipes pumped by ``select`` may
    interleave differently from run to run."""
    out: dict[int, bytes] = {}
    for fd, payload in frames:
        out[fd] = out.get(fd, b"") + payload
    return out


def tar_of(name: str, data: bytes) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        ti = tarfile.TarInfo(name)
        ti.size = len(data)
        tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def members(tar_bytes: bytes) -> list[tuple]:
    """A tar's members: name, type, mode and content (not the times)."""
    with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tf:
        return [(m.name, m.type, m.mode,
                 tf.extractfile(m).read() if m.isfile() else None)
                for m in tf.getmembers()]


def create(side: Side, name: str, cmd: list[str], **cfg) -> str:
    base = {"Image": IMAGE, "Cmd": cmd, "Labels": {}}
    base.update(cfg)
    return side.api.container_create(name, base)["Id"]


def run_to_exit(side: Side, cid: str) -> int:
    side.api.container_start(cid)
    return bounded(side.api.container_wait, cid)["StatusCode"]


def logs(side: Side, cid: str) -> bytes:
    return bounded(lambda: b"".join(side.api.container_logs(cid)))


# ------------------------------------------------------------- the cases
# (shared with tests/test_torch_nsd_live.py, which runs them on real
# namespaces; each returns what the twin compares)


def case_ping_info_version(side: Side) -> dict:
    return {path: http(side, "GET", path) for path in
            ("/_ping", "/info", "/version", "/v1.43/version",
             "/containers/nope/top")}


def case_lifecycle(side: Side) -> dict:
    ev = Events(side)
    cid = create(side, "lc1",
                 ["sh", "-c", "echo out-line; echo err-line >&2; exit 3"])
    created = http(side, "GET", f"/containers/{cid}/json")
    code = run_to_exit(side, cid)
    insp = http(side, "GET", f"/containers/{cid}/json")
    raw = logs(side, cid)
    again = http(side, "POST", f"/containers/{cid}/wait")
    listed = http(side, "GET", "/containers/json?all=1")
    removed = http(side, "DELETE", f"/containers/{cid}?force=1")
    gone = http(side, "GET", f"/containers/{cid}/json")
    assert wait_for(lambda: b'"destroy"' in ev.data)
    return {"code": code, "created": created, "inspect": insp,
            "logs": by_stream(demux(raw)),
            "streams": sorted({fd for fd, _ in demux(raw)}),
            "wait again": again, "listed": listed, "removed": removed,
            "gone": gone, "events": ev.close()}


def case_attach_and_archive_before_start(side: Side, cmd: list[str],
                                         **cfg) -> dict:
    cid = create(side, "att1", cmd, OpenStdin=True, **cfg)
    side.api.put_archive(cid, "/seeded", tar_of("f.txt", b"seeded-content\n"))
    stream = side.api.container_attach(cid, tty=False)
    side.api.container_start(cid)
    stream.write(b"over-stdin\n")
    got = bounded(lambda: by_stream(stream.frames()))
    stream.close()
    code = bounded(side.api.container_wait, cid)["StatusCode"]
    seeded = members(side.api.get_archive(cid, "/seeded/f.txt"))
    side.api.container_remove(cid, force=True)
    return {"attached": got, "code": code, "seeded": seeded}


def case_archive_binds(side: Side, cmd: list[str]) -> dict:
    host_dir = side.base / "bound"
    host_dir.mkdir()
    cid = create(side, "arc1", cmd, HostConfig={"Binds": [f"{host_dir}:/work"]})
    side.api.put_archive(cid, "/work", tar_of("in.txt", b"bind-routed\n"))
    seeded = (host_dir / "in.txt").read_bytes()
    code = run_to_exit(side, cid)
    out = members(side.api.get_archive(cid, "/work/out.txt"))
    side.api.container_remove(cid, force=True)
    return {"seeded": seeded, "code": code,
            "host": (host_dir / "out.txt").read_bytes(), "archive": out}


def _exec(side: Side, cid: str, cmd: list[str]) -> tuple[dict, dict]:
    e = side.api.exec_create(cid, {"Cmd": cmd})
    s = side.api.exec_start(e["Id"], tty=False)
    out = bounded(lambda: by_stream(s.frames()))
    s.close()
    assert wait_for(lambda: not side.api.exec_inspect(e["Id"])["Running"])
    return out, side.api.exec_inspect(e["Id"])


def init_ran(side: Side, cid: str, cmd: list[str]) -> bool:
    """Whether the container's init has exec'd ``cmd``, so its set-up
    (mounts, ``pivot_root``, hostname, cwd) is over.  ``State.Pid`` is
    there as soon as ``start`` returns, while the shim (or the double's
    init) still sets the container up: an exec that joins it then sees
    the host's hostname, or no root at all."""
    want = ("\0".join(cmd) + "\0").encode()

    def ran() -> bool:
        pid = side.api.container_inspect(cid)["State"]["Pid"]
        try:
            return bool(pid) and \
                Path(f"/proc/{pid}/cmdline").read_bytes() == want
        except OSError:
            return False

    return wait_for(ran)


def case_exec(side: Side) -> dict:
    cid = create(side, "ex1", ["sleep", "15"], Hostname="exhost")
    side.api.container_start(cid)
    assert init_ran(side, cid, ["sleep", "15"])
    hostname = _exec(side, cid, ["sh", "-c", "hostname"])
    nine = _exec(side, cid, ["sh", "-c", "exit 9"])
    missing = http(side, "POST", "/exec/nope/start", {"Detach": False})
    bounded(lambda: side.api.container_stop(cid, timeout=1))
    state = side.api.container_inspect(cid)["State"]
    side.api.container_remove(cid, force=True)
    return {"hostname": hostname, "nine": nine, "missing": missing,
            "stopped": state}


def case_volumes_and_labels(side: Side, cmd: list[str]) -> dict:
    made = http(side, "POST", "/volumes/create",
                {"Name": "nsdvol1", "Labels": {"clawker.managed": "1"}})
    vols = side.api.volume_list(filters={"label": ["clawker.managed=1"]})
    cid = create(side, "vol1", cmd, HostConfig={"Binds": ["nsdvol1:/data"]},
                 Labels={"clawker.project": "nsdtest"})
    code = run_to_exit(side, cid)
    kept = members(side.api.get_archive(cid, "/data/keep.txt"))
    rows = side.api.container_list(
        all=True, filters={"label": ["clawker.project=nsdtest"]})
    busy = http(side, "DELETE", "/volumes/nsdvol1")
    side.api.container_remove(cid, force=True)
    freed = http(side, "DELETE", "/volumes/nsdvol1")
    return {"made": made, "volumes": vols, "code": code, "kept": kept,
            "rows": rows, "busy": busy, "freed": freed,
            "after": side.api.volume_list()}


def case_statuses(side: Side) -> dict:
    out = {}
    cid = create(side, "dup1", ["true"])
    out["duplicate"] = http(side, "POST", "/containers/create?name=dup1",
                            {"Image": IMAGE, "Cmd": ["true"]})
    out["no image"] = http(side, "POST", "/containers/create?name=x",
                           {"Image": "absent:1", "Cmd": ["true"]})
    out["missing"] = http(side, "GET", "/containers/definitely-missing/json")
    out["no path"] = http(side, "GET",
                          f"/containers/{cid}/archive?path=/no/such")
    out["rename unnamed"] = http(side, "POST", f"/containers/{cid}/rename")
    out["wait created"] = http(side, "POST", f"/containers/{cid}/wait")
    ro = side.base / "ro-src"
    ro.mkdir()
    rid = create(side, "ro1", ["true"],
                 HostConfig={"Binds": [f"{ro}:/cfg:ro"]})
    out["ro put"] = http(side, "PUT", f"/containers/{rid}/archive?path=/cfg",
                         raw=tar_of("evil.txt", b"x"))
    out["ro left"] = sorted(os.listdir(ro))
    for ref in (cid, rid):
        out.setdefault("removed", []).append(
            http(side, "DELETE", f"/containers/{ref}?force=1"))
    with pytest.raises(side.m.errors.NotFoundError):
        side.api.container_inspect("definitely-missing")
    return out


def case_concurrent(side: Side, n: int = 6) -> dict:
    """N lifecycles from parallel threads, each with its own exit code."""
    results: dict = {}

    def one(i: int) -> None:
        try:
            cid = create(side, f"race{i}",
                         ["sh", "-c", f"echo out-{i}; exit {10 + i}"])
            side.api.container_start(cid)
            code = side.api.container_wait(cid)["StatusCode"]
            raw = b"".join(side.api.container_logs(cid))
            side.api.container_remove(cid, force=True)
            results[i] = (code, by_stream(demux(raw)))
        except Exception as e:  # noqa: BLE001 - compared below
            results[i] = f"{e.__class__.__name__}: {e}"

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "daemon deadlock"
    left = [r["Names"][0] for r in side.api.container_list(all=True)
            if r["Names"][0].startswith("/race")]
    return {"results": [results.get(i) for i in range(n)], "left": left}


# ------------------------------------------------------- twins over the double


def test_ping_info_version(sides):
    got = twin(sides, case_ping_info_version)
    assert got["/_ping"] == (200, b"OK")
    assert got["/info"][1]["Name"] == "nsd"
    assert got["/version"][1]["ApiVersion"] == "1.43"
    assert got["/containers/nope/top"][0] == 404


def test_lifecycle_exit_code_and_framed_logs(sides):
    got = twin(sides, case_lifecycle)
    assert got["code"] == 3 and got["inspect"][1]["State"]["ExitCode"] == 3
    assert got["logs"] == {1: b"out-line\n", 2: b"err-line\n"}
    assert [e["Action"] for e in got["events"]] == [
        "create", "start", "die", "destroy"]
    assert got["gone"][0] == 404


def test_inspect_names_each_containers_cgroup_dir(cgroup_sides):
    """Given a cgroup root, a container's inspect names its cgroup dir
    under it (``NsdCgroupDir``, which the firewall's resolver reads):
    the same in both packages once each side's root is masked, as the
    tier B twins compare it."""
    got = twin(cgroup_sides, case_lifecycle)
    assert got["created"][1]["NsdCgroupDir"] == "<cgroup>/<hex>"
    assert got["inspect"][1]["NsdCgroupDir"] == "<cgroup>/<hex>"
    assert got["code"] == 3


def test_attach_stdin_and_archive_before_start(sides):
    got = twin(sides, case_attach_and_archive_before_start,
               ["sh", "-c", "read l; echo got:$l; cat f.txt"],
               WorkingDir="/seeded")
    assert got["attached"] == {1: b"got:over-stdin\nseeded-content\n"}
    assert got["code"] == 0


def test_archive_maps_bind_shadowed_paths(sides):
    got = twin(sides, case_archive_binds,
               ["sh", "-c", "cat work/in.txt > work/out.txt"])
    assert got["seeded"] == got["host"] == b"bind-routed\n"
    assert got["archive"][0][3] == b"bind-routed\n"


def test_exec_with_exit_code(sides):
    got = twin(sides, case_exec)
    assert got["hostname"][0] == {1: (socket.gethostname() + "\n").encode()}
    assert got["nine"][1] == {"ExitCode": 9, "Running": False}
    assert got["missing"][0] == 404
    # the double's init is the command, which SIGTERM ends (a namespace
    # init ignores it, and the grace period's SIGKILL gives 137)
    assert got["stopped"]["ExitCode"] == 128 + signal.SIGTERM


def test_volumes_and_label_filters(sides):
    got = twin(sides, case_volumes_and_labels,
               ["sh", "-c", "echo kept > data/keep.txt"])
    assert got["code"] == 0 and got["kept"][0][3] == b"kept\n"
    assert [v["Name"] for v in got["volumes"]["Volumes"]] == ["nsdvol1"]
    assert got["busy"][0] == 409 and got["freed"] == (204, None)


def test_conflict_and_not_found_map_to_http_statuses(sides):
    got = twin(sides, case_statuses)
    assert got["duplicate"][0] == 409 and "already in use" in \
        got["duplicate"][1]["message"]
    assert got["missing"][0] == got["no image"][0] == got["no path"][0] \
        == 404
    assert got["ro put"][0] == 403 and got["ro left"] == []


def test_concurrent_lifecycles_do_not_interfere(sides):
    got = twin(sides, case_concurrent)
    assert got["results"] == [(10 + i, {1: f"out-{i}\n".encode()})
                              for i in range(6)]
    assert got["left"] == []


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_socket_modes_are_restrictive_at_bind(tmp_path, pkg):
    """0600 socket, 0700 parent, under a permissive umask, and the umask
    given back -- both packages, one daemon at a time."""
    m = PKGS[pkg]
    sock_dir = tmp_path / "run" / "clawker-nsd"
    old = os.umask(0o022)
    try:
        daemon = m.server.NsDaemon(tmp_path / "state", sock_dir / "nsd.sock",
                                   cgroup_root="")
        t = threading.Thread(target=daemon.serve, daemon=True)
        t.start()
        try:
            assert wait_for(lambda: daemon._server_sock is not None)
            assert ((sock_dir / "nsd.sock").stat().st_mode & 0o777) == 0o600
            assert (sock_dir.stat().st_mode & 0o777) == 0o700
            assert os.umask(0o022) == 0o022
        finally:
            daemon.shutdown()
            t.join(5)
    finally:
        os.umask(old)


# --------------------------------------------- twins of tests/test_nsd_ro.py


def _ro_runtime(m, tmp_path, monkeypatch):
    rt = m.runtime.NsRuntime(tmp_path / "state")
    # no overlayfs: archive resolution needs only the merged dir
    monkeypatch.setattr(m.runtime.NsRuntime, "_mount_overlay",
                        lambda self, c: None)
    return rt


def _ro_container(m, tmp_path, binds: list[str]):
    cdir = tmp_path / "ctr"
    (cdir / "merged").mkdir(parents=True)
    return m.runtime.NsContainer(
        id="c" * 64, name="ro-test", cgroup_dir=None, dir=cdir,
        config={"Image": "busybox", "HostConfig": {"Binds": binds}})


def _ro_twin(tmp_path, monkeypatch, case):
    """``case(m, runtime, base)`` in each package's own directory; the
    results, with the directory masked, agree; -> the reference's."""
    got = {}
    for tag, m in PKGS.items():
        base = tmp_path / tag
        base.mkdir()
        got[tag] = mask(case(m, _ro_runtime(m, base, monkeypatch), base),
                        base)
    assert got["port"] == got["ref"]
    return got["ref"]


def _raised(fn) -> tuple | None:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by the twin
        return type(e).__name__, str(e)
    return None


def test_put_archive_refuses_ro_bind(tmp_path, monkeypatch):
    def case(m, rt, base):
        src = base / "host-src"
        src.mkdir()
        c = _ro_container(m, base, [f"{src}:/cfg:ro"])
        return [_raised(lambda: rt.put_archive(c, "/cfg", tar_of(
                    "evil.txt", b"write-through\n"))),
                _raised(lambda: rt.put_archive(c, "/cfg/sub/dir",
                                               tar_of("evil.txt", b"x"))),
                sorted(os.listdir(src))]

    got = _ro_twin(tmp_path, monkeypatch, case)
    assert got[0][0] == got[1][0] == "PermissionError" and got[2] == []
    assert "read-only" in got[0][1]


def test_put_archive_still_writes_rw_bind_and_overlay(tmp_path, monkeypatch):
    def case(m, rt, base):
        src = base / "host-rw"
        src.mkdir()
        (base / "ro-src").mkdir()
        c = _ro_container(m, base, [f"{src}:/work", f"{base / 'ro-src'}:/cfg:ro"])
        rt.put_archive(c, "/work", tar_of("in.txt", b"bind-routed\n"))
        rt.put_archive(c, "/plain", tar_of("f.txt", b"overlay\n"))
        return [(src / "in.txt").read_bytes(),
                (c.merged / "plain" / "f.txt").read_bytes()]

    assert _ro_twin(tmp_path, monkeypatch, case) == [b"bind-routed\n",
                                                     b"overlay\n"]


def test_get_archive_reads_through_ro_bind(tmp_path, monkeypatch):
    def case(m, rt, base):
        src = base / "host-ro"
        src.mkdir()
        (src / "f.txt").write_bytes(b"readable\n")
        c = _ro_container(m, base, [f"{src}:/cfg:ro"])
        return members(rt.get_archive(c, "/cfg/f.txt"))

    got = _ro_twin(tmp_path, monkeypatch, case)
    assert [(name, data) for name, _, _, data in got] == [("f.txt",
                                                           b"readable\n")]


def test_resolver_reports_ro_of_longest_matching_bind(tmp_path, monkeypatch):
    def case(m, rt, base):
        ro_src, rw_src = base / "ro", base / "rw"
        ro_src.mkdir(), rw_src.mkdir()
        c = _ro_container(m, base, [f"{ro_src}:/data:ro", f"{rw_src}:/data/rw"])
        return [[str(x) if isinstance(x, Path) else x
                 for x in rt._resolve_in_rootfs(c, path)]
                for path in ("/data/rw/x", "/data/other")] + [
                _raised(lambda: rt._resolve_in_rootfs(c, "/../../etc"))]

    got = _ro_twin(tmp_path, monkeypatch, case)
    assert got[0] == ["<base>/rw", "<base>/rw/x", False]
    assert got[1] == ["<base>/ro", "<base>/ro/other", True]


def _remount_calls(m, monkeypatch, fail) -> tuple[list, tuple | None]:
    calls: list = []

    def fake_mount(src, dst, fstype, flags, data=""):
        calls.append((dst, flags))
        fail(flags)

    monkeypatch.setattr(m.shim, "_mount", fake_mount)
    raised = None
    try:
        m.shim._remount_ro("/t")
    except OSError as e:
        raised = (e.errno, str(e))
    return calls, raised


@pytest.mark.parametrize("kernel", ["einval", "eperm", "supported"],
                         ids=["retries_without_ms_rec_on_einval",
                              "propagates_non_einval",
                              "single_call_when_supported"])
def test_shim_ro_remount(monkeypatch, kernel):
    """The shim's read-only remount: retried without ``MS_REC`` where the
    kernel says EINVAL to it, any other error raised, one call where the
    kernel takes it -- the same calls and errors in both packages."""
    assert (port_shim.MS_BIND, port_shim.MS_REMOUNT, port_shim.MS_RDONLY,
            port_shim.MS_REC) == (ref_shim.MS_BIND, ref_shim.MS_REMOUNT,
                                  ref_shim.MS_RDONLY, ref_shim.MS_REC)
    s = port_shim

    def fail(flags):
        if kernel == "eperm":
            raise OSError(errno.EPERM, "not allowed")
        if kernel == "einval" and flags & s.MS_REMOUNT and flags & s.MS_REC:
            raise OSError(errno.EINVAL, "older kernel: no recursive ro "
                                        "bind remount")

    got = {tag: _remount_calls(m, monkeypatch, fail)
           for tag, m in PKGS.items()}
    assert got["port"] == got["ref"]
    calls, raised = got["ref"]
    full = s.MS_BIND | s.MS_REMOUNT | s.MS_RDONLY | s.MS_REC
    if kernel == "einval":
        assert calls == [("/t", full), ("/t", full & ~s.MS_REC)]
        assert raised is None
    elif kernel == "eperm":
        assert calls == [("/t", full)] and raised[0] == errno.EPERM
    else:
        assert calls == [("/t", full)] and raised is None


# ------------------------------------------------------------- the driver


def test_driver_does_not_answer_on_a_missing_socket(tmp_path):
    for m in PKGS.values():
        drv = m.nsdriver.NsdDriver(docker_host=f"unix://{tmp_path}/none.sock")
        assert drv._answers() is False and drv._proc is None


def test_driver_refuses_to_spawn_where_nsd_cannot_run(tmp_path, monkeypatch):
    said = {}
    for tag, m in PKGS.items():
        monkeypatch.setattr(m.nsdriver, "nsd_capable", lambda: False)
        drv = m.nsdriver.NsdDriver(docker_host=f"unix://{tmp_path}/{tag}.sock")
        with pytest.raises(m.errors.DriverError) as ei:
            drv.connect()
        said[tag] = str(ei.value)
        assert drv._proc is None and not (tmp_path / f"{tag}.sock").exists()
    assert said["port"] == said["ref"] == (
        "nsd driver needs root + unshare/nsenter (namespace runtime)")


@pytest.mark.skipif(os.geteuid() != 0,
                    reason="the daemon's entry point runs as root only")
def test_driver_spawns_its_own_daemon_and_it_is_stopped(tmp_path, double,
                                                        monkeypatch):
    """With no daemon answering, ``connect`` spawns the package's own
    ``python -m <package>.nsd`` (the double stands in for the kernel's
    tools, and the interpreter gives the daemon no cgroup root) and
    rides it; the process is terminated at teardown."""
    monkeypatch.setattr(sys, "executable", str(
        python_without_cgroups(tmp_path / "bin" / "python")))
    seen = {}
    for tag, m in PKGS.items():
        sock = tmp_path / tag / "nsd.sock"
        monkeypatch.setenv(m.nsdriver.ENV_STATE, str(tmp_path / tag / "state"))
        drv = m.nsdriver.NsdDriver(docker_host=f"unix://{sock}")
        try:
            workers = drv.connect()
            proc = drv._proc
            assert proc is not None and proc.poll() is None
            argv = Path(f"/proc/{proc.pid}/cmdline").read_bytes().split(b"\0")
            at = argv.index(b"-m")
            api = drv._api_unchecked()
            list(api.image_pull(IMAGE))
            cid = api.container_create("cg1", {"Image": IMAGE,
                                               "Cmd": ["true"]})["Id"]
            cgroup_dir = api.container_inspect(cid)["NsdCgroupDir"]
            api.container_remove(cid, force=True)
            api.close()
            seen[tag] = ([w.id for w in workers], workers[0].engine.ping(),
                         argv[at:at + 2], (sock.stat().st_mode & 0o777),
                         drv._answers(), cgroup_dir)
        finally:
            if drv._proc is not None:
                drv._proc.terminate()
                try:
                    drv._proc.wait(10)
                except subprocess.TimeoutExpired:
                    drv._proc.kill()
                    drv._proc.wait(5)
            drv.close()
    assert seen["ref"][2] == [b"-m", b"clawker_tpu.nsd"]
    assert seen["port"][2] == [b"-m", b"clawker_tpu_torch.nsd"]
    assert seen["port"][:2] == seen["ref"][:2] == (["local-0"], True)
    assert seen["port"][3:] == seen["ref"][3:] == (0o600, True, "")


def test_entry_point_as_non_root_exits_1(tmp_path):
    """``python -m <package>.nsd`` with ``geteuid`` made non-root: exit 1
    with the reference's text, and no socket."""
    got = {}
    for tag, m in PKGS.items():
        sock = tmp_path / tag / "nsd.sock"
        code = ("import os, runpy, sys\n"
                "os.geteuid = lambda: 1000\n"
                f"sys.argv = ['nsd', '--socket', {str(sock)!r}, "
                f"'--state-dir', {str(tmp_path / tag / 'state')!r}]\n"
                f"runpy.run_module({m.module!r}, run_name='__main__', "
                "alter_sys=True)\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                              capture_output=True, text=True, timeout=60,
                              env=dict(os.environ, PYTHONPATH=str(
                                  Path(__file__).resolve().parents[1])))
        got[tag] = (proc.returncode, proc.stderr, sock.exists())
    assert got["port"] == got["ref"] == (
        1, "nsd: must run as root (namespaces + overlay + cgroups)\n", False)
