"""The port's Docker HTTP client against the reference's.

Every twin runs the same scenario through both packages: the reference's
``HTTPDockerAPI`` over the reference's ``StubDockerDaemon``, and the
port's over the port's, each on its own unix socket.  The pool cases
are tests/test_engine_pool.py's 18, each giving the same dial, reuse,
retry and daemon counts (or the same invariants where thread timing
sets the counts) and the same exception classes.  The wire twin drives
one sequence of ``Engine`` calls through each package's client against
its own ``FakeEngineDaemon`` (the port's test daemon, which serves a
``FakeDockerAPI`` over HTTP/1.1) and compares the request logs and the
results; the daemon's mapped statuses read back as the exception
classes the fake raises directly; a stream (``image_pull``) and an
``exec`` hijack cross the socket.
"""

from __future__ import annotations

import re
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.engine.api as ref_api
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.engine.httpapi as ref_httpapi
import clawker_tpu.errors as ref_errors
import clawker_tpu.testenv as ref_testenv
import clawker_tpu.util.phases as ref_phases
import clawker_tpu_torch.engine as port_engine
import clawker_tpu_torch.engine.api as port_api
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.engine.httpapi as port_httpapi
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.testenv as port_testenv
import clawker_tpu_torch.util.phases as port_phases
from clawker_tpu_torch.testenv import FakeEngineDaemon

PKGS = {
    "ref": SimpleNamespace(httpapi=ref_httpapi, api=ref_api, fake=ref_fake,
                           drivers=ref_drivers, errors=ref_errors,
                           testenv=ref_testenv, phases=ref_phases),
    "port": SimpleNamespace(httpapi=port_httpapi, api=port_api,
                            fake=port_fake, drivers=port_drivers,
                            errors=port_errors, testenv=port_testenv,
                            phases=port_phases),
}


def _client(m, sock, **kw):
    timeout = kw.pop("timeout", None)
    factory = (m.httpapi.unix_socket_factory(sock) if timeout is None
               else m.httpapi.unix_socket_factory(sock, timeout=timeout))
    return m.httpapi.HTTPDockerAPI(factory, **kw)


def _counting(m, sock):
    base = m.httpapi.unix_socket_factory(sock)
    dials = [0]

    def factory():
        dials[0] += 1
        return base()

    return factory, dials


def _raises(fn) -> str:
    """The class name of what ``fn`` raised, with its message's head."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- compared across packages
        return f"{type(e).__name__}: {str(e).split(':')[0]}"
    return ""


# ------------------------------------------------------- the pool's cases
# Each case: (package, scratch dir) -> its observables.  Its twin asserts
# the two packages agree and that the reference test's expectations hold.


def _stub(m, d: Path, **kw):
    return m.testenv.StubDockerDaemon(d / "stub.sock", **kw).start()


def case_sequential_reuse(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path)
        for _ in range(6):
            api.info()
        s = api.pool_stats()
        api.close()
        return {"dials": s["dials"], "reuses": s["reuses"],
                "connections": daemon.connections,
                "requests": daemon.requests}
    finally:
        daemon.stop()


def case_pool_disabled(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path, pool_max_idle=0)
        for _ in range(4):
            api.info()
        s = api.pool_stats()
        api.close()
        return {"dials": s["dials"], "reuses": s["reuses"],
                "connections": daemon.connections}
    finally:
        daemon.stop()


def case_concurrent_lanes(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path)
        errors: list = []

        def lane():
            try:
                for _ in range(10):
                    api.container_inspect("c1")
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=lane) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        s = api.pool_stats()
        api.close()
        return {"errors": len(errors),
                "dials+reuses": s["dials"] + s["reuses"],
                "dials<=lanes": s["dials"] <= 8,
                "requests": daemon.requests}
    finally:
        daemon.stop()


def case_stale_retry(m, d):
    daemon = _stub(m, d, max_requests_per_conn=1)
    try:
        api = _client(m, daemon.sock_path)
        ok = [api.info() is not None for _ in range(3)]
        s = api.pool_stats()
        api.close()
        return {"ok": ok, "stale_retries": s["stale_retries"],
                "dials": s["dials"]}
    finally:
        daemon.stop()


def case_non_idempotent_not_resent(m, d):
    daemon = _stub(m, d, max_requests_per_conn=1)
    try:
        api = _client(m, daemon.sock_path)
        api.info()
        raised = _raises(lambda: api.container_kill("c1"))
        s = api.pool_stats()
        out = {"raised": raised, "stale_retries": s["stale_retries"],
               "suppressed_retries": s["suppressed_retries"],
               "dials": s["dials"], "requests": daemon.requests}
        out["after"] = api.info() is not None
        api.close()
        return out
    finally:
        daemon.stop()


def case_first_dial_failure(m, d):
    d.mkdir(parents=True, exist_ok=True)
    factory, dials = _counting(m, d / "nothing-listens-here.sock")
    api = m.httpapi.HTTPDockerAPI(factory)
    raised = _raises(api.info)
    return {"raised": raised, "dials": dials[0],
            "stale_retries": api.pool_stats()["stale_retries"]}


def case_truncated_response(m, d):
    daemon = _stub(m, d, truncate_after=1)
    try:
        api = _client(m, daemon.sock_path)
        api.info()
        raised = _raises(lambda: api.container_kill("c1"))
        s = api.pool_stats()
        api.close()
        return {"raised": raised, "stale_retries": s["stale_retries"],
                "dials": s["dials"], "requests": daemon.requests}
    finally:
        daemon.stop()


def case_slow_daemon(m, d):
    daemon = _stub(m, d, delay_after=1, response_delay_s=1.0)
    try:
        api = _client(m, daemon.sock_path, timeout=0.2)
        api.info()
        raised = _raises(lambda: api.container_kill("c1"))
        s = api.pool_stats()
        api.close()
        return {"raised": raised, "stale_retries": s["stale_retries"],
                "dials": s["dials"], "requests": daemon.requests}
    finally:
        daemon.stop()


def case_stale_retry_dial_fails(m, d):
    daemon = _stub(m, d)
    factory, dials = _counting(m, daemon.sock_path)
    api = m.httpapi.HTTPDockerAPI(factory)
    api.info()
    daemon.stop()
    raised = _raises(api.info)
    return {"raised": raised,
            "stale_retries": api.pool_stats()["stale_retries"],
            "dials": dials[0]}


def case_streams_unpooled(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path)
        api.info()
        idle0 = api.pool_stats()["idle"]
        list(api.container_logs("c1"))
        stream = api.container_attach("c1", tty=True)
        stream.close()
        list(api.events())
        s = api.pool_stats()
        api.close()
        return {"idle0": idle0, "idle": s["idle"], "dials": s["dials"],
                "reuses": s["reuses"]}
    finally:
        daemon.stop()


def case_blocking_ops_dedicated(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path)
        api.container_wait("c1")
        api.container_stop("c1")
        s = api.pool_stats()
        api.info()
        idle = api.pool_stats()["idle"]
        api.close()
        return {"idle": s["idle"], "dials": s["dials"], "idle_after": idle}
    finally:
        daemon.stop()


def case_stream_socket_unbounded(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path)
        conn = api._pool.dedicated()
        unbounded = conn.sock.gettimeout() is None
        conn.close()
        conn2, _ = api._pool.checkout()
        conn2.connect()
        bounded = conn2.sock.gettimeout() is not None
        conn2.close()
        api.close()
        return {"dedicated_unbounded": unbounded, "pooled_bounded": bounded}
    finally:
        daemon.stop()


def case_ttl_reaped(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path, pool_idle_ttl=0.05)
        api.info()
        time.sleep(0.12)
        api.info()
        s = api.pool_stats()
        api.close()
        return {"dials": s["dials"], "reuses": s["reuses"]}
    finally:
        daemon.stop()


def case_close_drains(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path)
        api.info()
        idle0 = api.pool_stats()["idle"]
        api.close()
        idle1 = api.pool_stats()["idle"]
        api.info()
        return {"idle": [idle0, idle1, api.pool_stats()["idle"]]}
    finally:
        daemon.stop()


def case_engine_pass_through(m, d):
    daemon = _stub(m, d)
    try:
        eng = m.api.Engine(_client(m, daemon.sock_path))
        ok = eng.ping()
        dials = eng.pool_stats()["dials"]
        eng.close()
        return {"ping": ok, "dials": dials,
                "idle": eng.pool_stats()["idle"]}
    finally:
        daemon.stop()


def case_fake_close_surface(m, d):
    eng = m.api.Engine(m.fake.FakeDockerAPI())
    stats = eng.pool_stats()
    eng.close()
    return {"stats": stats, "closed": bool(eng.api.calls_named("close"))}


def case_fake_driver_close(m, d):
    drv = m.drivers.FakeDriver(n_workers=2)
    drv.close()
    return {"closed": [bool(api.calls_named("close")) for api in drv.apis]}


def case_dials_on_stopwatch(m, d):
    daemon = _stub(m, d)
    try:
        api = _client(m, daemon.sock_path)
        m.phases.enable()
        try:
            for _ in range(3):
                api.info()
            counts = m.phases.counts()
        finally:
            totals = m.phases.disable()
        api.close()
        return {"timed": totals.get("engine.dial", 0) > 0,
                "dial_count": counts.get("engine.dial")}
    finally:
        daemon.stop()


UNREACHABLE = "DriverError: daemon unreachable (GET /info)"
POOL_CASES = {
    "sequential_reuse": (case_sequential_reuse, {
        "dials": 1, "reuses": 5, "connections": 1, "requests": 6}),
    "pool_disabled": (case_pool_disabled, {
        "dials": 4, "reuses": 0, "connections": 4}),
    "concurrent_lanes": (case_concurrent_lanes, {
        "errors": 0, "dials+reuses": 80, "dials<=lanes": True,
        "requests": 80}),
    "stale_retry": (case_stale_retry, {
        "ok": [True] * 3, "stale_retries": 2, "dials": 3}),
    "non_idempotent_not_resent": (case_non_idempotent_not_resent, {
        "raised": "DriverError: daemon unreachable (POST /containers/c1/kill)",
        "stale_retries": 0, "suppressed_retries": 1, "dials": 1,
        "requests": 1, "after": True}),
    "first_dial_failure": (case_first_dial_failure, {
        "raised": UNREACHABLE, "dials": 1, "stale_retries": 0}),
    "truncated_response": (case_truncated_response, {
        "raised": "DriverError: daemon unreachable (POST /containers/c1/kill)",
        "stale_retries": 0, "dials": 1, "requests": 2}),
    "slow_daemon": (case_slow_daemon, {
        "raised": "DriverError: daemon unreachable (POST /containers/c1/kill)",
        "stale_retries": 0, "dials": 1, "requests": 2}),
    "stale_retry_dial_fails": (case_stale_retry_dial_fails, {
        "raised": UNREACHABLE, "stale_retries": 1, "dials": 2}),
    "streams_unpooled": (case_streams_unpooled, {
        "idle0": 1, "idle": 1, "dials": 4, "reuses": 0}),
    "blocking_ops_dedicated": (case_blocking_ops_dedicated, {
        "idle": 0, "dials": 2, "idle_after": 1}),
    "stream_socket_unbounded": (case_stream_socket_unbounded, {
        "dedicated_unbounded": True, "pooled_bounded": True}),
    "ttl_reaped": (case_ttl_reaped, {"dials": 2, "reuses": 0}),
    "close_drains": (case_close_drains, {"idle": [1, 0, 0]}),
    "engine_pass_through": (case_engine_pass_through, {
        "ping": True, "dials": 1, "idle": 0}),
    "fake_close_surface": (case_fake_close_surface, {
        "stats": {"dials": 0, "reuses": 0, "stale_retries": 0,
                  "suppressed_retries": 0, "idle": 0}, "closed": True}),
    "fake_driver_close": (case_fake_driver_close, {"closed": [True, True]}),
    "dials_on_stopwatch": (case_dials_on_stopwatch, {
        "timed": True, "dial_count": 1}),
}


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_pool_case_matches_reference(name, tmp_path):
    fn, want = POOL_CASES[name]
    ref = fn(PKGS["ref"], tmp_path / "ref")
    port = fn(PKGS["port"], tmp_path / "port")
    assert ref == want
    assert port == ref


def test_port_engine_exports_the_client():
    assert port_engine.HTTPDockerAPI is port_httpapi.HTTPDockerAPI
    assert port_engine.APIError.__name__ == "APIError"
    assert port_engine.ConnectionPool.__module__.endswith("engine.pool")
    assert port_httpapi.IDEMPOTENT_METHODS == ref_httpapi.IDEMPOTENT_METHODS


# ----------------------------------------------------------- the wire twin

IMAGE = "clawker-wire:default"
_ID = re.compile(r"[0-9a-f]{32,64}")


def _fake(m):
    api = port_fake.FakeDockerAPI()
    api.add_image(IMAGE)
    api.add_image("busybox:1")
    api.set_behavior(IMAGE, port_fake.exit_behavior(b"wire\n", 3, delay=0.05))
    api.exec_handler = lambda c, cmd: (0, f"ran {' '.join(cmd)}\n".encode())
    return api


def _norm(x):
    """Ids are random per run: each reads ``<id>``."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()
                if k not in ("time", "Created")}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    if isinstance(x, str):
        return _ID.sub("<id>", x)
    return x


def _wire_sequence(m, eng) -> dict:
    """One sequence of Engine calls over every route the daemon serves;
    -> each step's result."""
    spec = m.api.ContainerSpec(image=IMAGE, cmd=["run"], env={"A": "1"},
                               labels={"dev.clawker.agent": "a1"})
    name, out = "clawker.wire.a1", {}
    out["ping"] = eng.ping()
    out["info"] = eng.info()["Name"]
    out["version"] = eng.api.version()
    out["create"] = len(eng.create_container(name, spec))
    out["inspect"] = eng.inspect_container(name)["State"]
    out["list"] = eng.list_containers(all=True)
    eng.put_archive(name, "/home/agent", b"tar" * 100)
    out["archive"] = eng.get_archive(name, "/home/agent")
    eng.start_container(name)
    eng.resize_container(name, 40, 120)
    out["exec"] = eng.run_exec(name, ["echo", "hi"])
    out["wait"] = eng.wait_container(name)
    eng.rename_container(name, "clawker.wire.a2")
    out["images"] = eng.list_images()
    out["image"] = eng.inspect_image(IMAGE)["RepoTags"]
    out["pull"] = list(eng.pull_image("busybox:2"))
    out["volume"] = eng.ensure_volume("clawker.wire.vol", {"x": "1"})
    out["volumes"] = eng.list_volumes()
    out["network"] = eng.ensure_network("clawker-wire-net")
    out["networks"] = eng.api.network_list()
    eng.connect_network("clawker-wire-net", "clawker.wire.a2",
                        ipv4="172.28.0.77")
    eng.api.network_disconnect("clawker-wire-net", "clawker.wire.a2")
    out["404"] = _raises(lambda: eng.inspect_container("clawker.wire.none"))
    out["409"] = _raises(lambda: eng.create_container("clawker.wire.a2",
                                                      spec))
    eng.remove_container("clawker.wire.a2", force=True, volumes=True)
    eng.remove_network("clawker-wire-net")
    out["left"] = eng.list_containers(all=True)
    return out


def test_wire_twin_same_requests_and_results(tmp_path):
    results, logs = {}, {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        with FakeEngineDaemon(tmp_path / f"{pkg}.sock", _fake(m)) as daemon:
            eng = m.api.Engine(_client(m, daemon.sock_path))
            results[pkg] = _norm(_wire_sequence(m, eng))
            results[pkg]["stale_retries"] = eng.pool_stats()["stale_retries"]
            eng.close()
            assert daemon.unrouted == []
            logs[pkg] = [_norm(list(r)) for r in daemon.log]
    assert results["port"] == results["ref"]
    assert logs["port"] == logs["ref"]
    got = results["port"]
    # the exec's hijacked output, the archive and the stream crossed
    assert got["exec"] == (0, b"ran echo hi\n")
    assert got["archive"] == b"tar" * 100
    assert got["wait"] == 3
    assert got["pull"][-1] == {"status": "Download complete"}
    assert got["404"].startswith("NotFoundError")
    assert got["409"].startswith("ConflictError")
    assert got["left"] == [] and got["stale_retries"] == 0


def test_wire_results_match_the_fake_directly(tmp_path):
    """What the port's client reads over the socket is what the fake
    returns in process (ids and timestamps aside)."""
    direct = _norm(_wire_sequence(PKGS["port"],
                                  port_api.Engine(_fake(None))))
    with FakeEngineDaemon(tmp_path / "e.sock", _fake(None)) as daemon:
        eng = port_api.Engine(_client(PKGS["port"], daemon.sock_path))
        wired = _norm(_wire_sequence(PKGS["port"], eng))
        eng.close()
    # the daemon hands the fake the tag the client splits off, which the
    # fake's first pull line echoes; everything else is equal
    assert wired.pop("pull")[1:] == direct.pop("pull")[1:]
    assert wired == direct


@pytest.mark.parametrize("status,cls", [(404, "NotFoundError"),
                                        (409, "ConflictError"),
                                        (500, "DriverError")])
def test_mapped_errors_are_the_fakes_classes(tmp_path, status, cls):
    fail = {404: port_errors.NotFoundError("No such container: x"),
            409: port_errors.ConflictError("container name x already in use"),
            500: port_errors.DriverError("daemon on fire")}[status]
    api = _fake(None)
    api.fail_next["container_inspect"] = fail
    with pytest.raises(type(fail)) as direct:
        api.container_inspect("x")
    got = {}
    with FakeEngineDaemon(tmp_path / "e.sock", api) as daemon:
        for pkg in ("ref", "port"):
            api.fail_next["container_inspect"] = fail
            client = _client(PKGS[pkg], daemon.sock_path)
            with pytest.raises(PKGS[pkg].errors.ClawkerError) as raised:
                client.container_inspect("x")
            got[pkg] = (type(raised.value).__name__, str(raised.value))
            client.close()
    assert got["ref"] == got["port"] == (cls, str(direct.value))


def test_unrouted_requests_get_a_loud_404(tmp_path):
    with FakeEngineDaemon(tmp_path / "e.sock", _fake(None)) as daemon:
        client = _client(PKGS["port"], daemon.sock_path)
        with pytest.raises(port_errors.NotFoundError, match="no route"):
            client.container_pause("c1")
        client.close()
    assert daemon.unrouted == [("POST", "/containers/c1/pause")]


def test_image_pull_streams_and_exec_hijack(tmp_path):
    api = _fake(None)
    api.add_image("echo:1")
    api.set_behavior("echo:1", port_fake.echo_behavior)
    with FakeEngineDaemon(tmp_path / "e.sock", api) as daemon:
        client = _client(PKGS["port"], daemon.sock_path)
        pulled = list(client.image_pull("busybox:3"))
        assert pulled == list(_fake(None).image_pull("busybox:3"))
        assert "busybox:3" in api.images
        cid = client.container_create("echo", {"Image": "echo:1",
                                               "Tty": True})["Id"]
        client.container_start(cid)
        # a TTY attach: raw bytes both ways
        stream = client.container_attach(cid, tty=True)
        stream.write(b"over the wire\n")
        assert stream.read() == b"over the wire\n"
        stream.close_write()
        stream.close()
        # a non-TTY exec: framed stdout, exit code by exec inspect
        eid = client.exec_create(cid, {"Cmd": ["id"]})["Id"]
        frames = list(client.exec_start(eid).frames())
        assert frames == [(1, b"ran id\n")]
        assert client.exec_inspect(eid)["ExitCode"] == 0
        stats = client.pool_stats()
        client.close()
    # the pull, the attach and the exec start each rode their own socket
    assert stats["dials"] >= 4
    assert daemon.routes["exec_start"] == 1 and daemon.routes["image_pull"] == 1


def test_stop_ends_parked_waits(tmp_path):
    """A wait parked on an idle container fails fast once the daemon
    stops, instead of hanging its caller."""
    api = _fake(None)
    api.add_image("idle:1")
    daemon = FakeEngineDaemon(tmp_path / "e.sock", api).start()
    client = _client(PKGS["port"], daemon.sock_path)
    cid = client.container_create("idle", {"Image": "idle:1"})["Id"]
    client.container_start(cid)
    box = {}
    t = threading.Thread(target=lambda: box.update(
        raised=_raises(lambda: client.container_wait(cid))))
    t.start()
    assert _until(lambda: daemon.routes["container_wait"] == 1)
    daemon.stop()
    t.join(5)
    assert not t.is_alive()
    assert box["raised"].startswith("DriverError")
    api.container_kill(cid)


def _until(pred, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()
