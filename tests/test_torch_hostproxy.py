"""The port's host proxy and daemon lifecycle against the reference's.

Twins of tests/test_hostproxy.py (the proxy's routes over a live HTTP
server on loopback, with the browser and ``git credential fill`` seamed;
the zone rule; the scripts; the manager spawning the real daemon) and of
tests/test_daemonutil.py (the phase stopwatch and the health cache).
Each twin drives both packages with the same inputs and holds the
port's answers to the reference's.  The reference's dockerfile check
(``test_scripts_baked_into_harness_dockerfile``) needs the image
bundler, which waits for ROADMAP §1 items 12-13: its twin holds the
scripts the bundler would bake.

Last, the port's ``loop`` on default settings, the host proxy on (a
free port, so parallel test workers never share one): the bootstrap
starts ``python -m clawker_tpu_torch.hostproxy``, and the run agrees
with the reference's event for event.  Every test that starts a proxy
stops it in a ``finally``, and each test has its own time limit.
"""

from __future__ import annotations

import contextlib
import json
import socket
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.config as ref_config
import clawker_tpu.config.schema as ref_schema
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.hostproxy.manager as ref_manager
import clawker_tpu.hostproxy.scripts as ref_scripts
import clawker_tpu.hostproxy.server as ref_server
import clawker_tpu.loop as ref_loop
import clawker_tpu.util.daemon as ref_daemon
import clawker_tpu.util.phases as ref_phases
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.hostproxy.manager as port_manager
import clawker_tpu_torch.hostproxy.scripts as port_scripts
import clawker_tpu_torch.hostproxy.server as port_server
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.util.daemon as port_daemon
import clawker_tpu_torch.util.phases as port_phases
from clawker_tpu import consts
from clawker_tpu.testenv import TestEnv
from test_torch_loopd import _time_limit, free_port  # noqa: F401 -- fixture


PKGS = {
    "ref": SimpleNamespace(config=ref_config, schema=ref_schema,
                           server=ref_server, manager=ref_manager,
                           daemon=ref_daemon, phases=ref_phases,
                           drivers=ref_drivers, fake=ref_fake,
                           loop=ref_loop),
    "port": SimpleNamespace(config=port_config, schema=port_schema,
                            server=port_server, manager=port_manager,
                            daemon=port_daemon, phases=port_phases,
                            drivers=port_drivers, fake=port_fake,
                            loop=port_loop),
}


EGRESS_PROJECT = ("project: hp\n"
                  "security:\n"
                  "  egress:\n"
                  "    - dst: github.com\n"
                  "    - dst: '*.example.com'\n")


@pytest.fixture
def proxies():
    """The reference's and the port's proxy over one project config,
    each with its own seamed browser and credential store."""
    with TestEnv() as tenv:
        proj = tenv.base / "p"
        proj.mkdir()
        (proj / consts.PROJECT_FLAT_FORM).write_text(EGRESS_PROJECT)
        out = {}
        try:
            for pkg, m in PKGS.items():
                opened, fills = [], []

                def fake_open(url, opened=opened):
                    opened.append(url)
                    return True

                def fake_fill(request, fills=fills):
                    fills.append(request)
                    if "host=github.com" in request:
                        return ("protocol=https\nhost=github.com\n"
                                "username=bot\npassword=s3cret\n")
                    return ""

                p = m.server.HostProxy(m.config.load_config(proj), port=0,
                                       open_browser=fake_open,
                                       git_fill=fake_fill)
                p.start()
                out[pkg] = SimpleNamespace(proxy=p, opened=opened,
                                           fills=fills)
            yield out
        finally:
            for side in out.values():
                side.proxy.stop()


def call(p, method: str, path: str, body=None,
         content_type="application/json"):
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{p.bound_port}{path}", data=data, method=method,
        headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def both(proxies, *args, **kw) -> tuple:
    """The same request to both proxies: -> (reference's, port's)."""
    return (call(proxies["ref"].proxy, *args, **kw),
            call(proxies["port"].proxy, *args, **kw))


# ------------------------------------------------------------------ routes


def test_healthz(proxies):
    want, got = both(proxies, "GET", "/healthz")
    assert got == want
    assert got[0] == 200 and json.loads(got[1])["ok"]


def test_open_url_and_scheme_guard(proxies):
    for url, code in (("https://docs.example.com/x", 200),
                      ("file:///etc/passwd", 400),
                      ("javascript:alert(1)", 400)):
        want, got = both(proxies, "POST", "/open/url", {"url": url})
        assert got == want and got[0] == code
    assert proxies["port"].opened == proxies["ref"].opened == [
        "https://docs.example.com/x"]
    assert json.loads(got[1]) == json.loads(want[1])


def _oauth_roundtrip(p) -> list:
    """The reference test's steps on one proxy: -> what each step saw."""
    seen = []
    code, body = call(p, "POST", "/oauth/listen", {"port": 0})
    session = json.loads(body)
    seen.append((code, sorted(session)))
    seen.append(call(p, "GET", f"/oauth/poll?session={session['session']}"))
    with urllib.request.urlopen(
            f"http://127.0.0.1:{session['port']}/callback?code=abc123"
            "&state=xyz", timeout=5) as r:
        seen.append(b"Authentication complete" in r.read())
    code, body = call(p, "GET", f"/oauth/poll?session={session['session']}")
    seen.append((code, json.loads(body)))
    seen.append(call(p, "GET",
                     f"/oauth/poll?session={session['session']}")[0])
    # the callback listener is torn down (async close: poll briefly)
    deadline = time.time() + 5
    closed = False
    while time.time() < deadline and not closed:
        try:
            socket.create_connection(("127.0.0.1", session["port"]),
                                     timeout=0.5).close()
            time.sleep(0.05)
        except OSError:
            closed = True
    seen.append(closed)
    return seen


def test_oauth_capture_roundtrip(proxies):
    want = _oauth_roundtrip(proxies["ref"].proxy)
    got = _oauth_roundtrip(proxies["port"].proxy)
    assert got == want
    assert got == [(200, ["port", "session"]), (204, b""), True,
                   (200, {"path": "/callback",
                          "query": {"code": "abc123", "state": "xyz"}}),
                   404, True]


def test_oauth_unknown_session(proxies):
    want, got = both(proxies, "GET", "/oauth/poll?session=nope")
    assert got == want and got[0] == 404


def test_git_credential_fill_allowed_host(proxies):
    want, got = both(proxies, "POST", "/git/credential",
                     b"protocol=https\nhost=github.com\n\n",
                     content_type="text/plain")
    assert got == want and got[0] == 200 and b"password=s3cret" in got[1]
    # only protocol+host are forwarded to the host git (no injected keys)
    assert proxies["port"].fills == proxies["ref"].fills == [
        "protocol=https\nhost=github.com\n\n"]


def test_git_credential_denied_outside_egress(proxies):
    want, got = both(proxies, "POST", "/git/credential",
                     b"protocol=https\nhost=evil.net\n\n",
                     content_type="text/plain")
    assert got == want and got[0] == 403
    assert proxies["port"].fills == proxies["ref"].fills == []


def test_git_credential_requires_proto_host(proxies):
    for body in (b"host=github.com\n", b"protocol=ssh\nhost=github.com\n"):
        want, got = both(proxies, "POST", "/git/credential", body,
                         content_type="text/plain")
        assert got == want and got[0] == 400


@pytest.mark.parametrize("host", [
    "github.com", "sub.github.com", "api.example.com", "example.com",
    "badexample.com", "example.com.evil.net", "GitHub.com."])
def test_host_allowed_zone_semantics(host):
    def allowed(m):
        rules = [m.schema.EgressRule(dst="github.com"),
                 m.schema.EgressRule(dst="*.example.com")]
        return m.server._host_allowed(host, rules)

    assert allowed(PKGS["port"]) == allowed(PKGS["ref"])


def test_scripts_baked_into_harness_dockerfile():
    """The bundler that bakes the scripts into the harness image is not
    ported (ROADMAP §1 items 12-13); the scripts and their targets are
    the reference's."""
    assert port_scripts.CONTEXT_SCRIPTS == ref_scripts.CONTEXT_SCRIPTS
    assert [path for path, _ in port_scripts.CONTEXT_SCRIPTS.values()] == [
        consts.HOST_OPEN_PATH, consts.GIT_CREDENTIAL_HELPER_PATH,
        "/usr/local/bin/oauth-forward"]


# ----------------------------------------------------------------- manager


def _cmdline(pid: int) -> str:
    return Path(f"/proc/{pid}/cmdline").read_bytes().replace(
        b"\0", b" ").decode()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_manager_daemon_lifecycle(pkg):
    """Spawn the real daemon process, health it, stop it: the port's
    manager forks its own ``clawker_tpu_torch.hostproxy``."""
    m = PKGS[pkg]
    module = {"ref": "clawker_tpu.hostproxy",
              "port": "clawker_tpu_torch.hostproxy"}[pkg]
    with TestEnv() as tenv:
        tenv.write_settings(f"host_proxy:\n  port: {free_port()}\n")
        cfg = m.config.load_config(tenv.base)
        assert m.manager.health(cfg) is None
        try:
            m.manager.ensure_running(cfg)
            h = m.manager.health(cfg)
            assert h == {"ok": True, "sessions": 0}
            pid = int((cfg.state_dir / "hostproxy.pid").read_text())
            assert _cmdline(pid).endswith(f"-m {module} ")
            m.manager.ensure_running(cfg)  # idempotent
            assert int((cfg.state_dir / "hostproxy.pid").read_text()) == pid
        finally:
            assert m.manager.stop(cfg)
        deadline = time.time() + 5
        while m.manager.health(cfg) is not None and time.time() < deadline:
            time.sleep(0.1)
        assert m.manager.health(cfg) is None
        assert not (cfg.state_dir / "hostproxy.pid").exists()


def test_concurrent_spawns_leave_one_daemon():
    """The port's lanes call ``ensure_running`` at once on their first
    creates: one daemon comes up, and the pidfile names it."""
    import threading

    with TestEnv() as tenv:
        tenv.write_settings(f"host_proxy:\n  port: {free_port()}\n")
        cfg = port_config.load_config(tenv.base)
        errors = []

        def ensure():
            try:
                port_manager.ensure_running(cfg)
            except Exception as e:      # noqa: BLE001 -- reported below
                errors.append(e)

        threads = [threading.Thread(target=ensure) for _ in range(4)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            pid = int((cfg.state_dir / "hostproxy.pid").read_text())
            assert not errors
            assert _cmdline(pid).endswith("-m clawker_tpu_torch.hostproxy ")
        finally:
            assert port_manager.stop(cfg)
        deadline = time.time() + 5
        while port_manager.health(cfg) is not None and time.time() < deadline:
            time.sleep(0.1)
        assert port_manager.health(cfg) is None


# -------------------------------------------------------------- daemonutil


def _stopwatch(phases) -> tuple:
    with phases.phase("off"):
        pass
    before = "off" in phases.totals()
    phases.enable()
    for _ in range(3):
        with phases.phase("on"):
            pass
    out = phases.disable()
    counts = phases.counts()["on"]
    with phases.phase("off2"):
        pass
    return before, out["on"] >= 0, counts, "off2" in phases.totals()


def test_phases_stopwatch_accumulates_only_when_enabled():
    assert _stopwatch(port_phases) == _stopwatch(ref_phases) == (
        False, True, 3, False)


def _health_probes(dmod, tmp_path: Path) -> list:
    """The reference test's probe sequence on one package: -> each
    verdict and the probe count after it."""
    calls = []

    class FakeResp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return json.dumps({"ok": True}).encode()

    def live(url, timeout=0):
        calls.append(url)
        return FakeResp()

    def dead(url, timeout=0):
        calls.append(url)
        raise OSError("refused")

    spec = dmod.DaemonSpec(name="t", module="m", pidfile=tmp_path / "p",
                           logfile=tmp_path / "l",
                           health_url="http://127.0.0.1:1/healthz")
    seen = []
    real = dmod.urlrequest.urlopen
    dmod.invalidate_health_cache()
    try:
        for opener, ttl in ((live, 5.0), (live, 5.0), (live, 0.0),
                            (dead, 0.0), (dead, 5.0)):
            dmod.urlrequest.urlopen = opener
            seen.append((spec.health(cache_ttl_s=ttl), len(calls)))
    finally:
        dmod.urlrequest.urlopen = real
        dmod.invalidate_health_cache()
    return seen


def test_health_cache_reuses_positive_and_reprobes_negative(tmp_path):
    want = _health_probes(ref_daemon, tmp_path)
    assert _health_probes(port_daemon, tmp_path) == want == [
        ({"ok": True}, 1), ({"ok": True}, 1), ({"ok": True}, 2),
        (None, 3), (None, 4)]


# --------------------------------------------- loop on default settings


PROJECT = "twin"
IMAGE = f"clawker-{PROJECT}:default"
RUN_ID = "proxyrun0001"


@contextlib.contextmanager
def default_env(tmp_path: Path, tag: str):
    """A TestEnv on default settings but for a free proxy port and a
    disk watermark below any real disk (the flight recorder keeps every
    span); -> (TestEnv, project dir)."""
    tenv = TestEnv(base=tmp_path / tag)
    with tenv:
        tenv.write_settings(
            f"host_proxy:\n  port: {free_port()}\n"
            "loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
            "    hard_free_pct: 0.0005\n")
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text(f"project: {PROJECT}\n")
        yield tenv, proj


def run_default(pkg: str, tmp_path: Path) -> dict:
    m = PKGS[pkg]
    with default_env(tmp_path, pkg) as (tenv, proj):
        cfg = m.config.load_config(proj)
        assert cfg.settings.host_proxy.enable      # the default
        assert m.manager.health(cfg) is None
        # one worker: the reference's lanes race their first creates into
        # two proxy spawns on a multi-worker fake, and the loser's pid
        # overwrites the winner's in the pidfile (the port's spawn lock
        # repairs this; see test_concurrent_spawns_leave_one_daemon)
        drv = m.drivers.FakeDriver(n_workers=1)
        for api in drv.apis:
            api.add_image(IMAGE)
            api.set_behavior(IMAGE, m.fake.exit_behavior(b"done\n", 0))
        events = []
        try:
            sched = m.loop.LoopScheduler(
                cfg, drv, m.loop.LoopSpec(parallel=3, iterations=2),
                on_event=lambda a, e, d="": events.append((a, e)),
                run_id=RUN_ID)
            sched.start()
            sched.run(poll_s=0.02)
            status = sched.status()
            journal = [r["kind"] for r in
                       type(sched.journal).read(sched.journal.path)]
            sched.cleanup(remove_containers=True)
            health = m.manager.health(cfg)
            pid = int((cfg.state_dir / "hostproxy.pid").read_text())
            cmd = _cmdline(pid)
        finally:
            m.manager.stop(cfg)
        return {"status": status, "events": events, "journal": journal,
                "health": health, "cmd": cmd}


def test_loop_runs_on_default_settings_with_the_proxy_up(tmp_path):
    want = run_default("ref", tmp_path)
    got = run_default("port", tmp_path)
    assert got["status"] == want["status"]
    assert all(r["status"] == "done" and r["iteration"] == 2
               for r in got["status"])
    for agent in {a for a, _ in want["events"]}:
        assert [e for a, e in got["events"] if a == agent] == \
            [e for a, e in want["events"] if a == agent], agent
    assert sorted(got["journal"]) == sorted(want["journal"])
    assert got["health"] == want["health"] == {"ok": True, "sessions": 0}
    assert want["cmd"].endswith("-m clawker_tpu.hostproxy ")
    assert got["cmd"].endswith("-m clawker_tpu_torch.hostproxy ")
