"""The port's ``local`` driver against the reference's.

``LocalDriver``'s ``DOCKER_HOST`` parsing and error texts, word for
word; ``get_driver`` building it on default settings; the CLI's clean
exit 1 with no daemon.  Then the loop twins over a socket: each package
runs its ``LocalDriver`` against its own ``FakeEngineDaemon`` (the
port's test daemon serving a ``FakeDockerAPI`` on a unix socket), with
one run id on both sides -- the same status rows, scheduler events and
journal records; the warm pool killed and resumed, where the HTTP
engine cannot relabel, with the same reconcile summary; and
``engine.request`` spans under an ambient trace context.  HOME points
at an empty directory, so the harness staging has nothing to stage.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from pathlib import Path

import pytest

import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.tracing.context as ref_context
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.tracing.context as port_context
from clawker_tpu_torch.testenv import FakeEngineDaemon
from test_torch_warmpool import (
    IMAGE,
    PKGS,
    RUN_ID,
    journal_of,
    kind_counts,
    scheduler,
    side,
    wait_for,
)

LOCAL = {"ref": ref_drivers.LocalDriver, "port": port_drivers.LocalDriver}
CONTEXT = {"ref": ref_context, "port": port_context}


@pytest.fixture(autouse=True)
def _empty_home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("CLAUDE_CONFIG_DIR", raising=False)
    monkeypatch.delenv("DOCKER_HOST", raising=False)
    monkeypatch.delenv("CLAWKER_TPU_DRIVER", raising=False)
    for m in PKGS.values():
        m.orchestrate.clear_harness_seed_cache()


def _api(behavior=None):
    api = port_fake.FakeDockerAPI()
    api.add_image(IMAGE)
    api.set_behavior(IMAGE, behavior
                     or port_fake.exit_behavior(b"iter done\n", 0))
    return api


@contextlib.contextmanager
def _daemon(path: Path, behavior=None):
    d = FakeEngineDaemon(path, _api(behavior)).start()
    try:
        yield d
    finally:
        d.stop()


# ------------------------------------------------------------ DOCKER_HOST


def _connect(pkg: str, host: str) -> str:
    drv = LOCAL[pkg](docker_host=host)
    try:
        ws = drv.workers()
    except Exception as e:  # noqa: BLE001 -- compared across packages
        return f"{type(e).__name__}: {e}"
    out = [(w.id, w.index, w.hostname) for w in ws]
    drv.close()
    return repr(out)


@pytest.mark.parametrize("form", ["absent unix", "absent path", "default",
                                  "unsupported", "tcp refused", "live unix",
                                  "live path"])
def test_docker_host_parsing_and_errors_match_reference(tmp_path, form,
                                                        monkeypatch):
    sock = tmp_path / "e.sock"
    hosts = {"absent unix": f"unix://{tmp_path}/absent.sock",
             "absent path": f"{tmp_path}/absent.sock",
             "default": "",
             "unsupported": "ssh://user@host",
             "tcp refused": "tcp://127.0.0.1:9",
             "live unix": f"unix://{sock}",
             "live path": str(sock)}
    host = hosts[form]
    if form == "default":
        for m in (ref_drivers, port_drivers):
            mod = __import__(m.LocalDriver.__module__, fromlist=["x"])
            monkeypatch.setattr(mod, "DEFAULT_SOCKET",
                                str(tmp_path / "docker.sock"))
    with _daemon(sock):
        got = {pkg: _connect(pkg, host) for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    want = {"absent unix": f"Docker socket {tmp_path}/absent.sock not found",
            "absent path": f"Docker socket {tmp_path}/absent.sock not found",
            "default": f"Docker socket {tmp_path}/docker.sock not found",
            "unsupported": "unsupported DOCKER_HOST 'ssh://user@host'",
            "tcp refused": "local Docker daemon did not answer ping",
            "live unix": "[('local-0', 0, 'localhost')]",
            "live path": "[('local-0', 0, 'localhost')]"}[form]
    assert want in got["port"]


def test_docker_host_env_is_the_fallback(tmp_path, monkeypatch):
    with _daemon(tmp_path / "e.sock") as d:
        monkeypatch.setenv("DOCKER_HOST", f"unix://{d.sock_path}")
        drv = port_drivers.LocalDriver()
        assert [w.id for w in drv.workers()] == ["local-0"]
        eng = drv.engine()
        assert eng.ping() and not eng.supports_relabel
        drv.close()
        assert d.routes["ping"] == 2


def test_get_driver_builds_local_on_default_settings(tmp_path):
    settings = port_config.Settings()
    assert settings.runtime.driver == ref_config.Settings().runtime.driver \
        == "local"
    settings.runtime.docker_host = f"unix://{tmp_path}/x.sock"
    drv = port_drivers.get_driver(settings)
    assert isinstance(drv, port_drivers.LocalDriver)
    assert drv._docker_host == settings.runtime.docker_host
    assert port_drivers.base.UNPORTED_DRIVERS == ("nsd",)


def test_cli_without_a_daemon_exits_1_with_the_reference_text(
        tmp_path, monkeypatch, capsys):
    absent = f"unix://{tmp_path}/absent.sock"
    monkeypatch.setenv("DOCKER_HOST", absent)
    monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
    out = {}
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path) as s:
            monkeypatch.chdir(s.proj)
            main = ref_root.main if pkg == "ref" else port_cli.main
            argv = ["loop", "-p", "1", "-n", "1", "--json"]
            if pkg == "ref":
                argv += ["--no-daemon"]
            rc = main(argv)
            out[pkg] = (rc, capsys.readouterr().err)
    assert out["port"][0] == out["ref"][0] == 1
    text = f"Docker socket {tmp_path}/absent.sock not found -- is the " \
           "Docker daemon running?"
    assert text in out["ref"][1] and text in out["port"][1]


# -------------------------------------------------------- loop over socket


def _loop_side(s, sock: Path, **spec):
    """One package's in-process run over its LocalDriver: -> what it
    left behind."""
    drv = LOCAL[s.pkg](docker_host=f"unix://{sock}")
    events: list = []
    sched = s.m.loop.LoopScheduler(
        s.cfg, drv, s.m.loop.LoopSpec(**spec),
        on_event=lambda a, e, d="": events.append((a, e)), run_id=RUN_ID)
    sched.start()
    sched.run(poll_s=0.02)
    status = sched.status()
    records = journal_of(s, sched)
    sched.cleanup(remove_containers=True)
    drv.close()
    per_agent = collections.defaultdict(list)
    for a, e in events:
        per_agent[a].append(e)
    kinds = collections.defaultdict(list)
    for r in records:
        kinds[r.get("agent", "")].append(r["kind"])
    return status, dict(per_agent), dict(kinds)


@pytest.mark.parametrize("spec", [
    dict(parallel=4, iterations=2),
    dict(parallel=3, iterations=1, max_inflight_per_worker=1),
])
def test_loop_over_local_driver_matches_reference(tmp_path, spec):
    out, served = {}, {}
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path) as s, \
                _daemon(tmp_path / f"{pkg}.sock") as d:
            out[pkg] = _loop_side(s, d.sock_path, **spec)
            served[pkg] = (dict(d.routes), d.unrouted, d.api.containers)
    assert out["port"] == out["ref"]
    status = out["port"][0]
    assert [r["status"] for r in status] == ["done"] * spec["parallel"]
    assert all(r["worker"] == "local-0" for r in status)
    for pkg in ("ref", "port"):
        routes, unrouted, left = served[pkg]
        assert unrouted == [] and left == {}
        assert routes["container_create"] == spec["parallel"]
        assert routes["container_start"] == \
            spec["parallel"] * spec["iterations"]
    assert served["port"][0] == served["ref"][0]


def test_relabel_less_warm_pool_resume_matches_reference(tmp_path):
    """The warm pool over HTTP (no in-place relabel): a pool hit keeps
    its ``pool`` epoch label, and after a kill the journal's container
    id is what reconcile adopts."""
    hold = threading.Event()

    def behavior(io) -> int:
        if not hold.is_set():
            hold.wait(20.0)
        return 0

    out = {}
    for pkg in ("ref", "port"):
        hold.clear()
        with side(pkg, tmp_path) as s, \
                _daemon(tmp_path / f"{pkg}.sock", behavior) as d:
            m = s.m
            drv = LOCAL[pkg](docker_host=f"unix://{d.sock_path}")
            assert not drv.engine().supports_relabel
            sched1 = scheduler(s, drv, parallel=2, iterations=2,
                               warm_pool_depth=1)
            sched1.prefill_pool(timeout=10.0)
            sched1.start()
            t = threading.Thread(target=sched1.run, kwargs={"poll_s": 0.02},
                                 daemon=True)
            t.start()
            assert wait_for(lambda: all(l.status == "running"
                                        for l in sched1.loops))
            sched1.kill()
            t.join(10.0)
            image = m.journal.replay(journal_of(s, sched1))
            pool_epoch = {
                c.name: c.id for c in d.api.containers.values()
                if c.labels.get(m.consts.LABEL_LOOP_EPOCH)
                == m.consts.POOL_EPOCH and ".loop-" in c.name}
            journaled = {f"clawker.loopproj.{a}": li.container_id
                         for a, li in image.loops.items()}
            creates = _agent_creates(d)
            drv2 = LOCAL[pkg](docker_host=f"unix://{d.sock_path}")
            sched2 = m.loop.LoopScheduler.resume(s.cfg, drv2, image)
            summary = sched2.reconcile()
            hold.set()
            sched2.run(poll_s=0.02)
            rows = [(r["agent"], r["status"], r["exit_codes"])
                    for r in sched2.status()]
            sched2.cleanup(remove_containers=True)
            drv.close()
            drv2.close()
            adopted_pool = sorted(
                n for n, cid in pool_epoch.items() if journaled.get(n) == cid)
            # the pool's refills race the kill; the agents' records do not
            kinds = kind_counts([r for r in journal_of(s, sched1)
                                 if not r["kind"].startswith("pool_")])
            out[pkg] = (summary, rows, adopted_pool,
                        _agent_creates(d) - creates, kinds, d.unrouted)
    assert out["port"] == out["ref"]
    summary, rows, adopted_pool, new_creates, _, unrouted = out["port"]
    assert summary["adopted"] == 2 and summary["ghosts"] == 0
    assert adopted_pool, "no adopted row still labelled with the pool epoch"
    assert new_creates == 0 and unrouted == []
    assert all(status == "done" for _, status, _ in rows)


def _agent_creates(d) -> int:
    """Creates of loop agents' containers (pool fills are ``pool-*``)."""
    return sum(1 for a, _ in d.api.calls_named("container_create")
               if ".loop-" in a[0])


@pytest.mark.parametrize("op", ["inspect", "missing"])
def test_engine_request_spans_under_an_ambient_context(tmp_path, op):
    """Each unary call under ``use(ctx)`` is one ``engine.request`` span
    whose parent is the context's span, ``failed`` on an error status;
    outside a context nothing is recorded."""
    out = {}
    for pkg in ("ref", "port"):
        ctxm = CONTEXT[pkg]
        spans = []
        with _daemon(tmp_path / f"{pkg}.sock") as d:
            drv = LOCAL[pkg](docker_host=f"unix://{d.sock_path}")
            eng = drv.engine()
            cid = d.api.container_create("c1", {"Image": IMAGE})["Id"]
            eng.api.container_inspect(cid)          # no context: no span
            ctx = ctxm.TraceContext(trace_id="run1", span_id="iter1",
                                    agent="a", worker="local-0",
                                    sink=spans.append)
            with ctxm.use(ctx):
                try:
                    eng.api.container_inspect(cid if op == "inspect"
                                              else "nope")
                except Exception:  # noqa: BLE001 -- the span says failed
                    pass
                eng.api.container_wait(cid) if op == "inspect" else None
            drv.close()
        out[pkg] = [(sp.name, sp.trace_id, sp.parent_id, sp.agent,
                     sp.status, sp.attrs["verb"], sp.attrs["path"]
                     .replace(cid, "<cid>")) for sp in spans]
    assert out["port"] == out["ref"]
    want = [("engine.request", "run1", "iter1", "a",
             "ok" if op == "inspect" else "failed", "GET",
             "/containers/<cid>/json" if op == "inspect"
             else "/containers/nope/json")]
    if op == "inspect":
        want.append(("engine.request", "run1", "iter1", "a", "ok", "POST",
                     "/containers/<cid>/wait"))
    assert out["port"] == want


# ----------------------------------------------------------------- workerd


def test_workerd_liveness_of_the_local_worker_matches_reference(tmp_path):
    """``liveness`` resolves the local worker's canonical socket: absent
    before a workerd serves it, live while one does, absent after."""
    import clawker_tpu.workerd as ref_workerd
    import clawker_tpu.workerd.server as ref_wserver
    import clawker_tpu_torch.workerd as port_workerd
    import clawker_tpu_torch.workerd.server as port_wserver

    mods = {"ref": (ref_workerd, ref_wserver),
            "port": (port_workerd, port_wserver)}
    out = {}
    for pkg in ("ref", "port"):
        wd, server = mods[pkg]
        with side(pkg, tmp_path) as s, \
                _daemon(tmp_path / f"{pkg}.sock") as d:
            drv = LOCAL[pkg](docker_host=f"unix://{d.sock_path}")
            seen = [wd.liveness(s.cfg, drv)]
            srv = server.WorkerdServer(s.cfg, drv.engine(),
                                       worker_id="local-0",
                                       driver=drv).start()
            try:
                seen.append(wd.liveness(s.cfg, drv))
            finally:
                srv.stop()
            seen.append(wd.liveness(s.cfg, drv))
            drv.close()
        out[pkg] = seen
    assert out["port"] == out["ref"]
    assert out["port"] == [{"local-0": "absent"}, {"local-0": "live"},
                           {"local-0": "absent"}]


def test_workerd_daemon_serves_the_engine_at_docker_host(tmp_path):
    """``python -m clawker_tpu_torch.workerd`` on default settings
    serves the daemon at ``DOCKER_HOST``; at an absent socket it exits
    1 with the reference's text."""
    import os
    import subprocess
    import sys

    import clawker_tpu_torch.workerd as port_workerd
    from clawker_tpu_torch.workerd.executor import ping_socket

    root = Path(__file__).resolve().parents[1]
    with side("port", tmp_path) as s, _daemon(tmp_path / "e.sock") as d:
        env = dict(os.environ, PYTHONPATH=str(root),
                   DOCKER_HOST=f"unix://{tmp_path}/absent.sock")
        gone = subprocess.run([sys.executable, "-m",
                               "clawker_tpu_torch.workerd"], cwd=s.proj,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        env["DOCKER_HOST"] = f"unix://{d.sock_path}"
        proc = subprocess.Popen([sys.executable, "-m",
                                 "clawker_tpu_torch.workerd"], cwd=s.proj,
                                env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        sock = port_workerd.socket_path(s.cfg)
        try:
            live = wait_for(lambda: sock.exists() and ping_socket(sock),
                            timeout=60.0)
        finally:
            proc.terminate()
            err = proc.communicate(timeout=30)[1]
        pings = d.routes["ping"]
    assert gone.returncode == 1
    assert (f"Docker socket {tmp_path}/absent.sock not found -- is the "
            "Docker daemon running?") in gone.stderr
    assert live, err[-2000:]
    assert proc.returncode == 0 and pings >= 1
