"""The port's loopd against the reference's.

Twins of tests/test_loopd.py.  Each twin runs the reference's scenario
and then the port's, each package under its own ``TestEnv``, and holds
the port's result to the reference's: run ids differ between the two,
so agent names are compared with the id replaced.  The twins turn the
host proxy off: on a fake with several workers the reference's lanes
race two proxy spawns, the second kills the first's half-started
daemon and a loop's start fails (the port spawns under a lock:
``util/daemon.py``).  The port-only cases below run the proxy on a free
port, and every proxy a test started is stopped when it ends.  The
cases and what each holds:

- the socket's modes, the refusal to usurp a live daemon;
- submit / stream / status / stop-with-drain, the shared admission cap
  and the WFQ interleave of two clients, detach / re-attach, the shared
  lane registry, the retention of done runs, drop-oldest publishing;
- the ``loopd.post_submit`` crash seam (``kill()`` before the ack);
- the CLI: ``loop`` submits to an answering daemon (``--json``,
  ``--detach``, ``loop attach``), ``--no-daemon`` and no daemon run in
  process, ``--daemon`` with ``--resume``/``--chaos-plan`` errors, the
  client's two-stage Ctrl-C, ``loopd start|stop|status``.

``test_daemon_sigkill_mid_run_resume_adopts_zero_duplicates`` is
twinned in both halves and ends with each package's chaos invariant
checker, as the reference's does.  ``adopt_run`` (a killed daemon's run
resumed by a second daemon) and a hosted run with a warm pool are held
against the reference's too.  The reference cases with no twin, each
waiting for its item:

- ``test_transport_forwards_loopd_socket_over_mux``: the SSH transport
  of the ``gpu_host`` driver (ROADMAP §1 item 12b);
- ``test_fleet_health_renders_daemon_breakers`` and
  ``test_fleet_placement_renders_daemon_admission``: the ``fleet
  health`` / ``fleet placement`` verbs the port lacks (§1 item 13; the
  status RPC they read is held here);
- ``test_fleet_warmpool_renders_daemon_pools``: the ``fleet warmpool``
  verb (§1 item 13; the status RPC's ``warm_pools`` it reads is held
  here).

Every test that starts a daemon stops it in a ``finally``, and each
test has its own time limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import stat
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.agentd.protocol as ref_protocol
import clawker_tpu.chaos.invariants as ref_inv
import clawker_tpu.chaos.seams as ref_seams
import clawker_tpu.cli.cmd_loop as ref_cmd_loop
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.loop as ref_loop
import clawker_tpu.loop.journal as ref_journal
import clawker_tpu.loopd as ref_loopd
import clawker_tpu.loopd.client as ref_client
import clawker_tpu.loopd.server as ref_server
import clawker_tpu.monitor.ledger as ref_ledger
import clawker_tpu_torch.agentd.protocol as port_protocol
import clawker_tpu_torch.chaos.invariants as port_inv
import clawker_tpu_torch.chaos.seams as port_seams
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.loop.journal as port_journal
import clawker_tpu_torch.loopd as port_loopd
import clawker_tpu_torch.loopd.client as port_client
import clawker_tpu_torch.loopd.server as port_server
import clawker_tpu_torch.monitor.ledger as port_ledger
from clawker_tpu.testenv import TestEnv

PROJECT = "loopdproj"
IMAGE = f"clawker-{PROJECT}:default"
TIME_LIMIT_S = 120.0    # per test: a hung daemon fails one test

PKGS = {
    "ref": SimpleNamespace(
        config=ref_config, drivers=ref_drivers, fake=ref_fake,
        loop=ref_loop, journal=ref_journal, loopd=ref_loopd,
        client=ref_client, server=ref_server, protocol=ref_protocol,
        seams=ref_seams, ledger=ref_ledger, inv=ref_inv),
    "port": SimpleNamespace(
        config=port_config, drivers=port_drivers, fake=port_fake,
        loop=port_loop, journal=port_journal, loopd=port_loopd,
        client=port_client, server=port_server, protocol=port_protocol,
        seams=port_seams, ledger=port_ledger, inv=port_inv),
}


@pytest.fixture(autouse=True)
def _time_limit():
    """A hung daemon or proxy fails its own test, not the whole run
    (the daemon tests of the other files import this fixture)."""
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stop_proxies(state_dir: Path) -> None:
    """SIGTERM every host proxy a run under ``state_dir`` started.  The
    reference's lanes can race two spawns into one pidfile, so its
    manager's ``stop`` may miss the survivor: find them by their
    environment instead."""
    want = f"CLAWKER_TPU_STATE_DIR={state_dir}".encode()
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            cmd = (proc / "cmdline").read_bytes()
            if b".hostproxy" not in cmd:
                continue
            if want in (proc / "environ").read_bytes().split(b"\0"):
                os.kill(int(proc.name), signal.SIGTERM)
        except OSError:
            continue


@contextlib.contextmanager
def side(pkg: str, tmp_path: Path, settings: str = "", *,
         proxy: bool = True):
    """One package's environment, the host proxy on a free port (or
    off): -> namespace with ``m`` (the package's modules), ``cfg``,
    ``proj``, ``tenv``; every proxy it started is stopped on the way
    out."""
    tenv = TestEnv(base=tmp_path / pkg)
    with tenv:
        tenv.write_settings(
            f"host_proxy:\n  enable: {str(proxy).lower()}\n"
            f"  port: {free_port()}\n"
            "loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
            "    hard_free_pct: 0.0005\n" + settings)
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text(f"project: {PROJECT}\n")
        m = PKGS[pkg]
        try:
            yield SimpleNamespace(m=m, cfg=m.config.load_config(proj),
                                  proj=proj, tenv=tenv, pkg=pkg)
        finally:
            stop_proxies(tenv.base / "state")


def driver_with(m, n_workers: int, behavior=None):
    drv = m.drivers.FakeDriver(n_workers=n_workers)
    for api in drv.apis:
        api.add_image(IMAGE)
        api.set_behavior(IMAGE, behavior or m.fake.exit_behavior(b"done\n", 0))
    return drv


def hold_behavior(hold: threading.Event):
    def run(io) -> int:
        if not hold.is_set():
            hold.wait(20.0)
        return 0

    return run


def wait_for(pred, timeout=10.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def total_creates(drv) -> int:
    return sum(len(api.calls_named("container_create")) for api in drv.apis)


@contextlib.contextmanager
def daemon(s, drv, **kw):
    srv = s.m.server.LoopdServer(s.cfg, drv, **kw).start()
    try:
        yield srv
    finally:
        srv.stop()


def run_to_done(client, spec_doc, **kw):
    ack = client.submit_run(spec_doc, **kw)
    final = None
    for frame in client.events():
        if frame.get("type") == "run_done":
            final = frame
    return ack, final


def norm(obj, run_id: str):
    """``obj`` with the run id (and its 6-character agent tag) replaced,
    so two packages' runs compare."""
    text = json.dumps(obj).replace(run_id, "RUN").replace(run_id[:6], "RUN")
    return json.loads(text)


def twin(tmp_path: Path, scenario, settings: str = ""):
    """``scenario(side)`` on the reference, then on the port: ->
    (reference's result, port's)."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, settings, proxy=False) as s:
            out.append(scenario(s))
    return tuple(out)


# ---------------------------------------------------------------- security


def test_socket_modes_private(tmp_path):
    """0700 runtime dir, 0600 socket: filesystem permissions are the
    authentication."""
    def scenario(s):
        with daemon(s, driver_with(s.m, 2)) as srv:
            sock = srv.sock_path
            return (stat.S_IMODE(os.stat(sock).st_mode),
                    stat.S_IMODE(os.stat(sock.parent).st_mode),
                    sock.relative_to(s.tenv.base).as_posix())

    want, got = twin(tmp_path, scenario)
    assert got == want == (0o600, 0o700, "state/loopd/loopd.sock")


def test_second_daemon_refuses_to_usurp(tmp_path):
    def scenario(s):
        drv = driver_with(s.m, 2)
        with daemon(s, drv):
            with pytest.raises(s.m.loopd.LoopdError) as e:
                s.m.server.LoopdServer(s.cfg, drv).start()
            return str(e.value).replace(str(s.tenv.base), "BASE")

    want, got = twin(tmp_path, scenario)
    assert got == want and "already running" in got


# ------------------------------------------------------------ basic verbs


def test_submit_streams_and_completes(tmp_path):
    def scenario(s):
        with daemon(s, driver_with(s.m, 2)):
            client = s.m.client.discover(s.cfg)
            assert client is not None
            ack, final = run_to_done(client, {"parallel": 2,
                                              "iterations": 1})
            client.close()
            # the run journaled under the ordinary path
            assert s.m.journal.journal_path(s.cfg.logs_dir,
                                            ack["run"]).exists()
            return norm({"agents": ack["agents"], "final": final},
                        ack["run"])

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["final"]["ok"] and all(
        a["status"] == "done" and a["iteration"] == 1
        for a in got["final"]["agents"])


def test_status_reports_runs_admission_health(tmp_path):
    def scenario(s):
        with daemon(s, driver_with(s.m, 2)) as srv:
            client = s.m.client.discover(s.cfg)
            ack, _ = run_to_done(client, {"parallel": 1, "iterations": 1})
            client.close()
            c2 = s.m.client.LoopdClient(srv.sock_path)
            doc = c2.status()
            c2.close()
        run = {r["run"]: r for r in doc["runs"]}[ack["run"]]
        return {
            "keys": sorted(doc),
            "run_keys": sorted(run),
            "run": {k: run[k] for k in ("state", "ok", "parallel",
                                        "iterations", "placement",
                                        "gitguard", "events_dropped")},
            "tenant": run["tenant"].startswith("uid"),
            "admission": sorted(doc["admission"]["workers"]),
            "health": sorted(h["worker"] for h in doc["health"]),
            "project": doc["project"], "pod": doc["pod"],
            "sections": {k: doc[k] for k in ("warm_pools", "capacity",
                                             "sentinel", "shipper")},
            # no workerd on a fake pod: every worker reads absent
            "workerd": doc["workerd"],
        }

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["run"]["state"] == "done" and got["run"]["ok"] is True
    assert got["tenant"] and got["admission"]
    assert got["health"] == ["fake-0", "fake-1"]
    assert got["project"] == PROJECT


def test_stop_drains_to_resumable_journal(tmp_path):
    """`loopd stop` journals a durable shutdown per live run."""
    def scenario(s):
        # the iteration runs until the drain halts it, so the stop, never
        # the container's own exit, ends the loop (a container released
        # just before the stop raced it: the exit was accounted or not)
        drv = driver_with(s.m, 1, behavior=s.m.fake.idle_behavior)
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        try:
            client = s.m.client.discover(s.cfg)
            ack = client.submit_run({"parallel": 1, "iterations": 1},
                                    stream=False)
            run = srv.runs[ack["run"]]
            # the wait span opens once REC_STARTED is journaled
            assert wait_for(lambda: run.sched is not None
                            and bool(run.sched._iter_started))
            client.close()
        finally:
            srv.stop()
        records = s.m.journal.RunJournal.read(
            s.m.journal.journal_path(s.cfg.logs_dir, ack["run"]))
        return sorted(r["kind"] for r in records)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert "run" in got and "placement" in got


# ------------------------------------------- cross-process cap + fairness


def test_two_clients_hold_admission_cap_and_interleave(tmp_path):
    """Two clients on one daemon never jointly exceed
    max_inflight_per_worker, and the WFQ interleaves their tenants."""
    cap = 2

    def scenario(s):
        s.cfg.settings.loop.placement.max_inflight_per_worker = cap
        drv = driver_with(s.m, 1)
        api = drv.apis[0]
        orig_create = api.container_create

        def slow_create(name, config):
            time.sleep(0.02)
            return orig_create(name, config)

        api.container_create = slow_create
        created_order: list[str] = []
        done = {}
        with daemon(s, drv) as srv:
            def one_client(tenant: str):
                c = s.m.client.LoopdClient(srv.sock_path)
                c.hello()
                c.submit_run({"parallel": 6, "iterations": 1,
                              "placement": "pack", "tenant": tenant})
                for frame in c.events():
                    if (frame.get("type") == "event"
                            and frame.get("event") == "created"):
                        created_order.append(tenant)
                    if frame.get("type") == "run_done":
                        done[tenant] = frame
                c.close()

            threads = [threading.Thread(target=one_client, args=(t,))
                       for t in ("tenant-a", "tenant-b")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            stats = srv.admission.stats()
        first = {t: created_order.index(t) for t in done}
        last = {t: len(created_order) - 1 - created_order[::-1].index(t)
                for t in done}
        return {
            "ok": {t: f["ok"] for t, f in done.items()},
            "hwm_held": drv.gates[0].launch_hwm <= cap
            and stats["workers"]["fake-0"]["inflight_hwm"] <= cap,
            "interleaved": (first["tenant-a"] < last["tenant-b"]
                            and first["tenant-b"] < last["tenant-a"]),
            "created": sorted(created_order),
        }

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["ok"] == {"tenant-a": True, "tenant-b": True}
    assert got["hwm_held"] and got["interleaved"]


# ------------------------------------------------- detach / attach / kill


def test_detached_run_survives_client_and_reattaches(tmp_path):
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        try:
            c1 = s.m.client.LoopdClient(srv.sock_path)
            c1.hello()
            ack = c1.submit_run({"parallel": 2, "iterations": 1})
            started = 0
            for frame in c1.events():
                if (frame.get("type") == "event"
                        and frame.get("event") == "iteration_start"):
                    started += 1
                    if started == 2:
                        break
            c1.close()      # the viewer dies mid-run
            run = srv.runs[ack["run"]]
            alive = not run.done.is_set()
            hold.set()
            c2 = s.m.client.LoopdClient(srv.sock_path)
            c2.hello()
            snap = c2.attach(ack["run"][:6])
            final = None
            for frame in c2.events():
                if frame.get("type") == "run_done":
                    final = frame
            c2.close()
        finally:
            hold.set()
            srv.stop()
        return norm({"alive": alive, "snap_run": snap["run"] == ack["run"],
                     "snap": sorted(snap), "final": final}, ack["run"])

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["alive"] and got["snap_run"] and got["final"]["ok"]
    assert all(a["status"] == "done" for a in got["final"]["agents"])


def test_explicit_detach_frame_keeps_run_alive(tmp_path):
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 1, behavior=hold_behavior(hold))
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        try:
            c = s.m.client.LoopdClient(srv.sock_path)
            c.hello()
            ack = c.submit_run({"parallel": 1, "iterations": 1})
            for frame in c.events():
                if (frame.get("type") == "event"
                        and frame.get("event") == "iteration_start"):
                    break
            c.detach()
            c.close()
            run = srv.runs[ack["run"]]
            unsubscribed = wait_for(lambda: not run.subs)
            alive = not run.done.is_set()
            hold.set()
            finished = run.done.wait(10.0)
        finally:
            hold.set()
            srv.stop()
        return unsubscribed, alive, finished, run.result["ok"]

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, True, True, True)


def test_daemon_sigkill_mid_run_resume_adopts_zero_duplicates(tmp_path):
    """SIGKILL the daemon mid-run; the viewer's stream dies without a
    run_done, the socket file survives, discovery reads "no daemon", and
    no engine call follows the kill.  Then ``LoopScheduler.resume`` on
    the journal the daemon left adopts both containers in place and
    every loop finishes.  Both packages are held to zero duplicate
    creates, every loop ``done`` and no container of the run left after
    cleanup, and each package's chaos invariant checker
    (``chaos.invariants``) finds nothing, as the reference's test asks."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        try:
            client = s.m.client.LoopdClient(srv.sock_path)
            client.hello()
            ack = client.submit_run({"parallel": 2, "iterations": 1})
            started = 0
            for frame in client.events():
                if (frame.get("type") == "event"
                        and frame.get("event") == "iteration_start"):
                    started += 1
                    if started == 2:
                        break
            creates = total_creates(drv)
            srv.kill()
            frames = []
            with pytest.raises(Exception):
                for frame in client.events():
                    frames.append(frame["type"])
            client.close()
            killed = ("run_done" not in frames, srv.sock_path.exists(),
                      s.m.client.discover(s.cfg) is None,
                      total_creates(drv) - creates)
            # the resume half, from the journal the daemon left behind
            image = s.m.journal.replay(s.m.journal.RunJournal.read(
                s.m.journal.journal_path(s.cfg.logs_dir, ack["run"])))
            sched2 = s.m.loop.LoopScheduler.resume(s.cfg, drv, image)
            summary = sched2.reconcile()
            hold.set()
            t = threading.Thread(target=sched2.run,
                                 kwargs={"poll_s": 0.05}, daemon=True)
            t.start()
            t.join(15.0)
            statuses = [l.status for l in sched2.loops]
            duplicates = total_creates(drv) - creates
            sched2.cleanup(remove_containers=True)
            left = [c for api in drv.apis for c in api.containers.values()
                    if (c.config.get("Labels") or {}).get(
                        port_consts.LABEL_LOOP) == ack["run"]]
            violations = s.m.inv.check_invariants(
                drv, s.cfg, ack["run"], loops=sched2.loops, kills=1)
            result = (killed, summary, statuses, duplicates, len(left),
                      violations)
        finally:
            hold.set()
            srv.sock_path.unlink(missing_ok=True)
        return result

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == (True, True, True, 0)
    assert got[1]["adopted"] == 2
    assert got[2:] == (["done", "done"], 0, 0, [])


def test_daemon_killed_at_post_submit_seam_leaves_no_orphan_state(tmp_path):
    """Crash consistency at the loopd.post_submit seam: the client never
    gets an ack, and no engine call was made for the registered run."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        seams = s.m.seams.SeamRegistry()
        srv = s.m.server.LoopdServer(s.cfg, drv, seams=seams).start()
        try:
            seams.arm("loopd.post_submit", srv.kill)
            client = s.m.client.LoopdClient(srv.sock_path)
            client.hello()
            with pytest.raises((s.m.protocol.ConnectionClosed,
                                s.m.loopd.LoopdError, OSError)):
                client.submit_run({"parallel": 1, "iterations": 1})
            client.close()
        finally:
            srv.sock_path.unlink(missing_ok=True)
        return total_creates(drv), seams.fired

    want, got = twin(tmp_path, scenario)
    assert got == want == (0, ["loopd.post_submit"])


# --------------------------------------------------------------- lanes


def test_shared_lane_registry_serializes_across_runs(tmp_path):
    """Two hosted runs' engine calls for one worker ride the SAME lane."""
    def scenario(s):
        with daemon(s, driver_with(s.m, 2)) as srv:
            finals = []
            for _ in range(2):
                c = s.m.client.LoopdClient(srv.sock_path)
                c.hello()
                _, final = run_to_done(c, {"parallel": 1, "iterations": 1,
                                           "placement": "pack"})
                c.close()
                finals.append(final)
            scheds = [srv.runs[f["run"]].sched for f in finals]
            return ([f["ok"] for f in finals], "fake-0" in srv.lanes.lanes,
                    all(sc.lanes is srv.lanes for sc in scheds))

    want, got = twin(tmp_path, scenario)
    assert got == want == ([True, True], True, True)


def test_hosted_run_roots_link_to_the_daemon_submit_span(tmp_path):
    """What loopd hands the scheduler: the run's iteration roots carry
    the daemon's ``loopd.submit`` span as ``ctx_parent`` and the
    router's clock offset as ``skew_s``, and the run record journals
    both spec fields."""
    def scenario(s):
        with daemon(s, driver_with(s.m, 2)) as srv:
            c = s.m.client.LoopdClient(srv.sock_path)
            c.hello()
            ack, final = run_to_done(
                c, {"parallel": 2, "iterations": 1},
                tp="00-routertrace-feedfacefeedface-01", clock_offset_s=0.25)
            c.close()
            pod_flight = srv.flight.path
        logs = s.cfg.logs_dir
        submit = [json.loads(line) for line in
                  pod_flight.read_text().splitlines()]
        run_flight = s.m.ledger.flight_path(logs, ack["run"])
        roots = [r for r in map(json.loads,
                                run_flight.read_text().splitlines())
                 if r.get("name") == "iteration" and not r["parent_id"]]
        header = next(r for r in s.m.journal.RunJournal.read(
            s.m.journal.journal_path(logs, ack["run"])) if r["kind"] == "run")
        span = submit[0]
        return {
            "ok": final["ok"],
            "submit": (span["name"], span["trace_id"] == ack["run"],
                       span["attrs"]),
            "roots": sorted((r["attrs"]["ctx_parent"] == span["span_id"],
                             r["attrs"]["skew_s"]) for r in roots),
            "header": (header["spec"]["trace_parent"]
                       == f"00-{ack['run']}-{span['span_id']}-01",
                       header["spec"]["clock_offset_s"]),
        }

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["submit"][0] == "loopd.submit" and got["submit"][1]
    assert got["submit"][2]["ctx_parent"] == "feedfacefeedface"
    assert got["roots"] == [(True, 0.25)] * 2
    assert got["header"] == (True, 0.25)


# ------------------------------------------------------------- CLI wiring


def invoke(s, drv, args: list[str], **kw):
    """The package's CLI on ``args`` with a Factory over ``drv``."""
    if s.pkg == "ref":
        return CliRunner().invoke(
            ref_root.cli, args,
            obj=ref_factory.Factory(cwd=s.proj, driver=drv), **kw)
    return CliRunner().invoke(
        port_cli.cli, args, obj=port_cli.Factory(cwd=s.proj, driver=drv),
        **kw)


@pytest.fixture
def cpu(monkeypatch):
    """The port's in-process paths score on the CPU."""
    monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")


def test_cli_loop_submits_to_daemon_and_attach_restreams(tmp_path, cpu):
    def scenario(s):
        drv = driver_with(s.m, 2)
        with daemon(s, drv) as srv:
            res = invoke(s, drv, ["loop", "-p", "2", "-n", "1", "--json"],
                         catch_exceptions=False)
            assert res.exit_code == 0, res.output
            out = json.loads(res.output[res.output.index("{"):])
            hosted = out["loop_id"] in srv.runs
        return norm({"daemon_owned": "daemon-owned" in res.output,
                     "agents": out["agents"], "hosted": hosted},
                    out["loop_id"])

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["daemon_owned"] and got["hosted"]
    assert all(a["status"] == "done" for a in got["agents"])


def test_cli_loop_detach_and_attach(tmp_path, cpu):
    def scenario(s):
        drv = driver_with(s.m, 1)
        with daemon(s, drv) as srv:
            res = invoke(s, drv, ["loop", "-p", "1", "-n", "1", "--detach"],
                         catch_exceptions=False)
            assert res.exit_code == 0, res.output
            run_id = next(iter(srv.runs))
            srv.runs[run_id].done.wait(10.0)
            res2 = invoke(s, drv, ["loop", "attach", run_id[:6], "--json"],
                          catch_exceptions=False)
            assert res2.exit_code == 0, res2.output
            out = json.loads(res2.output[res2.output.index("{"):])
        return norm({"hint": "loop attach" in res.output,
                     "attached": out}, run_id)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["hint"] and got["attached"]["loop_id"] == "RUN"


def test_cli_loop_no_daemon_flag_and_detach_without_daemon(tmp_path, cpu):
    def scenario(s):
        drv = driver_with(s.m, 1)
        with daemon(s, drv) as srv:
            # --no-daemon forces the in-process scheduler despite a live
            # daemon
            res = invoke(s, drv, ["loop", "-p", "1", "-n", "1",
                                  "--no-daemon", "--json"]
                         + (["--no-workerd"] if s.pkg == "ref" else []),
                         catch_exceptions=False)
            hosted = bool(srv.runs)
        # --detach without a daemon is an explicit error, not a silent
        # in-process run that dies with the CLI
        res2 = invoke(s, drv, ["loop", "-p", "1", "-n", "1", "--detach"])
        return (res.exit_code, hosted, res2.exit_code != 0,
                "loopd" in res2.output)

    want, got = twin(tmp_path, scenario)
    assert got == want == (0, False, True, True)


def test_cli_no_daemon_degrades_in_process(tmp_path, cpu):
    """No socket -> discover None -> the in-process path."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        assert s.m.client.discover(s.cfg) is None
        res = invoke(s, drv, ["loop", "-p", "1", "-n", "1", "--json"]
                     + (["--no-workerd"] if s.pkg == "ref" else []),
                     catch_exceptions=False)
        out = json.loads(res.output[res.output.index("{"):])
        return res.exit_code, norm(out["agents"], out["loop_id"])

    want, got = twin(tmp_path, scenario)
    assert got == want and got[0] == 0


def test_client_interrupt_first_detaches_then_hard_exits(monkeypatch):
    """The first Ctrl-C DETACHES (the run keeps executing); the second
    hard-exits the viewer.  Killing the viewer never kills the run."""
    def scenario(mod):
        exits = []
        monkeypatch.setattr(mod, "_hard_exit", exits.append)

        class ClientStub:
            def __init__(self):
                self.detaches = 0

            def detach(self):
                self.detaches += 1

        stub = ClientStub()
        handler = mod._ClientInterrupt(stub, "abc123def")
        handler()
        first = (stub.detaches, handler.detached, list(exits))
        handler()
        return first, exits, stub.detaches

    assert scenario(port_cli) == scenario(ref_cmd_loop) == (
        (1, True, []), [130], 1)


def test_cli_loopd_group_status_stop(tmp_path, cpu):
    def scenario(s):
        drv = driver_with(s.m, 1)
        # status with no daemon: non-zero (liveness probe contract)
        res = invoke(s, drv, ["loopd", "status"])
        codes = [res.exit_code]
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        try:
            res = invoke(s, drv, ["loopd", "status", "--format", "json"],
                         catch_exceptions=False)
            codes.append(res.exit_code)
            doc = json.loads(res.output)
            res = invoke(s, drv, ["loopd", "start"], catch_exceptions=False)
            already = "already running" in res.output
            res = invoke(s, drv, ["loopd", "stop"], catch_exceptions=False)
            codes.append(res.exit_code)
        finally:
            srv.stop()
        return (codes, doc["pid"] == os.getpid(), doc["runs"],
                sorted(doc["console"]), already, srv.sock_path.exists())

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == [1, 0, 0] and got[1] and got[2] == [] and got[4]
    assert not got[5]


def test_publish_drop_oldest_always_delivers_terminal_frames():
    """A slow subscriber sheds its OLDEST frames; the run_done frame and
    the None sentinel always land."""
    import queue as _queue

    def scenario(m):
        run = m.server._DaemonRun(run_id="r", spec=m.loop.LoopSpec(),
                                  tenant="t", client="c")
        _, q, _, _ = run.subscribe()
        for i in range(m.server.SUB_QUEUE_MAX + 50):
            run.publish({"type": "event", "i": i})
        run.publish({"type": "run_done", "run": "r", "agents": [],
                     "ok": True})
        run.publish(None)
        frames = []
        while True:
            try:
                frames.append(q.get_nowait())
            except _queue.Empty:
                break
        return frames[-1], frames[-2]["type"], run.dropped, len(frames)

    assert scenario(PKGS["port"]) == scenario(PKGS["ref"])
    assert scenario(PKGS["port"])[:2] == (None, "run_done")


def test_cli_explicit_daemon_rejects_resume_and_chaos(tmp_path, cpu):
    """--daemon must error, not silently degrade, when combined with the
    in-process-only modes."""
    plan = tmp_path / "plan.json"
    plan.write_text('{"seed": 1, "events": []}')

    def scenario(s):
        drv = driver_with(s.m, 1)
        out = []
        for extra, needle in ((["--resume", "whatever"], "--resume"),
                              (["--chaos-plan", str(plan)], "--chaos-plan")):
            res = invoke(s, drv, ["loop", "--daemon", *extra])
            out.append((res.exit_code != 0, needle in res.output,
                        "cannot combine" in res.output))
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want == [(True, True, True)] * 2


def test_done_runs_evicted_past_retention(tmp_path, monkeypatch):
    """A resident daemon keeps a bounded window of finished runs."""
    def scenario(s):
        monkeypatch.setattr(s.m.server, "DONE_RUNS_KEPT", 2)
        ids = []
        with daemon(s, driver_with(s.m, 2)) as srv:
            for _ in range(4):
                c = s.m.client.LoopdClient(srv.sock_path)
                c.hello()
                ack, final = run_to_done(c, {"parallel": 1, "iterations": 1})
                c.close()
                assert final["ok"]
                ids.append(ack["run"])
            return [rid in srv.runs for rid in ids]

    want, got = twin(tmp_path, scenario)
    # the fourth submit evicts the oldest of three done runs
    assert got == want == [False, True, True, True]


# ------------------------------------------------------- adopt_run


def _agent_creates(drv) -> list[str]:
    return sorted(a[0] for api in drv.apis
                  for a, _k in api.calls_named("container_create")
                  if ".loop-" in a[0])


def test_adopt_run_resumes_a_killed_daemons_run(tmp_path):
    """A daemon hosting a pooled 2-loop run is killed mid-run; a second
    daemon on the same logs dir adopts the run (``adopt_run``, streamed):
    the drive thread resumes the journal and reconciles, both running
    containers are adopted in place (no second create for an agent), and
    the run ends ``ok`` with every loop done, as the reference's does."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
        srv = s.m.server.LoopdServer(s.cfg, drv).start()
        srv2 = None
        try:
            with s.m.client.LoopdClient(srv.sock_path) as c:
                c.hello()
                ack = c.submit_run({"parallel": 2, "iterations": 1,
                                    "warm_pool_depth": 1})
                started = 0
                for frame in c.events():
                    if frame.get("event") == "iteration_start":
                        started += 1
                        if started == 2:
                            break
                creates = _agent_creates(drv)
                srv.kill()
            srv2 = s.m.server.LoopdServer(s.cfg, drv).start()
            with s.m.client.LoopdClient(srv2.sock_path) as c:
                c.hello()
                adopted = c.adopt_run(ack["run"], stream=True)
                run = srv2.runs[ack["run"]]
                # released once the reconcile adopted both containers:
                # an exit before it would be accounted, not adopted
                assert wait_for(lambda: run.sched is not None and all(
                    l.status == "running" for l in run.sched.loops))
                hold.set()
                final = None
                for frame in c.events():
                    if frame.get("type") == "run_done":
                        final = frame
                        break
            assert run.done.wait(10.0)
            kinds = [r["kind"] for r in s.m.journal.RunJournal.read(
                s.m.journal.journal_path(s.cfg.logs_dir, ack["run"]))]
            return (adopted["type"], adopted["run"] == ack["run"],
                    final["ok"], [a["status"] for a in final["agents"]],
                    kinds.count("adopted"),
                    _agent_creates(drv) == creates, len(creates))
        finally:
            hold.set()
            if srv2 is not None:
                srv2.stop()
            srv.sock_path.unlink(missing_ok=True)

    want, got = twin(tmp_path, scenario)
    assert got == want == ("adopted", True, True, ["done", "done"], 2,
                           True, 2)


def test_adopt_run_without_a_journal_errors_as_the_reference(tmp_path):
    def scenario(s):
        with daemon(s, driver_with(s.m, 1)) as srv:
            with s.m.client.LoopdClient(srv.sock_path) as c:
                with pytest.raises(s.m.loopd.LoopdError) as e:
                    c.adopt_run("somerun")
        return str(e.value).split(" under ")[0]

    want, got = twin(tmp_path, scenario)
    assert got == want == "adopt_run: no journal for run 'somerun'"


def test_hosted_run_takes_a_warm_pool(tmp_path):
    """A submitted spec with ``warm_pool_depth`` runs pooled under the
    daemon: the same pool stats in the status RPC's ``warm_pools``."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        with daemon(s, drv) as srv:
            with s.m.client.LoopdClient(srv.sock_path) as c:
                c.hello()
                ack, final = run_to_done(c, {"parallel": 2, "iterations": 2,
                                             "warm_pool_depth": 1})
            with s.m.client.LoopdClient(srv.sock_path) as c:
                doc = c.status()
        pools = doc["warm_pools"][ack["run"]]
        return (final["ok"], [a["status"] for a in final["agents"]],
                pools["target_depth"], sorted(pools["workers"]),
                {w: r["target"] for w, r in pools["workers"].items()})

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] is True and got[2] == 1


# ------------------------------------------------ what the port refuses


def test_pods_stays_refused(tmp_path, cpu):
    with side("port", tmp_path) as s:
        drv = driver_with(s.m, 1)
        res = invoke(s, drv, ["loop", "-p", "1", "--pods"])
    assert res.exit_code == 1
    assert "--pods (federation) is not yet ported" in res.output
    assert total_creates(drv) == 0


def test_forked_daemon_runs_the_port_and_stops_clean(tmp_path, cpu):
    """``loopd start`` forks ``python -m clawker_tpu_torch.loopd``, which
    builds its own fake driver from the environment; ``loop`` submits to
    it by default, ``loop attach`` re-streams, ``loopd stop`` drains and
    leaves no socket or pidfile."""
    with side("port", tmp_path) as s, contextlib.ExitStack() as stack:
        # the daemon starts in the project dir: PYTHONPATH finds the port
        env = {"CLAWKER_TPU_DRIVER": "fake",
               "CLAWKER_TPU_FAKE_IMAGES": IMAGE,
               "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
        for k, v in env.items():
            stack.enter_context(_setenv(k, v))
        runner = CliRunner()
        f = port_cli.Factory(cwd=s.proj)
        try:
            res = runner.invoke(port_cli.cli, ["loopd", "start"], obj=f)
            assert res.exit_code == 0, res.output
            pid = int(port_loopd.pidfile_path(s.cfg).read_text())
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            assert cmd.endswith(b"-m\0clawker_tpu_torch.loopd\0")
            res = runner.invoke(port_cli.cli,
                                ["loop", "-p", "2", "-n", "1", "--json"],
                                obj=port_cli.Factory(cwd=s.proj))
            assert res.exit_code == 0, res.output
            assert "daemon-owned" in res.output
            out = json.loads(res.output[res.output.index("{"):])
            assert [a["status"] for a in out["agents"]] == ["done"] * 2
            res = runner.invoke(port_cli.cli,
                                ["loop", "attach", out["loop_id"], "--json"],
                                obj=port_cli.Factory(cwd=s.proj))
            assert res.exit_code == 0, res.output
            res = runner.invoke(port_cli.cli, ["loopd", "status", "--json"],
                                obj=port_cli.Factory(cwd=s.proj))
            doc = json.loads(res.output)
            assert doc["pid"] == pid and doc["runs"][0]["state"] == "done"
        finally:
            res = runner.invoke(port_cli.cli, ["loopd", "stop"],
                                obj=port_cli.Factory(cwd=s.proj))
        assert res.exit_code == 0, res.output
        assert not port_loopd.socket_path(s.cfg).exists()
        assert not port_loopd.pidfile_path(s.cfg).exists()
        assert wait_for(lambda: _gone(pid), 10.0)


def _gone(pid: int) -> bool:
    """The process exited (a zombie awaiting its reap counts)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] == "Z"
    except OSError:
        return True


@contextlib.contextmanager
def _setenv(key: str, value: str):
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old
