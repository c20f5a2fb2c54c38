"""The port's workerd against the reference's.

Twins of tests/test_workerd.py.  Each twin runs one scenario on the
reference (``clawker_tpu.workerd``, ``LoopScheduler(executors=)``) and
then on the port, each package under its own ``TestEnv`` with the host
proxy off (tests/test_torch_loop.py says why) and its own fake pod: one
``WorkerdServer`` per worker on ``FakeDriver.local_engine(i)`` and a
``WorkerdExecutor`` for each in an ``ExecutorSet``.  Both runs share one
run id, so agent and container names agree, and each twin holds the
port's observable results to the reference's: create counts and where
they ran, loop summaries, the event order per agent, liveness rows and
CLI exit codes and output.

Beyond tests/test_workerd.py: loopd hosting a run over workerd (the
status RPC's ``workerd`` rows; a killed workerd turns its row
``degraded`` and its loops finish on the direct path), the sentinel
riding a run over workerd (its rows held to the reference's with the
tolerances tests/test_torch_loop_anomaly.py states), and ``loop
--workerd`` with none answering.  The reference cases with no twin,
each waiting for its slice (ROADMAP §1): worktree runs (item 6), the
chaos plans (item 8) and ``fleet health`` (item 13).  The warm pool's
fills and pooled launches over workerd and ``--resume`` after a killed
workerd have their twins (tests/test_workerd.py:319 and :627), with the
intents each server executed and the ``created`` events it emitted
held beside the reference's.

Every wait has a deadline, every daemon and channel is torn down in a
``finally``, and each test has its own time limit.
"""

from __future__ import annotations

import contextlib
import re
import socket as socketlib
import stat
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.agentd.protocol as ref_protocol
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.consts as ref_consts
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.loop as ref_loop
import clawker_tpu.loop.journal as ref_journal
import clawker_tpu.loopd.client as ref_loopd_client
import clawker_tpu.loopd.server as ref_loopd_server
import clawker_tpu.workerd as ref_workerd
import clawker_tpu.workerd.executor as ref_executor
import clawker_tpu.workerd.server as ref_wserver
import clawker_tpu_torch.agentd.protocol as port_protocol
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.loop.journal as port_journal
import clawker_tpu_torch.loopd.client as port_loopd_client
import clawker_tpu_torch.loopd.server as port_loopd_server
import clawker_tpu_torch.workerd as port_workerd
import clawker_tpu_torch.workerd.executor as port_executor
import clawker_tpu_torch.workerd.server as port_wserver
from clawker_tpu.testenv import TestEnv
from test_torch_loop_anomaly import _assert_rows_agree, run_with_rider
from test_torch_loopd import _time_limit  # noqa: F401
from test_torch_sentinel import injected  # noqa: F401

PROJECT = "wdproj"
IMAGE = f"clawker-{PROJECT}:default"
RUN_ID = "wdtwinrun001"
SETTINGS = ("host_proxy:\n  enable: false\n"
            "loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
            "    hard_free_pct: 0.0005\n")

PKGS = {
    "ref": SimpleNamespace(
        config=ref_config, consts=ref_consts, drivers=ref_drivers,
        fake=ref_fake, errors=ref_errors, loop=ref_loop,
        journal=ref_journal, workerd=ref_workerd, executor=ref_executor,
        server=ref_wserver, protocol=ref_protocol,
        loopd_server=ref_loopd_server, loopd_client=ref_loopd_client),
    "port": SimpleNamespace(
        config=port_config, consts=port_consts, drivers=port_drivers,
        fake=port_fake, errors=port_errors, loop=port_loop,
        journal=port_journal, workerd=port_workerd, executor=port_executor,
        server=port_wserver, protocol=port_protocol,
        loopd_server=port_loopd_server, loopd_client=port_loopd_client),
}


@contextlib.contextmanager
def side(pkg: str, tmp_path: Path, settings: str = ""):
    """One package's environment: -> namespace with ``m`` (its
    modules), ``cfg``, ``proj``, ``tenv``, ``pkg``."""
    tenv = TestEnv(base=tmp_path / pkg)
    with tenv:
        tenv.write_settings(SETTINGS + settings)
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text(f"project: {PROJECT}\n")
        m = PKGS[pkg]
        yield SimpleNamespace(m=m, cfg=m.config.load_config(proj),
                              proj=proj, tenv=tenv, pkg=pkg)


def twin(tmp_path: Path, scenario, settings: str = ""):
    """``scenario(side)`` on the reference, then on the port: ->
    (reference's result, port's)."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, settings) as s:
            out.append(scenario(s))
    return tuple(out)


def driver_with(m, n_workers: int, behavior=None):
    drv = m.drivers.FakeDriver(n_workers=n_workers)
    for api in drv.apis:
        api.add_image(IMAGE)
        api.set_behavior(IMAGE,
                         behavior or m.fake.exit_behavior(b"", 0, delay=0.02))
    return drv


def hold_behavior(hold: threading.Event):
    def run(io) -> int:
        if not hold.is_set():
            hold.wait(20.0)
        return 0

    return run


def record_calls(drv) -> list[list[tuple[str, bool]]]:
    """Per worker, every gated engine call as (name, through the local
    view): the fake gate's ``_gate`` is wrapped on each instance."""
    seen: list[list[tuple[str, bool]]] = [[] for _ in drv.gates]
    for i, gate in enumerate(drv.gates):
        inner = gate._gate

        def gated(name, *, local=False, _inner=inner, _seen=seen[i]):
            _seen.append((name, local))
            return _inner(name, local=local)

        gate._gate = gated
    return seen


def launch_calls(seen, *, local: bool) -> int:
    return sum(1 for calls in seen for name, loc in calls
               if loc == local and name in ("container_create",
                                            "container_start"))


def servers_for(s, drv):
    """Per-worker WorkerdServers on the LOCAL engine views: -> (servers,
    worker id -> socket)."""
    servers, socks = [], {}
    for i, w in enumerate(drv.workers()):
        socks[w.id] = s.tenv.base / f"wd-{i}.sock"
        servers.append(s.m.server.WorkerdServer(
            s.cfg, drv.local_engine(i), worker_id=w.id,
            sock_path=socks[w.id]).start())
    return servers, socks


def executors_for(s, socks, *, intent_deadline_s: float = 10.0,
                  rtt_s: float = 0.0):
    return s.m.executor.ExecutorSet({
        wid: s.m.executor.WorkerdExecutor(
            wid, sock, rtt_s=rtt_s, intent_deadline_s=intent_deadline_s)
        for wid, sock in socks.items()})


def pod(s, drv, **kw):
    """The servers and an executor set over them."""
    servers, socks = servers_for(s, drv)
    return servers, executors_for(s, socks, **kw)


def teardown(servers, execset, drv):
    if execset is not None:
        execset.close_all()
    for srv in servers:
        srv.stop()
    drv.close()


def total_creates(drv) -> int:
    return sum(len(api.calls_named("container_create")) for api in drv.apis)


def wait_for(pred, timeout=10.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def scheduler(s, drv, execset, *, on_event=None, **spec):
    return s.m.loop.LoopScheduler(
        s.cfg, drv, s.m.loop.LoopSpec(image=IMAGE, **spec),
        on_event=on_event, run_id=RUN_ID, executors=execset)


def handshake(sock_path: Path, m):
    s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    s.settimeout(10.0)
    s.connect(str(sock_path))
    m.protocol.write_msg(s, {"type": "hello"})
    hello = m.protocol.read_msg(s)["type"]
    m.protocol.write_msg(s, {"type": "resync", "running": []})
    resync = m.protocol.read_msg(s)["type"]
    return s, (hello, resync)


# ---------------------------------------------------------------- protocol


def test_protocol_round_trip_launch_intent(tmp_path):
    """A raw launch intent over the socket executes create+start on the
    local engine and streams created/started/exited events back."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        sock = s.tenv.base / "wd.sock"
        srv = s.m.server.WorkerdServer(s.cfg, drv.local_engine(0),
                                       worker_id="fake-0",
                                       sock_path=sock).start()
        conn = None
        try:
            conn, hs = handshake(sock, s.m)
            s.m.protocol.write_msg(conn, {"type": "intents", "batch": [{
                "kind": "launch", "seq": 1, "agent": "proto-0",
                "epoch": 0, "iteration": 0,
                "opts": {"agent": "proto-0", "image": IMAGE,
                         "loop_id": "protorun", "worker": "fake-0",
                         "extra_labels": {
                             s.m.consts.LABEL_LOOP_EPOCH: "0"}},
            }]})
            got = []
            while len(got) < 3:
                frame = s.m.protocol.read_msg(conn)
                assert frame["type"] == "events"
                got.extend(frame["batch"])
            return {"handshake": hs,
                    "kinds": [ev["ev"] for ev in got[:3]],
                    "seqs": [ev.get("seq") for ev in got[:3]],
                    "cid": bool(got[0]["cid"]) and got[0]["cid"] ==
                    got[1]["cid"],
                    "exit": (got[2]["code"], got[2]["iteration"],
                             got[2]["agent"], got[2]["epoch"]),
                    "creates": total_creates(drv),
                    "stats": {k: srv.stats[k] for k in
                              ("intents", "events", "dedup_hits")}}
        finally:
            if conn is not None:
                conn.close()
            srv.stop()
            drv.close()

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["kinds"] == ["created", "started", "exited"]
    assert got["exit"] == (0, 0, "proto-0", 0) and got["creates"] == 1


def test_intent_dedup_no_double_create(tmp_path):
    """Re-sending an executed intent (a client retry across a partition)
    must not double-create: workerd dedups by (kind, agent, epoch,
    iteration)."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        sock = s.tenv.base / "wd.sock"
        srv = s.m.server.WorkerdServer(s.cfg, drv.local_engine(0),
                                       worker_id="fake-0",
                                       sock_path=sock).start()
        conn = None
        try:
            conn, _ = handshake(sock, s.m)
            intent = {"kind": "launch", "seq": 7, "agent": "dup-0",
                      "epoch": 0, "iteration": 0,
                      "opts": {"agent": "dup-0", "image": IMAGE,
                               "loop_id": "duprun", "worker": "fake-0"}}
            s.m.protocol.write_msg(conn, {"type": "intents",
                                          "batch": [intent]})
            s.m.protocol.write_msg(conn, {"type": "intents",
                                          "batch": [intent]})
            hit = wait_for(lambda: srv.stats["dedup_hits"] == 1)
            created = wait_for(lambda: total_creates(drv) == 1, 5.0)
            time.sleep(0.1)
            return (hit, created, srv.stats["dedup_hits"],
                    total_creates(drv))
        finally:
            if conn is not None:
                conn.close()
            srv.stop()
            drv.close()

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, True, 1, 1)


# ----------------------------------------------------------- full fan-out


def test_workerd_run_zero_remote_launch_calls(tmp_path):
    """An 8-loop/4-worker run over workerd executors completes with every
    create/start executed through the LOCAL views -- the remote (WAN)
    side never sees a launch call."""
    def scenario(s):
        drv = driver_with(s.m, 4)
        seen = record_calls(drv)
        servers, execset = pod(s, drv)
        try:
            sched = scheduler(s, drv, execset, parallel=8, iterations=3,
                              agent_prefix="wd")
            sched.start()
            loops = sched.run(poll_s=0.2)
            out = {"status": sched.status(), "creates": total_creates(drv),
                   "remote_launches": launch_calls(seen, local=False),
                   "local_creates": sum(
                       1 for calls in seen for n, loc in calls
                       if loc and n == "container_create"),
                   "intents": [srv.stats["intents"] for srv in servers],
                   "events": [srv.stats["events"] for srv in servers],
                   "done": all(l.status == "done" and l.iteration == 3
                               for l in loops)}
            sched.cleanup(remove_containers=True)
            return out
        finally:
            teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["done"] and got["creates"] == got["local_creates"] == 8
    assert got["remote_launches"] == 0
    # one launch and two restarts for each of a worker's two loops, and
    # the workspace seed shipped once; every server streamed its exits
    assert got["intents"] == [7] * 4
    assert all(n >= 3 for n in got["events"])


def test_event_stream_preserves_per_agent_bus_order(tmp_path):
    """Batched events from two agents on one worker interleave freely
    across agents but keep per-agent lifecycle order on the bus."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        servers, execset = pod(s, drv)
        events: list[tuple[str, str]] = []
        lock = threading.Lock()

        def on_event(agent, event, detail=""):
            with lock:
                events.append((agent, event))

        try:
            sched = scheduler(s, drv, execset, on_event=on_event,
                              parallel=4, iterations=2, agent_prefix="ord")
            sched.start()
            loops = sched.run(poll_s=0.2)
            sched.cleanup(remove_containers=True)
            sched.events.flush()
            return {l.agent: [e for a, e in events if a == l.agent
                              and e in ("created", "iteration_start",
                                        "iteration_done", "done")]
                    for l in loops if l.status == "done"}
        finally:
            teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario)
    assert got == want and len(got) == 4
    for seq in got.values():
        assert seq == ["created", "iteration_start", "iteration_done",
                       "iteration_start", "iteration_done", "done"]


# ------------------------------------------------------ partition / kill


def test_partition_mid_run_reconnects_zero_duplicate_creates(tmp_path):
    """Partition the channel right after launches are submitted: the
    executor redials + resyncs, buffered events replay, the run drains
    with zero duplicate creates and every exit accounted once."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, hold_behavior(hold))
        servers, execset = pod(s, drv)
        runner = None
        try:
            sched = scheduler(s, drv, execset, parallel=4, iterations=1,
                              agent_prefix="part")
            sched.start()
            runner = threading.Thread(target=sched.run,
                                      kwargs={"poll_s": 0.1}, daemon=True)
            runner.start()
            for srv in servers:
                srv.drop_conns()
            healed = wait_for(lambda: all(
                ex.live() for ex in execset.executors.values()), 5.0)
            hold.set()
            runner.join(15.0)
            recs = s.m.journal.RunJournal.read(
                s.m.journal.journal_path(s.cfg.logs_dir, sched.loop_id))
            exits = [(r["agent"], r["iteration"]) for r in recs
                     if r.get("kind") == "exited"]
            reconnects = sum(ex.reconnects
                             for ex in execset.executors.values())
            out = {"healed": healed, "finished": not runner.is_alive(),
                   "status": sched.status(), "creates": total_creates(drv),
                   "exits": sorted(exits),
                   "exits_once": len(exits) == len(set(exits)),
                   "reconnected": reconnects >= 2}
            sched.cleanup(remove_containers=True)
            out["undelivered"] = [srv.undelivered() for srv in servers]
            return out
        finally:
            hold.set()
            teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["healed"] and got["finished"] and got["reconnected"]
    assert all(r["status"] == "done" and r["iteration"] == 1
               for r in got["status"])
    assert got["creates"] == 4 and got["exits_once"]
    assert len(got["exits"]) == 4 and got["undelivered"] == [0, 0]


def test_workerd_kill_degrades_to_direct_path(tmp_path):
    """SIGKILL one worker's workerd before the run: its pending intents
    hit the deadline, the loops strand WITHOUT a breaker penalty, rescue
    re-places, and the run still drains (the degrade matrix row)."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        servers, execset = pod(s, drv, intent_deadline_s=1.0)
        try:
            sched = scheduler(s, drv, execset, parallel=4, iterations=2,
                              agent_prefix="kill", orphan_grace_s=30.0)
            servers[0].kill()
            sched.start()
            loops = sched.run(poll_s=0.1)
            out = {"done": [(l.status, l.iteration) for l in loops],
                   "breakers": [sched.health.state(w.id)
                                for w in drv.workers()]}
            sched.cleanup(remove_containers=True)
            return out
        finally:
            teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["done"] == [("done", 2)] * 4
    # workerd death is not engine sickness: no worker quarantined
    assert got["breakers"] == ["closed", "closed"]


# ------------------------------------------------------------ degrade


def test_no_executors_is_the_direct_path_unchanged(tmp_path):
    """executors=None is the direct in-process path: polls, waiters,
    lanes -- every launch call through the remote view."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        seen = record_calls(drv)
        try:
            sched = scheduler(s, drv, None, parallel=2, iterations=2,
                              agent_prefix="direct")
            assert sched._workerd_for(drv.workers()[0]) is None
            sched.start()
            sched.run(poll_s=0.1)
            out = {"status": sched.status(),
                   "local_launches": launch_calls(seen, local=True),
                   "remote_launches": launch_calls(seen, local=False)}
            sched.cleanup(remove_containers=True)
            return out
        finally:
            drv.close()

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert all(r["status"] == "done" and r["iteration"] == 2
               for r in got["status"])
    assert got["local_launches"] == 0 and got["remote_launches"] >= 4


# ------------------------------------------------------------- fake WAN


def test_fake_wan_rtt_remote_pays_local_does_not(tmp_path):
    """FakeDriver.set_rtt: the remote view pays the injected RTT per
    call; the local view (workerd's side) never does, while faults
    still apply to both (a dead daemon is dead from any side)."""
    def scenario(s):
        drv = s.m.drivers.FakeDriver(n_workers=1)
        drv.apis[0].add_image(IMAGE)
        try:
            drv.set_rtt(0, 0.05)
            remote = drv.workers()[0].require_engine()
            local = drv.local_engine(0)
            t0 = time.perf_counter()
            remote.ping()
            remote_cost = time.perf_counter() - t0
            t0 = time.perf_counter()
            local.ping()
            local_cost = time.perf_counter() - t0
            drv.inject_fault(0, "refuse")
            with pytest.raises(s.m.errors.DriverError):
                local.list_containers(all=True)
            drv.clear_fault(0)
            return remote_cost >= 0.05, local_cost < 0.02
        finally:
            drv.close()

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, True)


def inject_wan_rtt(drv, executors, rtt_s: float) -> None:
    """The fake-WAN knobs: every remote engine call pays ``rtt_s``, and
    each workerd channel half of it per frame each way."""
    drv.set_rtt_all(rtt_s)
    for ex in (executors.executors.values() if executors else ()):
        ex.rtt_s = rtt_s


@pytest.mark.slow
def test_rtt_independence_shape(tmp_path):
    """The bench's acceptance shape in miniature: with 50ms injected
    per-call RTT, the workerd path stays within 1.5x of its zero-RTT
    wall while the direct path visibly scales with RTT."""
    def scenario(s):
        def one(rtt_s: float, workerd: bool) -> float:
            drv = driver_with(s.m, 2)
            servers, execset = pod(s, drv) if workerd else ([], None)
            inject_wan_rtt(drv, execset, rtt_s)
            sched = s.m.loop.LoopScheduler(
                s.cfg, drv, s.m.loop.LoopSpec(
                    parallel=4, iterations=3, image=IMAGE,
                    agent_prefix=f"rtt{int(rtt_s * 1000)}"
                                 f"{'w' if workerd else 'd'}"),
                executors=execset)
            try:
                t0 = time.perf_counter()
                sched.start()
                loops = sched.run(poll_s=0.2)
                wall = time.perf_counter() - t0
                assert all(l.status == "done" for l in loops)
                inject_wan_rtt(drv, execset, 0.0)
                sched.cleanup(remove_containers=True)
            finally:
                teardown(servers, execset, drv)
            return wall

        wd_base, wd_rtt = one(0.0, True), one(0.05, True)
        direct_base, direct_rtt = one(0.0, False), one(0.05, False)
        return (wd_rtt <= max(1.5 * wd_base, wd_base + 0.6),
                direct_rtt >= direct_base + 0.5)

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, True)


# ----------------------------------------------------- liveness / CLI


def tap(servers) -> list[list[tuple]]:
    """Per server, every intent it executed as (kind, pool_cid) and
    every ``created`` event it emitted as ("created", pool, pool_error):
    the instance's ``_execute`` and ``_emit`` wrapped."""
    seen: list[list[tuple]] = [[] for _ in servers]
    for srv, log in zip(servers, seen):
        execute, emit = srv._execute, srv._emit

        def traced(intent, _execute=execute, _log=log):
            _log.append((intent.get("kind"), bool(intent.get("pool_cid"))))
            return _execute(intent)

        def emitted(ev, _emit=emit, _log=log):
            if ev.get("ev") == "created":
                _log.append(("created", ev.get("pool"),
                             ev.get("pool_error")))
            return _emit(ev)

        srv._execute, srv._emit = traced, emitted
    return seen


def test_workerd_sigkill_then_resume_adopts_zero_duplicate_creates(
        tmp_path):
    """Kill workerd AND the scheduler mid-run; a resume with no
    executors adopts the still-running containers in place: zero
    duplicate creates, every loop reaches its budget."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, hold_behavior(hold))
        servers, execset = pod(s, drv)
        try:
            sched1 = scheduler(s, drv, execset, parallel=4, iterations=1,
                               agent_prefix="res")
            sched1.start()
            runner = threading.Thread(target=sched1.run,
                                      kwargs={"poll_s": 0.1}, daemon=True)
            runner.start()
            assert wait_for(lambda: all(l.status == "running"
                                        for l in sched1.loops))
            creates_before = total_creates(drv)
            for srv in servers:
                srv.kill()
            sched1.kill()
            runner.join(10.0)
            execset.close_all()
            image = s.m.journal.replay(s.m.journal.RunJournal.read(
                s.m.journal.journal_path(s.cfg.logs_dir, sched1.loop_id)))
            sched2 = s.m.loop.LoopScheduler.resume(s.cfg, drv, image)
            summary = sched2.reconcile()
            duplicates = total_creates(drv) - creates_before
            runner2 = threading.Thread(target=sched2.run,
                                       kwargs={"poll_s": 0.1}, daemon=True)
            runner2.start()
            hold.set()
            runner2.join(15.0)
            out = {"summary": summary, "duplicates": duplicates,
                   "creates": total_creates(drv),
                   "done": [(l.status, l.iteration) for l in sched2.loops]}
            sched2.cleanup(remove_containers=True)
            return out
        finally:
            hold.set()
            teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["summary"]["adopted"] == 4 and got["duplicates"] == 0
    assert got["done"] == [("done", 1)] * 4 and got["creates"] == 4


def test_pool_fill_and_adoption_ride_workerd(tmp_path):
    """Warm-pool refills execute worker-resident (``create`` intents)
    and placements adopt pool members through launch intents'
    ``pool_cid``, whose ``created`` event reads ``pool: True`` with no
    ``pool_error``; no pool container leaks past cleanup."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        servers, execset = pod(s, drv)
        seen = tap(servers)
        try:
            sched = scheduler(s, drv, execset, parallel=1, iterations=2,
                              agent_prefix="pool", warm_pool_depth=1)
            sched.prefill_pool(timeout=5.0)
            prefilled = sched.warmpool.depth_of(drv.workers()[0].id)
            fill_intents = servers[0].stats["intents"]
            sched.start()
            loops = sched.run(poll_s=0.1)
            hits = sched.warmpool.stats()["hits"]
            sched.cleanup(remove_containers=True)
            leftovers = [c for c in drv.apis[0].containers.values()
                         if c.labels.get(s.m.consts.LABEL_LOOP)
                         == sched.loop_id]
            launches = [e for e in seen[0] if e[0] == "launch"]
            return {"prefilled": prefilled, "fill_intents": fill_intents,
                    "done": [(l.status, l.iteration) for l in loops],
                    "hits": hits, "leftovers": leftovers,
                    # the seed ships first, then the fill's create
                    "first": next(e for e in seen[0] if e[0] != "seed"),
                    "launches": launches,
                    "created": [e for e in seen[0] if e[0] == "created"],
                    "creates_via_intent": sum(1 for e in seen[0]
                                              if e[0] == "create")}
        finally:
            teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got["prefilled"] >= 1 and got["fill_intents"] >= 1
    assert got["first"] == ("create", False)      # the fill
    assert got["done"] == [("done", 2)] and got["hits"] >= 1
    assert got["launches"] == [("launch", True)]
    assert got["created"] == [("created", True, "")]
    assert got["leftovers"] == []


def test_liveness_live_degraded_absent(tmp_path):
    def scenario(s):
        drv = driver_with(s.m, 2)
        sock0 = s.tenv.base / "wd-0.sock"
        srv = s.m.server.WorkerdServer(s.cfg, drv.local_engine(0),
                                       worker_id="fake-0",
                                       sock_path=sock0).start()
        dead = s.tenv.base / "wd-1.sock"
        dead.touch()        # socket file with nothing behind it
        try:
            wids = [w.id for w in drv.workers()]
            mapped = s.m.workerd.liveness(
                s.cfg, drv, sock_by_worker={wids[0]: sock0,
                                            wids[1]: dead})
            return mapped, s.m.workerd.liveness(s.cfg, drv)
        finally:
            srv.stop()
            drv.close()

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == {"fake-0": "live", "fake-1": "degraded"}
    assert got[1] == {"fake-0": "absent", "fake-1": "absent"}


def _normalize(text: str, base: Path) -> str:
    text = text.replace(str(base), "BASE")
    return re.sub(r"pid \d+", "pid N", re.sub(r"uptime [\d.]+s", "uptime Ts",
                                              text))


def test_cli_workerd_start_status_stop(tmp_path, monkeypatch):
    """The verbs against a real detached daemon (fake engine)."""
    def scenario(s):
        monkeypatch.chdir(s.proj)
        s.tenv.write_settings(SETTINGS + "runtime:\n  driver: fake\n")
        if s.pkg == "ref":
            ref_root.register_commands()

            def invoke(args):
                return CliRunner().invoke(ref_root.cli, args)
        else:
            def invoke(args):
                return CliRunner().invoke(port_cli.cli, args)
        sock = s.m.workerd.socket_path(s.cfg)
        pidfile = s.m.workerd.pidfile_path(s.cfg)
        steps = []
        try:
            for args in (["workerd", "status"], ["workerd", "start"],
                         ["workerd", "status"], ["workerd", "stop"]):
                res = invoke(args)
                steps.append((args[1], res.exit_code,
                              _normalize(res.output, s.tenv.base),
                              s.m.executor.ping_socket(sock),
                              pidfile.exists()))
        finally:
            if s.m.executor.ping_socket(sock):
                invoke(["workerd", "stop"])
        return steps

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert [(step, rc, up, pid) for step, rc, _, up, pid in got] == [
        ("status", 1, False, False), ("start", 0, True, True),
        ("status", 0, True, True), ("stop", 0, False, False)]
    assert "no workerd answering" in got[0][2]
    assert "workerd started (pid N) on BASE/state/workerd/workerd.sock" \
        in got[1][2]
    assert "fake-0\tabsent" in got[2][2]


def test_socket_modes(tmp_path):
    """The loopd/bksession hardening pattern: 0700 runtime dir, 0600
    socket."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        sock = s.tenv.base / "rt" / "workerd.sock"
        srv = s.m.server.WorkerdServer(s.cfg, drv.local_engine(0),
                                       worker_id="fake-0",
                                       sock_path=sock).start()
        try:
            return (stat.S_IMODE(sock.parent.stat().st_mode),
                    stat.S_IMODE(sock.stat().st_mode))
        finally:
            srv.stop()
            drv.close()

    want, got = twin(tmp_path, scenario)
    assert got == want == (0o700, 0o600)


def test_cli_loop_workerd_with_none_answering_fails(tmp_path, monkeypatch):
    """``loop --workerd`` with no workerd answering fails as the
    reference's does, naming ``workerd start``, and launches nothing."""
    monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")

    def scenario(s):
        drv = driver_with(s.m, 1)
        args = ["loop", "-p", "1", "-n", "1", "--no-daemon", "--workerd"]
        if s.pkg == "ref":
            res = CliRunner().invoke(
                ref_root.cli, args,
                obj=ref_factory.Factory(cwd=s.proj, driver=drv))
        else:
            res = CliRunner().invoke(
                port_cli.cli, args,
                obj=port_cli.Factory(cwd=s.proj, driver=drv))
        return (res.exit_code,
                "--workerd: no workerd answering on any worker"
                in res.output,
                "workerd start" in res.output, total_creates(drv))

    want, got = twin(tmp_path, scenario)
    assert got == want == (1, True, True, 0)


# ---------------------------------------------------------------- loopd


def _loopd_run(s, *, kill_one: bool):
    """loopd hosting one run over workerd (a factory of executor sets,
    one a hosted run), the status RPC read while it runs and after.
    With ``kill_one`` worker 0's workerd dies once every loop runs: its
    row turns degraded and its loops finish on the direct path."""
    hold = threading.Event()
    drv = driver_with(s.m, 2, hold_behavior(hold) if kill_one else None)
    seen = record_calls(drv)
    servers, socks = servers_for(s, drv)
    made = []

    def factory():
        made.append(executors_for(s, socks, intent_deadline_s=5.0))
        return made[-1]

    srv = s.m.loopd_server.LoopdServer(s.cfg, drv, executors=factory).start()
    client = None
    try:
        client = s.m.loopd_client.LoopdClient(srv.sock_path)
        ack = client.submit_run({"parallel": 4, "iterations": 2})
        run_id = ack["run"]
        with s.m.loopd_client.LoopdClient(srv.sock_path) as c:
            def agents():
                return next(r["agents"] for r in c.status()["runs"]
                            if r["run"] == run_id)

            # the hosted scheduler (and its executor set) exists once the
            # run reports its agents
            running = wait_for(lambda: len(agents()) == 4 and (
                not kill_one
                or all(a["status"] == "running" for a in agents())), 10.0)
            rows_live = c.status()["workerd"]
        remote_before = launch_calls(seen, local=False)
        if kill_one:
            servers[0].kill()
            hold.set()
        final = None
        for frame in client.events():
            if frame.get("type") == "run_done":
                final = frame
        with s.m.loopd_client.LoopdClient(srv.sock_path) as c:
            rows_after = c.status()["workerd"]
        return {
            "running": running,
            "agents": sorted((a["status"], a["iteration"])
                             for a in final["agents"]),
            "ok": final["ok"], "creates": total_creates(drv),
            "remote_before": remote_before,
            "remote_starts_after_on_0": sum(
                1 for name, loc in seen[0]
                if not loc and name == "container_start"),
            "rows_live": rows_live, "rows_after": rows_after,
            "mapped": s.m.workerd.liveness(s.cfg, drv,
                                           sock_by_worker=socks),
            "sets": len(made),
            "closed": all(not ex.live() for ex in
                          made[0].executors.values()),
        }
    finally:
        hold.set()
        if client is not None:
            client.close()
        srv.stop()
        teardown(servers, None, drv)


def test_loopd_hosts_a_run_over_workerd(tmp_path):
    """``LoopdServer(executors=<factory>)`` builds one executor set per
    hosted run, dispatches its launches through workerd (no launch call
    on the remote views), closes the set after the run, and its status
    RPC's ``workerd`` rows read live for every worker.  The reference's
    rows read ``absent`` on a fake pod (it passes liveness no socket
    map); the port's are the reference's liveness over the executors'
    sockets."""
    want, got = twin(tmp_path, lambda s: _loopd_run(s, kill_one=False))
    for key in ("agents", "ok", "creates", "remote_before", "sets",
                "closed", "mapped"):
        assert got[key] == want[key], key
    assert got["agents"] == [("done", 2)] * 4 and got["ok"]
    assert got["creates"] == 4 and got["remote_before"] == 0
    assert got["sets"] == 1 and got["closed"]
    live = {"fake-0": "live", "fake-1": "live"}
    assert got["rows_live"] == got["mapped"] == live
    assert want["rows_live"] == {"fake-0": "absent", "fake-1": "absent"}


def test_loopd_workerd_kill_degrades_row_and_loops_go_direct(tmp_path):
    """Kill one worker's workerd while every hosted loop runs: its row
    turns ``degraded``, its loops' next iterations start over the
    direct path, and the run finishes."""
    want, got = twin(tmp_path, lambda s: _loopd_run(s, kill_one=True))
    for key in ("running", "agents", "ok", "creates", "mapped"):
        assert got[key] == want[key], key
    assert got["running"] and got["agents"] == [("done", 2)] * 4
    assert got["rows_live"] == {"fake-0": "live", "fake-1": "live"}
    assert got["rows_after"] == got["mapped"] == {"fake-0": "degraded",
                                                  "fake-1": "live"}
    assert got["remote_before"] == 0
    assert got["remote_starts_after_on_0"] >= 1
    assert want["remote_starts_after_on_0"] >= 1


# ------------------------------------------------------------- sentinel


def test_loop_over_workerd_with_sentinel_matches_reference(tmp_path,
                                                           injected):
    """The sentinel rides a run over workerd (on the CPU on the port's
    side): the same flags, per-agent z rows within ROW_Z_ATOL, the same
    behaviour snapshot as the reference's."""
    calls = {}

    def over_workerd(pkg, cfg, drv, tenv):
        calls[pkg] = record_calls(drv)
        return pod(SimpleNamespace(m=PKGS[pkg], cfg=cfg, tenv=tenv), drv)

    want = run_with_rider("ref", tmp_path, rider="sentinel", hot_slot=2,
                          pod=over_workerd)
    got = run_with_rider("port", tmp_path, rider="sentinel", hot_slot=2,
                         pod=over_workerd)
    hot = got["agents"][2]
    assert got["errors"] == want["errors"] == []
    assert got["scored"] == want["scored"] and got["scored"][0] > 0
    _assert_rows_agree(got, want)
    assert got["flagged"] == want["flagged"] and hot in got["flagged"]
    assert got["flags"] == want["flags"]
    assert got["snapshot"] == want["snapshot"]
    assert got["audit"] == want["audit"]
    for pkg in ("ref", "port"):
        assert launch_calls(calls[pkg], local=False) == 0
        # one create a loop, one start an iteration
        assert launch_calls(calls[pkg], local=True) == 8 + 8 * 2

