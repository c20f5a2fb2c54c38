"""The ``tpu_vm`` driver over a pod of SSH workers on one machine, the
port's against the reference's.

Both packages' ``TPUVMDriver`` dial through their real ``Runner``,
which execs ``ssh`` from ``PATH``: here the loopback ssh of
``clawker_tpu_torch.testenv.install_ssh_shim``, which serves each
worker host from a directory holding that worker's Docker socket (a
``FakeEngineDaemon``) and its home.  Each package gets its own pod and
its own ``TestEnv``, and each twin holds the port to the reference on
the same input: a ``loop`` run (placements by worker, events, journal
kinds, the requests each worker's daemon served), the side channels'
``-R`` forwards and URLs, workerd discovered over forwarded sockets,
the probe texts of a dead daemon and of a dead host, and ``fleet
anomaly`` over a 4-worker fake and over the pod.  The shim's refusal of
any command outside its short list is held too: nothing it is handed
beyond that list runs on this machine.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import shutil
import signal
import tempfile
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from click.testing import CliRunner
from test_torch_fleet_sentinel import ROW_Z_ATOL, _rec
from test_torch_sentinel import injected  # noqa: F401 -- fixture
from test_torch_warmpool import PKGS as LOOP_PKGS
from test_torch_warmpool import IMAGE, PROJECT, RUN_ID, SETTINGS, journal_of

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.fleet.channels as ref_channels
import clawker_tpu.hostproxy.manager as ref_hp_manager
import clawker_tpu.hostproxy.server as ref_hp_server
import clawker_tpu.workerd as ref_workerd
import clawker_tpu.workerd.executor as ref_executor
import clawker_tpu.workerd.server as ref_wd_server
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.fleet.channels as port_channels
import clawker_tpu_torch.hostproxy.manager as port_hp_manager
import clawker_tpu_torch.hostproxy.server as port_hp_server
import clawker_tpu_torch.workerd as port_workerd
import clawker_tpu_torch.workerd.executor as port_executor
import clawker_tpu_torch.workerd.server as port_wd_server
from clawker_tpu.testenv import TestEnv
from clawker_tpu_torch import sshseam
from clawker_tpu_torch.engine.fake import FakeDockerAPI, exit_behavior
from clawker_tpu_torch.testenv import FakeEngineDaemon, install_ssh_shim

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

PKGS = {pkg: SimpleNamespace(**vars(LOOP_PKGS[pkg])) for pkg in LOOP_PKGS}
for _pkg, _ch, _hpm, _hp, _wd, _ex, _srv in (
        ("ref", ref_channels, ref_hp_manager, ref_hp_server, ref_workerd,
         ref_executor, ref_wd_server),
        ("port", port_channels, port_hp_manager, port_hp_server,
         port_workerd, port_executor, port_wd_server)):
    PKGS[_pkg].channels, PKGS[_pkg].hp_server = _ch, _hp
    PKGS[_pkg].hp_manager = _hpm
    PKGS[_pkg].workerd, PKGS[_pkg].executor, PKGS[_pkg].wd_server = \
        _wd, _ex, _srv
    PKGS[_pkg].pkg = _pkg

WORKERS = 4
TRAIN_STEPS = 40
HOT = "clawker.p.loop-hot"
BASE_T = 1_700_000_000 - 1_700_000_000 % 60      # window-aligned
_RTT = re.compile(r"\d+ms rtt")
LAUNCH_ROUTES = ("container_create", "container_start", "container_remove")
EGRESS_GITHUB = ("security:\n  egress:\n    - dst: github.com\n"
                 "      proto: https\n")


@contextlib.contextmanager
def pod(tag: str, monkeypatch, *, n: int = WORKERS, down=(),
        behavior=None):
    """``n`` worker hosts ``<tag>w<i>`` on the loopback ssh, first on
    ``PATH``, each with a ``FakeEngineDaemon`` holding the loop image
    (hosts in ``down`` are marked down from the start); on the way out
    every daemon stops and no shim process may be left."""
    base = Path(tempfile.mkdtemp(prefix="p", dir="/tmp"))
    hosts = {f"{tag}w{i}": base / f"w{i}" for i in range(n)}
    shim = install_ssh_shim(base / "bin", hosts)
    monkeypatch.setenv("PATH", shim.env()["PATH"])
    for i in down:
        shim.set_down(f"{tag}w{i}")
    daemons = []
    try:
        for root in hosts.values():
            api = FakeDockerAPI()
            api.add_image(IMAGE)
            api.set_behavior(IMAGE, behavior
                             or exit_behavior(b"iter done\n", 0))
            daemons.append(FakeEngineDaemon(
                root / "var/run/docker.sock", api).start())
        yield SimpleNamespace(shim=shim, hosts=list(hosts), daemons=daemons,
                              roots=list(hosts.values()))
    finally:
        for d in daemons:
            d.stop()
        left = []
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            left = shim.live_pids()
            if not left:
                break
            time.sleep(0.05)
        for pid in left:        # a case that failed may leave forwards
            os.kill(pid, signal.SIGKILL)
        shutil.rmtree(base, ignore_errors=True)
        assert left == [], f"shim processes left: {left}"


@contextlib.contextmanager
def side(pkg: str, hosts: list[str], settings: str = "", project: str = ""):
    """One package's environment under a short temporary dir (the ssh
    mux sockets live under its state dir): -> namespace with ``m``,
    ``cfg``, ``proj``, ``tenv`` and ``pkg``."""
    base = Path(tempfile.mkdtemp(prefix="t", dir="/tmp"))
    try:
        with TestEnv(base=base) as tenv:
            tenv.write_settings(
                SETTINGS + "runtime:\n  driver: tpu_vm\n  tpu:\n"
                f"    workers: [{', '.join(hosts)}]\n" + settings)
            proj = base / "proj"
            proj.mkdir()
            (proj / ".clawker.yaml").write_text(f"project: {PROJECT}\n"
                                                + project)
            m = PKGS[pkg]
            yield SimpleNamespace(m=m, cfg=m.config.load_config(proj),
                                  proj=proj, tenv=tenv, pkg=pkg)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def tpu_vm(s):
    return s.m.drivers.get_driver(s.cfg.settings)


def _norm(text: str, s) -> str:
    """A text with the side's own paths and rtt taken out."""
    return _RTT.sub("Nms rtt", text.replace(str(s.tenv.base), "BASE"))


# -------------------------------------------------------------------- loop


def _loop_side(s, p, **spec):
    drv = tpu_vm(s)
    assert type(drv).__name__ == "TPUVMDriver"
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
    calls = collections.Counter(
        (r["kind"], p.hosts.index(r["host"])) for r in p.shim.invocations())
    return {"status": status, "events": dict(per_agent),
            "kinds": dict(kinds),
            # the launch routes: the health probes' count rides the clock
            "routes": [{k: d.routes.get(k, 0) for k in LAUNCH_ROUTES}
                       for d in p.daemons],
            "unrouted": [d.unrouted for d in p.daemons],
            "left": [len(d.api.containers) for d in p.daemons],
            "ssh": dict(calls)}


@pytest.mark.parametrize("spec", [
    dict(parallel=4, iterations=2, placement="spread"),
    dict(parallel=8, iterations=1, max_inflight_per_worker=1),
])
def test_loop_over_the_pod_matches_reference(monkeypatch, spec):
    out = {}
    for pkg in ("ref", "port"):
        with pod(pkg, monkeypatch) as p, side(pkg, p.hosts) as s:
            out[pkg] = _loop_side(s, p, **spec)
    assert out["port"] == out["ref"]
    got = out["port"]
    assert [r["status"] for r in got["status"]] == ["done"] * spec["parallel"]
    workers = collections.Counter(r["worker"] for r in got["status"])
    assert set(workers) == {f"tpu-{i}" for i in range(WORKERS)}
    assert got["unrouted"] == [[]] * WORKERS and got["left"] == [0] * WORKERS
    for i, routes in enumerate(got["routes"]):
        assert routes["container_create"] == workers[f"tpu-{i}"]
    # one docker forward a worker; the host proxy is off: no -R
    assert {k: v for k, v in got["ssh"].items() if k[0] == "L"} == \
        {("L", i): 1 for i in range(WORKERS)}
    assert not any(k[0] == "R" for k in got["ssh"])


# ----------------------------------------------------------- side channels


def test_side_channels_reverse_forward_to_the_laptop_proxy(monkeypatch):
    """Each worker's side channels: one ``-R`` from the worker's
    gateway to the proxy here, probed ready; a git-credential request
    at the worker's end of the tunnel is answered by this machine's
    proxy."""
    out = {}
    for pkg in ("ref", "port"):
        with pod(pkg, monkeypatch) as p, side(
                pkg, p.hosts, "host_proxy:\n  enable: true\n",
                EGRESS_GITHUB) as s:
            m = s.m
            proxy = m.hp_server.HostProxy(
                s.cfg, port=0,
                git_fill=lambda req: req + "username=bot\npassword=tok\n")
            proxy.start()
            monkeypatch.setattr(m.hp_manager, "ensure_running",
                                lambda c: None)
            s.cfg.settings.host_proxy.port = proxy.bound_port
            drv = tpu_vm(s)
            try:
                chans = [m.channels.open_side_channels(w.engine, s.cfg)
                         for w in drv.workers()]
                again = [m.channels.open_side_channels(w.engine, s.cfg)
                         for w in drv.workers()]
                answers = []
                for host in p.hosts:
                    req = urllib.request.Request(
                        f"http://{p.shim.address(host)}:{proxy.bound_port}"
                        "/git/credential",
                        data=b"protocol=https\nhost=github.com\n",
                        method="POST")
                    with urllib.request.urlopen(req, timeout=5) as resp:
                        answers.append("password=tok" in resp.read().decode())
            finally:
                drv.close()
                proxy.stop()
            port = proxy.bound_port
            rev = [(p.hosts.index(r["host"]),
                    [a.replace(str(port), "PORT") for a in r["argv"]
                     if a.count(":") == 3])
                   for r in p.shim.invocations() if r["kind"] == "R"]
            probes = [p.hosts.index(r["host"]) for r in p.shim.invocations()
                      if "/dev/tcp/" in (r.get("cmd") or "")]
            out[pkg] = ([{k: v.replace(str(port), "PORT")
                          for k, v in vars(c).items() if isinstance(v, str)}
                         | {"remote": c.remote} for c in chans],
                        [a is b for a, b in zip(chans, again)], answers,
                        sorted(rev), sorted(set(probes)))
    assert out["port"] == out["ref"]
    chans, cached, answers, rev, probes = out["port"]
    assert all(c == {"hostproxy_url": "http://172.28.0.1:PORT",
                     "otlp_endpoint": "", "remote": True} for c in chans)
    assert all(cached) and answers == [True] * WORKERS
    assert rev == [(i, ["172.28.0.1:PORT:127.0.0.1:PORT"])
                   for i in range(WORKERS)]
    assert probes == list(range(WORKERS))


# ----------------------------------------------------------------- workerd


def _wd_sock(root: Path) -> Path:
    return root / "home/clawker/.local/state/clawker-tpu/workerd/workerd.sock"


def test_workerd_discovered_over_forwarded_sockets(monkeypatch):
    """workerd answers on w0 and w1 only: executors for tpu-0/tpu-1, and
    the forwards of tpu-2/tpu-3 come up with nothing behind them."""
    out = {}
    for pkg in ("ref", "port"):
        with pod(pkg, monkeypatch) as p, side(pkg, p.hosts) as s:
            m = s.m
            servers = []
            try:
                for i in (0, 1):
                    eng = m.drivers.LocalDriver(
                        docker_host=f"unix://{p.roots[i]}/var/run/docker.sock"
                    ).engine()
                    servers.append(m.wd_server.WorkerdServer(
                        s.cfg, eng, worker_id=f"tpu-{i}",
                        sock_path=_wd_sock(p.roots[i])).start())
                drv = tpu_vm(s)
                before = m.workerd.liveness(s.cfg, drv)
                execs = m.executor.discover_executors(s.cfg, drv)
                after = m.workerd.liveness(s.cfg, drv)
                by_sock = m.workerd.liveness(
                    s.cfg, drv, sock_by_worker=execs.sockets())
                found = sorted(execs.executors)
                socks = sorted(Path(x).name for x in execs.sockets().values())
                execs.close_all()
                drv.close()
            finally:
                for srv in servers:
                    srv.stop()
            forwards = collections.Counter(
                p.hosts.index(r["host"]) for r in p.shim.invocations()
                if r["kind"] == "L" and "workerd.sock" in " ".join(r["argv"]))
            out[pkg] = (before, found, socks, after, by_sock, dict(forwards))
    assert out["port"] == out["ref"]
    before, found, socks, after, by_sock, forwards = out["port"]
    assert found == ["tpu-0", "tpu-1"]
    assert socks == ["workerd-0.sock", "workerd-1.sock"]
    assert forwards == {i: 1 for i in range(WORKERS)}
    assert set(before.values()) == {"absent"}
    assert after == by_sock == {"tpu-0": "live", "tpu-1": "live",
                                "tpu-2": "degraded", "tpu-3": "degraded"}


# ------------------------------------------------------------------ probes


def test_probe_tells_a_dead_daemon_from_a_dead_host(monkeypatch):
    out = {}
    for pkg in ("ref", "port"):
        with pod(pkg, monkeypatch) as p, side(pkg, p.hosts) as s:
            drv = tpu_vm(s)
            ws = drv.workers()
            texts = {}
            drv.probe(ws[0])
            p.daemons[1].stop()
            p.shim.set_down(p.hosts[3])
            time.sleep(3 * sshseam.POLL_S)
            for w in ws[1:]:
                try:
                    drv.probe(w)
                    texts[w.id] = "ok"
                except s.m.errors.DriverError as e:
                    texts[w.id] = _norm(str(e), s)
            texts["diagnose"] = [_norm(drv.diagnose(w), s) for w in ws]
            drv.close()
            out[pkg] = texts
    assert out["port"] == out["ref"]
    got = out["port"]
    assert got["tpu-1"].startswith(
        "worker tpu-1: docker daemon unreachable but host ssh alive (Nms rtt")
    assert got["tpu-2"] == "ok"
    assert got["tpu-3"].startswith("worker tpu-3: host unreachable over ssh")
    assert got["diagnose"][3] == "host unreachable over ssh"
    assert got["diagnose"][1] == "host ssh alive (Nms rtt); daemon hung?"


def test_a_worker_down_from_the_start_joins_engine_less(monkeypatch):
    out = {}
    for pkg in ("ref", "port"):
        with pod(pkg, monkeypatch, down=(2,)) as p, side(pkg, p.hosts) as s:
            drv = tpu_vm(s)
            ws = drv.connect()
            fast = s.m.health.HealthConfig(probe_interval_s=0.03,
                                           probe_deadline_s=0.4)
            mon = s.m.health.HealthMonitor(drv, config=fast)
            out[pkg] = ([(w.id, w.engine is None,
                          _norm(w.meta.get("dial_error", ""), s))
                         for w in ws],
                        mon.state("tpu-2") == s.m.health.BREAKER_OPEN)
            drv.close()
    assert out["port"] == out["ref"]
    rows, state = out["port"]
    assert [r[1] for r in rows] == [False, False, True, False]
    assert "socket forward /var/run/docker.sock" in rows[2][2]
    assert state


def test_a_pod_with_no_worker_up_raises(monkeypatch):
    out = {}
    for pkg in ("ref", "port"):
        with pod(pkg, monkeypatch, n=2, down=(0, 1)) as p, \
                side(pkg, p.hosts) as s:
            with pytest.raises(s.m.errors.DriverError) as ei:
                tpu_vm(s).connect()
            out[pkg] = _norm(str(ei.value), s)
    assert out["port"] == out["ref"]
    assert out["port"].startswith("tpu_vm: no worker could be dialed (tpu-0:")


# ------------------------------------------------------------- fleet anomaly


def _egress(workers: list[str], hot_worker: str) -> dict[str, list[dict]]:
    """Each worker's records: two benign agents a worker over six
    windows, and a deny storm from ``HOT`` on ``hot_worker``."""
    out = {w: [] for w in workers}
    for i, w in enumerate(workers):
        for a in range(2):
            agent = f"clawker.p.loop-{2 * i + a}"
            for win in range(6):
                out[w] += [_rec(BASE_T + win * 60 + k * 3, agent=agent,
                                ip=f"198.51.100.{(2 * i + a) * 20 + k}")
                           for k in range(12)]
    out[hot_worker] += [_rec(BASE_T + 5 * 60 + k % 59, agent=HOT,
                             verdict="DENY", reason="NO_DNS_ENTRY",
                             ip=f"203.0.113.{k}", port=4444 + k, zone="")
                        for k in range(55)]
    return out


def _write(path: Path, recs: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))


def _anomaly(s, driver=None) -> tuple[int, dict]:
    argv = ["fleet", "anomaly", "--no-daemon", "--format", "json",
            "--train-steps", str(TRAIN_STEPS)]
    if s.pkg == "ref":
        fac = ref_factory.Factory(cwd=s.proj, driver=driver)
        try:
            res = CliRunner().invoke(ref_root.cli, argv, obj=fac,
                                     catch_exceptions=False)
        finally:
            if driver is None:
                # the reference's CLI leaves its driver's forwards up
                fac.driver.close()
    else:
        res = CliRunner().invoke(
            port_cli.cli, argv,
            obj=port_cli.Factory(cwd=s.proj, driver=driver),
            env={port_cli.DEVICE_ENV: "cpu"}, catch_exceptions=False)
    return res.exit_code, json.loads(res.output)


def _rows(doc: dict) -> list[tuple]:
    return [(r["agent"], r["worker"], r["windows"], r["flagged"],
             r["stream_records"]) for r in doc["rows"]]


def _same_scores(got: dict, want: dict) -> None:
    assert _rows(got) == _rows(want)
    assert got["threshold"] == want["threshold"]
    assert got["stream_counts"] == want["stream_counts"]
    for r, w in zip(got["rows"], want["rows"]):
        assert r["latest_z"] == pytest.approx(w["latest_z"], abs=ROW_Z_ATOL)
        assert r["peak_z"] == pytest.approx(w["peak_z"], abs=ROW_Z_ATOL)
    assert {(f["agent"], f["worker"]) for f in got["flags"]} == \
        {(f["agent"], f["worker"]) for f in want["flags"]}


SENTINEL_SETTINGS = "sentinel:\n  threshold: 2.75\n  baseline_window: 128\n"


def test_fleet_anomaly_over_a_four_worker_fake_matches_reference(
        monkeypatch, injected):
    """The repair: the verb's sentinel tails the configured driver's
    workers (each fake worker's own stream under the logs dir) with
    settings ``sentinel``'s threshold, as the reference's does."""
    workers = [f"fake-{i}" for i in range(WORKERS)]
    recs = _egress(workers, "fake-2")
    out = {}
    for pkg in ("ref", "port"):
        with side(pkg, [], SENTINEL_SETTINGS) as s:
            for w, rs in recs.items():
                _write(s.cfg.logs_dir / f"ebpf-egress-{w}.jsonl",
                       [{k: v for k, v in r.items() if k != "worker"}
                        for r in rs])
            drv = s.m.drivers.FakeDriver(n_workers=WORKERS)
            out[pkg] = _anomaly(s, drv)
            drv.close()
    (code, got), (want_code, want) = out["port"], out["ref"]
    assert code == want_code == 2
    _same_scores(got, want)
    assert got["threshold"] == 2.75
    assert set(got["stream_counts"]) == set(workers)
    assert (HOT, "fake-2") in {(f["agent"], f["worker"]) for f in got["flags"]}


def test_fleet_anomaly_over_the_pod_matches_reference(monkeypatch, injected):
    """The same over the pod: each worker's stream is read by a remote
    ``tail -F`` over its ssh, and the records carry ``tpu-<i>``."""
    out = {}
    for pkg in ("ref", "port"):
        with pod(pkg, monkeypatch) as p, \
                side(pkg, p.hosts, SENTINEL_SETTINGS) as s:
            recs = _egress([f"tpu-{i}" for i in range(WORKERS)], "tpu-2")
            for i, root in enumerate(p.roots):
                _write(root / "home/clawker/.local/state/clawker-tpu/logs"
                       "/ebpf-egress.jsonl",
                       [{k: v for k, v in r.items() if k != "worker"}
                        for r in recs[f"tpu-{i}"]])
            out[pkg] = _anomaly(s)
            tails = collections.Counter(
                p.hosts.index(r["host"]) for r in p.shim.invocations()
                if (r.get("cmd") or "").startswith("tail -n +1 -F"))
            out[pkg] += (dict(tails),)
    (code, got, tails), (want_code, want, want_tails) = \
        out["port"], out["ref"]
    assert code == want_code == 2
    _same_scores(got, want)
    assert tails == want_tails == {i: 1 for i in range(WORKERS)}
    assert got["stream_counts"] == {f"tpu-{i}": n for i, n in enumerate(
        [144, 144, 144 + 55, 144])}
    assert (HOT, "tpu-2") in {(f["agent"], f["worker"]) for f in got["flags"]}


# -------------------------------------------------------------------- shim


@pytest.mark.parametrize("cmd", [
    "sudo true", "apt-get install -y -q python3", "make -C /opt/x",
    "systemctl restart docker", "docker ps", "true; touch MARK",
    "tail -n +1 -F /x 2>/dev/null; touch MARK",
    "mkdir -p /a && tar -xzf - -C /b", "bash -c 'touch MARK'",
    "timeout 2 bash -c 'exec 3<>/dev/tcp/1.2.3.4/1' 2>/dev/null; touch MARK",
])
def test_shim_refuses_commands_outside_its_list(tmp_path, monkeypatch, cmd):
    from clawker_tpu_torch.config.schema import TPUSettings
    from clawker_tpu_torch.fleet.transport import SSHTransport

    mark = tmp_path / "mark"
    with pod("x", monkeypatch, n=1) as p:
        t = SSHTransport(TPUSettings(), p.hosts[0], 0,
                         mux_dir=tmp_path / "mux")
        res = t.run(cmd.replace("MARK", str(mark)), timeout=30)
        kinds = [r["kind"] for r in p.shim.invocations()]
    assert res.rc == 127, res
    assert "loopback ssh: command not allowed" in res.err
    assert not mark.exists() and kinds == ["cmd"]


def test_shim_runs_its_list_under_the_worker_root(tmp_path, monkeypatch):
    """``true``, a push, and a tail under the worker's home; the mux
    exit answers; a down host is refused with ssh's text."""
    import io
    import tarfile

    from clawker_tpu_torch.config.schema import TPUSettings
    from clawker_tpu_torch.fleet.transport import SSHTransport

    with pod("y", monkeypatch, n=2) as p:
        t = SSHTransport(TPUSettings(), p.hosts[0], 0,
                         mux_dir=tmp_path / "mux")
        assert t.probe() >= 0.0
        src = tmp_path / "f.txt"
        src.write_text("payload")
        t.push_paths({"d/f.txt": src}, "/opt/dest")
        assert (p.roots[0] / "opt/dest/d/f.txt").read_text() == "payload"
        log = p.roots[0] / "home/clawker/.local/state/clawker-tpu/logs"
        _write(log / "ebpf-egress.jsonl", [{"dst": "9.9.9.9"}])
        proc = t.runner.spawn_piped(t.ssh_base() + [
            "tail -n +1 -F ${XDG_STATE_HOME:-$HOME/.local/state}"
            "/clawker-tpu/logs/ebpf-egress.jsonl 2>/dev/null"])
        assert json.loads(proc.stdout.readline()) == {"dst": "9.9.9.9"}
        proc.terminate()
        proc.wait(timeout=3)
        t.drop_mux()
        p.shim.set_down(p.hosts[1])
        down = SSHTransport(TPUSettings(), p.hosts[1], 1,
                            mux_dir=tmp_path / "mux")
        res = down.run("true")
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            ti = tarfile.TarInfo("../../escape")
            ti.size = 1
            tf.addfile(ti, io.BytesIO(b"x"))
        with pytest.raises(Exception):
            t.push_tar(buf.getvalue(), "/opt/dest")
        kinds = collections.Counter(r["kind"] for r in p.shim.invocations())
    assert res.rc == 255
    assert res.err.strip() == \
        f"ssh: connect to host {p.hosts[1]} port 22: Connection refused"
    assert kinds == {"cmd": 5, "O": 1}
    assert not (p.roots[0].parent / "escape").exists()


def test_shim_refuses_a_root_too_deep_for_a_socket_path(tmp_path):
    deep = tmp_path / ("d" * 60)
    with pytest.raises(ValueError, match="too deep"):
        install_ssh_shim(tmp_path / "bin", {"w0": deep})


def test_shim_parses_ssh_argv_as_openssh_does():
    opts, dest, cmd = sshseam.parse_argv(
        ["-o", "BatchMode=yes", "-oControlPath=/m/%r@%h:%p", "-i", "/k",
         "-N", "-L", "/a.sock:/b.sock", "-nT", "u@h", "tail", "-n", "+1"])
    assert dest == "u@h" and cmd == "tail -n +1"
    assert ("-L", "/a.sock:/b.sock") in opts and ("-n", "") in opts
    assert ("-o", "ControlPath=/m/%r@%h:%p") in opts
