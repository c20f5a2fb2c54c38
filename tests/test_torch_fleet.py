"""The port's fleet transport, provisioning and ``tpu_vm`` driver against
the reference's, over the scripted-transcript seam.

Twins of tests/test_fleet.py (inventory parsing and discovery, the mux
argv, ``run``/``check``, ``push_paths``, the plan's shapes, the payload,
provisioning with its aborts, optional failures, streaming, one shared
tar and per-worker isolation, the driver's hosts and errors, the CLI's
dry run, workers and bad index), tests/test_channels.py (the ``-R``
forwards, the side channels, a remote loop agent's proxy URL),
tests/test_egress_feed.py's two remote cases, tests/test_health.py's
SSH probe and partial-dial cases, tests/test_loopd.py's loopd forward
and ``fleet status``.  Each twin runs the same input through both
packages, each over its own ``FakeRunner``, and holds the port's
transcripts, pushes, reports and output to the reference's.

The plans here run with ``with_cp=False`` / ``--no-cp`` as the
reference's tests do, but for the cases that hold the control-plane
half (``cp-unit``, ``verify-healthz``) against the reference's plan and
``make_scaler``'s ``tpu_vm`` provisioner.  No case reaches the network:
discovery's metadata and ``gcloud`` lookups are patched.
"""

from __future__ import annotations

import dataclasses
import io
import json
import tarfile
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.capacity as ref_capacity
import clawker_tpu.cli.cmd_fleet as ref_cmd_fleet
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.config.schema as ref_schema
import clawker_tpu.consts as ref_consts
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.drivers.tpu_vm as ref_tpu_vm
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.fleet as ref_fleet
import clawker_tpu.fleet.channels as ref_channels
import clawker_tpu.fleet.egress_tail as ref_egress
import clawker_tpu.fleet.inventory as ref_inventory
import clawker_tpu.fleet.provision as ref_provision
import clawker_tpu.fleet.transport as ref_transport
import clawker_tpu.health as ref_health
import clawker_tpu.hostproxy.manager as ref_hp_manager
import clawker_tpu.hostproxy.server as ref_hp_server
import clawker_tpu.loop as ref_loop
import clawker_tpu_torch.capacity as port_capacity
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.drivers.tpu_vm as port_tpu_vm
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.fleet as port_fleet
import clawker_tpu_torch.fleet.channels as port_channels
import clawker_tpu_torch.fleet.egress_tail as port_egress
import clawker_tpu_torch.fleet.inventory as port_inventory
import clawker_tpu_torch.fleet.provision as port_provision
import clawker_tpu_torch.fleet.transport as port_transport
import clawker_tpu_torch.health as port_health
import clawker_tpu_torch.hostproxy.manager as port_hp_manager
import clawker_tpu_torch.hostproxy.server as port_hp_server
import clawker_tpu_torch.loop as port_loop
from clawker_tpu.testenv import TestEnv

REPO = Path(__file__).resolve().parent.parent
IMAGE = "clawker-chanproj:default"

PKGS = {
    "ref": SimpleNamespace(
        pkg="ref", name="clawker_tpu", capacity=ref_capacity,
        config=ref_config, schema=ref_schema, consts=ref_consts,
        drivers=ref_drivers, tpu_vm=ref_tpu_vm, fake=ref_fake,
        errors=ref_errors, fleet=ref_fleet, channels=ref_channels,
        egress=ref_egress, inventory=ref_inventory,
        provision=ref_provision, transport=ref_transport,
        health=ref_health, hp_manager=ref_hp_manager,
        hp_server=ref_hp_server, loop=ref_loop),
    "port": SimpleNamespace(
        pkg="port", name="clawker_tpu_torch", capacity=port_capacity,
        config=port_config, schema=port_schema, consts=port_consts,
        drivers=port_drivers, tpu_vm=port_tpu_vm, fake=port_fake,
        errors=port_errors, fleet=port_fleet, channels=port_channels,
        egress=port_egress, inventory=port_inventory,
        provision=port_provision, transport=port_transport,
        health=port_health, hp_manager=port_hp_manager,
        hp_server=port_hp_server, loop=port_loop),
}


def both(fn):
    """``fn(m)`` for the reference's modules, then the port's: ->
    (reference's result, port's)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def wait_for(pred, timeout=5.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


@pytest.fixture(autouse=True)
def _no_discovery_network(monkeypatch):
    """Discovery past an explicit host list asks the GCE metadata server
    and ``gcloud``: neither may run here."""
    def no_metadata(*a, **k):
        raise urllib.error.URLError("metadata server patched out")

    for m in (ref_inventory, port_inventory):
        _patch_urlopen(monkeypatch, m, no_metadata)
        monkeypatch.setattr(m.subprocess, "run", _no_gcloud)


def _patch_urlopen(monkeypatch, inventory, urlopen) -> None:
    """Patch the metadata lookup's ``urlopen`` in one inventory module
    only (its ``urlrequest``), never ``urllib.request`` itself."""
    monkeypatch.setattr(inventory, "urlrequest", SimpleNamespace(
        Request=urllib.request.Request, urlopen=urlopen))


def _no_gcloud(*a, **k):
    raise OSError("gcloud patched out")


def _transport(m, tmp_path, runner=None, host="10.0.0.5", index=2):
    tpu = m.schema.TPUSettings(pod="v5e-test", ssh_user="ops",
                               ssh_key="/keys/id")
    runner = runner if runner is not None else m.transport.FakeRunner()
    return m.transport.SSHTransport(tpu, host, index,
                                    mux_dir=tmp_path / "mux", runner=runner)


def _fleet_transports(m, tmp_path, n=4):
    tpu = m.schema.TPUSettings(pod="v5e-test", ssh_user="ops",
                               ssh_key="/keys/id")
    return [m.transport.SSHTransport(tpu, f"10.0.0.{i}", i,
                                     mux_dir=tmp_path / "mux",
                                     runner=m.transport.FakeRunner())
            for i in range(n)]


def _report(rep) -> tuple:
    return (rep.host, rep.index, rep.ok,
            [(r.name, r.ok, r.detail) for r in rep.results])


def _untar(blob: bytes) -> dict:
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tf:
        return {ti.name: (tf.extractfile(ti).read() if ti.isfile() else None)
                for ti in tf.getmembers()}


# ----------------------------------------------------------------- inventory


@pytest.mark.parametrize("raw", ["10.0.0.1,10.0.0.2",
                                 "10.0.0.1:8470:0, 10.0.0.2:8470:1", "",
                                 " , 10.0.0.9 ,"])
def test_parse_worker_endpoints_formats(raw):
    want, got = both(lambda m: m.inventory.parse_worker_endpoints(raw))
    assert got == want
    if raw.startswith("10.0.0.1"):
        assert got == ["10.0.0.1", "10.0.0.2"]


def test_parse_describe_json_prefers_external_ip():
    raw = json.dumps({"networkEndpoints": [
        {"ipAddress": "10.0.0.1",
         "accessConfig": {"externalIp": "34.1.2.3"}},
        {"ipAddress": "10.0.0.2"},
        {"accessConfig": {}},
    ]})
    want, got = both(lambda m: m.inventory.parse_describe_json(raw))
    assert got == want == ["34.1.2.3", "10.0.0.2"]


def test_discover_workers_explicit_list_wins():
    want, got = both(lambda m: m.inventory.discover_workers(
        m.schema.TPUSettings(workers=["w0", "w1", "w2"])))
    assert got == want == ["w0", "w1", "w2"]


@pytest.mark.parametrize("source", ["metadata", "gcloud", "none",
                                    "gcloud fails"])
def test_discover_workers_order_metadata_then_gcloud(monkeypatch, source):
    """No explicit list: the metadata server first, then ``gcloud
    describe`` for the pod (with its zone and project), then nothing."""
    seen = []

    class Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def urlopen(req, timeout=None):
        seen.append(("metadata", req.full_url, req.get_header("Metadata-flavor"),
                     timeout))
        if source != "metadata":
            raise urllib.error.URLError("not on a TPU-VM")
        return Resp(b"10.1.0.1:8470:0,10.1.0.2:8470:1")

    def run(cmd, **kw):
        seen.append(("gcloud", cmd))
        if source == "gcloud fails":
            return SimpleNamespace(returncode=1, stdout="", stderr="denied\n")
        body = json.dumps({"networkEndpoints": [{"ipAddress": "10.2.0.1"}]})
        return SimpleNamespace(returncode=0, stdout=body, stderr="")

    def discover(m):
        seen.clear()
        _patch_urlopen(monkeypatch, m.inventory, urlopen)
        monkeypatch.setattr(m.inventory.subprocess, "run", run)
        tpu = m.schema.TPUSettings(pod="v5e-16", zone="us-w4-a", project="p1")
        try:
            out = m.inventory.discover_workers(tpu)
        except Exception as e:   # noqa: BLE001 -- compared across packages
            out = f"{type(e).__name__}: {e}"
        return out, list(seen)

    want, got = both(discover)
    assert got == want
    hosts = {"metadata": ["10.1.0.1", "10.1.0.2"], "gcloud": ["10.2.0.1"],
             "none": ["10.2.0.1"],
             "gcloud fails": "DriverError: gcloud describe v5e-16: denied"}
    assert got[0] == hosts[source]
    assert got[1][0][1] == port_inventory.METADATA_URL \
        == ref_inventory.METADATA_URL
    if source != "metadata":
        assert got[1][1][1][-4:] == ["--zone", "us-w4-a", "--project", "p1"]


# ----------------------------------------------------------------- transport


def test_ssh_base_has_mux_and_identity(tmp_path):
    want, got = both(lambda m: _transport(m, tmp_path).ssh_base())
    assert got == want
    joined = " ".join(got)
    assert "ControlMaster=auto" in joined and "ControlPersist=300" in joined
    assert "-i /keys/id" in joined and "BatchMode=yes" in joined
    assert got[-1] == "ops@10.0.0.5"


def test_run_and_check(tmp_path):
    def run(m):
        t = _transport(m, tmp_path)
        t.runner.script["docker info"] = (0, "27.0.1\n")
        out = [t.check("docker info")]
        t.runner.script["false-cmd"] = (1, "boom")
        with pytest.raises(m.transport.TransportError, match="boom") as ei:
            t.check("false-cmd")
        out.append(str(ei.value))
        res = t.run("uname -a")
        out.append(dataclasses.asdict(res))
        return out, t.runner.calls

    want, got = both(run)
    assert got == want
    assert got[0][0] == "27.0.1\n"
    assert all(c[0] == "ssh" for c in got[1])
    assert issubclass(port_transport.TransportError, port_errors.DriverError)


def test_push_paths_builds_tar(tmp_path):
    src = tmp_path / "hello.txt"
    src.write_text("payload")

    def push(m):
        t = _transport(m, tmp_path)
        t.push_paths({"sub/hello.txt": src}, "/opt/dest")
        [(dst, blob)] = list(t.runner.pushed.items())
        return dst, _untar(blob), t.runner.calls

    want, got = both(push)
    assert got == want
    assert got[1] == {"sub/hello.txt": b"payload"}
    last = " ".join(got[2][-1])
    assert "mkdir -p /opt/dest" in last and "tar -xzf -" in last


def test_push_failure_and_sudo_setup(tmp_path):
    def push(m):
        t = _transport(m, tmp_path)
        t.push_tar(b"x", "/opt/root owned", sudo=True)
        t.runner.script["tar -xzf"] = (2, "disk full")
        with pytest.raises(m.transport.TransportError) as ei:
            t.push_tar(b"x", "/opt/d")
        return str(ei.value), t.runner.calls

    want, got = both(push)
    assert got == want
    assert "push to /opt/d failed" in got[0]
    assert "sudo mkdir -p '/opt/root owned'" in got[1][0][-1]


def test_ssh_transport_probe_latency_and_failure(tmp_path):
    def probe(m):
        tpu = m.schema.TPUSettings(ssh_user="ops")
        t = m.transport.SSHTransport(tpu, "10.0.0.1", 0,
                                     mux_dir=tmp_path / "mux",
                                     runner=m.transport.FakeRunner())
        assert t.probe() >= 0.0
        down = m.transport.SSHTransport(
            tpu, "10.0.0.2", 1, mux_dir=tmp_path / "mux",
            runner=m.transport.FakeRunner({"true": (255, "broken pipe")}))
        with pytest.raises(m.transport.TransportError) as ei:
            down.probe()
        return t.runner.calls, str(ei.value)

    want, got = both(probe)
    assert got == want
    assert got[0][-1][-1] == "true"
    assert got[1] == "worker 1 (10.0.0.2): ssh probe rc=255: broken pipe"


def test_transport_forwards_loopd_and_workerd_sockets_over_mux(tmp_path):
    def fwd(m):
        tpu = m.schema.TPUSettings(ssh_user="clawker")
        t = m.transport.SSHTransport(tpu, "worker0", 0, mux_dir=tmp_path,
                                     runner=m.transport.FakeRunner())
        seen = []

        def fake_forward(remote_sock, tag="docker"):
            seen.append((remote_sock, tag))
            return tmp_path / f"{tag}-0.sock"

        t.forward_unix = fake_forward
        locals_ = [t.forward_loopd().name, t.forward_workerd().name]
        root = m.transport.SSHTransport(
            m.schema.TPUSettings(ssh_user="root"), "w", 1, mux_dir=tmp_path)
        return (seen, locals_, t.remote_loopd_sock(), t.remote_workerd_sock(),
                root.remote_workerd_sock())

    want, got = both(fwd)
    assert got == want
    assert got[2] == "/home/clawker/.local/state/clawker-tpu/loopd/loopd.sock"
    assert got[1] == ["loopd-0.sock", "workerd-0.sock"]
    assert got[4] == "/root/.local/state/clawker-tpu/workerd/workerd.sock"


def test_forward_unix_reports_a_forward_that_dies(tmp_path):
    """A forward whose ssh exits before its socket appears raises at
    once (the readiness loop polls the process), and ``close`` reaps."""
    class Dead:
        def poll(self):
            return 255

        def terminate(self):
            pass

        def wait(self, timeout=None):
            return 255

    def fwd(m):
        runner = m.transport.FakeRunner()
        runner.spawn = lambda argv: (runner.spawned.append(argv), Dead())[1]
        t = _transport(m, tmp_path, runner)
        t0 = time.monotonic()
        with pytest.raises(m.transport.TransportError) as ei:
            t.forward_unix("/var/run/docker.sock")
        quick = time.monotonic() - t0 < 2.0
        t.close()
        return str(ei.value), runner.spawned, quick, t._forwards

    want, got = both(fwd)
    assert got == want
    assert "did not come up" in got[0] and got[2] and got[3] == []
    assert "-N" in got[1][0] and "-L" in got[1][0]


# --------------------------------------------------------------- provisioning


@pytest.mark.parametrize("with_firewall", [True, False])
def test_build_plan_shapes(with_firewall):
    def plan(m):
        return [dataclasses.astuple(s) for s in m.provision.build_plan(
            with_firewall=with_firewall, with_cp=False)]

    want, got = both(plan)
    assert got == want
    names = [s[0] for s in got]
    assert names[0] == "preflight-docker" and "install-supervisor" in names
    assert ("kernel-load" in names) == with_firewall
    assert "verify-healthz" not in names
    assert all(s[2] for s in got if "ebpf" in s[0] or "kernel" in s[0])
    # the port's plan is the reference's full plan less its CP steps
    full = [dataclasses.astuple(s) for s in ref_provision.build_plan(
        with_firewall=with_firewall)]
    assert [s for s in full if s[0] not in ("cp-unit", "verify-healthz")] \
        == got


def _pkg_free(m, obj):
    """``obj`` as JSON with the package's name read ``PKG``."""
    return json.loads(json.dumps(obj).replace(m.name, "PKG"))


def test_control_plane_half_is_refused_by_name_before_any_ssh(tmp_path):
    """The control-plane half of the plan, as the reference plans it
    (tests/test_fleet.py:106-115): ``build_plan()`` ends its steps with
    ``cp-unit`` (the systemd unit, or ``nohup python3 -m
    <package>.controlplane``) and ``verify-healthz`` (``/healthz`` on
    ``CP_HEALTH_PORT``), and ``provision_worker`` and
    ``provision_fleet`` run them over SSH by default."""
    def prov(m):
        plan = [dataclasses.astuple(s) for s in m.provision.build_plan()]
        minimal = [s.name for s in m.provision.build_plan(
            with_firewall=False, with_cp=False)]
        t = _transport(m, tmp_path)
        report = _report(m.provision.provision_worker(t, REPO))
        ts = _fleet_transports(m, tmp_path / "fleet", n=2)
        fleet = [_report(r) for r in m.provision.provision_fleet(ts, REPO)]
        return _pkg_free(m, [plan, minimal, report,
                             [" ".join(c) for c in t.runner.calls], fleet])

    want, got = both(prov)
    assert got == want
    plan, minimal, report, calls, fleet = got
    names = [s[0] for s in plan]
    assert names[0] == "preflight-docker"
    assert "kernel-load" in names and "verify-healthz" in names
    assert names.index("install-supervisor") < names.index("cp-unit") \
        < names.index("verify-healthz") < names.index("e2e-smoke")
    assert "python3 -m PKG.controlplane" in plan[names.index("cp-unit")][1]
    assert f"127.0.0.1:{port_consts.CP_HEALTH_PORT}/healthz" in \
        plan[names.index("verify-healthz")][1]
    assert "verify-healthz" not in minimal and "install-supervisor" in minimal
    assert report[2] and {"cp-unit", "verify-healthz"} <= \
        {r[0] for r in report[3] if r[1]}
    assert any("clawker-cp.service" in c for c in calls)
    assert all(r[2] for r in fleet) and len(fleet) == 2


def test_payload_tar_contents():
    def names(m):
        blob = m.provision.payload_tar(REPO, monitor=True)
        members = _untar(blob)
        unit = members["clawker-cp.service"].decode()
        pkg = f"src/{m.name}/"
        return ({n for n in members if not n.startswith(pkg)
                 and not n.startswith("src/tests/")},
                {n[len(pkg):] for n in members if n.startswith(pkg)},
                unit.replace(m.name, "PKG"), set(members))

    want, got = both(names)
    # the native tree and the unit are the same; each package ships itself
    assert got[0] - {"src/clawker_tpu_torch"} == want[0] - {"src/clawker_tpu"}
    assert got[2] == want[2] and "CLAWKER_TPU_OTLP" in got[2]
    members = got[3]
    assert "src/clawker_tpu_torch/consts.py" in members
    assert "src/native/ebpf/fw.c" in members and "clawker-cp.service" in members
    assert not any(n.endswith(".pyc") or "__pycache__" in n for n in members)
    assert not any(n.startswith("src/clawker_tpu/") or n.startswith("src/tests")
                   for n in members)
    on_disk = {str(p.relative_to(REPO / "clawker_tpu_torch"))
               for p in (REPO / "clawker_tpu_torch").rglob("*")
               if "__pycache__" not in p.parts and p.suffix != ".pyc"
               and "build" not in p.parts}
    assert on_disk <= got[1] | {""}


def test_provision_worker_happy_path(tmp_path):
    def prov(m):
        t = _transport(m, tmp_path)
        report = m.provision.provision_worker(t, REPO, with_cp=False)
        return _report(report), t.runner.calls, list(t.runner.pushed)

    want, got = both(prov)
    assert got == want
    assert got[0][2], got[0]
    names = [r[0] for r in got[0][3]]
    assert names.index("push-payload") < names.index("build-native")
    assert got[2] == [port_provision.REMOTE_ROOT]


def test_provision_worker_aborts_on_required_failure(tmp_path):
    def prov(m):
        t = _transport(m, tmp_path)
        t.runner.script["docker info"] = (1, "Cannot connect to the Docker daemon")
        return _report(m.provision.provision_worker(t, REPO, with_cp=False))

    want, got = both(prov)
    assert got == want
    assert not got[2] and [r[0] for r in got[3]] == ["preflight-docker"]


def test_provision_worker_optional_failure_continues(tmp_path):
    def prov(m):
        t = _transport(m, tmp_path)
        t.runner.script["which clang"] = (1, "clang not found")
        return _report(m.provision.provision_worker(t, REPO, with_cp=False))

    want, got = both(prov)
    assert got == want
    byname = {r[0]: r for r in got[3]}
    assert got[2] and byname["toolchain-bpf"][1] and byname["toolchain-bpf"][2]


def test_provision_worker_streams_step_results(tmp_path):
    def prov(m):
        t = _transport(m, tmp_path)
        seen = []

        def on_step(i, r):
            seen.append((i, r.name))
            if r.name == "toolchain":
                raise RuntimeError("a broken progress consumer")

        report = m.provision.provision_worker(t, REPO, with_cp=False,
                                              on_step=on_step)
        return seen, _report(report)

    want, got = both(prov)
    assert got == want
    assert [n for _, n in got[0]] == [r[0] for r in got[1][3]]
    assert all(i == 2 for i, _ in got[0]) and got[1][2]


def test_provision_monitor_unit_and_mux_drop(tmp_path):
    def prov(m):
        units = [m.provision.systemd_unit(monitor=x) for x in (True, False)]
        t = _transport(m, tmp_path)
        m.provision.provision_worker(t, REPO, with_cp=False)
        joined = [" ".join(c) for c in t.runner.calls]
        return [u.replace(m.name, "PKG") for u in units], joined

    want, got = both(prov)
    assert got == want
    assert "CLAWKER_TPU_OTLP" in got[0][0] and "CLAWKER_TPU_OTLP" not in got[0][1]
    sshd_i = next(i for i, c in enumerate(got[1]) if "GatewayPorts" in c)
    assert "-O exit" in got[1][sshd_i + 1]


def test_provision_fleet_tars_the_payload_once(monkeypatch, tmp_path):
    def prov(m):
        builds = []
        real = m.provision.payload_tar

        def spy(repo_root, *, monitor=False):
            builds.append(repo_root)
            return real(repo_root, monitor=monitor)

        monkeypatch.setattr(m.provision, "payload_tar", spy)
        ts = _fleet_transports(m, tmp_path / m.pkg)
        reports = m.provision.provision_fleet(ts, REPO, with_cp=False)
        return ([r.ok for r in reports], len(builds),
                [list(t.runner.pushed) for t in ts])

    want, got = both(prov)
    assert got == want
    assert got[0] == [True] * 4 and got[1] == 1
    assert got[2] == [[port_provision.REMOTE_ROOT]] * 4


def test_provision_fleet_streams_reports_and_isolates_failure(tmp_path):
    def prov(m):
        ts = _fleet_transports(m, tmp_path / m.pkg)
        ts[2].runner.script["docker info"] = (1, "Cannot connect")
        streamed = []
        reports = m.provision.provision_fleet(
            ts, REPO, with_cp=False, max_workers=2,
            on_report=lambda r: streamed.append(r.index))
        return [_report(r) for r in reports], sorted(streamed)

    want, got = both(prov)
    assert got == want
    assert [r[1] for r in got[0]] == [0, 1, 2, 3] and got[1] == [0, 1, 2, 3]
    assert not got[0][2][2] and [r[0] for r in got[0][2][3]] == \
        ["preflight-docker"]
    assert all(got[0][i][2] for i in (0, 1, 3))


def test_provision_fleet_transport_blowup_is_one_failed_report(tmp_path):
    def prov(m):
        class ExplodingRunner(m.transport.FakeRunner):
            def run(self, argv, *, input_bytes=None, timeout=60.0):
                raise m.transport.TransportError("ssh melted")

        ts = _fleet_transports(m, tmp_path / m.pkg, n=3)
        ts[1] = m.transport.SSHTransport(
            m.schema.TPUSettings(pod="v5e-test", ssh_user="ops"), "10.0.0.1",
            1, mux_dir=tmp_path / "mux", runner=ExplodingRunner())
        return [_report(r) for r in m.provision.provision_fleet(
            ts, REPO, with_cp=False)]

    want, got = both(prov)
    assert got == want
    assert [r[2] for r in got] == [True, False, True]
    assert "ssh melted" in got[1][3][-1][2]


def test_provision_fleet_of_no_workers():
    want, got = both(lambda m: m.provision.provision_fleet([], REPO,
                                                           with_cp=False))
    assert got == want == []


# ------------------------------------------------------------------ scaler


def test_tpu_vm_scaler_without_cp_matches_reference(tmp_path, monkeypatch):
    """``TPUVMScaler(cfg, with_cp=False)`` provisions the next standby
    hosts over the shared provisioner and drains by id."""
    def scale(m):
        calls = []

        def fake_fleet(transports, repo_root, **kw):
            calls.append(([(t.host, t.index) for t in transports],
                          repo_root, kw))
            return [m.provision.ProvisionReport(
                t.host, t.index, [m.provision.StepResult(
                    "preflight-docker", t.host != "h1")])
                for t in transports]

        monkeypatch.setattr(m.provision, "provision_fleet", fake_fleet)
        settings = m.config.Settings()
        settings.runtime.tpu.workers = ["h0", "h1", "h2", "h3"]
        cfg = SimpleNamespace(settings=settings, ssh_mux_dir=tmp_path / "mux")
        sc = m.capacity.TPUVMScaler(cfg, with_cp=False)
        first = sc.provision(2)
        second = sc.provision(5)
        drained = sc.drain("h0")
        third = sc.provision(1)
        return (first, second, drained, third, sc.provisioned, sc.drained,
                [(hosts, Path(root).name, kw) for hosts, root, kw in calls])

    want, got = both(scale)
    assert got == want
    # h1 fails its plan both times it is picked; a drained host is
    # standby again
    assert got[:4] == (["h0"], ["h2", "h3"], True, ["h0"])
    assert got[6][0][2] == {"with_firewall": True, "with_cp": False,
                            "monitor": False}


def test_make_scaler_refuses_the_tpu_vm_control_plane_by_name(tmp_path,
                                                             monkeypatch):
    """``make_scaler`` on a ``tpu_vm`` driver returns the provisioner,
    whose default provisions the per-worker control plane too, as the
    reference's does."""
    def scale(m):
        calls = []
        monkeypatch.setattr(m.provision, "provision_fleet",
                            lambda ts, root, **kw: calls.append(kw) or [])
        settings = m.config.Settings()
        settings.runtime.tpu.workers = ["h0"]
        cfg = SimpleNamespace(settings=settings, ssh_mux_dir=tmp_path / "mux")
        sc = m.capacity.make_scaler(SimpleNamespace(name="tpu_vm"), cfg,
                                    max_workers=2)
        return [type(sc).__name__, sc.with_cp, sc.with_firewall,
                sc.provision(1), calls]

    want, got = both(scale)
    assert got == want
    assert got == ["TPUVMScaler", True, True, [],
                   [{"with_firewall": True, "with_cp": True,
                     "monitor": False}]]


# ------------------------------------------------------------------ driver


def test_tpu_vm_driver_hosts_and_order():
    want, got = both(lambda m: m.tpu_vm.TPUVMDriver(
        m.schema.TPUSettings(workers=["h0", "h1"])).hosts())
    assert got == want == ["h0", "h1"]


def test_tpu_vm_driver_no_workers_errors():
    def hosts(m):
        with pytest.raises(m.errors.DriverError) as ei:
            m.tpu_vm.TPUVMDriver(m.schema.TPUSettings()).hosts()
        return str(ei.value)

    want, got = both(hosts)
    assert got == want
    assert "no workers found" in got


def test_get_driver_builds_tpu_vm():
    settings = port_config.Settings()
    settings.runtime.driver = "tpu_vm"
    settings.runtime.tpu.workers = ["w0"]
    drv = port_drivers.get_driver(settings)
    assert isinstance(drv, port_drivers.TPUVMDriver)
    assert drv.tpu is settings.runtime.tpu and drv.name == "tpu_vm"
    ref = ref_drivers.get_driver(ref_config.Settings(), override="tpu_vm")
    assert type(ref).__name__ == type(drv).__name__


def test_tpu_vm_connect_tolerates_partial_dial_failure(monkeypatch):
    """One worker refusing to dial joins engine-less (its breaker
    pre-opened by the monitor); only a pod with none raises."""
    class FakeEngine:
        def ping(self):
            return True

        def list_containers(self, **kw):
            return []

        def close(self):
            pass

    def run(m):
        def fake_connect(tpu, host, index, *, runner=None):
            if host == "h1":
                raise m.transport.TransportError(
                    "worker 1 (h1): forward did not come up")
            return FakeEngine()

        monkeypatch.setattr(m.transport, "connect_worker_engine",
                            fake_connect)
        drv = m.tpu_vm.TPUVMDriver(m.schema.TPUSettings(
            workers=["h0", "h1", "h2"]))
        workers = drv.connect()
        fast = m.health.HealthConfig(
            probe_interval_s=0.03, probe_deadline_s=0.4,
            breaker=m.health.BreakerConfig(
                failure_threshold=2, backoff_base_s=0.05, backoff_max_s=0.2,
                backoff_jitter=0.0, half_open_successes=2))
        mon = m.health.HealthMonitor(drv, config=fast)
        state = mon.state("tpu-1")
        last = mon.breakers["tpu-1"].last_error
        res = mon.probe_all()
        monkeypatch.setattr(
            m.transport, "connect_worker_engine",
            lambda *a, **k: (_ for _ in ()).throw(
                m.transport.TransportError("all dead")))
        with pytest.raises(m.errors.DriverError) as ei:
            m.tpu_vm.TPUVMDriver(m.schema.TPUSettings(
                workers=["h0", "h1"])).connect()
        return ([(w.id, w.index, w.hostname, w.engine is None, w.meta)
                 for w in workers], state, last,
                {k: v.ok for k, v in res.items()}, str(ei.value))

    want, got = both(run)
    assert got == want
    assert [w[3] for w in got[0]] == [False, True, False]
    assert got[1] == port_health.BREAKER_OPEN
    assert "forward did not come up" in got[2]
    assert got[3] == {"tpu-0": True, "tpu-1": False, "tpu-2": True}
    assert got[4].startswith("tpu_vm: no worker could be dialed (")


# ------------------------------------------------------------ side channels


def remote_fake_driver(m, n_workers: int, runner, mux_dir):
    """Fake engines dressed as remote workers: each carries an
    SSHTransport over the scripted runner (what a tpu_vm engine has)."""
    drv = m.drivers.FakeDriver(n_workers=n_workers)
    for api in drv.apis:
        api.add_image(IMAGE)
        api.set_behavior(IMAGE, m.fake.exit_behavior(b"done\n", 0))
    for w in drv.workers():
        w.engine.transport = m.transport.SSHTransport(
            m.schema.TPUSettings(), f"10.0.0.{10 + w.index}", w.index,
            mux_dir=mux_dir / f"w{w.index}", runner=runner)
    return drv


def test_reverse_forward_spawns_ssh_dash_r(tmp_path):
    def rev(m):
        runner = m.transport.FakeRunner()
        t = m.transport.SSHTransport(m.schema.TPUSettings(), "10.0.0.5", 2,
                                     mux_dir=tmp_path, runner=runner)
        t.reverse_forward_tcp("172.28.0.1", 18374, "127.0.0.1", 18374,
                              tag="hostproxy")
        t.reverse_forward_tcp("172.28.0.1", 18374, "127.0.0.1", 18374,
                              tag="hostproxy")
        return runner.spawned, runner.calls

    want, got = both(rev)
    assert got == want
    (argv,) = got[0]
    assert "-R" in argv and "-N" in argv and "ExitOnForwardFailure=yes" in argv
    assert "172.28.0.1:18374:127.0.0.1:18374" in argv
    assert any("/dev/tcp/172.28.0.1/18374" in " ".join(c) for c in got[1])


def test_reverse_forward_failure_raises(tmp_path):
    class DeadProc:
        def poll(self):
            return 1

        def terminate(self):
            pass

        def wait(self, timeout=None):
            return 1

    def rev(m):
        runner = m.transport.FakeRunner({"/dev/tcp/172.28.0.1/18374": (1, "")})
        runner.spawn = lambda argv: DeadProc()
        t = m.transport.SSHTransport(m.schema.TPUSettings(), "10.0.0.5", 0,
                                     mux_dir=tmp_path, runner=runner)
        errs = []
        for _ in range(2):      # the failed tag is not cached: a retry
            with pytest.raises(m.transport.TransportError) as ei:
                t.reverse_forward_tcp("172.28.0.1", 18374, "127.0.0.1", 18374)
            errs.append(str(ei.value))
        return errs, t._rev_tags, t._forwards

    want, got = both(rev)
    assert got == want
    assert all("reverse forward" in e for e in got[0])
    assert not got[1] and not got[2]


@pytest.fixture
def chan_env():
    with TestEnv() as tenv:
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text(
            "project: chanproj\n"
            "security:\n"
            "  egress:\n"
            "    - dst: github.com\n"
            "      proto: https\n")
        yield tenv, proj


def test_local_engine_channels_use_host_gateway(chan_env):
    tenv, proj = chan_env
    tenv.write_settings("host_proxy:\n  enable: true\n  port: 18374\n"
                        "monitoring:\n  enable: true\n")

    def open_(m):
        cfg = m.config.load_config(proj)
        ch = m.channels.open_side_channels(m.drivers.FakeDriver().engine(), cfg)
        return dataclasses.asdict(ch)

    want, got = both(open_)
    assert got == want
    assert got["hostproxy_url"] == "http://host.docker.internal:18374"
    assert not got["remote"]


def test_remote_engine_channels_tunnel_to_gateway(chan_env, tmp_path,
                                                  monkeypatch):
    tenv, proj = chan_env
    tenv.write_settings("host_proxy:\n  enable: true\n  port: 18374\n"
                        "monitoring:\n  enable: true\n")

    def open_(m):
        cfg = m.config.load_config(proj)
        ensured = []
        monkeypatch.setattr(m.hp_manager, "ensure_running",
                            lambda c: ensured.append(True))
        runner = m.transport.FakeRunner()
        drv = remote_fake_driver(m, 1, runner, tmp_path / m.pkg)
        eng = drv.engine()
        ch = m.channels.open_side_channels(eng, cfg)
        gateway = eng.network_static_ip(m.consts.NETWORK_NAME, 1)
        n = len(runner.spawned)
        again = m.channels.open_side_channels(eng, cfg) is ch
        spawned = [[a.replace(str(tmp_path / m.pkg), "MUX") for a in argv]
                   for argv in runner.spawned]
        return (dataclasses.asdict(ch), gateway, ensured, spawned,
                again and len(runner.spawned) == n)

    want, got = both(open_)
    assert got == want
    ch, gateway, ensured, spawned, cached = got
    otlp = port_channels.OTLP_HTTP_PORT
    assert ch["remote"] and ensured and cached
    assert ch["hostproxy_url"] == f"http://{gateway}:18374"
    assert ch["otlp_endpoint"] == f"http://{gateway}:{otlp}"
    binds = [a for argv in spawned for a in argv if a.count(":") == 3]
    assert binds == [f"{gateway}:18374:127.0.0.1:18374",
                     f"{gateway}:{otlp}:127.0.0.1:{otlp}",
                     f"127.0.0.1:{otlp}:127.0.0.1:{otlp}"]


def test_loop_agent_on_remote_worker_resolves_git_cred_via_laptop_proxy(
        chan_env, tmp_path, monkeypatch):
    """A loop agent on a remote worker carries CLAWKER_HOSTPROXY = the
    tunnel bind; the laptop proxy answers a git-credential fill."""
    tenv, proj = chan_env
    tenv.write_settings("host_proxy:\n  enable: true\n  port: 0\n")

    def run(m):
        cfg = m.config.load_config(proj)
        proxy = m.hp_server.HostProxy(
            cfg, port=0,
            git_fill=lambda req: req + "username=bot\npassword=tok\n")
        proxy.start()
        monkeypatch.setattr(m.hp_manager, "ensure_running", lambda c: None)
        cfg.settings.host_proxy.port = proxy.bound_port
        runner = m.transport.FakeRunner()
        drv = remote_fake_driver(m, 2, runner, tmp_path / m.pkg)
        for w in drv.workers():
            w.engine.ensure_network(m.consts.NETWORK_NAME)
        sched = m.loop.LoopScheduler(cfg, drv, m.loop.LoopSpec(
            image=IMAGE, parallel=2, iterations=1, placement="spread"))
        urls = []
        try:
            sched.start()
            assert sched.wait_launched(timeout=30.0)
            for loop in sched.loops:
                eng = loop.worker.require_engine()
                info = eng.inspect_container(loop.container_id)
                env_map = dict(e.split("=", 1) for e in info["Config"]["Env"])
                gateway = eng.network_static_ip(m.consts.NETWORK_NAME, 1)
                urls.append(env_map["CLAWKER_HOSTPROXY"]
                            == f"http://{gateway}:{proxy.bound_port}")
            req = urllib.request.Request(
                f"http://127.0.0.1:{proxy.bound_port}/git/credential",
                data=b"protocol=https\nhost=github.com\n", method="POST")
            with urllib.request.urlopen(req, timeout=5) as resp:
                body = resp.read().decode()
        finally:
            sched.stop()
            sched.cleanup(remove_containers=True)
            proxy.stop()
        rbinds = sorted(a.split(":", 1)[1] for argv in runner.spawned
                        for a in argv if a.count(":") == 3)
        return urls, "password=tok" in body, rbinds

    want, got = both(run)
    assert got[:2] == want[:2] == ([True, True], True)
    # one -R a worker, to the proxy each package bound
    assert len(got[2]) == len(want[2]) == 2


# -------------------------------------------------------------- egress feed


def test_remote_tail_rides_ssh_mux(tmp_path):
    def tail(m):
        records = [json.dumps({"verdict": "deny", "dst": "9.9.9.9",
                               "dst_port": 443})]
        runner = m.transport.FakeRunner(
            stream_script={"tail -n +1 -F": records})
        transport = m.transport.SSHTransport(
            m.schema.TPUSettings(), "w1.example", 0,
            mux_dir=tmp_path / "mux", runner=runner)
        feed = m.egress.EgressFeed()
        feed.add_remote("tpu-1", transport)
        try:
            assert wait_for(lambda: len(feed.tail()) == 1)
        finally:
            feed.stop()
        return feed.tail(), runner.spawned

    want, got = both(tail)
    assert got == want
    assert got[0][0]["worker"] == "tpu-1" and got[0][0]["dst"] == "9.9.9.9"
    spawned = " ".join(got[1][0])
    assert "ssh" in spawned and port_egress.REMOTE_EGRESS_LOG in spawned


def test_add_worker_dispatches_on_transport(tmp_path):
    """A fake (local) worker tails the local file; an engine carrying a
    transport rides the remote lane."""
    log = tmp_path / "egress.jsonl"
    log.write_text(json.dumps({"verdict": "deny", "dst": "1.1.1.1"}) + "\n")

    def feed_of(m):
        drv = m.drivers.FakeDriver(n_workers=2)
        runner = m.transport.FakeRunner(stream_script={"tail -n +1 -F": [
            json.dumps({"verdict": "deny", "dst": "2.2.2.2"})]})
        drv.workers()[1].engine.transport = m.transport.SSHTransport(
            m.schema.TPUSettings(), "w1", 1, mux_dir=tmp_path / "mux",
            runner=runner)
        feed = m.egress.EgressFeed()
        for w in drv.workers():
            feed.add_worker(w, local_path=log)
        try:
            assert wait_for(lambda: len(feed.tail()) >= 2)
        finally:
            feed.stop()
        return sorted((r["worker"], r["dst"]) for r in feed.tail()), \
            len(runner.spawned)

    want, got = both(feed_of)
    assert got == want == ([("fake-0", "1.1.1.1"), ("fake-1", "2.2.2.2")], 1)


# ---------------------------------------------------------------------- CLI


@pytest.fixture
def cli_env():
    with TestEnv() as tenv:
        tenv.write_settings(
            "runtime:\n  tpu:\n    workers: [w0.example, w1.example]\n")
        proj = tenv.base / "p"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text("project: fleetproj\n")
        yield tenv, proj


def _cli(pkg, proj, argv):
    if pkg == "ref":
        return CliRunner().invoke(
            ref_root.cli, argv,
            obj=ref_factory.Factory(cwd=proj, driver=ref_drivers.FakeDriver()))
    return CliRunner().invoke(
        port_cli.cli, argv,
        obj=port_cli.Factory(cwd=proj, driver=port_drivers.FakeDriver()))


def _out(res) -> tuple:
    return res.exit_code, res.output.replace("clawker_tpu_torch", "clawker_tpu")


def test_fleet_cli_dry_run_and_workers(cli_env):
    tenv, proj = cli_env
    got = {pkg: [_out(_cli(pkg, proj, argv)) for argv in (
        ["fleet", "workers"],
        ["fleet", "provision", "--dry-run", "--no-cp"],
        ["fleet", "provision", "--dry-run", "--no-cp", "--no-firewall"])]
        for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    workers, plan, minimal = got["port"]
    assert workers == (0, "0\tw0.example\n1\tw1.example\n")
    assert plan[0] == 0 and "preflight-docker" in plan[1]
    assert "kernel-load" in plan[1] and "kernel-load" not in minimal[1]


def test_fleet_workers_exits_1_with_no_workers():
    with TestEnv() as tenv:
        proj = tenv.base / "p"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text("project: fleetproj\n")
        got = {pkg: _out(_cli(pkg, proj, ["fleet", "workers"]))
               for pkg in ("ref", "port")}
    assert got["port"] == got["ref"] == (1, "")


def test_fleet_cli_provision_bad_worker_index_errors(cli_env):
    tenv, proj = cli_env
    got = {pkg: _out(_cli(pkg, proj, ["fleet", "provision", "--no-cp",
                                      "--worker", "7"]))
           for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert got["port"][0] != 0
    assert "no such worker index" in got["port"][1] and "0, 1" in got["port"][1]


def test_fleet_cli_provision_without_no_cp_is_refused(cli_env, monkeypatch):
    """Without ``--no-cp`` the plan carries the control-plane steps:
    ``--dry-run`` prints the reference's plan, and a provision dials the
    workers."""
    tenv, proj = cli_env
    got = {pkg: _out(_cli(pkg, proj, ["fleet", "provision", "--dry-run"]))
           for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0
    assert "cp-unit" in got["port"][1] and "verify-healthz" in got["port"][1]
    dialed = []
    monkeypatch.setattr(port_cli.cmd_fleet, "_transports",
                        lambda f: dialed.append(f) or [])
    res = _cli("port", proj, ["fleet", "provision"])
    assert res.exit_code == 0 and len(dialed) == 1


def test_cli_provision_streams_per_worker_summaries(cli_env, tmp_path,
                                                    monkeypatch):
    """Each worker's summary streams the moment it finishes; a failed
    worker exits 1."""
    tenv, proj = cli_env
    got = {}
    for pkg, cmd in (("ref", ref_cmd_fleet), ("port", port_cli.cmd_fleet)):
        m = PKGS[pkg]
        ts = _fleet_transports(m, tmp_path / pkg, n=3)
        ts[1].runner.script["docker info"] = (1, "Cannot connect")
        monkeypatch.setattr(cmd, "_transports", lambda f, ts=ts: ts)
        seen = {}
        real = m.provision.provision_fleet

        def spy(transports, repo_root, _real=real, _seen=seen, **kw):
            _seen.update(kw)
            return _real(transports, repo_root, **kw)

        monkeypatch.setattr(m.provision, "provision_fleet", spy)
        res = _cli(pkg, proj, ["fleet", "provision", "--no-cp", "-j", "1"])
        lines = res.output.splitlines()
        got[pkg] = (res.exit_code, callable(seen.get("on_report")),
                    sorted(lines), [l for l in lines if ": ok" in l
                                    or "FAILED" in l])
    assert got["port"][:3] == got["ref"][:3]
    code, streamed, lines, summaries = got["port"]
    assert code == 1 and streamed
    assert "worker 0 (10.0.0.0): ok" in lines
    assert "worker 2 (10.0.0.2): ok" in lines
    assert "worker 1 (10.0.0.1): FAILED at preflight-docker: Cannot connect" \
        in lines
    assert sorted(summaries) == sorted(got["ref"][3])


@pytest.mark.parametrize("fmt", ["table", "json"])
def test_fleet_status_over_scripted_workers(cli_env, tmp_path, monkeypatch,
                                            fmt):
    tenv, proj = cli_env
    got = {}
    for pkg, cmd in (("ref", ref_cmd_fleet), ("port", port_cli.cmd_fleet)):
        m = PKGS[pkg]
        ts = _fleet_transports(m, tmp_path, n=3)
        ts[0].runner.script["docker info"] = (0, "27.0.1\n")
        ts[1].runner.script["docker info"] = (1, "Cannot connect")
        ts[2].runner.script["docker info"] = (0, "26.1.4\n")
        ts[2].runner.script["healthz"] = (7, "refused")
        monkeypatch.setattr(cmd, "_transports", lambda f, ts=ts: ts)
        res = _cli(pkg, proj, ["fleet", "status", "--format", fmt])
        got[pkg] = (_out(res), [t.runner.calls for t in ts])
    assert got["port"] == got["ref"]
    code, out = got["port"][0]
    assert code == 0
    if fmt == "json":
        rows = json.loads(out)
        assert [(r["docker"], r["control_plane"]) for r in rows] == \
            [("27.0.1", "ok"), ("DOWN", "ok"), ("26.1.4", "DOWN")]
    else:
        assert out.splitlines()[1] == "1\t10.0.0.1\tdocker=DOWN\tcp=ok"


def test_fleet_status_with_no_workers_names_the_settings():
    with TestEnv() as tenv:
        proj = tenv.base / "p"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text("project: fleetproj\n")
        got = {pkg: _out(_cli(pkg, proj, ["fleet", "status"]))
               for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1 and "runtime.tpu.workers" in got["port"][1]


def test_fleet_exports_match_reference():
    assert port_fleet.__all__ == ref_fleet.__all__
    assert port_fleet.discover_workers is port_inventory.discover_workers
    assert port_fleet.connect_worker_engine is \
        port_transport.connect_worker_engine
