"""nsd against the reference's on real namespaces (tier B).

Twins of tests/test_nsd.py's 11 cases and tests/test_nsd_firewall.py's
5, gated as those files gate themselves: by the reference's own
``nsd_capable()`` (root with ``unshare``/``nsenter``), and the firewall
cases also by its ``bpfkern.kernel_available()``.  Each case runs on the
reference's daemon and then on the port's, and compares what it
observes, with ids, times, each side's base dir and each side's cgroup
root masked: the reference's result is the baseline, whatever it is.  The
file starts one daemon per package, the second once the first listens,
each with a cgroup root of its own, ``<cgroup2>/clawker-nsd/twin-<side>-
<pid>``, removed at teardown with every container.  A case that raises
on one side is compared by its error, and every container a case left
is removed after it.  The connect probe runs only in a container the
raw-socket probe shows enforced, so no unenforced connect leaves the
host.  The cases that need no kernel (the API over a double, the
read-only binds, the driver) are in tests/test_torch_nsd.py.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.engine.drivers.nsdriver as ref_nsdriver
import clawker_tpu.firewall.bpfkern as ref_bpfkern
import clawker_tpu.firewall.enroll as ref_enroll
import clawker_tpu.firewall.model as ref_model
import clawker_tpu.firewall.runtime as ref_fwruntime
import clawker_tpu_torch.firewall.bpfkern as port_bpfkern
import clawker_tpu_torch.firewall.enroll as port_enroll
import clawker_tpu_torch.firewall.model as port_model
import clawker_tpu_torch.firewall.runtime as port_fwruntime
from test_torch_nsd import (  # noqa: F401 - _no_leftovers is autouse here too
    PKGS,
    _exec,
    _no_leftovers,
    bounded,
    case_archive_binds,
    case_attach_and_archive_before_start,
    case_concurrent,
    case_exec,
    case_lifecycle,
    case_ping_info_version,
    case_statuses,
    case_volumes_and_labels,
    create,
    logs,
    mask,
    run_to_exit,
    serve,
    stop,
    test_socket_modes_are_restrictive_at_bind,
    wait_for,
)

pytestmark = pytest.mark.skipif(
    not ref_nsdriver.nsd_capable(), reason="nsd needs root + unshare/nsenter")
needs_bpf = pytest.mark.skipif(
    not (ref_nsdriver.nsd_capable() and ref_bpfkern.kernel_available()),
    reason="needs root + unshare/nsenter + bpf(2) + cgroup-v2")

FW = {"ref": SimpleNamespace(enroll=ref_enroll, model=ref_model,
                             fwruntime=ref_fwruntime),
      "port": SimpleNamespace(enroll=port_enroll, model=port_model,
                              fwruntime=port_fwruntime)}


def cgroup_root(tag: str) -> Path | None:
    """``<cgroup2>/clawker-nsd/twin-<tag>-<pid>``, or None without a
    writable cgroup-v2 (the daemon then places no container in one)."""
    root = ref_bpfkern.cgroup2_root()
    if root is None:
        return None
    return root / "clawker-nsd" / f"twin-{tag}-{os.getpid()}"


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """Both packages' daemons on real namespaces, started in turn."""
    out = {}
    roots = []
    try:
        for tag, m in PKGS.items():
            cg = cgroup_root(tag)
            if cg is not None:
                cg.mkdir(parents=True, exist_ok=True)
                roots.append(cg)
            out[tag] = serve(m, tmp_path_factory.mktemp(f"nsd-{tag}"),
                             cgroup_root=cg or "")
        yield out
    finally:
        for side in out.values():
            stop(side)
        for cg in roots:
            wait_for(lambda: not any(p.is_dir() for p in cg.iterdir()), 5)
            try:
                cg.rmdir()
            except OSError:
                pass


def outcome(side, case, *args, **kw):
    """What ``case(side, ...)`` returned, or the error it raised (the
    reference's side may fail on this host: its failure is then the
    baseline), masked; every container the case left is removed."""
    try:
        got = case(side, *args, **kw)
    except Exception as e:  # noqa: BLE001 - compared by the twin
        got = ("raised", type(e).__name__, str(e))
    finally:
        for row in side.api.container_list(all=True):
            bounded(side.api.container_remove, row["Id"], force=True)
    return mask(got, side.base, side.cgroup)


def live_twin(live: dict, case, *args, **kw):
    """``case`` on the reference's daemon, then the port's: the outcomes
    agree; -> the reference's."""
    got = {tag: outcome(side, case, *args, **kw)
           for tag, side in live.items()}
    assert got["port"] == got["ref"]
    return got["ref"]


# ------------------------------------------------ twins of test_nsd.py


def test_ping_info_version(live):
    live_twin(live, case_ping_info_version)


def test_lifecycle_exit_code_and_framed_logs(live):
    live_twin(live, case_lifecycle)


def _isolation(side) -> bytes:
    cid = create(side, "iso1", ["sh", "-c", 'echo "pid=$$ host=$(hostname)"'],
                 Hostname="isolated-ns")
    run_to_exit(side, cid)
    out = logs(side, cid)
    side.api.container_remove(cid, force=True)
    return out


def test_pid_and_uts_isolation(live):
    live_twin(live, _isolation)


def _overlay(side) -> tuple:
    marker = side.base / f"nsd-breakout-{os.getpid()}"
    cid = create(side, "ovl1", ["sh", "-c", f"echo gotcha > {marker}"])
    code = run_to_exit(side, cid)
    leaked = marker.exists()
    side.api.container_remove(cid, force=True)
    return code, leaked


def test_overlay_writes_never_touch_host(live):
    live_twin(live, _overlay)


def test_attach_stdin_and_archive_before_start(live):
    live_twin(live, case_attach_and_archive_before_start,
              ["sh", "-c", "read l; echo got:$l; cat /seeded/f.txt"])


def test_archive_maps_bind_shadowed_paths(live):
    live_twin(live, case_archive_binds,
              ["sh", "-c", "cat /work/in.txt > /work/out.txt"])


def test_exec_in_namespaces_with_exit_code(live):
    live_twin(live, case_exec)


def test_volumes_and_label_filters(live):
    live_twin(live, case_volumes_and_labels,
              ["sh", "-c", "echo kept > /data/keep.txt"])


def test_conflict_and_not_found_map_to_http_statuses(live):
    live_twin(live, case_statuses)


def test_concurrent_lifecycles_do_not_interfere(live):
    live_twin(live, case_concurrent)


# test_socket_modes_are_restrictive_at_bind: imported above, one case a
# package, as tests/test_torch_nsd.py runs it


# ------------------------------------------ twins of test_nsd_firewall.py

# real-syscall probes run inside the containers (python3 comes from the
# host's root, every nsd container's lower layer)
_CONNECT_PROBE = (
    "python3 -c 'import socket\n"
    "s = socket.socket(); s.settimeout(2)\n"
    "try:\n"
    "    s.connect((\"10.99.0.1\", 80)); print(\"connected\")\n"
    "except OSError as e:\n"
    "    print(\"errno\", e.errno)'"
)
_RAW_PROBE = (
    "python3 -c 'import socket\n"
    "try:\n"
    "    socket.socket(socket.AF_INET, socket.SOCK_RAW, 1).close()\n"
    "    print(\"created\")\n"
    "except OSError as e:\n"
    "    print(\"errno\", e.errno)'"
)
_ESCAPE_PROBE = (
    "w1=sealed; w2=sealed; w3=sealed\n"
    "echo $$ > /sys/fs/cgroup/unified/cgroup.procs 2>/dev/null && w1=ESCAPED\n"
    "echo $$ > /sys/fs/cgroup/cgroup.procs 2>/dev/null && w2=ESCAPED\n"
    "mkdir -p /tmp/cgm && mount -t cgroup2 none /tmp/cgm 2>/dev/null && "
    "echo $$ > /tmp/cgm/cgroup.procs 2>/dev/null && w3=mounted-and-moved\n"
    "echo sysfs:$w1 hostpath:$w2 mount:$w3\n"
)


class _EngineShim:
    """CgroupResolver only needs ``inspect_container``."""

    def __init__(self, api):
        self.api = api

    def inspect_container(self, ref):
        return self.api.container_inspect(ref)


def probe(side, cid: str, script: str) -> str:
    out, _ = _exec(side, cid, ["sh", "-c", script])
    return b"".join(out.values()).decode("utf-8", "replace")


def connect_probe(side, cid: str) -> str:
    """The connect probe, where the raw-socket probe shows the container
    enforced: an unenforced container's connect would leave the host."""
    raw = probe(side, cid, _RAW_PROBE)
    if "errno 1" not in raw:
        return f"not enforced: {raw}"
    return probe(side, cid, _CONNECT_PROBE)


def _sleeper(side, name: str) -> str:
    cid = create(side, name, ["sh", "-c", "sleep 60"])
    side.api.container_start(cid)
    assert wait_for(lambda: side.api.container_inspect(cid)["State"]["Pid"])
    time.sleep(0.3)
    return cid


def fw_twin(live: dict, case):
    """``case(side, fw, resolver, attacher)`` with each package's own
    resolver and kernel attacher over its daemon; -> the reference's
    result, which the port's equals."""
    got = {}
    for tag, side in live.items():
        fw = FW[tag]
        attacher = fw.enroll.KernelAttacher()
        try:
            got[tag] = outcome(side, case, fw, fw.enroll.CgroupResolver(),
                               attacher)
        finally:
            attacher.close()
    assert got["port"] == got["ref"]
    return got["ref"]


def _enforce(fw, attacher, cg_id: int, cg_path: str) -> None:
    attacher.attach(cg_path)
    attacher.maps.enroll(cg_id, fw.model.ContainerPolicy(
        envoy_ip="127.0.0.1", dns_ip="127.0.0.1",
        flags=fw.model.FLAG_ENFORCE))


def _release(attacher, cg_id: int, cg_path: str) -> None:
    attacher.maps.unenroll(cg_id)
    attacher.detach(cg_path)


@needs_bpf
def test_enrolled_nsd_container_is_kernel_enforced(live):
    def case(side, fw, resolver, attacher):
        cid = _sleeper(side, "fw1")
        cg_id, cg_path = resolver.resolve(_EngineShim(side.api), cid)
        _enforce(fw, attacher, cg_id, cg_path)
        try:
            out = [connect_probe(side, cid),
                   probe(side, cid, "echo ok > /tmp/x && cat /tmp/x")]
            evs = attacher.maps.drain_events(512)
            return ("clawker-nsd" in cg_path, out,
                    any(e.cgroup_id == cg_id for e in evs))
        finally:
            _release(attacher, cg_id, cg_path)
            bounded(side.api.container_remove, cid, force=True)

    fw_twin(live, case)


@needs_bpf
def test_unenrolled_sibling_container_unaffected(live):
    def case(side, fw, resolver, attacher):
        a, b = _sleeper(side, "fw-a"), _sleeper(side, "fw-b")
        shim = _EngineShim(side.api)
        (cg_a, path_a), (cg_b, _) = (resolver.resolve(shim, a),
                                     resolver.resolve(shim, b))
        _enforce(fw, attacher, cg_a, path_a)
        try:
            return (cg_a != cg_b, probe(side, a, _RAW_PROBE),
                    probe(side, b, _RAW_PROBE))
        finally:
            _release(attacher, cg_a, path_a)
            for cid in (a, b):
                bounded(side.api.container_remove, cid, force=True)

    fw_twin(live, case)


@needs_bpf
def test_detach_restores_egress(live):
    def case(side, fw, resolver, attacher):
        cid = _sleeper(side, "fw-d")
        cg_id, cg_path = resolver.resolve(_EngineShim(side.api), cid)
        _enforce(fw, attacher, cg_id, cg_path)
        try:
            held = probe(side, cid, _RAW_PROBE)
        finally:
            _release(attacher, cg_id, cg_path)
        restored = probe(side, cid, _RAW_PROBE)
        bounded(side.api.container_remove, cid, force=True)
        return held, restored

    fw_twin(live, case)


@needs_bpf
def test_inprocess_lane_selected_by_runtime_factory():
    assert (port_fwruntime.inprocess_kernel_available()
            == ref_fwruntime.inprocess_kernel_available())
    assert port_bpfkern.kernel_available() == ref_bpfkern.kernel_available()


@needs_bpf
def test_container_cannot_escape_its_enforcement_cgroup(live):
    def case(side, fw, resolver, attacher):
        cid = _sleeper(side, "cgesc")
        cg_id, cg_path = resolver.resolve(_EngineShim(side.api), cid)
        _enforce(fw, attacher, cg_id, cg_path)
        try:
            return (probe(side, cid, _ESCAPE_PROBE),
                    connect_probe(side, cid))
        finally:
            _release(attacher, cg_id, cg_path)
            bounded(side.api.container_remove, cid, force=True)

    fw_twin(live, case)
