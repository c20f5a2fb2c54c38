"""Worker provisioning: turn a bare TPU-VM into a clawker-tpu worker.

A provisioning *plan* is data -- an ordered list of steps, each one
remote command with a human name -- executed over any transport runner,
so the full sequence is unit-testable against scripted transcripts and
auditable before it touches a fleet (``clawker fleet provision
--dry-run`` prints it).

Steps (mirroring what the reference gets from its multi-stage
Dockerfile.controlplane build + local installs, re-shaped for remote
workers -- SURVEY.md 7 step 7):

1. preflight: docker daemon present + cgroup2 + bpffs mounted
2. toolchain: python3, g++, make (+ clang/libbpf-dev for the kernel half)
3. push the source payload (native/ + the clawker_tpu_torch package)
4. build: supervisor binary, fw.o + fwctl (skipped without clang)
5. install: binaries onto PATH, package into a venv-less site dir
6. kernel: fwctl load (pin maps+programs) -- skipped without clang
7. control plane: systemd unit (or nohup fallback) running
   ``python3 -m clawker_tpu_torch.controlplane`` per worker
8. verify: healthz answers on the worker

Failure of any step aborts the remaining steps for that worker and
reports; other workers proceed independently (per-worker isolation).

The port's copy of ``clawker_tpu/fleet/provision.py``.  Steps 1-6 are
the reference's, word for word.  The payload ships
``clawker_tpu_torch/`` and ``native/``; the reference's ``tests/e2e``
imports the reference package, so no e2e suite ships and the optional
``e2e-smoke`` step reports as skipped on a worker.  Steps 7-8 start
and probe the port's control plane, as the reference's start its own.
"""

from __future__ import annotations

import io
import tarfile
from dataclasses import dataclass, field
from pathlib import Path

from .. import consts, logsetup
from .transport import SSHTransport, TransportError

log = logsetup.get("fleet.provision")

REMOTE_ROOT = "/opt/clawker-tpu"


def systemd_unit(*, monitor: bool = False) -> str:
    """The per-worker CP unit.  With ``monitor``, CLAWKER_TPU_OTLP points
    the worker netlogger at the laptop collector behind the SSH -R
    loopback tunnel (fleet/channels.py); without it the env is absent so
    disabled telemetry generates zero failed connects."""
    otlp = (f"Environment=CLAWKER_TPU_OTLP=http://127.0.0.1:"
            f"{consts.OTLP_HTTP_PORT}\n" if monitor else "")
    return f"""[Unit]
Description=clawker-tpu per-worker control plane
After=docker.service
[Service]
Environment=PYTHONPATH={REMOTE_ROOT}/src
{otlp}ExecStart=/usr/bin/python3 -m clawker_tpu_torch.controlplane
Restart=on-failure
RestartSec=3
[Install]
WantedBy=multi-user.target
"""


@dataclass
class Step:
    name: str
    cmd: str
    optional: bool = False      # failure logs but does not abort the plan
    timeout: float = 300.0


@dataclass
class StepResult:
    name: str
    ok: bool
    detail: str = ""


@dataclass
class ProvisionReport:
    host: str
    index: int
    results: list[StepResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)


def build_plan(*, with_firewall: bool = True, with_cp: bool = True) -> list[Step]:
    steps = [
        Step("preflight-docker", "docker info --format '{{.ServerVersion}}'"),
        Step("preflight-cgroup2",
             "test -f /sys/fs/cgroup/cgroup.controllers"),
        Step("preflight-bpffs",
             "mountpoint -q /sys/fs/bpf || sudo mount -t bpf bpf /sys/fs/bpf"),
        Step("toolchain",
             "which python3 g++ make || sudo apt-get install -y -q "
             "python3 g++ make"),
        # Reverse forwards for the side channel (hostproxy/OTLP tunnels,
        # fleet/channels.py) must bind the worker's docker-gateway address
        # so containers can reach them; sshd only honors non-loopback -R
        # binds with GatewayPorts clientspecified.
        Step("sshd-gateway-ports",
             "test -f /etc/ssh/sshd_config.d/60-clawker.conf || "
             "(echo 'GatewayPorts clientspecified' | sudo tee "
             "/etc/ssh/sshd_config.d/60-clawker.conf >/dev/null && "
             "(sudo systemctl reload sshd || sudo systemctl reload ssh))",
             optional=True),
    ]
    if with_firewall:
        steps.append(Step(
            "toolchain-bpf",
            "which clang || sudo apt-get install -y -q clang libbpf-dev",
            optional=True,
        ))
    steps += [
        # (payload push happens between these steps; see provision_worker)
        Step("build-native", f"make -C {REMOTE_ROOT}/src/native"),
    ]
    if with_firewall:
        steps += [
            Step("build-ebpf",
                 f"which clang && make -C {REMOTE_ROOT}/src/native/ebpf all",
                 optional=True),
            Step("install-fwctl",
                 f"test -f {REMOTE_ROOT}/src/native/ebpf/build/fwctl && "
                 f"sudo install {REMOTE_ROOT}/src/native/ebpf/build/fwctl "
                 "/usr/local/bin/clawker-fwctl",
                 optional=True),
            Step("kernel-load",
                 f"test -f {REMOTE_ROOT}/src/native/ebpf/build/fw.o && "
                 "sudo clawker-fwctl load "
                 f"--obj {REMOTE_ROOT}/src/native/ebpf/build/fw.o "
                 f"--pin-dir {consts.BPF_PIN_DIR}",
                 optional=True),
        ]
    steps.append(Step(
        "install-supervisor",
        f"sudo install {REMOTE_ROOT}/src/native/build/clawker-supervisord "
        "/usr/local/bin/clawker-supervisord",
    ))
    if with_cp:
        steps += [
            Step("cp-unit",
                 f"sudo cp {REMOTE_ROOT}/clawker-cp.service "
                 "/etc/systemd/system/ && sudo systemctl daemon-reload && "
                 "sudo systemctl enable --now clawker-cp.service || "
                 f"(PYTHONPATH={REMOTE_ROOT}/src nohup python3 -m "
                 "clawker_tpu_torch.controlplane >/tmp/clawker-cp.log 2>&1 &)"),
            Step("verify-healthz",
                 "for i in $(seq 1 30); do "
                 f"curl -fsS http://127.0.0.1:{consts.CP_HEALTH_PORT}/healthz "
                 "&& exit 0; sleep 1; done; exit 1",
                 timeout=60.0),
        ]
    # real-daemon smoke, as the reference plans it; the port ships no
    # tests/e2e (module docstring), so on a worker this optional step
    # fails and reports as skipped
    steps.append(Step(
        "e2e-smoke",
        f"cd {REMOTE_ROOT}/src && CLAWKER_TPU_E2E=1 "
        "python3 -m pytest tests/e2e -q",
        optional=True, timeout=300.0,
    ))
    return steps


def payload_tar(repo_root: Path, *, monitor: bool = False) -> bytes:
    """Source payload: the package + native tree + the CP systemd unit."""
    buf = io.BytesIO()

    def _clean(ti: tarfile.TarInfo) -> tarfile.TarInfo | None:
        name = Path(ti.name).name
        if name in ("__pycache__", ".pytest_cache", "build") or name.endswith(".pyc"):
            return None
        return ti

    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        tf.add(str(repo_root / "clawker_tpu_torch"),
               arcname="src/clawker_tpu_torch", filter=_clean)
        tf.add(str(repo_root / "native"), arcname="src/native", filter=_clean)
        unit = systemd_unit(monitor=monitor).encode()
        ti = tarfile.TarInfo("clawker-cp.service")
        ti.size = len(unit)
        tf.addfile(ti, io.BytesIO(unit))
    return buf.getvalue()


def provision_worker(
    transport: SSHTransport,
    repo_root: Path,
    *,
    with_firewall: bool = True,
    with_cp: bool = True,
    monitor: bool = False,
    payload: bytes | None = None,
    on_step=None,
) -> ProvisionReport:
    """Run the plan against one worker.

    ``payload``: pre-built :func:`payload_tar` bytes -- fleet callers
    build the tar ONCE and share it across every worker
    (:func:`provision_fleet`); a standalone call may omit it and pay the
    build here.  ``on_step(worker_index, StepResult)`` streams each step
    result the moment it lands (CLI progress while other workers are
    still mid-plan).
    """
    report = ProvisionReport(transport.host, transport.index)
    plan = build_plan(with_firewall=with_firewall, with_cp=with_cp)

    def record(res: StepResult) -> None:
        report.results.append(res)
        if on_step is not None:
            try:
                on_step(transport.index, res)
            except Exception:
                # a broken progress consumer must not abort provisioning
                log.exception("on_step callback failed (worker %d)",
                              transport.index)

    pushed = False
    for step in plan:
        # the payload rides in right before the first build step
        if step.name == "build-native" and not pushed:
            try:
                blob = (payload if payload is not None
                        else payload_tar(repo_root, monitor=monitor))
                transport.push_tar(blob, REMOTE_ROOT, sudo=True)
                record(StepResult("push-payload", True))
            except TransportError as e:
                record(StepResult("push-payload", False, str(e)))
                return report
            pushed = True
        res = transport.run(step.cmd, timeout=step.timeout)
        ok = res.rc == 0
        detail = (res.err or res.out).strip()[:500]
        record(StepResult(step.name, ok or step.optional,
                          "" if ok else detail))
        log.info("worker %d %s: %s", transport.index, step.name,
                 "ok" if ok else f"FAILED ({detail[:120]})" if not step.optional
                 else f"skipped ({detail[:120]})")
        if step.name == "sshd-gateway-ports" and ok:
            # sshd reload only affects NEW connections; drop the mux so
            # later -R forwards (which ride it) see GatewayPorts
            transport.drop_mux()
        if not ok and not step.optional:
            return report
    return report


def provision_fleet(
    transports: list[SSHTransport],
    repo_root: Path,
    *,
    with_firewall: bool = True,
    with_cp: bool = True,
    monitor: bool = False,
    max_workers: int = 8,
    on_step=None,
    on_report=None,
) -> list[ProvisionReport]:
    """Provision every worker concurrently, one-pass.

    The payload is tarred ONCE and shared (provisioning K workers used
    to tar the repo K times), and the per-worker plans run over a
    bounded thread pool -- the same idiom as the tpu_vm driver's
    parallel dial (engine/drivers/tpu_vm.py), so wall time no longer
    stacks O(K * RTT) with pod size.  ``on_report(report)`` fires the
    moment each worker finishes (streaming CLI output); the returned
    list is in transport order regardless of completion order.  One
    worker's transport blowing up becomes a failed report for that
    worker, never an abort of the rest (per-worker isolation).
    """
    from concurrent.futures import ThreadPoolExecutor, as_completed

    if not transports:
        return []
    payload = payload_tar(repo_root, monitor=monitor)

    def one(t: SSHTransport) -> ProvisionReport:
        try:
            return provision_worker(
                t, repo_root, with_firewall=with_firewall, with_cp=with_cp,
                monitor=monitor, payload=payload, on_step=on_step)
        except Exception as e:    # transport layer raised past the plan
            rep = ProvisionReport(t.host, t.index)
            rep.results.append(StepResult("transport", False, str(e)))
            return rep

    by_index: dict[int, ProvisionReport] = {}
    with ThreadPoolExecutor(
            max_workers=min(max_workers, len(transports))) as pool:
        futs = [pool.submit(one, t) for t in transports]
        for fut in as_completed(futs):
            rep = fut.result()
            by_index[rep.index] = rep
            if on_report is not None:
                try:
                    on_report(rep)
                except Exception:
                    log.exception("on_report callback failed (worker %d)",
                                  rep.index)
    return [by_index[t.index] for t in transports]
