"""Step-plan executor: the CP drives agentd through typed plans.

Parity reference: controlplane/agent/exec.go:212-340 (Executor + Step
plans) with **InitPlan** (init_steps.go:67 -- config, git, git-credentials,
ssh, post-init, AgentInitialized) and **BootPlan** (boot_steps.go:52 --
docker-socket, pre-run, AgentReady), each step dispatched as ShellCommand
pipelines over the Session stream with per-stage uid/gid drop.

This build keeps the same shape: a plan is an ordered list of ``Step``
values (pure data, independently testable); ``Executor.run_plan`` walks
them over one ``SessionClient``, stops on the first hard failure, and
reports per-step results.  Steps degrade loudly -- a missing optional tool
(e.g. git absent from a minimal image) is a *soft* skip only when the step
is marked ``best_effort``.

The port's copy of ``clawker_tpu/controlplane/executor.py``, whole.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass, field

from .. import consts, logsetup
from .session_client import SessionClient, SessionError

log = logsetup.get("cp.executor")


@dataclass
class Step:
    """One shell-command step of a plan."""

    name: str
    stages: list[dict]                     # [{"argv": [...], "uid": N, "gid": N}]
    env: dict[str, str] = field(default_factory=dict)
    cwd: str = ""
    stdin: bytes | None = None
    timeout: float = 120.0
    best_effort: bool = False              # non-zero exit degrades, not aborts


@dataclass
class StepResult:
    name: str
    code: int
    stdout: bytes = b""
    stderr: bytes = b""
    skipped: bool = False

    @property
    def ok(self) -> bool:
        return self.skipped or self.code == 0


@dataclass
class PlanResult:
    plan: str
    steps: list[StepResult] = field(default_factory=list)
    aborted_at: str = ""

    @property
    def ok(self) -> bool:
        return not self.aborted_at


@dataclass
class AgentProfile:
    """Everything the plans need to know about one agent container.

    Built by the dialer from container labels + inspect output; plans are
    pure functions of this profile so they are testable without a daemon.
    """

    project: str
    agent: str
    uid: int = 0
    gid: int = 0
    workdir: str = "/workspace"
    cmd: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    git_user_name: str = ""
    git_user_email: str = ""
    post_init: str = ""                    # path of harness post-init script in image
    pre_run: str = ""                      # path of pre-run hook script
    docker_socket: bool = False            # docker.sock mounted -> fix group access
    host_proxy_url: str = ""               # http://<gw>:18374 when host proxy is on

    @property
    def full_name(self) -> str:
        return f"{self.project}.{self.agent}"


def _sh(script: str, *, uid: int = 0, gid: int = 0) -> list[dict]:
    return [{"argv": ["/bin/sh", "-c", script], "uid": uid, "gid": gid}]


def init_plan(p: AgentProfile) -> list[Step]:
    """The once-per-agent-container initialization plan.

    Parity: init_steps.go:67 ordering -- config, git, git-credentials, ssh,
    post-init.  AgentInitialized is sent by the executor's caller after the
    plan succeeds (it is a session verb, not a shell step).
    """
    steps: list[Step] = []
    steps.append(
        Step(
            name="config",
            stages=_sh(
                "mkdir -p /var/lib/clawker && "
                f"printf '%s\\n' {shlex.quote(p.full_name)} > /var/lib/clawker/agent-name"
            ),
        )
    )
    git_script = (
        f"command -v git >/dev/null 2>&1 || exit 0; "
        f"git config --global --add safe.directory {shlex.quote(p.workdir)}; "
        f"git config --global --add safe.directory '*'"
    )
    if p.git_user_name:
        git_script += f"; git config --global user.name {shlex.quote(p.git_user_name)}"
    if p.git_user_email:
        git_script += f"; git config --global user.email {shlex.quote(p.git_user_email)}"
    steps.append(
        Step(name="git", stages=_sh(git_script, uid=p.uid, gid=p.gid), best_effort=True)
    )
    if p.host_proxy_url:
        cred = (
            "command -v git >/dev/null 2>&1 || exit 0; "
            "git config --global credential.helper "
            f"{shlex.quote('!' + consts.GIT_CREDENTIAL_HELPER_PATH)}"
        )
        steps.append(
            Step(
                name="git-credentials",
                stages=_sh(cred, uid=p.uid, gid=p.gid),
                env={"CLAWKER_HOST_PROXY": p.host_proxy_url},
                best_effort=True,
            )
        )
    steps.append(
        Step(
            name="ssh",
            stages=_sh(
                "d=$(eval echo ~$(id -un)); mkdir -p \"$d/.ssh\" && chmod 700 \"$d/.ssh\"",
                uid=p.uid,
                gid=p.gid,
            ),
            best_effort=True,
        )
    )
    if p.post_init:
        steps.append(
            Step(
                name="post-init",
                stages=_sh(
                    f"[ -x {shlex.quote(p.post_init)} ] && {shlex.quote(p.post_init)} || exit 0",
                    uid=p.uid,
                    gid=p.gid,
                ),
                env=dict(p.env),
                cwd=p.workdir,
                timeout=600.0,
            )
        )
    return steps


def boot_plan(p: AgentProfile) -> list[Step]:
    """The every-container-start plan.  Parity: boot_steps.go:52 --
    docker-socket, pre-run; AgentReady is the session verb that follows."""
    steps: list[Step] = []
    if p.docker_socket:
        steps.append(
            Step(
                name="docker-socket",
                stages=_sh(
                    "[ -S /var/run/docker.sock ] || exit 0; "
                    f"chgrp {p.gid or 0} /var/run/docker.sock && "
                    "chmod g+rw /var/run/docker.sock",
                ),
                best_effort=True,
            )
        )
    if p.pre_run:
        steps.append(
            Step(
                name="pre-run",
                stages=_sh(
                    f"[ -x {shlex.quote(p.pre_run)} ] && {shlex.quote(p.pre_run)} || exit 0",
                    uid=p.uid,
                    gid=p.gid,
                ),
                env=dict(p.env),
                cwd=p.workdir,
                timeout=300.0,
            )
        )
    return steps


class Executor:
    """Runs plans over a live session, collecting per-step results."""

    def __init__(self, session: SessionClient, *, full_name: str = ""):
        self.session = session
        self.full_name = full_name

    def run_plan(self, plan_name: str, steps: list[Step]) -> PlanResult:
        result = PlanResult(plan=plan_name)
        for step in steps:
            try:
                shell = self.session.run_shell(
                    step.stages,
                    env=step.env,
                    cwd=step.cwd,
                    stdin=step.stdin,
                    timeout=step.timeout,
                )
            except SessionError as e:
                log.error(
                    "plan %s step %s transport failure for %s: %s",
                    plan_name, step.name, self.full_name, e,
                )
                result.steps.append(StepResult(name=step.name, code=-1, stderr=str(e).encode()))
                result.aborted_at = step.name
                return result
            sr = StepResult(
                name=step.name, code=shell.code, stdout=shell.stdout, stderr=shell.stderr
            )
            result.steps.append(sr)
            if shell.code != 0:
                if step.best_effort:
                    log.warning(
                        "plan %s step %s degraded (exit %d) for %s: %s",
                        plan_name, step.name, shell.code, self.full_name,
                        shell.stderr[-300:].decode(errors="replace"),
                    )
                    continue
                log.error(
                    "plan %s aborted at step %s (exit %d) for %s",
                    plan_name, step.name, shell.code, self.full_name,
                )
                result.aborted_at = step.name
                return result
        return result
