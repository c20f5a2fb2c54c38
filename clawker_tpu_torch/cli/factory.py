"""Factory: the lazily wired dependencies handed to every command.

The port's copy of ``clawker_tpu/cli/factory.py``, whole: ``streams``,
``prompter``, ``confirm_destructive``, ``config``, ``driver``,
``engine()``, ``agent_registry`` and ``runtime()``, whose create path
mints and installs each agent's identity (``controlplane/identity.py``
over ``agents.db``) and opens the side channels lazily.  One departure:
``close`` closes a driver that this factory built, and the root calls it
when the command ends (the reference's CLI leaves a ``tpu_vm`` driver's
ssh forwards running).  It also holds what every verb module shares:
``DEVICE_ENV``, ``ENV_DRIVER`` and the helpers ``_factory``,
``_project``, ``_device``, ``_bring_up`` and ``_not_ported``.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import click

# analytics.runtime.DEVICE_ENV, spelt here so that importing the CLI
# loads no torch
DEVICE_ENV = "CLAWKER_TORCH_DEVICE"
ENV_DRIVER = "CLAWKER_TPU_DRIVER"


class Factory:
    def __init__(self, *, cwd: Path | None = None, driver=None,
                 config=None):
        self.cwd = cwd or Path.cwd()
        self._driver_override = driver
        self._config_override = config

    @functools.cached_property
    def streams(self):
        from ..ui import IOStreams

        return IOStreams()

    @functools.cached_property
    def prompter(self):
        from ..ui import Prompter

        return Prompter(self.streams)

    def confirm_destructive(self, message: str, *, skip: bool = False) -> bool:
        """Gate for destructive verbs (container rm, project remove, ...).

        ``skip`` (a --force/--yes flag) bypasses; non-interactive runs
        proceed (scripts must not hang on a prompt they cannot answer --
        reference prompter is TTY-only); an interactive decline aborts.
        Reference: internal/prompter confirm flows (SURVEY.md 2.4)."""
        if skip or not self.streams.can_prompt():
            return True
        return self.prompter.confirm(message, default=False)

    @functools.cached_property
    def config(self):
        if self._config_override is not None:
            return self._config_override
        from ..config import load_config
        from ..util import phases

        with phases.phase("config_load"):
            return load_config(self.cwd)

    @functools.cached_property
    def driver(self):
        from ..engine.drivers import get_driver

        if self._driver_override is not None:
            return self._driver_override
        return get_driver(self.config.settings,
                          override=os.environ.get(ENV_DRIVER, ""))

    def engine(self):
        return self.driver.engine()

    @functools.cached_property
    def agent_registry(self):
        from ..controlplane.registry import Registry

        return Registry(self.config.data_dir / "agents.db")

    def runtime(self, engine=None):
        from ..runtime.orchestrate import AgentRuntime

        eng = engine or self.engine()

        # Lazy: lifecycle/query commands never pay hostproxy startup or
        # tunnel setup; only the create path resolves the callable.
        def channels():
            from ..fleet.channels import open_side_channels

            return open_side_channels(eng, self.config)

        # Deferred so lifecycle/query commands never pay the cryptography
        # import or open agents.db; only the create path invokes this.
        def bootstrap(container_id: str, project: str, agent: str) -> None:
            from ..controlplane.identity import make_bootstrapper

            make_bootstrapper(self.config, eng, self.agent_registry)(
                container_id, project, agent
            )

        return AgentRuntime(
            eng,
            self.config,
            pre_start=self._pre_start_hook(),
            post_start=self._post_start_hook(),
            bootstrap=bootstrap,
            channels=channels,
        )

    # Bootstrap hooks: the host proxy before start, the socket bridge
    # after it (container_start.go:103/:297 parity).
    def _pre_start_hook(self):
        from ..controlplane.bootstrap import pre_start_services

        cfg = self.config
        driver = self.driver

        def hook(container_ref: str) -> None:
            pre_start_services(cfg, driver, container_ref)

        return hook

    def _post_start_hook(self):
        from ..controlplane.bootstrap import post_start_services

        cfg = self.config
        driver = self.driver

        def hook(container_ref: str) -> None:
            post_start_services(cfg, driver, container_ref)

        return hook

    def close(self) -> None:
        """Close the driver this factory built (never one passed in)."""
        if self._driver_override is None and "driver" in self.__dict__:
            self.__dict__.pop("driver").close()


# ------------------------------------------------- shared by the verbs


def _factory(ctx: click.Context) -> Factory:
    return ctx.obj if isinstance(ctx.obj, Factory) else Factory()


def _project(f: Factory) -> str | None:
    try:
        return f.config.project_name()
    except LookupError:
        return None


def _device(verb: str) -> str:
    """The device ``CLAWKER_TORCH_DEVICE`` names; exits 1 when it is a
    CUDA device and there is no GPU."""
    from ..analytics import runtime as art

    device = art.env_device()
    try:
        art.resolve_device(device)
    except RuntimeError as e:
        click.echo(f"{verb}: {e} (set {DEVICE_ENV}=cpu to score on "
                   "the CPU)", err=True)
        raise SystemExit(1)
    return device


def _bring_up(verb: str, device: str) -> None:
    """Open the CUDA context and load the kernels before a long-running
    verb starts its rider: the rider's first tick then scores at once
    instead of paying seconds of set-up mid-run, and a card or a build
    that fails stops the verb before it starts anything (exit 1)."""
    from ..analytics import runtime as art

    try:
        art.bring_up(device)
    except (RuntimeError, OSError) as e:    # CUDA errors, KernelCompileError
        click.echo(f"{verb}: cannot bring up {device}: {e}", err=True)
        raise SystemExit(1)


def _not_ported(what: str) -> click.ClickException:
    return click.ClickException(
        f"{what} is not yet ported to clawker_tpu_torch")
