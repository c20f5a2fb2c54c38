"""Agent-container orchestration: create -> bootstrap -> start -> attach.

The port's copy of ``clawker_tpu/runtime/orchestrate.py``, whole: the
harness config staging (``harness_seed_tar`` and its TTL cache, over the
bundle resolver and ``containerfs``), the workspace seed cache
(``workspace_seed_tar``: every snapshot-mode create journals its
digest) and warm-pool adoption (:meth:`AgentRuntime.adopt_pooled`: the
relabel, the ``agent-env`` fixup archive and the rename, last).

Parity reference: internal/cmd/container/shared/container_create.go:1473
CreateContainer (workspace prep, config volumes, env assembly, create,
bootstrap material) and container_start.go (BootstrapServicesPreStart /
PostStart).  The control-plane/firewall bootstrap hooks are injected as
callables so this module stays below the CP layer in the import DAG.
"""

from __future__ import annotations

import io
import sys
import tarfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Callable

from .. import consts
from ..config import Config
from ..engine.api import ContainerSpec, Engine
from ..errors import ConflictError
from ..util import phases
from . import attach as attach_mod
from .labels import agent_labels
from .names import container_name
from .resolve import resolve_image

# --- harness-seed staging cache (docs/loop-warmpool.md) -------------------
# Building the harness staging tar (walk host harness state, copy into a
# staging dir, tar it) was 3.3ms of an 8.95ms framework cold start
# (BENCH_r05 harness_seed) and its content depends only on
# (harness, project root, credential staging policy) -- NOT on the agent
# or container.  Cache the finished tar bytes per key so a loop fan-out
# (or a warm-pool fill) stages once and every create after it pays one
# put_archive.  TTL-bounded: host harness state may change under a
# long-lived process, and a warm pool must not serve hour-old seeds.
_HARNESS_TAR_TTL_S = 30.0
_harness_tar_cache: dict[tuple, tuple[float, bytes]] = {}
_harness_tar_lock = threading.Lock()


def clear_harness_seed_cache() -> None:
    """Drop cached harness staging tars (tests; explicit invalidation)."""
    with _harness_tar_lock:
        _harness_tar_cache.clear()


# --- workspace-seed digest cache (docs/loop-worktrees.md#seed-cache) ------
# The same TTL-cache pattern, extended to the workspace snapshot itself:
# SnapshotSeed used to re-walk and re-tar the ENTIRE project tree per
# agent per create, so a 32-agent fan-out on one repo paid 32 identical
# tree walks.  The tar is deterministic (workspace.strategy._tar_tree
# normalizes every non-content field), so it digests to a stable sha256;
# the cache maps project root -> (built_at, digest, tar) and a second
# digest-keyed view serves the bytes back to whoever fans them out (the
# scheduler shipping one copy per worker into workerd seed stores).
_WORKSPACE_TAR_TTL_S = 30.0
_workspace_tar_cache: dict[str, tuple[float, str, bytes]] = {}
_workspace_tar_lock = threading.Lock()


def clear_workspace_seed_cache() -> None:
    """Drop cached workspace seed tars (tests; explicit invalidation)."""
    with _workspace_tar_lock:
        _workspace_tar_cache.clear()


def workspace_seed_tar(root: Path) -> tuple[str, bytes]:
    """``(digest, tar)`` for the project tree at ``root``: built once,
    then served from the TTL-bounded cache -- the tree walk is paid per
    *fan-out*, not per agent.  N git worktrees forked from one base have
    identical content and therefore collapse to one digest, but each
    worktree path keys its own entry (the walk is what discovers the
    content, so a path-keyed probe is the only free lookup)."""
    from ..workspace.strategy import (
        _SEED_CACHE_HITS,
        _SEED_CACHE_MISSES,
        _tar_tree,
        seed_digest,
    )

    key = str(root)
    now = time.monotonic()
    with _workspace_tar_lock:
        hit = _workspace_tar_cache.get(key)
        if hit is not None and now - hit[0] < _WORKSPACE_TAR_TTL_S:
            phases.incr("workspace_seed.tar_cache_hit")
            _SEED_CACHE_HITS.inc()
            return hit[1], hit[2]
    phases.incr("workspace_seed.tar_cache_miss")
    _SEED_CACHE_MISSES.inc()
    tar = _tar_tree(Path(root))
    digest = seed_digest(tar)
    with _workspace_tar_lock:
        if len(_workspace_tar_cache) > 64:
            _workspace_tar_cache.clear()
        _workspace_tar_cache[key] = (now, digest, tar)
    return digest, tar


def workspace_seed_by_digest(digest: str) -> bytes | None:
    """The cached tar for ``digest`` (any root), or None when the cache
    no longer holds it -- the content-addressed view the seed fan-out
    re-serves worker copies from."""
    with _workspace_tar_lock:
        for (_ts, d, tar) in _workspace_tar_cache.values():
            if d == digest:
                return tar
    return None


@dataclass
class CreateOptions:
    agent: str = "dev"
    image: str = "@"                  # '@' = project default harness image
    cmd: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    tty: bool = True
    workspace_mode: str = ""          # '' = project config value
    harness: str = ""
    worker: str = ""                  # tpu_vm worker id (label only here)
    loop_id: str = ""
    extra_labels: dict[str, str] = field(default_factory=dict)  # caller-scoped
    #                                 labels (loop epoch, ...) on top of the
    #                                 standard agent label set
    replace: bool = False             # remove an existing same-name container
    mount_docker_socket: bool | None = None
    worktree_git_dir: Path | None = None
    workspace_root: Path | None = None  # override project root (worktrees)
    workdir: str = ""                   # override container working dir
    seed_digest: str = ""               # expected workspace-seed digest
    #                                 (content-addressed; the workerd path
    #                                 resolves it in the worker-local store)
    seed_tar: bytes | None = None       # pre-resolved seed bytes: skip the
    #                                 tree walk and seed with exactly these
    #                                 (a worker-local seed-store hit)


class AgentRuntime:
    """Create/start/attach/stop agent containers on one worker engine."""

    def __init__(
        self,
        engine: Engine,
        cfg: Config,
        *,
        pre_start: Callable[[str], None] | None = None,
        post_start: Callable[[str], None] | None = None,
        bootstrap: Callable[[str, str, str], None] | None = None,
        channels=None,                 # fleet.channels.SideChannels | None
    ):
        self.engine = engine
        self.cfg = cfg
        # bootstrap hooks wired by the CLI factory once CP/firewall exist.
        # ``bootstrap(container_id, project, agent)`` runs between create and
        # start (reference: InstallAgentBootstrapMaterial in
        # createAndBootstrapContainer, container_create.go:2074).
        self.pre_start = pre_start
        self.post_start = post_start
        self.bootstrap = bootstrap
        # side-channel URLs for THIS worker (remote workers: SSH -R tunnel
        # addresses; local: host-gateway) -- fleet/channels.SideChannels,
        # or a zero-arg callable resolved lazily on the create path only
        self.channels = channels
        # lazy resolution replaces self.channels in place; guard it so a
        # runtime handed to threaded callers (the Factory exposes one to
        # arbitrary commands) resolves exactly once.  The loop scheduler
        # builds per-worker runtimes with channels already resolved, but
        # the contract must not depend on that.
        self._channels_lock = threading.Lock()

    def _resolve_channels(self):
        with self._channels_lock:
            if callable(self.channels):
                try:
                    self.channels = self.channels()
                except Exception as e:
                    # best-effort: a failed tunnel degrades the agent (no
                    # browser-open/OAuth/telemetry), never blocks the create
                    import logging

                    logging.getLogger("runtime").warning(
                        "event=side_channels_unavailable error=%s", e)
                    self.channels = None
            return self.channels

    # -------------------------------------------------------------- create

    def create(self, opts: CreateOptions) -> str:
        from ..workspace import setup_mounts  # local import: workspace is a peer

        project = self.cfg.project_name()
        name = container_name(project, opts.agent)

        if opts.replace and self.engine.container_exists(name):
            self.engine.remove_container(name, force=True, volumes=False)

        image = resolve_image(self.engine, project, opts.image)

        pconf = self.cfg.project
        mode = opts.workspace_mode or (pconf.workspace.mode if pconf else "bind")
        root = opts.workspace_root or self.cfg.project_root or Path.cwd()
        mount_sock = (
            opts.mount_docker_socket
            if opts.mount_docker_socket is not None
            else bool(pconf and pconf.workspace.mount_docker_socket)
        )
        with phases.phase("workspace_mounts"):
            mounts = setup_mounts(
                self.engine,
                project,
                opts.agent,
                root,
                mode=mode,
                extra_mounts=(pconf.workspace.extra_mounts if pconf else None),
                worktree_git_dir=opts.worktree_git_dir,
            )

        env = self._build_env(project, opts)
        harness = opts.harness or (pconf.build.harness if pconf else "")
        labels = agent_labels(
            project,
            opts.agent,
            harness=harness,
            worker=opts.worker,
            loop_id=opts.loop_id,
        )
        labels.update(opts.extra_labels)
        cmd = opts.cmd or (pconf.agent.cmd if pconf else [])
        spec = ContainerSpec(
            image=image,
            cmd=list(cmd),
            env=env,
            labels=labels,
            tty=opts.tty,
            open_stdin=True,
            working_dir=opts.workdir or consts.WORKSPACE_DIR,
            hostname=f"{project}-{opts.agent}",
            binds=mounts.binds,
            memory=(pconf.agent.memory if pconf else ""),
            nano_cpus=int((pconf.agent.cpus if pconf else 0.0) * 1e9),
            init=False,  # the harness image's clawkerd is PID 1, not tini
            mount_docker_socket=mount_sock,
            # host.docker.internal only resolves on Linux daemons with an
            # explicit host-gateway mapping; needed whenever any injected
            # URL (hostproxy OR OTLP telemetry) points there
            extra_hosts=(
                ["host.docker.internal:host-gateway"]
                if any("host.docker.internal" in v for v in env.values())
                or self.cfg.settings.host_proxy.enable
                else []
            ),
        )
        try:
            with phases.phase("engine_create"):
                cid = self.engine.create_container(name, spec)
        except ConflictError:
            raise ConflictError(
                f"agent {opts.agent!r} already exists for project {project!r} "
                f"(container {name}); use --replace or `clawker start`"
            )
        with phases.phase("workspace_seed"):
            mounts.seed(self.engine, cid, tar=opts.seed_tar,
                        worker=opts.worker)
        with phases.phase("harness_seed"):
            self._seed_harness_config(cid, harness, root)
        if self.bootstrap:
            with phases.phase("identity_bootstrap"):
                self.bootstrap(cid, project, opts.agent)
        return cid

    def prefetch_seeds(self, harness: str, root: Path) -> str:
        """Warm both create-time seed caches off the hot path (warm-pool
        fills call this before their create, so a later adoption -- the
        hit path -- never pays a tree walk or harness staging).  Returns
        the workspace seed digest ("" when the root has nothing to
        seed)."""
        self.harness_seed_tar(harness, root)
        if not Path(root).exists():
            return ""
        digest, _tar = workspace_seed_tar(Path(root))
        return digest

    # ------------------------------------------------------- pool adoption

    def adopt_pooled(self, cid: str, opts: CreateOptions) -> None:
        """Finalize a warm-pool container for a real agent placement
        (docs/loop-warmpool.md).

        The pool fill already paid the expensive create-time stages
        (engine create, workspace seed, harness seed, identity prewarm)
        under a placeholder agent name; adoption finalizes the
        agent-specific surface -- labels, env, name -- in place:

        - **relabel**: the full agent label set (plus ``extra_labels``,
          e.g. the loop epoch) replaces the placeholder's, where the
          engine supports in-place relabel; the pool-origin marker
          (``LABEL_WARMPOOL``) survives so volume sweeps can trace the
          placeholder's volumes.
        - **env fixup**: create-time env is immutable, so the
          agent-specific env lands as ``/run/clawker/agent-env``
          (KEY=VAL lines) -- the same advisory-file channel the loop
          scheduler already uses for per-iteration context.
        - **identity**: the bootstrap hook re-runs under the REAL agent
          name; with the CA session cache prewarmed this is the warm
          path (leaf reused, only the per-container assertion JWT and
          session key are fresh).
        - **rename** (LAST): the deterministic agent name lands only
          after every other fixup, so a crash mid-adoption leaves
          either a pool-named container (swept) or a fully-finalized
          one (continued) -- never a half-adopted name.

        Raises ClawkerError subclasses on failure; the caller owns the
        fallback to a cold create.
        """
        project = self.cfg.project_name()
        name = container_name(project, opts.agent)
        pconf = self.cfg.project
        harness = opts.harness or (pconf.build.harness if pconf else "")
        labels = agent_labels(
            project, opts.agent, harness=harness,
            worker=opts.worker, loop_id=opts.loop_id)
        labels.update(opts.extra_labels)
        with phases.phase("pool_adopt_env"):
            env = self._build_env(project, opts)
            body = "".join(f"{k}={v}\n" for k, v in sorted(env.items())).encode()
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as tf:
                ti = tarfile.TarInfo("agent-env")
                ti.size = len(body)
                ti.mode = 0o600
                tf.addfile(ti, io.BytesIO(body))
            env_tar = buf.getvalue()
        # without a bootstrap hook the whole fixup batches under ONE
        # jail check (rename included); with one, the rename waits for
        # the identity install so a crash mid-adoption can never leave
        # an agent-named container without identity material
        with phases.phase("pool_adopt_finalize"):
            self._finalize_replacing(
                cid, name, opts.replace, labels=labels,
                archive_path=consts.RUN_STATE_DIR, archive=env_tar,
                new_name="" if self.bootstrap else name)
        if self.bootstrap:
            with phases.phase("identity_bootstrap"):
                self.bootstrap(cid, project, opts.agent)
            with phases.phase("pool_adopt_rename"):
                self._rename_replacing(cid, name, opts.replace)

    def _finalize_replacing(self, cid: str, name: str, replace: bool,
                            **kw) -> None:
        """finalize_adoption with replace-on-conflict semantics: the
        conflict path (a leftover same-name container) pays the extra
        remove, the common path pays nothing."""
        try:
            self.engine.finalize_adoption(cid, **kw)
        except ConflictError:
            if not replace:
                raise
            self.engine.remove_container(name, force=True, volumes=False)
            self.engine.finalize_adoption(cid, **kw)

    def _rename_replacing(self, cid: str, name: str, replace: bool) -> None:
        try:
            self.engine.rename_container(cid, name)
        except ConflictError:
            if not replace:
                raise
            self.engine.remove_container(name, force=True, volumes=False)
            self.engine.rename_container(cid, name)

    def _seed_harness_config(self, cid: str, harness: str, root: Path) -> None:
        """Stage host harness state into the config volume per the harness
        bundle's staging manifest (containerfs; reference
        container_create.go:1907 initConfigVolume).  A host with zero
        harness state, or no staging manifest, degrades to a no-op.
        The staging tar is built once per (harness, root, credentials)
        and reused (see the module cache above)."""
        tar = self.harness_seed_tar(harness, root)
        if tar:
            self.engine.put_archive(cid, consts.CONTAINER_HOME, tar)

    def harness_seed_tar(self, harness: str, root: Path) -> bytes:
        """The staging tar for (harness, root, credential policy), built
        once and served from the TTL-bounded module cache afterwards --
        a warm-pool fill's own seed pays this cost off the hot path for
        every later create on the worker.  Returns b"" when the harness
        has nothing to stage."""
        stage_creds = self.cfg.settings.credentials.stage
        key = (harness or "claude", str(root), bool(stage_creds),
               consts.CONTAINER_HOME, consts.WORKSPACE_DIR)
        now = time.monotonic()
        with _harness_tar_lock:
            hit = _harness_tar_cache.get(key)
            if hit is not None and now - hit[0] < _HARNESS_TAR_TTL_S:
                phases.incr("harness_seed.tar_cache_hit")
                return hit[1]
        phases.incr("harness_seed.tar_cache_miss")
        tar = self._build_harness_seed_tar(harness, root, stage_creds)
        with _harness_tar_lock:
            if len(_harness_tar_cache) > 64:
                _harness_tar_cache.clear()
            _harness_tar_cache[key] = (now, tar)
        return tar

    def _build_harness_seed_tar(self, harness: str, root: Path,
                                stage_creds: bool) -> bytes:
        from .. import containerfs
        from ..bundle.resolver import Resolver
        from ..errors import NotFoundError

        try:
            h = Resolver(self.cfg).harness(harness or "claude")
        except NotFoundError:
            return b""
        staging = containerfs.Staging.from_raw(h.staging)
        if not staging.copy and not (stage_creds and staging.credentials):
            return b""
        sdir, cleanup = containerfs.prepare_config(
            staging,
            container_home=consts.CONTAINER_HOME,
            container_work=consts.WORKSPACE_DIR,
            host_project_root=str(root),
            include_credentials=stage_creds,
        )
        try:
            return containerfs.staging_tar(sdir)
        finally:
            cleanup()

    def _build_env(self, project: str, opts: CreateOptions) -> dict[str, str]:
        """Create-time env (reference: buildCreateTimeEnv
        container_create.go:2117): identity, workspace, host-proxy wiring."""
        env = {
            "CLAWKER_PROJECT": project,
            "CLAWKER_AGENT": opts.agent,
            "CLAWKER_WORKSPACE": consts.WORKSPACE_DIR,
            # socket-bridge landing point: ssh picks the agent up the
            # moment the bridge materializes the socket; harmless (key-file
            # fallback) when no bridge is running
            "SSH_AUTH_SOCK": "/run/clawker/ssh-agent.sock",
        }
        channels = self._resolve_channels()
        if channels is not None and channels.hostproxy_url:
            # worker-specific side channel (remote: the SSH -R tunnel bind)
            env["CLAWKER_HOSTPROXY"] = channels.hostproxy_url
        elif self.cfg.settings.host_proxy.enable:
            env["CLAWKER_HOSTPROXY"] = (
                f"http://host.docker.internal:{self.cfg.settings.host_proxy.port}"
            )
        if channels is not None and channels.otlp_endpoint:
            env["OTEL_EXPORTER_OTLP_ENDPOINT"] = channels.otlp_endpoint
        pconf = self.cfg.project
        if pconf:
            env.update(pconf.agent.env)
        env.update(opts.env)
        return env

    # --------------------------------------------------------- start/attach

    def start(self, name_or_id: str) -> None:
        if self.pre_start:
            with phases.phase("pre_start"):
                self.pre_start(name_or_id)
        with phases.phase("engine_start"):
            self.engine.start_container(name_or_id)
        if self.post_start:
            with phases.phase("post_start"):
                self.post_start(name_or_id)

    def attach_and_run(
        self,
        name_or_id: str,
        *,
        tty: bool = True,
        stdin: BinaryIO | None = None,
        stdout: BinaryIO | None = None,
    ) -> int:
        """Attach first, then start, then pump until exit (mirrors
        attachThenStart run.go:331 -- attaching before start loses no
        output).  Returns the container exit code."""
        out = stdout or sys.stdout.buffer
        stream = self.engine.attach_container(name_or_id, tty=tty)
        self.start(name_or_id)
        attach_mod.wire_resize(self.engine, name_or_id)
        use_raw = (
            stdin is None
            and stdout is None
            and tty
            and sys.stdin.isatty()
            and sys.stdout.isatty()
        )
        inp = stdin if stdin is not None else sys.stdin.buffer
        if use_raw:
            with attach_mod.raw_terminal(sys.stdin.fileno()):
                attach_mod.pump_streams(stream, inp, out)
        else:
            attach_mod.pump_streams(stream, inp, out)
        return self.engine.wait_container(name_or_id)

    # --------------------------------------------------------------- query

    def list_agents(self, *, all: bool = True, project: str | None = None) -> list[dict]:
        filters: dict = {"label": [f"{consts.LABEL_ROLE}=agent"]}
        if project:
            filters["label"].append(f"{consts.LABEL_PROJECT}={project}")
        return self.engine.list_containers(all=all, filters=filters)
