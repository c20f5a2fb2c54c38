"""Project image build orchestration: base stage then harness stage.

Reference call stack: internal/cmd/image/build/build.go:110 buildRun ->
bundler.GenerateBase/GenerateHarness -> client.BuildImage -> tag
``:<harness>`` + ``:default`` alias (SURVEY.md 3.2).

The port's copy of ``clawker_tpu/bundler/build.py``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

from .. import consts
from ..bundle import Resolver
from ..config import Config
from ..engine.api import Engine
from ..errors import ClawkerError
from .context import build_context
from .dockerfile import CTX_CA_CERT, generate_base, generate_harness
from .payload import agentd_payload


@dataclass
class BuildResult:
    base_ref: str = ""
    harness_ref: str = ""
    default_ref: str = ""
    with_agentd: bool = False
    with_ca: bool = False
    events: list[str] = field(default_factory=list)


class ProjectBuilder:
    def __init__(
        self,
        engine: Engine,
        cfg: Config,
        *,
        ca_cert_pem: bytes | None = None,
        progress: Callable[[str], None] | None = None,
    ):
        self.engine = engine
        self.cfg = cfg
        self.ca_cert_pem = ca_cert_pem
        self.progress = progress or (lambda _line: None)

    def build(self, *, harness_override: str = "", no_cache: bool = False,
              secrets: dict[str, bytes] | None = None,
              ssh_auth_sock: str = "") -> BuildResult:
        """secrets/ssh ride the BuildKit session lane (RUN --mount=type=
        secret|ssh); see engine/bksession.py."""
        pconf = self.cfg.project
        if pconf is None:
            raise ClawkerError("no project config found -- run `clawker init` first")
        project = self.cfg.project_name()
        resolver = Resolver(self.cfg)
        stack = resolver.stack(pconf.build.stack or "python")
        harness = resolver.harness(harness_override or pconf.build.harness or "claude")

        res = BuildResult()
        # ---- stage 1: base
        base_ref = f"{consts.IMAGE_NAME_PREFIX}{project}:{consts.IMAGE_TAG_BASE}"
        self.progress(f"building {base_ref} (stack {stack.name})")
        base_df = generate_base(project, stack, pconf.build)
        self._run_build(
            build_context({"Dockerfile": base_df.encode()}),
            tags=[base_ref],
            labels={consts.LABEL_IMAGE_KIND: "base", consts.LABEL_PROJECT: project},
            res=res,
            no_cache=no_cache,
            secrets=secrets,
            ssh_auth_sock=ssh_auth_sock,
        )
        res.base_ref = base_ref

        # ---- stage 2: harness
        harness_ref = f"{consts.IMAGE_NAME_PREFIX}{project}:{harness.name}"
        self.progress(f"building {harness_ref} (harness {harness.name})")
        agentd = agentd_payload()
        files: dict[str, bytes] = {}
        extra: list[str] = []
        if harness.source_dir is not None:
            src_root = harness.source_dir.resolve()
            for f in harness.files:
                # containment: a third-party bundle manifest must not reach
                # outside its own directory (matches the installer's
                # symlink rejection, bundle/manager.py)
                p = (src_root / f).resolve()
                if not p.is_relative_to(src_root):
                    raise ClawkerError(
                        f"harness {harness.name}: file {f!r} escapes the bundle directory"
                    )
                files[f] = p.read_bytes()
            extra = list(harness.files)
        with_ca = self.ca_cert_pem is not None
        if with_ca:
            files[CTX_CA_CERT] = self.ca_cert_pem  # type: ignore[assignment]
        if agentd is not None:
            files.update(agentd)
        from ..hostproxy.scripts import CONTEXT_SCRIPTS

        for arc, (_target, content) in CONTEXT_SCRIPTS.items():
            files[arc] = content.encode()
        harness_df = generate_harness(
            project,
            harness,
            pconf.build,
            base_ref=base_ref,
            with_ca_cert=with_ca,
            with_agentd=agentd is not None,
            extra_files=extra,
        )
        files["Dockerfile"] = harness_df.encode()
        self._run_build(
            build_context(files),
            tags=[harness_ref],
            labels={
                consts.LABEL_IMAGE_KIND: "harness",
                consts.LABEL_PROJECT: project,
                consts.LABEL_HARNESS: harness.name,
            },
            res=res,
            no_cache=no_cache,
            secrets=secrets,
            ssh_auth_sock=ssh_auth_sock,
        )
        res.harness_ref = harness_ref
        res.with_agentd = agentd is not None
        res.with_ca = with_ca

        # ---- :default alias
        default_ref = f"{consts.IMAGE_NAME_PREFIX}{project}:{consts.IMAGE_TAG_DEFAULT}"
        self.engine.tag_image(harness_ref, f"{consts.IMAGE_NAME_PREFIX}{project}", consts.IMAGE_TAG_DEFAULT)
        res.default_ref = default_ref
        self.progress(f"tagged {default_ref}")
        return res

    def _run_build(
        self, ctx: bytes, *, tags: list[str], labels: dict, res: BuildResult,
        no_cache: bool = False, secrets: dict[str, bytes] | None = None,
        ssh_auth_sock: str = "",
    ) -> None:
        stream: Iterator[dict] = self.engine.build_image(
            ctx, tags=tags, labels=labels, no_cache=no_cache,
            secrets=secrets, ssh_auth_sock=ssh_auth_sock,
        )
        err = ""
        for ev in stream:
            if "stream" in ev:
                line = ev["stream"].rstrip()
                if line:
                    res.events.append(line)
                    self.progress(line)
            elif "errorDetail" in ev or "error" in ev:
                err = (ev.get("errorDetail") or {}).get("message") or ev.get("error", "")
        if err:
            raise ClawkerError(f"build of {tags[0]} failed: {err}")
