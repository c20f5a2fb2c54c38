"""Dockerfile generation for the two-stage project image.

Stage 1 (``clawker-<project>:base``): stack base image + OS packages +
agent user + workspace.  Stage 2 (``clawker-<project>:<harness>``): harness
install + env + firewall CA + the native supervisor as PID 1 with the
agentd zipapp as its service child.  Generation is deterministic
(sorted packages, stable ordering) so unchanged config hits the daemon's
layer cache end to end.  Reference: internal/bundler/dockerfile.go
GenerateBase :367 / GenerateHarness :407; cache-tail invariant pinned by
the reference's TestBuildContext_LateClawkerBlock.

The port's copy of ``clawker_tpu/bundler/dockerfile.py``, whole.
"""

from __future__ import annotations

import json

from .. import consts
from ..bundle.model import Harness, Stack
from ..config.schema import BuildConfig

AGENT_USER = "agent"
AGENT_UID = 1001

# context-relative paths (fixed; the tar assembler must provide them)
CTX_SUPERVISOR = "clawker-supervisord"
CTX_AGENTD_PYZ = "clawker-agentd.pyz"
CTX_CA_CERT = "clawker-ca.crt"

# The agentd session daemon is a stdlib-only zipapp; python3 in the base
# stage is the one hard package requirement of every agent image.
BASE_REQUIRED_PACKAGES = ("python3", "ca-certificates")


def _env_lines(env: dict[str, str]) -> list[str]:
    return [f"ENV {k}={_quote(v)}" for k, v in sorted(env.items())]


def _quote(v: str) -> str:
    if v and all(c.isalnum() or c in "._-:/" for c in v):
        return v
    return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'


def generate_base(project: str, stack: Stack, build: BuildConfig) -> str:
    """Base-stage Dockerfile: stack image, packages, non-root agent user."""
    base_image = build.image or stack.base_image
    packages = set(stack.packages) | set(build.packages)
    # Stack bases are Debian-family, so the agentd runtime deps ride the
    # same apt layer.  A custom build.image may not have apt at all: the
    # user's image contract then includes python3 (documented in
    # docs/image-requirements) and we emit no unconditional apt RUN.
    if not build.image:
        packages |= set(BASE_REQUIRED_PACKAGES)
    packages = sorted(packages)
    lines = [
        f"# clawker-tpu base image for project {project!r} (stack {stack.name})",
        f"FROM {base_image}",
        "",
        "ARG DEBIAN_FRONTEND=noninteractive",
    ]
    if packages:
        lines += [
            "RUN apt-get update \\",
            "    && apt-get install -y --no-install-recommends \\",
            "       " + " ".join(packages) + " \\",
            "    && rm -rf /var/lib/apt/lists/*",
        ]
    lines += [f"RUN {cmd}" for cmd in stack.install]
    lines += _env_lines(stack.env)
    lines += [
        "",
        f"RUN useradd -m -u {AGENT_UID} -s /bin/bash {AGENT_USER} \\",
        f"    && mkdir -p {consts.WORKSPACE_DIR} \\",
        f"    && chown {AGENT_USER}:{AGENT_USER} {consts.WORKSPACE_DIR} \\",
        "    && mkdir -p /var/run/clawker /var/lib/clawker /run/clawker",
        f"WORKDIR {consts.WORKSPACE_DIR}",
    ]
    lines += _env_lines(build.env)
    lines += build.instructions
    return "\n".join(lines) + "\n"


def generate_harness(
    project: str,
    harness: Harness,
    build: BuildConfig,
    *,
    base_ref: str = "",
    with_ca_cert: bool = False,
    with_agentd: bool = True,
    extra_files: list[str] | None = None,
) -> str:
    """Harness-stage Dockerfile, FROM the project base image.

    The CA cert and the agentd binary are copied at the *tail* so harness
    layer caching survives agentd rebuilds and CA rotation (reference
    cache-tail invariant, bundler/dockerfile.go:550).
    """
    base = base_ref or f"{consts.IMAGE_NAME_PREFIX}{project}:{consts.IMAGE_TAG_BASE}"
    lines = [
        f"# clawker-tpu harness image for project {project!r} (harness {harness.name})",
        f"FROM {base}",
        "",
        "ARG DEBIAN_FRONTEND=noninteractive",
    ]
    packages = sorted(set(harness.packages))
    if packages:
        lines += [
            "RUN apt-get update \\",
            "    && apt-get install -y --no-install-recommends \\",
            "       " + " ".join(packages) + " \\",
            "    && rm -rf /var/lib/apt/lists/*",
        ]
    lines += [f"RUN {cmd}" for cmd in harness.install]
    lines += _env_lines(harness.env)
    # host-proxy side-channel scripts (no-ops when CLAWKER_HOSTPROXY is
    # unset; reference bakes internal/hostproxy/internals the same way)
    from ..hostproxy.scripts import CONTEXT_SCRIPTS

    targets = [t for _, (t, _c) in sorted(CONTEXT_SCRIPTS.items())]
    for arc, (target, _content) in sorted(CONTEXT_SCRIPTS.items()):
        lines.append(f"COPY {arc} {target}")
    lines += [
        f"RUN chmod 0755 {' '.join(targets)} \\",
        "    && git config --system credential.helper "
        "/usr/local/bin/git-credential-clawker || true",
    ]
    for f in extra_files or []:
        lines.append(f"COPY {f} /opt/clawker/{f}")
    # ---- cache tail: frequently-rotated material goes last ----
    if with_ca_cert:
        lines += [
            f"COPY {CTX_CA_CERT} {consts.CA_CERT_PATH}",
            "RUN update-ca-certificates || true",
            # tools that read their own CA bundles need the env hint
            f"ENV NODE_EXTRA_CA_CERTS={consts.CA_CERT_PATH}",
            f"ENV SSL_CERT_FILE={consts.CA_CERT_PATH}",
        ]
    if with_agentd:
        # ENTRYPOINT = native supervisor (PID 1) with the agentd zipapp as
        # its service child; Docker appends CMD to the entrypoint argv, so
        # the user command lands after --default-cmd and agentd stores it
        # to spawn on AgentReady (reference: clawkerd runs the image CMD
        # only when the CP sends AgentReady, SURVEY.md 3.1).
        entry = [
            consts.SUPERVISOR_PATH,
            "--socket", consts.SUPERVISOR_SOCKET,
            "--child",
            "python3", consts.AGENTD_PYZ_PATH,
            "--supervisor-socket", consts.SUPERVISOR_SOCKET,
            "--default-cmd",
        ]
        lines += [
            f"COPY {CTX_SUPERVISOR} {consts.SUPERVISOR_PATH}",
            f"COPY {CTX_AGENTD_PYZ} {consts.AGENTD_PYZ_PATH}",
            f"RUN chmod 0755 {consts.SUPERVISOR_PATH}",
            "ENTRYPOINT " + json.dumps(entry),
        ]
    cmd = build.env.get("CLAWKER_CMD_OVERRIDE", "")  # env override escape hatch
    harness_cmd = [cmd] if cmd else harness.cmd
    lines.append("CMD " + json.dumps(harness_cmd))
    return "\n".join(lines) + "\n"
