"""Framework-wide constants: names, labels, ports, paths, domains.

The port's copy of ``clawker_tpu/consts.py``, whole.

Parity reference: internal/consts/consts.go (ports at consts.go:567-583,
label keys, bootstrap dir /run/clawker/bootstrap). Values are re-derived for
this framework, not copied; the namespace is ``clawker-tpu`` / ``dev.clawker-tpu``
so a reference install and this framework can coexist on one host.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Product identity
# ---------------------------------------------------------------------------

PRODUCT = "clawker-tpu"
CLI_NAME = "clawker"

# ---------------------------------------------------------------------------
# Naming
#
# Containers are named ``clawker.<project>.<agent>`` (reference:
# internal/docker/names.go).  Images are ``clawker-<project>:<tag>`` with the
# two-stage build producing ``:base`` and ``:<harness>`` tags (reference:
# internal/bundler/dockerfile.go GenerateBase/GenerateHarness).
# ---------------------------------------------------------------------------

CONTAINER_NAME_PREFIX = "clawker"
CONTAINER_NAME_SEP = "."
IMAGE_NAME_PREFIX = "clawker-"
IMAGE_TAG_BASE = "base"
IMAGE_TAG_DEFAULT = "default"

CONTROLPLANE_CONTAINER = "clawker-controlplane"
ENVOY_CONTAINER = "clawker-envoy"
COREDNS_CONTAINER = "clawker-coredns"
NETWORK_NAME = "clawker-net"
# Default docker0 gateway: how agent containers reach host-side CP/hostproxy
# when the CP runs as a host daemon (the reference CP is a container at .202
# on clawker-net instead; ARCHITECTURE.md:490).
DOCKER_BRIDGE_GATEWAY = "172.17.0.1"

# Deterministic static addressing on clawker-net (reference:
# .claude/docs/ARCHITECTURE.md:490 -- gateway+.2 Envoy, +.3 CoreDNS, +.202 CP).
ENVOY_HOST_OFFSET = 2
COREDNS_HOST_OFFSET = 3
CONTROLPLANE_HOST_OFFSET = 202

# ---------------------------------------------------------------------------
# Labels (the label jail: every object the engine may touch carries the
# managed label; reference: pkg/whail/engine.go injectManagedFilter +
# internal/docker/labels.go dev.clawker.*)
# ---------------------------------------------------------------------------

LABEL_NS = "dev.clawker-tpu"
LABEL_MANAGED = f"{LABEL_NS}.managed"
LABEL_PROJECT = f"{LABEL_NS}.project"
LABEL_AGENT = f"{LABEL_NS}.agent"
LABEL_HARNESS = f"{LABEL_NS}.harness"
LABEL_ROLE = f"{LABEL_NS}.role"          # agent | controlplane | envoy | coredns | monitor
LABEL_WORKER = f"{LABEL_NS}.worker"      # tpu_vm worker id the object lives on
LABEL_VOLUME_PURPOSE = f"{LABEL_NS}.volume.purpose"  # workspace | config | history
LABEL_IMAGE_KIND = f"{LABEL_NS}.image.kind"          # base | harness | infra
LABEL_CONTENT_SHA = f"{LABEL_NS}.content-sha"        # content-derived infra image cache key
LABEL_LOOP = f"{LABEL_NS}.loop"          # loop-run id for `clawker loop` members
LABEL_LOOP_EPOCH = f"{LABEL_NS}.loop-epoch"  # placement epoch that created the
#                                          container: --resume adopts a
#                                          current-epoch copy and sweeps
#                                          stale ones as ghosts
LABEL_WARMPOOL = f"{LABEL_NS}.warmpool"  # warm-pool placeholder agent name:
#                                          set at pool fill, KEPT through
#                                          adoption so volume sweeps and
#                                          resumes can trace a container
#                                          back to its pool origin
POOL_EPOCH = "pool"                      # LABEL_LOOP_EPOCH value of an
#                                          unadopted warm-pool member

MANAGED_VALUE = "true"

# ---------------------------------------------------------------------------
# Ports (reference: internal/consts/consts.go:567-583 and Envoy listener
# blocks in controlplane/firewall/envoy_config.go)
# ---------------------------------------------------------------------------

CP_ADMIN_PORT = 7443          # AdminService gRPC (mTLS + bearer)
CP_AGENT_PORT = 7444          # AgentService gRPC (clawkerd -> CP register)
CP_HEALTH_PORT = 7080         # /healthz aggregate probe
AGENTD_PORT = 7700            # in-container clawkerd session listener
ENVOY_TLS_PORT = 10000        # SNI/MITM listener
ENVOY_TCP_PORT_BASE = 10001   # sequential raw-TCP listeners
ENVOY_HEALTH_PORT = 9902
HOSTPROXY_PORT = 18374        # host side-channel HTTP (browser-open, OAuth, git-cred)
DNS_PORT = 53

# ---------------------------------------------------------------------------
# In-container paths
# ---------------------------------------------------------------------------

RUN_STATE_DIR = "/run/clawker"             # in-container advisory state files
#                                            (loop-state, agent-env fixup)
BOOTSTRAP_DIR = "/run/clawker/bootstrap"   # cert/key/ca/assertion delivered pre-start
READY_FILE = "/var/run/clawker/ready"      # agentd healthcheck marker
INIT_MARKER = "/var/lib/clawker/initialized"
SUPERVISOR_PATH = "/usr/local/bin/clawker-supervisord"  # native PID 1
SUPERVISOR_SOCKET = "/run/clawker/supervisor.sock"
AGENTD_PYZ_PATH = "/usr/local/lib/clawker-agentd.pyz"   # session daemon zipapp
WORKSPACE_DIR = "/workspace"
CONTAINER_HOME = "/home/agent"   # agent user's home (staging dests are
#                                  home-relative, workspace/strategy mounts
#                                  config/history volumes under it)
CA_CERT_PATH = "/usr/local/share/ca-certificates/clawker-firewall-ca.crt"
# Container-side host-proxy scripts (reference: internal/hostproxy/internals
# host-open.sh + git-credential-clawker.sh, baked in by the bundler)
GIT_CREDENTIAL_HELPER_PATH = "/usr/local/bin/git-credential-clawker"
HOST_OPEN_PATH = "/usr/local/bin/host-open"

# Bootstrap file names inside BOOTSTRAP_DIR (reference: clawkerd/bootstrap.go
# reads cert/key/ca/assertion.jwt).
BOOTSTRAP_FILES = ("agent.crt", "agent.key", "ca.crt", "assertion.jwt", "session.key")

# ---------------------------------------------------------------------------
# eBPF (reference: controlplane/firewall/ebpf/bpf/common.h)
# ---------------------------------------------------------------------------

BPF_PIN_DIR = "/sys/fs/bpf/clawker-tpu"
# SO_MARK applied by Envoy egress so its own upstream connections bypass the
# cgroup hook (loop prevention; reference: common.h:76 CLAWKER_MARK 0xC1A4).
FW_SOCK_MARK = 0xC1A7

# ---------------------------------------------------------------------------
# Environment variable overrides for XDG dirs
# ---------------------------------------------------------------------------

ENV_CONFIG_DIR = "CLAWKER_TPU_CONFIG_DIR"
ENV_DATA_DIR = "CLAWKER_TPU_DATA_DIR"
ENV_STATE_DIR = "CLAWKER_TPU_STATE_DIR"
ENV_CACHE_DIR = "CLAWKER_TPU_CACHE_DIR"

# Project-level config discovery (reference: internal/storage discovery --
# dir-form `.clawker/` vs flat `.clawker.yaml`, bounded walk-up).
PROJECT_DIR_FORM = ".clawker"
PROJECT_FLAT_FORM = ".clawker.yaml"
PROJECT_LOCAL_SUFFIX = ".local"
WALKUP_LIMIT = 24

SETTINGS_FILE = "settings.yaml"
REGISTRY_FILE = "registry.yaml"
EGRESS_RULES_FILE = "egress-rules.yaml"

# ---------------------------------------------------------------------------
# Internal egress requirements: domains every agent needs regardless of
# project rules (reference: internal/config EgressRules() merge of required
# internal + project rules).
# ---------------------------------------------------------------------------

REQUIRED_EGRESS_DOMAINS = (
    "api.anthropic.com",
    "statsig.anthropic.com",
    "sentry.io",
)

# Upstream resolvers for allowed zones (reference:
# controlplane/firewall/coredns_config.go -- Cloudflare malware-blocking).
UPSTREAM_DNS = ("1.1.1.2", "1.0.0.2")
DOCKER_INTERNAL_DNS = "127.0.0.11"  # only valid INSIDE a container netns
INTERNAL_ZONE = "docker.internal"   # answered from the engine inventory

# OTLP/HTTP ingest of the monitor collector; also the side-channel tunnel
# port on workers (fleet/channels.py, provision systemd unit).
OTLP_HTTP_PORT = 4318

# ---------------------------------------------------------------------------
# TPU-VM runtime
# ---------------------------------------------------------------------------

TPU_METADATA_HOST = "metadata.google.internal"
TPU_WORKER_DOCKER_PORT = 2375        # remote dockerd reached only via SSH tunnel
TPU_SSH_USER_DEFAULT = "clawker"
TPU_SSH_MUX_DIR = "ssh-mux"          # under state dir: ControlMaster sockets

DEFAULT_COLD_START_BUDGET_S = 10.0   # BASELINE.md p50 container cold-start target
