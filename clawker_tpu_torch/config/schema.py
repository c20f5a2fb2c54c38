"""Typed configuration schemas: ``clawker.yaml`` (project) and ``settings.yaml``.

The port's copy of ``clawker_tpu/config/schema.py``, whole.

Parity reference: internal/config schemas (SURVEY.md 2.5): project =
build/agent/workspace/security; settings = logging, host_proxy,
firewall.enable, monitoring, control_plane ports.  This build adds the
``runtime`` settings block (driver selection + TPU-pod description) and the
``loop`` block for the autonomous-loop scheduler -- both net-new per
BASELINE.json north_star.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from functools import lru_cache
from typing import Any, get_args, get_origin, get_type_hints


@lru_cache(maxsize=None)
def _hints(cls) -> dict:
    """get_type_hints per dataclass, cached: the schema classes are
    static, and hint resolution dominated config-load time."""
    return get_type_hints(cls)


# --------------------------------------------------------------------------
# generic dict <-> dataclass plumbing
# --------------------------------------------------------------------------

def from_dict(cls, data: Any):
    """Build dataclass ``cls`` from a raw tree, ignoring unknown keys."""
    if data is None:
        return cls()
    if not isinstance(data, dict):
        raise TypeError(f"{cls.__name__}: expected mapping, got {type(data).__name__}")
    hints = _hints(cls)
    kwargs = {}
    for f in fields(cls):
        if f.name not in data:
            continue
        raw = data[f.name]
        ft = hints[f.name]
        kwargs[f.name] = _coerce(ft, raw)
    return cls(**kwargs)


def _coerce(ft, raw):
    origin = get_origin(ft)
    if is_dataclass(ft):
        # a schema class may accept legacy scalar forms (e.g.
        # ``loop.placement: spread`` predating the placement block)
        conv = getattr(ft, "from_raw", None)
        if conv is not None:
            return conv(raw)
        return from_dict(ft, raw)
    if origin is list:
        (elem,) = get_args(ft)
        if raw is None:
            return []
        return [_coerce(elem, r) for r in raw]
    if origin is dict:
        _, vt = get_args(ft)
        if raw is None:
            return {}
        return {k: _coerce(vt, v) for k, v in raw.items()}
    if origin is not None:  # Optional[...] and friends: pass through
        return raw
    if ft is float and isinstance(raw, int):
        return float(raw)
    return raw


def to_dict(obj) -> dict:
    """Dataclass -> plain tree, dropping values equal to the field default."""
    out: dict[str, Any] = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if f.default is not dataclasses.MISSING and v == f.default:
            continue
        if f.default_factory is not dataclasses.MISSING and v == f.default_factory():  # type: ignore[misc]
            continue
        if is_dataclass(v):
            sub = to_dict(v)
            if sub:
                out[f.name] = sub
        elif isinstance(v, list):
            out[f.name] = [to_dict(i) if is_dataclass(i) else i for i in v]
        else:
            out[f.name] = v
    return out


# --------------------------------------------------------------------------
# project config (clawker.yaml)
# --------------------------------------------------------------------------

# Characters allowed in an HTTP method.  Deliberately NARROWER than the
# RFC 7230 token charset: methods are interpolated into an Envoy
# safe_regex alternation, and token chars like | + . * ^ are regex
# metacharacters that would widen the route's method match.  Every real
# method (incl. WebDAV) fits [A-Z0-9_-].
_METHOD_TOKEN = frozenset("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")
# RFC 3986 pchar + "/" (plus %-escapes): what a literal route path may hold.
_PATH_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    "-._~!$&'()+,;=:@/%")


class RuleValidationError(ValueError):
    """A rule failed ingestion validation; the whole update is rejected
    (reference ValidateRule semantics, rules_store.go /
    controlplane/firewall/envoy_http.go:337)."""


def _validate_action(value: str, *, where: str,
                     allowed: tuple[str, ...]) -> str:
    v = (value or "").strip().lower()
    if v not in allowed:
        raise RuleValidationError(
            f"{where}: unknown action {value!r} (want one of "
            f"{'/'.join(a or chr(34) + chr(34) for a in allowed)}) -- "
            "a typo'd deny must not silently fail open")
    return v


def validate_path(path: str, *, where: str) -> None:
    """Reject paths that cannot mean what the user intended.

    Path rules are literal prefixes (Envoy `prefix:` match).  A glob like
    ``/repos/*`` would match the ``*`` LITERALLY -- denying everything the
    user meant to allow -- so glob metacharacters are rejected outright
    with the prefix-semantics hint (round-3 verdict weak #3; reference
    pathSpecifier requires an explicit regex marker,
    envoy_http.go:337-347)."""
    if not path.startswith("/"):
        raise RuleValidationError(
            f"{where}: path {path!r} must start with '/'")
    for ch in ("*", "?", "["):
        if ch in path:
            raise RuleValidationError(
                f"{where}: path {path!r} contains {ch!r} -- path rules are "
                "literal prefixes, not globs; '/repos/' already matches "
                "everything under /repos/")
    bad = set(path) - _PATH_CHARS
    if bad:
        raise RuleValidationError(
            f"{where}: path {path!r} contains invalid characters "
            f"{sorted(bad)!r}")


@dataclass
class PathRule:
    """One HTTP path verdict inside an egress rule (prefix match, applied
    in declaration order; reference: httpAllowRoute/httpDenyRoute in
    controlplane/firewall/envoy_http.go:296/:314).

    Validation is strict at construction (= ingestion: config parse and
    FirewallAddRules both build these via from_dict): unknown actions,
    non-token methods, and glob/relative paths reject the whole update
    instead of failing open (advisor r3 medium #1)."""

    path: str = ""
    action: str = "allow"           # allow | deny
    methods: list[str] = field(default_factory=list)  # empty = any verb

    def __post_init__(self) -> None:
        self.action = _validate_action(
            self.action or "allow", where=f"path_rule {self.path!r}",
            allowed=("allow", "deny"))
        methods = sorted({m.strip().upper() for m in self.methods if m})
        for m in methods:
            if not m or set(m) - _METHOD_TOKEN:
                raise RuleValidationError(
                    f"path_rule {self.path!r}: method {m!r} is not an "
                    "HTTP token (regex metacharacters would broaden the "
                    "route's method match)")
        self.methods = methods
        if self.path:
            validate_path(self.path, where=f"path_rule {self.path!r}")


@dataclass
class EgressRule:
    """One egress rule.

    ``dst`` is a domain -- exact, or wildcard as ``*.zone`` / leading-dot
    ``.zone`` (reference config syntax, e2e firewall_test.go:678); both
    normalize to the ``*.`` form.  ``proto`` is one of http|https|tcp|udp,
    ``port`` the destination port (0 = protocol default).  ``action: deny``
    carves a more-specific NXDOMAIN zone out of a broader wildcard allow
    (firewall_test.go:653 DenySubdomainUnderWildcard).  ``path_rules`` +
    ``path_default`` gate HTTP paths behind MITM/Host inspection
    (firewall_test.go:842-1320); ``paths`` is the legacy shorthand for
    allow-prefixes with an implied deny default.  Dedupe key is
    ``dst:proto:port`` (reference: controlplane/firewall/rules_store.go).
    """

    dst: str = ""
    proto: str = "https"
    port: int = 0
    action: str = "allow"           # allow | deny (domain-level)
    paths: list[str] = field(default_factory=list)
    path_rules: list[PathRule] = field(default_factory=list)
    path_default: str = ""          # allow | deny; "" = deny when ruled

    def __post_init__(self) -> None:
        dst = (self.dst or "").strip().lower().rstrip(".")
        if dst.startswith(".") and len(dst) > 1:
            dst = "*" + dst         # ".zone" == "*.zone"
        self.dst = dst
        self.action = _validate_action(
            self.action or "allow", where=f"rule {self.dst!r}",
            allowed=("allow", "deny"))
        self.path_default = _validate_action(
            self.path_default, where=f"rule {self.dst!r} path_default",
            allowed=("", "allow", "deny"))
        for p in self.paths:
            validate_path(p, where=f"rule {self.dst!r} paths")

    def key(self) -> str:
        return f"{self.dst}:{self.proto}:{self.effective_port()}"

    def effective_port(self) -> int:
        if self.port:
            return self.port
        return {"https": 443, "http": 80, "ssh": 22, "git": 9418,
                "udp": 0, "tcp": 0}.get(self.proto, 0)

    @property
    def wildcard(self) -> bool:
        return self.dst.startswith("*.")

    @property
    def apex(self) -> str:
        return self.dst[2:] if self.wildcard else self.dst

    def effective_path_rules(self) -> list[PathRule]:
        """Declared path_rules followed by legacy ``paths`` allow-prefixes."""
        out = list(self.path_rules)
        out.extend(PathRule(path=p) for p in self.paths)
        return out

    def effective_path_default(self) -> str:
        if self.path_default in ("allow", "deny"):
            return self.path_default
        return "deny" if self.effective_path_rules() else "allow"

    def needs_inspection(self) -> bool:
        """True when HTTP-layer path/method verdicts exist -- https rules
        must MITM instead of SNI-passthrough."""
        return bool(self.effective_path_rules()) or self.path_default == "deny"


@dataclass
class BuildConfig:
    image: str = ""                 # base image override (else stack default)
    stack: str = ""                 # language stack bundle (python, go, node...)
    harness: str = "claude"         # agent harness bundle
    packages: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    instructions: list[str] = field(default_factory=list)  # extra Dockerfile lines


@dataclass
class AgentConfig:
    default: str = "dev"            # default agent name
    cmd: list[str] = field(default_factory=list)   # override harness CMD
    env: dict[str, str] = field(default_factory=dict)
    memory: str = ""                # container memory limit, e.g. "8g"
    cpus: float = 0.0


@dataclass
class WorkspaceConfig:
    mode: str = "bind"              # bind | snapshot (reference: internal/workspace)
    mount_docker_socket: bool = False
    extra_mounts: list[str] = field(default_factory=list)  # "src:dst[:ro]"


@dataclass
class SecurityConfig:
    egress: list[EgressRule] = field(default_factory=list)
    allow_host_proxy: bool = True
    bypass_firewall: bool = False   # dev-only full bypass


@dataclass
class ProjectConfig:
    project: str = ""
    build: BuildConfig = field(default_factory=BuildConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)
    workspace: WorkspaceConfig = field(default_factory=WorkspaceConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)

    @staticmethod
    def merge_strategies() -> dict[str, str]:
        """Dotted-path merge strategies for the layered store (union lists)."""
        return {
            "build.packages": "union",
            "build.instructions": "union",
            "security.egress": "union",
            "workspace.extra_mounts": "union",
        }


# --------------------------------------------------------------------------
# settings (settings.yaml)
# --------------------------------------------------------------------------

@dataclass
class LoggingSettings:
    level: str = "info"
    file_enabled: bool = True
    otlp_enabled: bool = False


@dataclass
class HostProxySettings:
    enable: bool = True
    port: int = 18374


@dataclass
class FirewallSettings:
    enable: bool = False
    default_deny: bool = True
    dns_upstreams: list[str] = field(default_factory=list)  # default: consts.UPSTREAM_DNS


@dataclass
class ShipperSettings:
    """Fleet-telemetry bulk ingestion into the monitor stack
    (docs/fleet-console.md#ingestion).

    With ``enable``, a loopd daemon hosts one
    :class:`~clawker_tpu.monitor.shipper.TelemetryShipper` for its
    lifetime (in-process runs attach one with ``clawker loop
    --ship-telemetry``): registry snapshots, typed bus events, and
    flight-recorder spans batch into the OpenSearch bulk API.  Bounded
    by design -- at most ``max_batches`` sealed batches wait in memory;
    a slow or down index drops the OLDEST batches (counted in
    ``monitor_ingest_dropped_total``) and can never stall the event bus
    or a scheduler lane."""

    enable: bool = False
    url: str = ""                   # bulk endpoint override; "" = the
    #                                 local stack's opensearch port
    interval_s: float = 2.0         # snapshot + flush cadence
    batch_docs: int = 256           # docs per sealed bulk batch
    max_batches: int = 64           # sealed batches buffered before
    #                                 drop-oldest backpressure
    timeout_s: float = 5.0          # per-bulk-POST deadline


@dataclass
class MonitoringSettings:
    enable: bool = False
    opensearch_port: int = 9200
    dashboards_port: int = 5601
    prometheus_port: int = 9090
    otlp_grpc_port: int = 4317
    shipper: ShipperSettings = field(default_factory=ShipperSettings)


@dataclass
class ControlPlaneSettings:
    enable: bool = False            # bring the CP up on container start paths
    admin_port: int = 7443
    agent_port: int = 7444
    health_port: int = 7080
    advertise_host: str = ""        # address agents Register back to; "" = bridge gateway
    drain_to_zero: bool = False     # self-shutdown when the last agent exits
    per_worker: bool = True         # tpu_vm: one CP per worker VM + fleet aggregation


@dataclass
class TPUSettings:
    """TPU-pod runtime description (net-new; BASELINE.json north_star)."""

    pod: str = ""                   # TPU name, e.g. "my-v5e-8"
    zone: str = ""
    project: str = ""               # GCP project
    ssh_user: str = "clawker"
    ssh_key: str = ""               # path to private key; empty = agent/default
    workers: list[str] = field(default_factory=list)  # explicit host list override
    accelerator: str = "v5litepod-8"
    topology: str = ""              # worker grid "RxC" (e.g. "2x4") for the
    #                                 topology placement policy; "" = infer a
    #                                 near-square grid from the worker count


@dataclass
class LoopJournalSettings:
    """Durable run journal for ``clawker loop`` (docs/loop-resume.md).

    On by default: the journal exists exactly for the scheduler deaths
    nobody planned for, and its cost is one fsync-batched JSONL append
    per state transition.  ``fsync_batch_n`` / ``fsync_interval_s``
    bound how much un-synced tail a HOST crash may lose (a CLI crash
    loses nothing -- every record is flushed to the OS on append).

    ``on_fault`` is the storage-fault policy (docs/durability.md): a
    durable append that cannot be made durable either journals a
    ``degraded-durability`` state and keeps the run alive (``degrade``,
    the default -- agents keep working, resume fidelity is at risk) or
    fail-stops the run (``fail`` -- the WAL contract is load-bearing,
    running on without it is worse than stopping)."""

    enable: bool = True
    fsync_batch_n: int = 8          # records per group-commit fsync
    fsync_interval_s: float = 0.25  # max age of an un-synced tail
    on_fault: str = "degrade"       # degrade | fail (durable-append fault)


@dataclass
class StoragePressureSettings:
    """Disk-pressure degradation ladder (docs/durability.md#ladder).

    A statvfs watermark monitor ticked by the scheduler and loopd: at
    the SOFT watermark non-durable streams shed first (flight spans ->
    shipper batches -> sentinel state), each shed counted per-stream;
    at the HARD watermark the emergency retention GC deletes journals
    and flight files of done runs past the newest ``retention_runs`` --
    reclaiming space BEFORE a durable append is allowed to fail.
    Watermarks are free-space fractions of the logs filesystem."""

    enable: bool = True
    soft_free_pct: float = 10.0     # shed non-durable streams below this
    hard_free_pct: float = 3.0      # emergency retention GC below this
    check_interval_s: float = 5.0   # statvfs cadence
    retention_runs: int = 64        # newest done-run journals kept by GC


@dataclass
class LoopPlacementSettings:
    """Pod-scale placement & admission defaults (docs/loop-placement.md).

    ``max_inflight_per_worker`` is the per-worker admission token
    bucket: how many create/start launches may be outstanding against
    one daemon at once -- a 64-loop burst drains at each worker's
    sustainable rate instead of flooding its lane.  ``max_pending_per_
    worker`` bounds the admission queue (beyond it, submissions are
    REJECTED and counted, and the scheduler re-places or retries).
    Tenant weight/caps drive the weighted fair queue that keeps two
    runs sharing a pod from starving each other.

    Back-compat: ``loop.placement`` used to be a bare policy string
    (``placement: spread``); that form still parses as
    ``{policy: spread}`` (see ``from_raw``)."""

    policy: str = "spread"          # spread | pack | topology
    max_inflight_per_worker: int = 4
    max_pending_per_worker: int = 256
    tenant: str = "default"         # tenant id new runs bill under
    tenant_weight: float = 1.0      # weighted-fair-queue share
    tenant_max_inflight: int = 0    # per-tenant in-flight launch cap; 0 = none

    @classmethod
    def from_raw(cls, raw) -> "LoopPlacementSettings":
        if isinstance(raw, str):
            return cls(policy=raw)
        return from_dict(cls, raw)


@dataclass
class LoopWarmPoolSettings:
    """Per-worker warm pool of created-not-yet-started agent containers
    (docs/loop-warmpool.md).

    With ``enable``, each worker keeps ``depth`` pre-created containers
    with the expensive create-time stages (engine create, workspace
    seed, harness seed, identity prewarm) already paid; a placement
    ADOPTS one -- relabel/env-fixup + start -- instead of a full
    bootstrap.  Refills bill a dedicated low-weight admission tenant so
    they never starve live placements; ``max_age_s`` bounds how stale a
    pre-staged workspace/harness snapshot may get before the member is
    recycled."""

    enable: bool = False
    depth: int = 2                  # target pool depth per worker
    max_age_s: float = 600.0        # recycle members older than this
    tenant_weight: float = 0.25     # WFQ share of the refill tenant vs
    #                                 real placements (weight 1.0)


@dataclass
class LoopWorktreeSettings:
    """The ``clawker loop --worktrees`` swarm scenario: N agents
    collaborating on ONE repository, branch-per-agent
    (docs/loop-worktrees.md).

    Each agent loop gets its own branch forked from ``base`` and its own
    linked git worktree (never a clone); ``workspace_mode`` picks how
    that tree reaches the container -- ``bind`` mounts the worktree dir
    live (local driver only), ``snapshot`` seeds the container from the
    content-addressed seed cache (one tar per fan-out, workerd-capable,
    warm-pool-capable).  With ``merge_queue``, agent branches land
    serially into a run-scoped integration branch at iteration end;
    conflict losers are resubmitted through admission after
    ``merge_retry_s`` (or the admission controller's ``retry_after_s``
    when it quotes one)."""

    workspace_mode: str = "bind"    # bind | snapshot
    branch_prefix: str = "loop"     # agent branches: <prefix>/<run>/<agent>
    base: str = "HEAD"              # ref agent branches fork from
    merge_queue: bool = True        # land agent branches at iteration end
    merge_into: str = ""            # target branch; "" = run-scoped
    #                                 integration branch <prefix>/<run>/merged
    merge_retry_s: float = 0.5      # conflict-loser resubmit delay when
    #                                 admission quotes no retry_after_s
    merge_attempts: int = 3         # merge tries per branch before the
    #                                 loser is reported failed


@dataclass
class LoopSettings:
    """Autonomous-loop scheduler defaults (net-new)."""

    parallel: int = 1
    max_iterations: int = 0         # 0 = unbounded
    idle_exit_s: float = 300.0
    placement: LoopPlacementSettings = field(
        default_factory=LoopPlacementSettings)
    failover: str = "migrate"       # migrate | wait | fail (worker death)
    journal: LoopJournalSettings = field(default_factory=LoopJournalSettings)
    storage_pressure: StoragePressureSettings = field(
        default_factory=StoragePressureSettings)
    warm_pool: LoopWarmPoolSettings = field(
        default_factory=LoopWarmPoolSettings)
    worktrees: LoopWorktreeSettings = field(
        default_factory=LoopWorktreeSettings)


@dataclass
class RuntimeSettings:
    driver: str = "local"           # local | tpu_vm | nsd | fake
    docker_host: str = ""           # override local daemon address
    tpu: TPUSettings = field(default_factory=TPUSettings)


@dataclass
class FlightRecorderSettings:
    """Per-run / per-daemon span JSONL under logs/flight
    (docs/telemetry.md#flight-recorder).

    Back-compat: ``telemetry.flight_recorder`` used to be a bare bool;
    that form still parses as ``{enable: <bool>}`` (see ``from_raw``).
    ``max_bytes`` size-caps each recorder file: at the cap the current
    file rotates to ``<file>.1`` and a fresh generation starts, so a
    long daemon-hosted run cannot grow logs/flight unboundedly while
    the newest records stay readable (readers cross the boundary)."""

    enable: bool = True
    max_bytes: int = 0              # per-file rotation cap; 0 = unbounded

    @classmethod
    def from_raw(cls, raw) -> "FlightRecorderSettings":
        if isinstance(raw, bool):
            return cls(enable=raw)
        return from_dict(cls, raw)

    def __bool__(self) -> bool:     # legacy truthiness: `if
        return self.enable          # settings.telemetry.flight_recorder:`


@dataclass
class TracingSettings:
    """Cross-process distributed tracing (docs/tracing.md).

    Context propagation rides frame fields on RPCs that already exist,
    so ``enable`` gates only the *recording* side: daemon-side remote
    spans and the per-channel clock-skew estimation.  ``skew_alpha`` is
    the EWMA weight for new midpoint-offset samples."""

    enable: bool = True
    skew_alpha: float = 0.25        # EWMA weight per offset sample


@dataclass
class TelemetrySettings:
    """Fleet telemetry (net-new; docs/telemetry.md).

    Spans + flight recorder are on by default (cheap, and post-mortems
    exist for the runs nobody planned to debug); the Prometheus scrape
    port is opt-in because it opens a listener."""

    metrics_port: int = 0           # 127.0.0.1 scrape port; 0 = off
    otlp: bool = False              # ship registry snapshots over the
    #                                 CP's OTLP lanes during loop runs
    flight_recorder: FlightRecorderSettings = field(
        default_factory=FlightRecorderSettings)
    tracing: TracingSettings = field(default_factory=TracingSettings)


@dataclass
class LoopdSettings:
    """The host-resident loop-supervisor daemon (docs/loopd.md).

    ``clawker loopd start`` brings up one daemon per host; it owns the
    pod-scale state -- ONE admission controller, the per-worker serial
    lanes, its own health breakers -- so two concurrent ``clawker
    loop`` invocations share the per-worker inflight caps and tenant
    fairness ACROSS processes, and runs keep executing after the
    submitting CLI exits (``clawker loop attach <run>`` re-streams).

    With ``enable`` the CLI auto-discovers a running daemon (unix
    socket in a 0700 runtime dir under the state dir) and becomes a
    thin control client; no daemon = today's in-process scheduler,
    unchanged.  ``autostart`` spawns the daemon on first ``clawker
    loop`` when none answers."""

    enable: bool = True             # CLI may discover & use a running daemon
    socket: str = ""                # unix socket path override
    #                                 ("" = <state>/loopd/loopd.sock)
    autostart: bool = False         # `clawker loop` starts loopd if absent
    metrics_port: int = 0           # daemon-owned Prometheus scrape port
    #                                 (127.0.0.1; 0 = off)
    drain_grace_s: float = 10.0     # graceful-stop budget per live run
    start_deadline_s: float = 15.0  # loopd start: socket-answering deadline


@dataclass
class FederationSettings:
    """Multi-pod federation: the front-tier run router (docs/federation.md).

    One loopd daemon serves one pod; with ``pods`` listing several
    daemons' sockets the ``FederationRouter`` places whole runs (or
    shards of one large ``--parallel N`` run) ACROSS pods: a
    ``PodPolicy`` picks pods by locality tier (ICI group < pod < DCN),
    live load, and breaker state from each pod's status RPC, then the
    pod's own per-worker policy places intra-pod, untouched.  Launch
    admission is amortized through bounded, renewable capacity LEASES
    (``lease_tokens`` launch tokens per pod, ``lease_ttl_s`` TTL), so
    the launch hot path pays zero extra WAN hops.  No pods configured
    = the single-pod loopd path, byte-identical (degrade matrix)."""

    enable: bool = False            # `clawker loop --pods` / `clawker fed`
    name: str = ""                  # THIS pod's name in the federation
    #                                 ("" = the socket's directory name)
    pods: list[str] = field(default_factory=list)  # per-pod loopd socket
    #                                 paths the router addresses
    shape: str = ""                 # pod grid "RxC" for locality tiers
    #                                 ("" = flat: every pod equidistant)
    lease_tokens: int = 8           # launch tokens per capacity lease
    lease_ttl_s: float = 5.0        # lease TTL; a partitioned router's
    #                                 tokens lapse back to the pod
    status_interval_s: float = 1.0  # pod status/health poll cadence


@dataclass
class WorkerdSettings:
    """The worker-resident launch daemon (docs/workerd.md).

    ``clawker workerd start`` brings up one daemon per WORKER host; the
    scheduler (or loopd) discovers it -- the transport-forwarded socket
    for ``tpu_vm`` workers, the canonical state-dir socket for the
    local engine -- and moves the launch data plane there: batched
    intents out, batched typed events back, one persistent channel per
    worker, so creates/starts/waits stop paying a host<->worker WAN
    round trip per engine call.  No daemon answering = the in-process
    direct executor, unchanged (`clawker loop --no-workerd` forces it;
    `fleet health` renders per-worker liveness)."""

    enable: bool = True             # scheduler may discover & use workerd
    socket: str = ""                # unix socket path override
    #                                 ("" = <state>/workerd/workerd.sock)
    intent_deadline_s: float = 60.0  # pending intent age before the loop
    #                                  fails over to the direct path
    start_deadline_s: float = 15.0  # workerd start: socket-answer deadline
    seed_cache_bytes: int = 64 * 1024 * 1024  # worker-local seed store
    #                                 cap: content-addressed workspace
    #                                 seed tars kept resident (LRU by
    #                                 bytes) so launch intents reference
    #                                 a digest instead of re-shipping the
    #                                 tree over the WAN per agent
    #                                 (docs/loop-worktrees.md#seed-cache)


@dataclass
class SentinelSettings:
    """The online fleet sentinel (docs/analytics-online.md).

    With ``enable`` (or ``clawker loop --sentinel``), every loop run
    fuses the fleet's egress streams with the scheduler's typed events
    and scores the whole fleet's open windows each ``interval_s`` as
    ONE sharded program -- flags surface as typed ``anomaly.flag`` bus
    events, ``anomaly_score``/``anomaly_flags_total`` metrics, and
    flight-recorder spans.  Strictly observe-only: flags never feed
    breakers or placement.  ``threshold`` is the worker-relative robust
    z past which an agent's window flags; ``baseline_window`` bounds
    the per-worker rolling normal profile (persisted per run, so
    ``--resume`` keeps it)."""

    enable: bool = False
    interval_s: float = 5.0
    window_s: int = 60
    train_steps: int = 40           # denoising fit steps per tick
    threshold: float = 3.5
    baseline_window: int = 256


@dataclass
class ChaosSettings:
    """Defaults for ``clawker chaos run`` (docs/chaos.md).

    ``seed`` pins the soak schedule: scenario ``i`` of a run is fully
    determined by ``(seed, i)``, so a CI failure replays anywhere with
    ``clawker chaos replay --seed S --scenario I``.  The fleet shape
    mirrors the 4-worker fake pod the robustness suites use."""

    scenarios: int = 25             # seeded scenarios per soak
    seed: int = 20260803            # fixed default: CI soaks are repros
    parallel: int = 6               # agent loops per scenario
    workers: int = 4                # fake pod size
    iterations: int = 2             # per-loop iteration budget


@dataclass
class CapacitySloSettings:
    """Per-tenant latency SLOs the admission scaling law targets
    (docs/elastic-capacity.md).  A tenant's SLO bounds the admission
    wait its launches may see; the tightest configured SLO drives the
    per-worker token scaling, and a queue that provably cannot drain
    inside it flips to reject-with-``retry_after_s``.  0 = no SLO."""

    default_s: float = 0.0          # SLO for tenants not listed below
    tenants: dict[str, float] = field(default_factory=dict)


@dataclass
class CapacityAutoscaleSettings:
    """Fleet autoscaling thresholds (docs/elastic-capacity.md).

    Sustained per-worker queue depth past ``queue_high`` provisions a
    worker through the concurrent fleet provisioner; sustained busy
    fraction under ``idle_low`` drains the least-loaded worker --
    gated on journal replay proving zero live placements on the victim
    (a journaled run is never stranded by scale-down)."""

    enable: bool = False
    min_workers: int = 1
    max_workers: int = 8
    queue_high: int = 8             # sustained pending per worker -> grow
    idle_low: float = 0.25          # sustained busy fraction under -> drain
    sustain_s: float = 5.0          # how long a signal must hold


@dataclass
class CapacitySettings:
    """The elastic-capacity controller (docs/elastic-capacity.md).

    With ``enable``, loopd ticks one controller across its hosted runs
    (in-process ``--no-daemon`` runs tick their own): warm-pool depth
    follows the EWMA arrival rate per worker within
    ``[pool_min_depth, pool_max_depth]``, admission tokens scale from
    measured launch latency against the ``slo`` block, and the
    ``autoscale`` block provisions/drains workers.  Every decision is
    journaled (``REC_CAPACITY_*``) and emitted as a typed
    ``capacity.decision`` bus event."""

    enable: bool = False
    interval_s: float = 1.0         # controller tick cadence
    pool_min_depth: int = 0         # adaptive target clamp, per worker
    pool_max_depth: int = 8
    refill_lead_s: float = 0.0      # arrival window one pool member must
    #                                 cover; 0 = use measured launch latency
    alpha_up: float = 0.5           # arrival EWMA: burst response
    alpha_down: float = 0.08        # arrival EWMA: decay to quiet baseline
    token_min: int = 0              # token scaling floor; 0 = the static
    #                                 loop.placement.max_inflight_per_worker
    token_max: int = 16             # token scaling ceiling per worker
    slo: CapacitySloSettings = field(default_factory=CapacitySloSettings)
    autoscale: CapacityAutoscaleSettings = field(
        default_factory=CapacityAutoscaleSettings)


@dataclass
class GitguardSettings:
    """The git-protocol firewall proxy for worktree swarms
    (docs/git-policy.md).

    With ``enable``, a ``clawker loop --worktrees`` run starts a
    gitguard proxy on a hardened unix socket, installs run-scoped
    egress rules (each host in ``hosts`` gets an https lane forced
    through the guard plus ssh/22 and git/9418 deny pins), and tears
    both down at cleanup.  The guard filters ref advertisements and
    refuses out-of-namespace pushes per agent identity -- fail-closed:
    with the guard down, every git path is a connection error."""

    enable: bool = True             # guard worktree swarm runs
    hosts: list[str] = field(default_factory=list)
    #                                 git hosts to route through the guard
    #                                 (empty = the run's own seed repo only)
    socket: str = ""                # unix socket path override
    #                                 ("" = <state>/gitguard/<run>.sock)
    merge_identity: str = "mergeq"  # privileged role that may land the
    #                                 integration branch


@dataclass
class CredentialSettings:
    """Host-credential staging policy (off by default).

    The default contract: credentials are NEVER copied from the host;
    you authenticate once inside the agent container and the token
    family persists across recreates in the per-agent config volume
    (proven by tests/e2e/test_e2e_credentials.py).  ``stage: true``
    opts in to copying the harness manifest's declared credential
    files (staging.credentials) at create time -- the reference's
    keyring behavior -- so fleet fan-outs start pre-authenticated."""

    stage: bool = False


@dataclass
class Settings:
    logging: LoggingSettings = field(default_factory=LoggingSettings)
    host_proxy: HostProxySettings = field(default_factory=HostProxySettings)
    firewall: FirewallSettings = field(default_factory=FirewallSettings)
    monitoring: MonitoringSettings = field(default_factory=MonitoringSettings)
    control_plane: ControlPlaneSettings = field(default_factory=ControlPlaneSettings)
    runtime: RuntimeSettings = field(default_factory=RuntimeSettings)
    loop: LoopSettings = field(default_factory=LoopSettings)
    loopd: LoopdSettings = field(default_factory=LoopdSettings)
    federation: FederationSettings = field(default_factory=FederationSettings)
    workerd: WorkerdSettings = field(default_factory=WorkerdSettings)
    telemetry: TelemetrySettings = field(default_factory=TelemetrySettings)
    credentials: CredentialSettings = field(default_factory=CredentialSettings)
    chaos: ChaosSettings = field(default_factory=ChaosSettings)
    sentinel: SentinelSettings = field(default_factory=SentinelSettings)
    capacity: CapacitySettings = field(default_factory=CapacitySettings)
    gitguard: GitguardSettings = field(default_factory=GitguardSettings)

    @staticmethod
    def merge_strategies() -> dict[str, str]:
        return {
            "firewall.dns_upstreams": "union",
            "runtime.tpu.workers": "union",
            "federation.pods": "union",
            "gitguard.hosts": "union",
        }
