"""FirewallStack: lifecycle of the proxy container and the DNS gate.

The port's copy of ``clawker_tpu/firewall/stack.py``, whole.

Two data-plane services back the kernel programs:

- **Envoy** runs as the ``clawker-envoy`` container at the deterministic
  .2 address on clawker-net, config + MITM certs delivered via a
  generated config directory bind.  Config drift is detected by a
  content-sha label; a reload with changed bytes recreates the
  container (deterministic YAML makes the sha meaningful).
- **The DNS gate** runs in-process in the control-plane daemon, bound to
  the clawker-net gateway :53.  The reference ships a custom CoreDNS
  container for this (Stack.ensureCorednsImage stack.go:1039); running
  the gate in the CP process instead removes an image build + container
  per worker and gives it direct pinned-map access on the host where
  the maps live -- the right trade on TPU-VM workers where the CP
  daemon is already privileged.

Parity reference: controlplane/firewall/stack.go (EnsureRunning :156,
Reload :214, WaitForHealthy :261, container specs :657/:723, drift
labels :796).
"""

from __future__ import annotations

import hashlib
from pathlib import Path

from .. import consts, logsetup
from ..config.schema import EgressRule
from ..engine.api import ContainerSpec, Engine
from ..errors import ClawkerError
from .dnsgate import DnsGate, ZonePolicy
from .envoy import EnvoyBundle, generate_envoy_config
from .maps import FirewallMaps
from . import pki

log = logsetup.get("firewall.stack")

ENVOY_IMAGE = "envoyproxy/envoy:v1.30.2"
ENVOY_CONF_MOUNT = "/etc/clawker"


class StackError(ClawkerError):
    pass


class FirewallStack:
    def __init__(
        self,
        engine: Engine,
        maps: FirewallMaps,
        *,
        conf_dir: Path,
        pki_dir: Path,
        dns_host: str = "",
        dns_port: int = consts.DNS_PORT,
        upstreams: tuple[str, ...] = consts.UPSTREAM_DNS,
        gitguard_hosts: tuple[str, ...] = (),
        gitguard_socket: str = "",
    ):
        self.engine = engine
        self.maps = maps
        self.conf_dir = Path(conf_dir)
        self.pki_dir = Path(pki_dir)
        self.dns_host = dns_host
        self.dns_port = dns_port
        self.upstreams = upstreams
        # git hosts whose MITM chain routes through the gitguard proxy
        # socket instead of dynamic-forward-proxy (docs/git-policy.md);
        # only armed when settings name a STABLE socket -- per-run
        # sockets are enforced at the proxy itself
        self.gitguard_hosts = tuple(gitguard_hosts)
        self.gitguard_socket = gitguard_socket
        self.gate: DnsGate | None = None
        self.bundle: EnvoyBundle | None = None

    # ------------------------------------------------------------ network

    def network(self) -> dict:
        return self.engine.ensure_network(consts.NETWORK_NAME)

    def envoy_ip(self) -> str:
        return self.engine.network_static_ip(consts.NETWORK_NAME, consts.ENVOY_HOST_OFFSET)

    def gateway_ip(self) -> str:
        """Gateway = .1: where host daemons (DNS gate, hostproxy) listen."""
        return self.engine.network_static_ip(consts.NETWORK_NAME, 1)

    def network_cidr(self) -> tuple[str, int]:
        """(network_address, prefix_len) of the sandbox bridge -- the
        CIDR the kernel's intra-network bypass admits (sibling services
        on the bridge are reachable without a rule: firewall_test.go:398)."""
        import ipaddress

        subnet = self.network()["IPAM"]["Config"][0]["Subnet"]
        net = ipaddress.ip_network(subnet)
        return str(net.network_address), net.prefixlen

    # ------------------------------------------------------------- render

    def render(self, rules: list[EgressRule]) -> EnvoyBundle:
        """Config + certs on disk; returns the bundle (listener ports).

        The EXACT artifact about to be deployed is validated before the
        write: an invalid bootstrap reaching a real Envoy is a NACK (=
        full egress outage on reload), so the caller's mutation fails
        while the previous config keeps serving (envoy_validate.go)."""
        from .envoy import validate_bundle

        bundle = generate_envoy_config(
            rules, cert_dir=ENVOY_CONF_MOUNT + "/certs",
            gitguard_hosts=self.gitguard_hosts,
            gitguard_socket=self.gitguard_socket)
        errs = validate_bundle(bundle)
        if errs:
            raise ClawkerError(
                "refusing data-plane swap; generated Envoy bootstrap is "
                "invalid: " + "; ".join(errs[:4]))
        self.conf_dir.mkdir(parents=True, exist_ok=True)
        (self.conf_dir / "envoy.yaml").write_text(bundle.config_yaml)
        certs = self.conf_dir / "certs"
        certs.mkdir(exist_ok=True)
        ca = pki.ensure_ca(self.pki_dir)
        for domain in bundle.mitm_domains:
            crt, key = certs / f"{domain}.crt", certs / f"{domain}.key"
            if not (crt.exists() and key.exists()):
                pair = pki.generate_domain_cert(ca, domain)
                crt.write_bytes(pair.cert_pem)
                key.touch(mode=0o600)
                key.write_bytes(pair.key_pem)
        self.bundle = bundle
        return bundle

    def config_sha(self) -> str:
        h = hashlib.sha256()
        for f in sorted(self.conf_dir.rglob("*")):
            if f.is_file():
                h.update(f.name.encode())
                h.update(f.read_bytes())
        # spec-level knobs drift the container too: an already-deployed
        # proxy whose envoy.yaml is unchanged must still recreate when
        # e.g. its resolver pinning changes (upgrade path)
        h.update(repr(self._envoy_dns()).encode())
        return h.hexdigest()[:16]

    def _envoy_dns(self) -> list[str]:
        """Resolver override for the proxy container: pin to the gate
        ONLY when the gate actually serves gateway:53 (production
        placement) -- a loopback/ephemeral gate (monitor fallback, unit
        tests) is unreachable from the container netns, and pinning
        there would black-hole all upstream resolution."""
        if self.dns_port == consts.DNS_PORT and not self.dns_host:
            return [self.gateway_ip()]
        return []

    # ------------------------------------------------------------- envoy

    def ensure_envoy(self) -> str:
        """Idempotent: running container with current config sha, else
        (re)create (drift label: stack.go:796 analogue)."""
        self.network()
        sha = self.config_sha()
        name = consts.ENVOY_CONTAINER
        if self.engine.container_exists(name):
            info = self.engine.inspect_container(name)
            labels = (info.get("Config") or {}).get("Labels") or {}
            running = (info.get("State") or {}).get("Running")
            if labels.get(consts.LABEL_CONTENT_SHA) == sha and running:
                return info["Id"]
            log.info("envoy drift (sha %s -> %s): recreating",
                     labels.get(consts.LABEL_CONTENT_SHA), sha)
            self.engine.remove_container(name, force=True)
        if not self.engine.image_exists(ENVOY_IMAGE):
            for _ in self.engine.pull_image(ENVOY_IMAGE):
                pass
        spec = ContainerSpec(
            image=ENVOY_IMAGE,
            cmd=["-c", f"{ENVOY_CONF_MOUNT}/envoy.yaml", "--base-id", "7"],
            labels={
                consts.LABEL_ROLE: "envoy",
                consts.LABEL_CONTENT_SHA: sha,
            },
            binds=[f"{self.conf_dir}:{ENVOY_CONF_MOUNT}:ro"],
            network=consts.NETWORK_NAME,
            static_ip=self.envoy_ip(),
            restart_policy="on-failure:3",
            # the proxy's OWN upstream resolution (LOGICAL_DNS clusters,
            # dynamic-forward-proxy caches) must go through the gate too:
            # a daemon-default resolver here would let a rebinding answer
            # bypass the gate's guard on the second resolution
            dns=self._envoy_dns(),
        )
        cid = self.engine.create_container(name, spec)
        self.engine.start_container(cid)
        return cid

    # ---------------------------------------------------------- dns gate

    def internal_lookup(self, qname: str) -> str | None:
        """docker.internal resolution from the engine's inventory: the gate
        is host-resident, so Docker's embedded 127.0.0.11 resolver (netns-
        local) is unreachable -- answer ``<name>.docker.internal`` with the
        container's clawker-net address via inspect instead."""
        name = qname.strip(".").lower()
        suffix = "." + consts.INTERNAL_ZONE
        if name.endswith(suffix):
            name = name[: -len(suffix)]
        if not name:
            return None
        try:
            info = self.engine.inspect_container(name)
        except ClawkerError:
            return None
        nets = ((info.get("NetworkSettings") or {}).get("Networks") or {})
        net = nets.get(consts.NETWORK_NAME)
        if net and net.get("IPAddress"):
            return net["IPAddress"]
        ip = (info.get("NetworkSettings") or {}).get("IPAddress")
        return ip or None

    def ensure_gate(self, rules: list[EgressRule]) -> DnsGate:
        policy = ZonePolicy.from_rules(rules)
        if self.gate is None:
            self.gate = DnsGate(
                policy, self.maps,
                upstreams=self.upstreams,
                internal_lookup=self.internal_lookup,
                host=self.dns_host or self.gateway_ip(),
                port=self.dns_port,
            )
            self.gate.start()
        else:
            self.gate.set_policy(policy)
        return self.gate

    # ----------------------------------------------------------- combined

    def ensure_running(self, rules: list[EgressRule]) -> EnvoyBundle:
        bundle = self.render(rules)
        # gate first: the proxy container's only configured resolver may
        # be the gate, so it must be listening before Envoy boots and
        # fires its startup LOGICAL_DNS/DFP resolutions
        self.ensure_gate(rules)
        self.ensure_envoy()
        return bundle

    def reload(self, rules: list[EgressRule]) -> EnvoyBundle:
        """Same as ensure_running: render detects drift, gate hot-swaps."""
        return self.ensure_running(rules)

    def status(self) -> dict:
        envoy_running = False
        try:
            if self.engine.container_exists(consts.ENVOY_CONTAINER):
                info = self.engine.inspect_container(consts.ENVOY_CONTAINER)
                envoy_running = bool((info.get("State") or {}).get("Running"))
        except ClawkerError:
            pass
        return {
            # aggregate verdict, the reference's `"running": true` in
            # `firewall status --json` (firewall_test.go:382)
            "running": envoy_running and bool(self.gate and self.gate.bound_port),
            "envoy_running": envoy_running,
            "dns_gate_up": bool(self.gate and self.gate.bound_port),
            "dns_stats": vars(self.gate.stats) if self.gate else {},
            "config_sha": self.config_sha() if self.conf_dir.exists() else "",
        }

    def stop(self) -> None:
        if self.gate is not None:
            self.gate.stop()
            self.gate = None
        try:
            if self.engine.container_exists(consts.ENVOY_CONTAINER):
                self.engine.remove_container(consts.ENVOY_CONTAINER, force=True)
        except ClawkerError as e:
            log.warning("envoy teardown: %s", e)
