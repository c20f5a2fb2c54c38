"""FirewallHandler: the 13 admin verbs, serialized through the ActionQueue.

The port's copy of ``clawker_tpu/firewall/handler.py``, whole.

Owned by the control-plane daemon; every verb is registered on the
AdminServer so the CLI reaches it as ``POST /v1/Firewall<Verb>`` behind
mTLS + bearer auth.  All mutations run on the single action thread; reads
(ListRules/Status/ResolveHostname) answer from a consistent snapshot by
riding the same queue.

Parity reference: controlplane/firewall/handler.go -- FirewallInit :300
(idempotent stack-up + re-enroll :374), Enable :538 (per-container cgroup
enroll, drift-guarded INV-B2-016), Disable :603, Bypass :656 (dead-man
timer), AddRules :726, RemoveRule :777, ListRules :824, Reload :932,
Status :948, RotateCA :981, SyncRoutes :1015, ResolveHostname :1032,
Remove :471.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .. import consts, logsetup
from ..config.schema import EgressRule, from_dict, to_dict
from ..errors import ClawkerError
from .dnsgate import ZonePolicy
from .enroll import Attacher, CgroupResolver, EnrollError
from .maps import FirewallMaps
from .model import (
    FLAG_ENFORCE,
    FLAG_HOSTPROXY,
    Action,
    ContainerPolicy,
)
from . import pki, policy as policy_mod
from .queue import ActionQueue
from .rules import RulesStore
from .stack import FirewallStack

log = logsetup.get("firewall.handler")

BYPASS_DEFAULT_S = 300
BYPASS_MAX_S = 3600


@dataclass
class Enrollment:
    container_id: str
    cgroup_id: int
    cgroup_path: str
    enrolled_at: float = field(default_factory=time.time)


class FirewallHandler:
    def __init__(
        self,
        *,
        stack: FirewallStack,
        maps: FirewallMaps,
        rules_store: RulesStore,
        base_rules: list[EgressRule],
        pki_dir: Path,
        resolver: CgroupResolver,
        attacher: Attacher,
        hostproxy_port: int = consts.HOSTPROXY_PORT,
        allow_hostproxy: bool = True,
        state_path: Path | None = None,
    ):
        self.stack = stack
        self.maps = maps
        self.rules_store = rules_store
        self.base_rules = base_rules
        self.pki_dir = Path(pki_dir)
        self.resolver = resolver
        self.attacher = attacher
        self.hostproxy_port = hostproxy_port
        self.allow_hostproxy = allow_hostproxy
        self.state_path = Path(state_path) if state_path else None
        self.queue = ActionQueue()
        self.enrollments: dict[str, Enrollment] = self._load_enrollments()
        self._bypass_timers: dict[str, threading.Timer] = {}
        self.initialized = False

    # --------------------------------------------------- enrollment state

    def _load_enrollments(self) -> dict[str, Enrollment]:
        """Rehydrate from disk so a restarted handler (CP crash, new CLI
        process) still knows which containers it enrolled -- without this,
        Init's re-enroll would be a no-op and restarted agents would run
        unenforced."""
        import json

        if self.state_path is None or not self.state_path.exists():
            return {}
        try:
            raw = json.loads(self.state_path.read_text())
        except (OSError, ValueError):
            return {}
        return {
            cid: Enrollment(cid, e["cgroup_id"], e["cgroup_path"],
                            e.get("enrolled_at", 0.0))
            for cid, e in raw.items()
        }

    def _persist_enrollments(self) -> None:
        import json

        if self.state_path is None:
            return
        from ..util.fs import atomic_write

        self.state_path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write(self.state_path, json.dumps({
            e.container_id: {"cgroup_id": e.cgroup_id,
                             "cgroup_path": e.cgroup_path,
                             "enrolled_at": e.enrolled_at}
            for e in self.enrollments.values()
        }, indent=1).encode())

    # ------------------------------------------------------------ helpers

    def effective_rules(self) -> list[EgressRule]:
        return self.rules_store.effective(self.base_rules)

    def _sync_data_plane(self) -> dict:
        """Render Envoy + gate + kernel routes from the effective rules.
        The one function every rule mutation funnels through, so proxy,
        gate and kernel can never disagree.

        stack.render validates the bootstrap it is about to deploy
        BEFORE writing it (an invalid config reaching a real Envoy is a
        NACK -- a full egress outage on reload), so a bad rule set fails
        here and the old data plane stays up (reference
        envoy_validate.go)."""
        rules = self.effective_rules()
        bundle = self.stack.ensure_running(rules)
        table = policy_mod.build_routes(
            rules,
            envoy_ip=self.stack.envoy_ip(),
            tls_port=consts.ENVOY_TLS_PORT,
            tcp_ports=bundle.tcp_ports,
        )
        self.maps.sync_routes(table)
        return {"rules": len(rules), "routes": len(table),
                "tcp_listeners": len(bundle.tcp_ports)}

    def _container_policy(self) -> ContainerPolicy:
        flags = FLAG_ENFORCE
        hp_ip, hp_port = "0.0.0.0", 0
        if self.allow_hostproxy:
            flags |= FLAG_HOSTPROXY
            hp_ip, hp_port = self.stack.gateway_ip(), self.hostproxy_port
        # Intra-network bypass (FW_R_INTRA_NET): sibling services on the
        # sandbox bridge are reachable without a rule, like the reference's
        # IntraNetworkBypass (firewall_test.go:398).  Degrade to no-bypass
        # if the network is not inspectable (policy stays fail-closed).
        net_ip, net_prefix = "0.0.0.0", 0
        try:
            net_ip, net_prefix = self.stack.network_cidr()
        except (ClawkerError, KeyError, IndexError, TypeError, ValueError) as e:
            log.warning("intra-net bypass disabled: %s", e)
        return ContainerPolicy(
            envoy_ip=self.stack.envoy_ip(),
            dns_ip=self.stack.gate.host if self.stack.gate else self.stack.gateway_ip(),
            hostproxy_ip=hp_ip,
            hostproxy_port=hp_port,
            flags=flags,
            net_ip=net_ip,
            net_prefix=net_prefix,
        )

    def register_on(self, admin) -> None:
        for verb, fn in (
            ("FirewallInit", self.init), ("FirewallEnable", self.enable),
            ("FirewallDisable", self.disable), ("FirewallBypass", self.bypass),
            ("FirewallAddRules", self.add_rules),
            ("FirewallRemoveRule", self.remove_rule),
            ("FirewallListRules", self.list_rules),
            ("FirewallReload", self.reload), ("FirewallStatus", self.status),
            ("FirewallRotateCA", self.rotate_ca),
            ("FirewallSyncRoutes", self.sync_routes),
            ("FirewallResolveHostname", self.resolve_hostname),
            ("FirewallRemove", self.remove),
        ):
            admin.register(verb, fn)

    # -------------------------------------------------------------- verbs

    def init(self, req: dict) -> dict:
        """Idempotent bring-up + re-enroll of still-running containers
        (stack restart / CP crash recovery: handler.go:374)."""
        def act():
            counts = self._sync_data_plane()
            reenrolled, stale = 0, []
            for cid, enr in list(self.enrollments.items()):
                try:
                    cgid, cgpath = self.resolver.resolve(self.stack.engine, cid)
                except (EnrollError, ClawkerError):
                    stale.append(cid)
                    continue
                if cgid != enr.cgroup_id:  # restarted container: new cgroup
                    self.maps.unenroll(enr.cgroup_id)
                    self.attacher.attach(cgpath)
                    self.enrollments[cid] = Enrollment(cid, cgid, cgpath)
                self.maps.enroll(cgid, self._container_policy())
                reenrolled += 1
            for cid in stale:
                self.maps.unenroll(self.enrollments.pop(cid).cgroup_id)
            self._persist_enrollments()
            self.initialized = True
            return {"initialized": True, "reenrolled": reenrolled,
                    "stale_removed": len(stale), **counts}
        return self.queue.run(act)

    def enable(self, req: dict) -> dict:
        container = str(req.get("container_id") or "")
        if not container:
            raise ClawkerError("enable: container_id required")

        def act():
            if not self.initialized:
                self._sync_data_plane()
                self.initialized = True
            cgid, cgpath = self.resolver.resolve(self.stack.engine, container)
            prior = self.enrollments.get(container)
            if prior and prior.cgroup_id != cgid:
                # drift guard (INV-B2-016): restarted container left a
                # stale cgroup entry -- remove it before enrolling anew
                self.maps.unenroll(prior.cgroup_id)
            self.attacher.attach(cgpath)
            self.maps.enroll(cgid, self._container_policy())
            self.enrollments[container] = Enrollment(container, cgid, cgpath)
            self._persist_enrollments()
            log.info("firewall enabled: container=%s cgroup=%d", container, cgid)
            return {"enabled": True, "cgroup_id": cgid}
        return self.queue.run(act)

    def disable(self, req: dict) -> dict:
        container = str(req.get("container_id") or "")

        def act():
            enr = self.enrollments.pop(container, None)
            if enr is None:
                return {"disabled": False, "reason": "not enrolled"}
            self._cancel_bypass(container)
            self.maps.unenroll(enr.cgroup_id)
            self._persist_enrollments()
            try:
                self.attacher.detach(enr.cgroup_path)
            except EnrollError as e:
                log.warning("detach %s: %s", container, e)
            return {"disabled": True}
        return self.queue.run(act)

    def bypass(self, req: dict) -> dict:
        """Time-boxed full allow with a dead-man timer: if the CP dies the
        deadline stays in the pinned map and Init's CleanupStaleBypass
        analogue (clear_expired) removes it (handler.go:656)."""
        container = str(req.get("container_id") or "")
        duration = min(float(req.get("duration_s") or BYPASS_DEFAULT_S), BYPASS_MAX_S)

        def act():
            enr = self.enrollments.get(container)
            if enr is None:
                raise ClawkerError(f"bypass: {container} is not enrolled")
            # Drift guard (INV-B2-016, handler.go:656): re-resolve the
            # cgroup at bypass time.  A stopped container fails resolution;
            # a restarted one has a new cgroup id -- either way the stale
            # enrollment must not receive a blanket allow.
            try:
                cgid, _ = self.resolver.resolve(self.stack.engine, container)
            except (EnrollError, ClawkerError) as e:
                raise ClawkerError(f"bypass: {container}: {e}") from e
            if cgid != enr.cgroup_id:
                raise ClawkerError(
                    f"bypass: {container}: cgroup drift (INV-B2-016)")
            import math

            # ceil: int truncation must never move the deadline into the past
            deadline = math.ceil(time.time() + duration)
            self.maps.set_bypass(enr.cgroup_id, deadline)
            self._cancel_bypass(container)
            t = threading.Timer(duration, self._bypass_expired, args=(container, enr.cgroup_id))
            t.daemon = True
            t.start()
            self._bypass_timers[container] = t
            return {"bypassed": True, "until_unix": deadline}
        return self.queue.run(act)

    def _bypass_expired(self, container: str, cgroup_id: int) -> None:
        try:
            self.queue.run(lambda: self.maps.clear_bypass(cgroup_id))
            log.info("bypass expired: %s", container)
        except ClawkerError:
            pass

    def _cancel_bypass(self, container: str) -> None:
        t = self._bypass_timers.pop(container, None)
        if t is not None:
            t.cancel()

    def clear_expired_bypass(self) -> int:
        """Init-time GC of deadlines that outlived a dead CP."""
        from .maps import iter_expired_bypass

        n = 0
        for cg in iter_expired_bypass(self.maps):
            self.maps.clear_bypass(cg)
            n += 1
        return n

    def gc_tick(self) -> dict:
        """Periodic map GC: expire dns_cache entries + stale bypass deadlines.

        The kernel deliberately skips expires_unix at lookup (common.h:98:
        TTL "enforced exclusively by userspace GC"), so without this ticker
        stale ip->zone entries keep direct-ALLOW routes open long past DNS
        TTL.  Reference: ebpf/dns_gc.go (GarbageCollectDNS on a ticker).
        Serialized through the action queue like every other map mutation.
        """
        def act():
            return {
                "dns_expired": self.maps.expire_dns(),
                "bypass_cleared": self.clear_expired_bypass(),
            }

        return self.queue.run(act)

    def add_rules(self, req: dict) -> dict:
        raw = req.get("rules") or []
        try:
            new = [from_dict(EgressRule, r) for r in raw]
        except (ValueError, TypeError) as e:
            # ingestion validation (schema RuleValidationError): reject the
            # whole update with a clean RPC error, reference ValidateRule
            raise ClawkerError(str(e)) from e

        def act():
            snapshot = self.rules_store.load()
            added = self.rules_store.add(new)
            try:
                counts = self._sync_data_plane()
            except ClawkerError:
                # refused swap (e.g. invalid bootstrap): the poison rule
                # must not stay persisted, or every later sync -- and the
                # next daemon init -- would re-render the same failure
                self.rules_store.replace(snapshot)
                raise
            return {"added": [r.key() for r in added], **counts}
        return self.queue.run(act)

    def remove_rule(self, req: dict) -> dict:
        key = str(req.get("key") or "")

        def act():
            snapshot = self.rules_store.load()
            removed = self.rules_store.remove(key)
            if not removed:
                return {"removed": False}
            try:
                counts = self._sync_data_plane()
            except ClawkerError:
                self.rules_store.replace(snapshot)  # see add_rules
                raise
            return {"removed": True, **counts}
        return self.queue.run(act)

    def list_rules(self, req: dict) -> dict:
        def act():
            stored = {r.key() for r in self.rules_store.load()}
            return {"rules": [
                {**to_dict(r), "key": r.key(),
                 "source": "dynamic" if r.key() in stored else "base"}
                for r in self.effective_rules()
            ]}
        return self.queue.run(act)

    def reload(self, req: dict) -> dict:
        def act():
            counts = self._sync_data_plane()
            return {"reloaded": True, **counts}
        return self.queue.run(act)

    def status(self, req: dict) -> dict:
        def act():
            return {
                "initialized": self.initialized,
                "enrolled": [
                    {"container_id": e.container_id, "cgroup_id": e.cgroup_id,
                     "bypassed": self.maps.bypassed(e.cgroup_id)}
                    for e in self.enrollments.values()
                ],
                "stack": self.stack.status(),
                "dns_cache_entries": len(self.maps.dns_entries()),
                "routes": len(self.maps.routes()),
            }
        return self.queue.run(act)

    def rotate_ca(self, req: dict) -> dict:
        """New CA: MITM certs regenerate on next render; agent images must
        be rebuilt to trust it (handler.go:981 contract)."""
        def act():
            pki.rotate_ca(self.pki_dir)
            certs = self.stack.conf_dir / "certs"
            if certs.exists():
                for f in certs.iterdir():
                    f.unlink()
            counts = self._sync_data_plane()
            return {"rotated": True, **counts}
        return self.queue.run(act)

    def sync_routes(self, req: dict) -> dict:
        def act():
            return self._sync_data_plane()
        return self.queue.run(act)

    def resolve_hostname(self, req: dict) -> dict:
        """Debug verb: what would the policy do for this name?"""
        hostname = str(req.get("hostname") or "").strip().lower().rstrip(".")

        def act():
            zp = ZonePolicy.from_rules(self.effective_rules())
            zone = zp.match(hostname)
            if zone is None:
                return {"hostname": hostname, "allowed": False,
                        "verdict": "NXDOMAIN (no matching zone)"}
            routes = [
                {"port": k.port, "proto": k.proto, "action": Action(v.action).name,
                 "redirect_port": v.redirect_port}
                for k, v in sorted(self.maps.routes().items(),
                                   key=lambda kv: (kv[0].port, kv[0].proto))
                if k.zone_hash == zone.hash
            ]
            return {"hostname": hostname, "allowed": True, "zone": zone.apex,
                    "wildcard": zone.wildcard, "internal": zone.internal,
                    "routes": routes}
        return self.queue.run(act)

    def remove(self, req: dict) -> dict:
        """Full teardown: detach every cgroup, flush maps, stop the stack."""
        def act():
            for container, enr in list(self.enrollments.items()):
                self._cancel_bypass(container)
                try:
                    self.attacher.detach(enr.cgroup_path)
                except EnrollError as e:
                    log.warning("remove: detach %s: %s", container, e)
            self.enrollments.clear()
            self._persist_enrollments()
            self.maps.flush_all()
            self.stack.stop()
            self.initialized = False
            return {"removed": True}
        return self.queue.run(act)

    # --------------------------------------------------------------- drain

    def close(self) -> None:
        """Drain ordering: queue first (no new mutations), then timers.

        NOTE: an in-process KernelAttacher is deliberately NOT closed
        here -- closing would detach the programs and drop enforcement,
        and close() runs on crash-path drains too (fail-closed: pinned
        OR in-process maps keep enforcing).  teardown() is the explicit
        data-plane removal."""
        self.queue.close()
        for t in self._bypass_timers.values():
            t.cancel()
        self._bypass_timers.clear()

    def teardown(self) -> None:
        """Post-drain data-plane teardown -- drain-to-zero only (no agents
        left to protect).  On a crash-path drain this is NOT called: the
        pinned maps keep enforcing the last rule set (fail-closed)."""
        for enr in self.enrollments.values():
            try:
                self.attacher.detach(enr.cgroup_path)
            except EnrollError as e:
                log.warning("teardown: detach %s: %s", enr.container_id, e)
        self.enrollments.clear()
        self._persist_enrollments()
        self.maps.flush_all()
        self.stack.stop()
        self.initialized = False
