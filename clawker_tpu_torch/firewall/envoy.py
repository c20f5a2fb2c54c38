"""Deterministic Envoy bootstrap generation for the egress proxy.

The port's copy of ``clawker_tpu/firewall/envoy.py``, whole.

The kernel rewrites allowed flows to Envoy listeners; this module turns
the egress rule set into the matching proxy config:

- TLS listener (:10000): TLS-inspector sniffs SNI.  Domains with path
  rules get a MITM filter chain (terminate TLS with the per-domain cert
  our CA signed, HTTP connection manager allowing only the ruled path
  prefixes, re-encrypt upstream); plain domain allowances get an SNI
  passthrough tcp_proxy chain.  No chain matches -> connection refused
  (default deny).
- HTTP rules share the sequential listener pool: a plain-HTTP listener
  with Host-header routing per domain (the reference detects HTTP on
  a dedicated lane too -- e2e firewall_test.go:709).
- tcp rules get one sequential tcp_proxy listener each (:10001+); the
  allocation is returned so policy.build_routes programs the kernel
  with the same ports.

Everything is emitted in sorted order so the same rule set always
yields byte-identical YAML -- config drift is detected by hash.

Parity reference: controlplane/firewall/envoy_config.go
GenerateEnvoyConfig (+ envoy_{tls,tcp,http,upstream}.go): TLS listener
:10000 w/ TLS Inspector, MITM chains for path rules, SNI passthrough,
sequential TCP listeners, gRPC ALS.  Re-designed: listener allocation is
returned as data for the kernel route sync, and access logs go to stdout
JSON (scraped by the monitor pipeline) instead of a gRPC ALS service.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import yaml

from .. import consts
from ..config.schema import EgressRule


@dataclass
class EnvoyBundle:
    """Rendered proxy config + the listener allocation the kernel needs."""

    config_yaml: str
    tcp_ports: dict[str, int] = field(default_factory=dict)  # rule.key() -> port
    mitm_domains: list[str] = field(default_factory=list)    # need CA-signed certs
    gitguard_domains: list[str] = field(default_factory=list)
    #                               MITM'd hosts routed via the gitguard
    #                               pipe cluster (docs/git-policy.md)


def _cluster_name(domain: str, port: int, *, tls: bool) -> str:
    # tls mode is part of the key: an exact MITM rule (re-encrypt upstream)
    # and a passthrough rule sharing an apex must not collide on one cluster.
    mode = "tls" if tls else "plain"
    return f"up_{domain.replace('.', '_').replace('*', 'w')}_{port}_{mode}"


def _cluster(domain: str, port: int, *, tls: bool) -> dict:
    """Exact-host upstream: LOGICAL_DNS pinned to the rule's host."""
    name = _cluster_name(domain, port, tls=tls)
    c = {
        "name": name,
        "type": "LOGICAL_DNS",
        "dns_lookup_family": "V4_ONLY",
        "connect_timeout": "10s",
        "load_assignment": {
            "cluster_name": name,
            "endpoints": [{
                "lb_endpoints": [{
                    "endpoint": {
                        "address": {
                            "socket_address": {"address": domain, "port_value": port}
                        }
                    }
                }]
            }],
        },
    }
    if tls:
        c["transport_socket"] = {
            "name": "envoy.transport_sockets.tls",
            "typed_config": {
                "@type": "type.googleapis.com/envoy.extensions.transport_sockets.tls.v3.UpstreamTlsContext",
                "sni": domain,
            },
        }
    return c


# Dynamic-forward-proxy upstreams for wildcard rules: the destination host is
# whatever subdomain the client named (SNI for passthrough, Host/:authority
# for MITM/HTTP), so it cannot be pinned at config time.  Parity:
# envoy_config.go:269-297 (httpsWildcardUpstreamLayer / httpWildcardUpstream
# use DFP; exact rules keep pinned clusters).
# The gitguard lane (docs/git-policy.md): MITM chains for git hosts
# route allowed paths to the run's gitguard proxy over its hardened
# unix socket instead of the real upstream.  The vhost strips any
# client-supplied identity header and pins the mTLS-verified peer
# subject -- the guard trusts the header precisely because only Envoy
# can reach the 0600 socket.
GITGUARD_CLUSTER = "gitguard"
GITGUARD_IDENTITY_HEADER = "X-Clawker-Identity"


def _gitguard_cluster(socket_path: str) -> dict:
    return {
        "name": GITGUARD_CLUSTER,
        "type": "STATIC",
        "connect_timeout": "5s",
        "load_assignment": {
            "cluster_name": GITGUARD_CLUSTER,
            "endpoints": [{
                "lb_endpoints": [{
                    "endpoint": {
                        "address": {"pipe": {"path": socket_path}}
                    }
                }]
            }],
        },
    }


def _pin_gitguard_identity(chain: dict) -> dict:
    """Strip client identity headers and stamp the verified peer subject
    on every vhost of a gitguard-routed MITM chain."""
    for f in chain.get("filters", []):
        rc = (f.get("typed_config") or {}).get("route_config")
        for vh in (rc or {}).get("virtual_hosts", []):
            vh["request_headers_to_remove"] = [GITGUARD_IDENTITY_HEADER]
            vh["request_headers_to_add"] = [{
                "header": {
                    "key": GITGUARD_IDENTITY_HEADER,
                    "value": "%DOWNSTREAM_PEER_SUBJECT%",
                },
                "append": False,
            }]
    return chain


DFP_CACHE_PLAIN = "dfp_cache_plain"
DFP_CACHE_TLS = "dfp_cache_tls"
DFP_CLUSTER_PLAIN = "dfp_plain"
DFP_CLUSTER_TLS = "dfp_tls"


def _dfp_cache(name: str) -> dict:
    return {"name": name, "dns_lookup_family": "V4_ONLY"}


def _dfp_cluster(name: str, cache: str, *, tls: bool) -> dict:
    c = {
        "name": name,
        "lb_policy": "CLUSTER_PROVIDED",
        "connect_timeout": "10s",
        "cluster_type": {
            "name": "envoy.clusters.dynamic_forward_proxy",
            "typed_config": {
                "@type": "type.googleapis.com/envoy.extensions.clusters.dynamic_forward_proxy.v3.ClusterConfig",
                "dns_cache_config": _dfp_cache(cache),
            },
        },
    }
    if tls:
        # auto_sni/auto_san_validation: SNI + cert check follow the request
        # authority, since there is no single configurable hostname.
        c["typed_extension_protocol_options"] = {
            "envoy.extensions.upstreams.http.v3.HttpProtocolOptions": {
                "@type": "type.googleapis.com/envoy.extensions.upstreams.http.v3.HttpProtocolOptions",
                "upstream_http_protocol_options": {
                    "auto_sni": True,
                    "auto_san_validation": True,
                },
                "explicit_http_config": {"http_protocol_options": {}},
            }
        }
        c["transport_socket"] = {
            "name": "envoy.transport_sockets.tls",
            "typed_config": {
                "@type": "type.googleapis.com/envoy.extensions.transport_sockets.tls.v3.UpstreamTlsContext"
            },
        }
    return c


def _dfp_http_filter(cache: str) -> dict:
    return {
        "name": "envoy.filters.http.dynamic_forward_proxy",
        "typed_config": {
            "@type": "type.googleapis.com/envoy.extensions.filters.http.dynamic_forward_proxy.v3.FilterConfig",
            "dns_cache_config": _dfp_cache(cache),
        },
    }


def _access_log() -> list[dict]:
    """JSON access log on stdout; the monitor pipeline ships container
    stdout to the clawker-envoy index."""
    return [{
        "name": "envoy.access_loggers.stdout",
        "typed_config": {
            "@type": "type.googleapis.com/envoy.extensions.access_loggers.stream.v3.StdoutAccessLog",
            "log_format": {
                "json_format": {
                    "ts": "%START_TIME%",
                    "sni": "%REQUESTED_SERVER_NAME%",
                    "authority": "%REQ(:AUTHORITY)%",
                    "path": "%REQ(:PATH)%",
                    "method": "%REQ(:METHOD)%",
                    "code": "%RESPONSE_CODE%",
                    "flags": "%RESPONSE_FLAGS%",
                    "bytes_tx": "%BYTES_SENT%",
                    "upstream": "%UPSTREAM_HOST%",
                }
            },
        },
    }]


def _sni_names(domain: str) -> list[str]:
    """filter_chain_match server_names for a rule dst."""
    if domain.startswith("*."):
        return [domain, domain[2:]]  # wildcard matches apex too (zone semantics)
    return [domain]


# Centralized non-fingerprinting deny body: the verdict travels via the
# access-log metadata, never the body, and the body must not disclose the
# enforcement product (reference: envoy_config.go firewallBlockedBody;
# pinned by e2e firewall_test.go:930-933).
FIREWALL_BLOCKED_BODY = "403 Forbidden\n"


def _hcm_hardening() -> dict:
    """Edge-hardening fields every HTTP connection manager carries.

    normalize_path + merge_slashes + UNESCAPE_AND_REDIRECT close the
    URL-encoded-traversal path-smuggling vector (reference:
    envoy_http.go:411 httpConnectionManagerHardening; pinned by e2e
    firewall_test.go:1131 PathRuleNormalizationDefeatsSmuggling)."""
    return {
        "normalize_path": True,
        "merge_slashes": True,
        "path_with_escaped_slashes_action": "UNESCAPE_AND_REDIRECT",
        "common_http_protocol_options": {
            "headers_with_underscores_action": "REJECT_REQUEST",
        },
    }


def _action_metadata(action: str) -> dict:
    """Per-route metadata the access log reads so each record carries the
    concrete verdict (reference: envoy_http.go clawkerActionMetadata)."""
    return {"filter_metadata": {"fw": {"action": action}}}


def _deny_route(match: dict) -> dict:
    return {
        "match": match,
        "metadata": _action_metadata("denied"),
        "direct_response": {
            "status": 403,
            "body": {"inline_string": FIREWALL_BLOCKED_BODY},
        },
    }


def _route_match(pr) -> dict:
    match: dict = {"prefix": pr.path}
    if pr.methods:
        if len(pr.methods) == 1:
            sm = {"exact": pr.methods[0]}
        else:
            sm = {"safe_regex": {"regex": "|".join(pr.methods)}}
        match["headers"] = [{"name": ":method", "string_match": sm}]
    return match


def _path_routes(rule: EgressRule, cluster: str) -> list[dict]:
    """Ordered route list from path_rules + path_default (allow -> cluster,
    deny -> direct_response 403), ending in the catch-all default."""
    routes = []
    for pr in rule.effective_path_rules():
        if pr.action == "deny":
            routes.append(_deny_route(_route_match(pr)))
        else:
            routes.append({
                "match": _route_match(pr),
                "metadata": _action_metadata("allowed"),
                "route": {"cluster": cluster, "timeout": "0s"},
            })
    default = {"prefix": "/"}
    if rule.effective_path_default() == "deny":
        routes.append(_deny_route(default))
    else:
        routes.append({
            "match": default,
            "metadata": _action_metadata("allowed"),
            "route": {"cluster": cluster, "timeout": "0s"},
        })
    return routes


def _mitm_chain(rule: EgressRule, cert_dir: str,
                cluster_override: str = "") -> dict:
    wildcard = rule.dst.startswith("*.")
    apex = rule.dst[2:] if wildcard else rule.dst
    # Wildcard: upstream host is the request authority (any subdomain), so
    # route through the TLS dynamic-forward-proxy cluster; exact: pinned.
    # A cluster_override (the gitguard pipe cluster) wins over both:
    # allowed paths land on the guard's unix socket, not the real host.
    cluster = cluster_override or (
        DFP_CLUSTER_TLS
        if wildcard
        else _cluster_name(apex, rule.effective_port(), tls=True)
    )
    routes = _path_routes(rule, cluster)
    http_filters = []
    if wildcard and not cluster_override:
        http_filters.append(_dfp_http_filter(DFP_CACHE_TLS))
    http_filters.append({
        "name": "envoy.filters.http.router",
        "typed_config": {
            "@type": "type.googleapis.com/envoy.extensions.filters.http.router.v3.Router"
        },
    })
    return {
        "filter_chain_match": {"server_names": _sni_names(rule.dst)},
        "transport_socket": {
            "name": "envoy.transport_sockets.tls",
            "typed_config": {
                "@type": "type.googleapis.com/envoy.extensions.transport_sockets.tls.v3.DownstreamTlsContext",
                "common_tls_context": {
                    "tls_certificates": [{
                        "certificate_chain": {"filename": f"{cert_dir}/{apex}.crt"},
                        "private_key": {"filename": f"{cert_dir}/{apex}.key"},
                    }]
                },
            },
        },
        "filters": [{
            "name": "envoy.filters.network.http_connection_manager",
            "typed_config": {
                "@type": "type.googleapis.com/envoy.extensions.filters.network.http_connection_manager.v3.HttpConnectionManager",
                "stat_prefix": f"mitm_{apex.replace('.', '_')}",
                "access_log": _access_log(),
                "http_filters": http_filters,
                **_hcm_hardening(),
                "route_config": {
                    "name": f"paths_{apex.replace('.', '_')}",
                    "virtual_hosts": [{
                        "name": apex,
                        # scoped to the rule's zone, NEVER "*": on a
                        # wildcard chain the DFP cluster resolves the
                        # request :authority, so a catch-all vhost would
                        # let Host: attacker.example smuggle through an
                        # allowed-SNI handshake to arbitrary upstreams
                        # (found by the sni-host-mismatch red-team probe)
                        "domains": sorted(
                            [apex, f"{apex}:*"]
                            + ([f"*.{apex}", f"*.{apex}:*"]
                               if wildcard else [])),
                        "routes": routes,
                        # path_default decides the catch-all: 403 or forward
                    }],
                },
            },
        }],
    }


def _passthrough_chain(rule: EgressRule) -> dict:
    wildcard = rule.dst.startswith("*.")
    apex = rule.dst[2:] if wildcard else rule.dst
    filters = []
    if wildcard:
        # SNI-derived upstream: the client named some subdomain; forward the
        # bytes to that host, not the apex (sni_dynamic_forward_proxy sets
        # the upstream from the sniffed SNI).
        filters.append({
            "name": "envoy.filters.network.sni_dynamic_forward_proxy",
            "typed_config": {
                "@type": "type.googleapis.com/envoy.extensions.filters.network.sni_dynamic_forward_proxy.v3.FilterConfig",
                "port_value": rule.effective_port(),
                "dns_cache_config": _dfp_cache(DFP_CACHE_PLAIN),
            },
        })
        cluster = DFP_CLUSTER_PLAIN
    else:
        cluster = _cluster_name(apex, rule.effective_port(), tls=False)
    filters.append({
        "name": "envoy.filters.network.tcp_proxy",
        "typed_config": {
            "@type": "type.googleapis.com/envoy.extensions.filters.network.tcp_proxy.v3.TcpProxy",
            "stat_prefix": f"sni_{apex.replace('.', '_')}",
            "cluster": cluster,
            "access_log": _access_log(),
        },
    })
    return {
        "filter_chain_match": {"server_names": _sni_names(rule.dst)},
        "filters": filters,
    }


def _tcp_listener(rule: EgressRule, port: int) -> dict:
    apex = rule.dst[2:] if rule.dst.startswith("*.") else rule.dst
    return {
        "name": f"tcp_{port}",
        "address": {"socket_address": {"address": "0.0.0.0", "port_value": port}},
        "filter_chains": [{
            "filters": [{
                "name": "envoy.filters.network.tcp_proxy",
                "typed_config": {
                    "@type": "type.googleapis.com/envoy.extensions.filters.network.tcp_proxy.v3.TcpProxy",
                    "stat_prefix": f"tcp_{apex.replace('.', '_')}_{rule.effective_port()}",
                    "cluster": _cluster_name(apex, rule.effective_port(), tls=False),
                    "access_log": _access_log(),
                },
            }]
        }],
    }


def _http_listener(rules: list[EgressRule], port: int) -> dict:
    """One plain-HTTP listener; Host-header routing across all http rules.

    Wildcard rules route to the plaintext dynamic-forward-proxy cluster
    (upstream = whatever in-zone subdomain the Host header names); exact
    rules keep their pinned clusters.
    """
    vhosts = []
    any_wildcard = False
    # exact rules own the bare apex: a coexisting wildcard vhost also
    # claiming it is (a) an Envoy NACK ("only unique values for domains")
    # and (b) a path-policy bypass via Host routing
    exact_http = {r.dst for r in rules if not r.dst.startswith("*.")}
    # several rules for ONE dst at different ports share the listener;
    # every vhost domain must stay unique (Envoy NACK otherwise), so
    # multi-port groups get port-qualified domains -- Host carries the
    # original port ("example.com:8080") -- and only the lowest-port rule
    # claims the bare names
    by_dst: dict[str, int] = {}
    for r in rules:
        by_dst[r.dst] = by_dst.get(r.dst, 0) + 1
    primary_port: dict[str, int] = {}
    for r in sorted(rules, key=lambda r: r.effective_port()):
        primary_port.setdefault(r.dst, r.effective_port())
    for rule in rules:
        wildcard = rule.dst.startswith("*.")
        apex = rule.dst[2:] if wildcard else rule.dst
        rport = rule.effective_port()
        multi = by_dst[rule.dst] > 1
        primary = not multi or primary_port[rule.dst] == rport
        if multi:
            domains = [f"{apex}:{rport}"] + ([apex] if primary else [])
            wild_domains = [f"*.{apex}:{rport}"] + ([f"*.{apex}"] if primary else [])
        else:
            domains = [apex, f"{apex}:*"]
            wild_domains = [f"*.{apex}", f"*.{apex}:*"]
        if wildcard:
            any_wildcard = True
            domains = (wild_domains if apex in exact_http
                       else domains + wild_domains)
            cluster = DFP_CLUSTER_PLAIN
        else:
            cluster = _cluster_name(apex, rport, tls=False)
        vhosts.append({
            "name": f"http_{apex.replace('.', '_')}_{rport}",
            "domains": sorted(domains),
            "routes": _path_routes(rule, cluster),
        })
    http_filters = []
    if any_wildcard:
        http_filters.append(_dfp_http_filter(DFP_CACHE_PLAIN))
    http_filters.append({
        "name": "envoy.filters.http.router",
        "typed_config": {
            "@type": "type.googleapis.com/envoy.extensions.filters.http.router.v3.Router"
        },
    })
    return {
        "name": f"http_{port}",
        "address": {"socket_address": {"address": "0.0.0.0", "port_value": port}},
        "filter_chains": [{
            "filters": [{
                "name": "envoy.filters.network.http_connection_manager",
                "typed_config": {
                    "@type": "type.googleapis.com/envoy.extensions.filters.network.http_connection_manager.v3.HttpConnectionManager",
                    "stat_prefix": "http_egress",
                    "access_log": _access_log(),
                    "http_filters": http_filters,
                    **_hcm_hardening(),
                    "route_config": {
                        "name": "http_egress",
                        "virtual_hosts": vhosts,
                        # no catch-all vhost: unlisted Host -> 404, logged
                    },
                },
            }]
        }],
    }


def generate_envoy_config(
    rules: list[EgressRule],
    *,
    cert_dir: str = "/etc/clawker/certs",
    tls_port: int = consts.ENVOY_TLS_PORT,
    tcp_port_base: int = consts.ENVOY_TCP_PORT_BASE,
    admin_port: int = consts.ENVOY_HEALTH_PORT,
    gitguard_hosts: tuple[str, ...] = (),
    gitguard_socket: str = "",
) -> EnvoyBundle:
    """Rule set -> (bootstrap YAML, sequential-listener allocation).

    ``gitguard_hosts`` + ``gitguard_socket`` (both required together)
    reroute those hosts' MITM chains to the gitguard proxy's unix
    socket: the allowed smart-HTTP paths land on the guard, which
    filters advertisements and judges pushes before anything reaches
    the real upstream (docs/git-policy.md)."""
    ordered = sorted(
        {r.key(): r for r in rules}.values(), key=lambda r: r.key()
    )
    # Apexes that also carry an exact https rule: the exact chain owns the
    # bare-apex SNI, so a coexisting wildcard chain must not claim it
    # (firewall_test.go:1326 WildcardAndExactCoexist -- independent filter
    # chains, no SNI collision).  Keyed on dst only: SNI carries no port
    # signal, and duplicate server_names across chains are an Envoy NACK
    # (= full egress outage on the next reload), which outranks steering
    # the apex of an odd-port exact rule.
    exact_https = {r.dst for r in ordered
                   if r.proto == "https" and not r.dst.startswith("*.")
                   and r.action != "deny"}

    def cede_apex_to_exact(chain: dict, rule: EgressRule) -> dict:
        apex_ = rule.dst[2:] if rule.dst.startswith("*.") else rule.dst
        if rule.dst.startswith("*.") and apex_ in exact_https:
            chain["filter_chain_match"]["server_names"] = [
                n for n in chain["filter_chain_match"]["server_names"]
                if n != apex_]
            # the HCM vhost must cede the apex too: with only the SNI
            # ceded, Host: apex through a subdomain handshake would still
            # route via the wildcard rule's (laxer) path policy,
            # bypassing the exact rule's restrictions
            for f in chain.get("filters", []):
                rc = (f.get("typed_config") or {}).get("route_config")
                for vh in (rc or {}).get("virtual_hosts", []):
                    vh["domains"] = [
                        d for d in vh["domains"]
                        if d not in (apex_, f"{apex_}:*")]
        return chain
    tls_chains: list[dict] = []
    clusters: dict[str, dict] = {}
    tcp_listeners: list[dict] = []
    tcp_ports: dict[str, int] = {}
    http_rules: list[EgressRule] = []
    mitm_domains: list[str] = []
    gitguard_domains: list[str] = []
    next_port = tcp_port_base

    for rule in ordered:
        wildcard = rule.dst.startswith("*.")
        apex = rule.dst[2:] if wildcard else rule.dst
        if not apex:
            continue
        if rule.action == "deny":
            # Domain-level deny never gets a proxy lane: the DNS gate
            # NXDOMAINs the zone and the kernel route table carries DENY
            # (firewall_test.go:653 DenySubdomainUnderWildcard).
            continue
        port = rule.effective_port()
        guarded = bool(gitguard_socket) and apex in set(gitguard_hosts)
        if rule.proto == "https":
            if rule.needs_inspection():
                if guarded:
                    tls_chains.append(cede_apex_to_exact(
                        _pin_gitguard_identity(_mitm_chain(
                            rule, cert_dir,
                            cluster_override=GITGUARD_CLUSTER)), rule))
                    gitguard_domains.append(apex)
                    clusters.setdefault(GITGUARD_CLUSTER,
                                        _gitguard_cluster(gitguard_socket))
                else:
                    tls_chains.append(cede_apex_to_exact(
                        _mitm_chain(rule, cert_dir), rule))
                mitm_domains.append(apex)
                if wildcard and not guarded:
                    clusters.setdefault(
                        DFP_CLUSTER_TLS,
                        _dfp_cluster(DFP_CLUSTER_TLS, DFP_CACHE_TLS, tls=True))
                elif not guarded:
                    clusters.setdefault(_cluster_name(apex, port, tls=True),
                                        _cluster(apex, port, tls=True))
            else:
                tls_chains.append(cede_apex_to_exact(
                    _passthrough_chain(rule), rule))
                if wildcard:
                    clusters.setdefault(
                        DFP_CLUSTER_PLAIN,
                        _dfp_cluster(DFP_CLUSTER_PLAIN, DFP_CACHE_PLAIN, tls=False))
                else:
                    clusters.setdefault(_cluster_name(apex, port, tls=False),
                                        _cluster(apex, port, tls=False))
        elif rule.proto == "http":
            http_rules.append(rule)
            if wildcard:
                clusters.setdefault(
                    DFP_CLUSTER_PLAIN,
                    _dfp_cluster(DFP_CLUSTER_PLAIN, DFP_CACHE_PLAIN, tls=False))
            else:
                clusters.setdefault(_cluster_name(apex, port, tls=False),
                                    _cluster(apex, port, tls=False))
        elif rule.proto != "udp":
            # Opaque TCP-mapped protocols (tcp, ssh, git, ...): a named
            # proto is a labelled TCP lane, same as the reference's ssh
            # rule riding the sequential listener (firewall_test.go:503).
            if wildcard:
                # Opaque TCP carries no L7 signal (no SNI/Host) to derive the
                # in-zone subdomain from, so no proxy lane is allocated: the
                # kernel direct-allows the flow, still DNS-gated by the
                # dns_cache zone match (same model as udp allows).
                continue
            tcp_listeners.append(_tcp_listener(rule, next_port))
            tcp_ports[rule.key()] = next_port
            clusters.setdefault(_cluster_name(apex, port, tls=False),
                                _cluster(apex, port, tls=False))
            next_port += 1
        # udp rules never reach Envoy (kernel allows them directly)

    # Residual SNI collisions (e.g. two https rules for the same dst at
    # different ports): a server_name may appear in exactly ONE chain or
    # Envoy NACKs the bootstrap -- a full egress outage on the next rule
    # sync.  First chain in sorted rule-key order keeps the name; a chain
    # left with no names is dropped.
    seen_names: set[str] = set()
    deduped: list[dict] = []
    for chain in tls_chains:
        names = [n for n in chain["filter_chain_match"]["server_names"]
                 if n not in seen_names]
        if not names:
            continue
        seen_names.update(names)
        chain["filter_chain_match"]["server_names"] = names
        deduped.append(chain)
    tls_chains = deduped

    listeners = [{
        "name": "tls_egress",
        "address": {"socket_address": {"address": "0.0.0.0", "port_value": tls_port}},
        "listener_filters": [{
            "name": "envoy.filters.listener.tls_inspector",
            "typed_config": {
                "@type": "type.googleapis.com/envoy.extensions.filters.listener.tls_inspector.v3.TlsInspector"
            },
        }],
        "filter_chains": tls_chains,
        # no default chain: unmatched SNI is refused (default deny)
    }]
    if http_rules:
        http_port = next_port
        listeners.append(_http_listener(http_rules, http_port))
        for rule in http_rules:
            tcp_ports[rule.key()] = http_port
        next_port += 1
    listeners.extend(tcp_listeners)

    bootstrap = {
        "admin": {
            "address": {
                "socket_address": {"address": "0.0.0.0", "port_value": admin_port}
            }
        },
        "static_resources": {
            "listeners": listeners,
            "clusters": [clusters[k] for k in sorted(clusters)],
        },
    }
    return EnvoyBundle(
        config_yaml=yaml.safe_dump(bootstrap, sort_keys=True),
        tcp_ports=tcp_ports,
        mitm_domains=sorted(set(mitm_domains)),
        gitguard_domains=sorted(set(gitguard_domains)),
    )


# ----------------------------------------------------------------- validate

def validate_bundle(bundle: EnvoyBundle) -> list[str]:
    """Structural validation of a generated bootstrap; [] when clean.

    The real Envoy NACKs an invalid bootstrap -- which, on a reload,
    means a full egress outage.  This is the pre-swap gate (reference
    envoy_validate.go): a rule mutation producing an invalid config must
    fail the RPC and leave the old data plane running.
    """
    errs: list[str] = []
    try:
        cfg = yaml.safe_load(bundle.config_yaml)
    except yaml.YAMLError as e:
        return [f"bootstrap does not parse: {e}"]
    res = (cfg or {}).get("static_resources") or {}
    clusters = {c.get("name") for c in res.get("clusters") or []}
    listeners = res.get("listeners") or []

    ports: set[int] = set()
    seen_sni: set[str] = set()
    for listener in listeners:
        port = (listener.get("address", {}).get("socket_address", {})
                .get("port_value"))
        if port in ports:
            errs.append(f"duplicate listener port {port}")
        ports.add(port)
        for chain in listener.get("filter_chains") or []:
            for name in (chain.get("filter_chain_match", {})
                         .get("server_names") or []):
                if name in seen_sni:
                    errs.append(f"duplicate SNI {name!r} across chains "
                                "(Envoy NACK)")
                seen_sni.add(name)
            for f in chain.get("filters") or []:
                tc = f.get("typed_config") or {}
                cluster = tc.get("cluster")
                if cluster and cluster not in clusters:
                    errs.append(
                        f"filter references unknown cluster {cluster!r}")
                rc = tc.get("route_config") or {}
                seen_domains: set[str] = set()
                for vh in rc.get("virtual_hosts") or []:
                    if not vh.get("domains"):
                        errs.append(f"virtual host {vh.get('name')!r} "
                                    "matches no domains")
                    for d in vh.get("domains") or []:
                        if d in seen_domains:
                            errs.append(
                                f"duplicate vhost domain {d!r} in "
                                f"{rc.get('name')!r} (Envoy NACK: only "
                                "unique domain values are permitted)")
                        seen_domains.add(d)
                    for route in vh.get("routes") or []:
                        dst = (route.get("route") or {}).get("cluster")
                        if dst and dst not in clusters:
                            errs.append(
                                f"route references unknown cluster {dst!r}")
                        if "route" not in route and \
                                "direct_response" not in route:
                            errs.append("route with neither cluster nor "
                                        "direct_response")
    # every kernel-advertised TCP lane must have a listener behind it
    for key, port in bundle.tcp_ports.items():
        if port not in ports:
            errs.append(f"rule {key}: kernel lane port {port} has no "
                        "listener (kernel would redirect into a refused "
                        "connect)")
    return errs
