"""The port's Envoy bootstrap generator against the reference's.

Twins of tests/test_firewall_handler.py's four ``envoy`` cases and of
tests/test_rule_validation.py's cases that render or validate a
bootstrap (``test_sni_chains_never_collide``,
``test_validate_bundle_clean_for_real_rule_sets``,
``test_validate_bundle_catches_torn_configs``,
``test_mitm_vhosts_scoped_to_rule_zone``,
``test_validate_bundle_flags_duplicate_vhost_domains``,
``test_same_dst_multi_port_http_rules_render_unique_vhosts``; the
handler's ``_sync_data_plane`` case is in
``test_torch_firewall_handler.py``): the same rules go through both
packages' ``generate_envoy_config`` and the bundles -- the YAML byte for
byte, the TCP listener allocation, the MITM and gitguard domains -- and
``validate_bundle``'s findings are compared.  A cert dir under a
package's tmp dir reads ``<CERTS>``.  Then rule sets drawn from a seed
over every lane (https passthrough and MITM, http, tcp, ssh, udp,
wildcards, denies, path rules, gitguard hosts).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import yaml

import clawker_tpu.config.schema as ref_schema
import clawker_tpu.consts as ref_consts
import clawker_tpu.firewall.envoy as ref_envoy
import clawker_tpu.firewall.policy as ref_policy
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.firewall.envoy as port_envoy
import clawker_tpu_torch.firewall.policy as port_policy

PKGS = {
    "ref": SimpleNamespace(tag="ref", envoy=ref_envoy, schema=ref_schema,
                           consts=ref_consts, policy=ref_policy),
    "port": SimpleNamespace(tag="port", envoy=port_envoy,
                            schema=port_schema, consts=port_consts,
                            policy=port_policy),
}


def both(fn):
    """``fn(m)`` in the reference, then in the port: -> (want, got)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def bundle_doc(b, cert_dir: str = "") -> dict:
    """A bundle's fields, its YAML with ``cert_dir`` read ``<CERTS>``."""
    text = b.config_yaml.replace(cert_dir, "<CERTS>") if cert_dir else \
        b.config_yaml
    return {"yaml": text, "tcp_ports": dict(b.tcp_ports),
            "mitm": list(b.mitm_domains), "gitguard": list(b.gitguard_domains)}


def rules(m, *specs):
    return [m.schema.EgressRule(**spec) for spec in specs]


def render(tmp_path, specs):
    """The rules ``specs`` through both generators, each with its own
    cert dir: -> (want, got) bundle docs."""
    def run(m):
        cert_dir = str(tmp_path / m.tag / "certs")
        b = m.envoy.generate_envoy_config(rules(m, *specs),
                                          cert_dir=cert_dir)
        return bundle_doc(b, cert_dir)
    return both(run)


# ---------------------------------------- tests/test_firewall_handler.py


def test_envoy_config_deterministic_and_structured():
    specs = [dict(dst="*.example.com", proto="https"),
             dict(dst="api.inspect.me", proto="https", paths=["/v1/"]),
             dict(dst="github.com", proto="tcp", port=22),
             dict(dst="plain.site", proto="http")]

    def run(m):
        b1 = m.envoy.generate_envoy_config(rules(m, *specs))
        b2 = m.envoy.generate_envoy_config(rules(m, *reversed(specs)))
        return [bundle_doc(b1), bundle_doc(b2)]

    want, got = both(run)
    assert got == want
    b1, b2 = got
    assert b1 == b2                       # order-independent
    cfg = yaml.safe_load(b1["yaml"])
    listeners = {x["name"]: x for x in cfg["static_resources"]["listeners"]}
    tls = listeners["tls_egress"]
    assert tls["address"]["socket_address"]["port_value"] == \
        port_consts.ENVOY_TLS_PORT
    chains = tls["filter_chains"]
    mitm = [c for c in chains if "transport_socket" in c]
    passthrough = [c for c in chains if "transport_socket" not in c]
    assert len(mitm) == 1 and len(passthrough) == 1
    assert b1["mitm"] == ["api.inspect.me"]
    assert set(passthrough[0]["filter_chain_match"]["server_names"]) == {
        "*.example.com", "example.com"}
    base = port_consts.ENVOY_TCP_PORT_BASE
    assert b1["tcp_ports"] == {"github.com:tcp:22": base,
                               "plain.site:http:80": base + 1}
    assert f"tcp_{base}" in listeners and f"http_{base + 1}" in listeners


def test_envoy_wildcard_rules_use_dynamic_forward_proxy():
    specs = [dict(dst="*.example.com", proto="https"),
             dict(dst="*.mitm.dev", proto="https", paths=["/api/"]),
             dict(dst="*.plainhttp.io", proto="http"),
             dict(dst="exact.net", proto="https")]

    def run(m):
        b = m.envoy.generate_envoy_config(rules(m, *specs))
        return [bundle_doc(b), m.envoy.DFP_CLUSTER_PLAIN,
                m.envoy.DFP_CLUSTER_TLS]

    want, got = both(run)
    assert got == want
    doc, plain, tls_dfp = got
    cfg = yaml.safe_load(doc["yaml"])
    clusters = {c["name"]: c for c in cfg["static_resources"]["clusters"]}
    for name in (plain, tls_dfp):
        assert clusters[name]["cluster_type"]["name"] == \
            "envoy.clusters.dynamic_forward_proxy"
    pinned = {ep["endpoint"]["address"]["socket_address"]["address"]
              for c in clusters.values() if "load_assignment" in c
              for e in c["load_assignment"]["endpoints"]
              for ep in e["lb_endpoints"]}
    assert pinned.isdisjoint({"example.com", "mitm.dev", "plainhttp.io"})
    assert "exact.net" in pinned
    chains = {tuple(c["filter_chain_match"]["server_names"]): c
              for x in cfg["static_resources"]["listeners"]
              if x["name"] == "tls_egress" for c in x["filter_chains"]}
    pt = next(c for k, c in chains.items() if "*.example.com" in k)
    assert [f["name"] for f in pt["filters"]] == [
        "envoy.filters.network.sni_dynamic_forward_proxy",
        "envoy.filters.network.tcp_proxy"]
    assert [f["name"] for f in chains[("exact.net",)]["filters"]] == [
        "envoy.filters.network.tcp_proxy"]


def test_envoy_wildcard_tcp_gets_no_proxy_lane():
    def run(m):
        rs = rules(m, dict(dst="*.ssh.example", proto="tcp", port=22))
        b = m.envoy.generate_envoy_config(rs)
        table = m.policy.build_routes(
            rs, envoy_ip="172.28.0.2", tls_port=m.consts.ENVOY_TLS_PORT,
            tcp_ports=b.tcp_ports)
        return [bundle_doc(b), sorted((k.pack().hex(), v.pack().hex(),
                                       v.action.name)
                                      for k, v in table.items())]

    want, got = both(run)
    assert got == want
    assert got[0]["tcp_ports"] == {}
    assert [a for _, _, a in got[1]] == ["ALLOW"]


def test_envoy_shared_apex_mitm_and_passthrough_clusters_distinct():
    want, got = both(lambda m: bundle_doc(m.envoy.generate_envoy_config(
        rules(m, dict(dst="dual.example", proto="https", paths=["/v1/"]),
              dict(dst="dual.example", proto="https", port=8443)))))
    assert got == want
    clusters = yaml.safe_load(got["yaml"])["static_resources"]["clusters"]
    assert sum("transport_socket" in c for c in clusters) == 1
    assert sum("transport_socket" not in c for c in clusters) == 1


# ---------------------------------------- tests/test_rule_validation.py


def test_sni_chains_never_collide(tmp_path):
    want, got = render(tmp_path, [
        dict(dst="*.example.com", proto="https", port=443),
        dict(dst="example.com", proto="https", port=8443),
        dict(dst="*.dup.com", proto="https", port=443),
        dict(dst="*.dup.com", proto="https", port=8443)])
    assert got == want
    (tls,) = [x for x in yaml.safe_load(got["yaml"])["static_resources"]
              ["listeners"] if x["name"] == "tls_egress"]
    names = [n for c in tls["filter_chains"]
             for n in c["filter_chain_match"]["server_names"]]
    assert len(names) == len(set(names))


def test_validate_bundle_clean_for_real_rule_sets(tmp_path):
    def run(m):
        P = m.schema.PathRule
        rs = [m.schema.EgressRule(dst="*.example.com", proto="https"),
              m.schema.EgressRule(
                  dst="example.com", proto="https",
                  path_rules=[P(path="/v1", action="allow")],
                  path_default="deny"),
              m.schema.EgressRule(dst="plain.example.net", proto="http"),
              m.schema.EgressRule(dst="github.com", proto="ssh", port=22),
              m.schema.EgressRule(dst="www.example.com", action="deny")]
        cert_dir = str(tmp_path / m.tag)
        b = m.envoy.generate_envoy_config(rs, cert_dir=cert_dir)
        return [bundle_doc(b, cert_dir), m.envoy.validate_bundle(b)]

    want, got = both(run)
    assert got == want and got[1] == []


def test_validate_bundle_catches_torn_configs(tmp_path):
    def run(m):
        cert_dir = str(tmp_path / m.tag)
        b = m.envoy.generate_envoy_config(
            rules(m, dict(dst="example.com", proto="https")),
            cert_dir=cert_dir)
        cfg = yaml.safe_load(b.config_yaml)
        cfg["static_resources"]["clusters"] = []
        torn = m.envoy.EnvoyBundle(config_yaml=yaml.safe_dump(cfg),
                                   tcp_ports=b.tcp_ports)
        stray = m.envoy.EnvoyBundle(config_yaml=b.config_yaml,
                                    tcp_ports={"x.com:tcp:9000": 10099})
        garbage = m.envoy.EnvoyBundle(config_yaml=":\n  - [")
        return [m.envoy.validate_bundle(x) for x in (torn, stray, garbage)]

    want, got = both(run)
    assert got == want
    assert any("unknown cluster" in e for e in got[0])
    assert any("no listener" in e for e in got[1])
    assert got[2]


def test_mitm_vhosts_scoped_to_rule_zone(tmp_path):
    def run(m):
        P = m.schema.PathRule
        rs = [m.schema.EgressRule(
                  dst="*.mitm.example.net", proto="https",
                  path_rules=[P(path="/", action="allow")],
                  path_default="allow"),
              m.schema.EgressRule(
                  dst="exact.example.org", proto="https",
                  path_rules=[P(path="/v1", action="allow")],
                  path_default="deny")]
        cert_dir = str(tmp_path / m.tag)
        return bundle_doc(m.envoy.generate_envoy_config(rs,
                                                        cert_dir=cert_dir),
                          cert_dir)

    want, got = both(run)
    assert got == want
    (tls,) = [x for x in yaml.safe_load(got["yaml"])["static_resources"]
              ["listeners"] if x["name"] == "tls_egress"]
    vhosts = [vh for c in tls["filter_chains"] for f in c["filters"]
              if "http_connection_manager" in f["name"]
              for vh in f["typed_config"]["route_config"]["virtual_hosts"]]
    assert vhosts
    for vh in vhosts:
        assert "*" not in vh["domains"]
        assert all(d.endswith((".example.net", ".example.net:*",
                               "example.org", "example.org:*"))
                   for d in vh["domains"])


def _http_domains(doc: dict) -> tuple[dict, list[str]]:
    cfg = yaml.safe_load(doc["yaml"])
    (http,) = [x for x in cfg["static_resources"]["listeners"]
               if x["name"].startswith("http_")]
    hcm = http["filter_chains"][0]["filters"][0]["typed_config"]
    return cfg, [d for vh in hcm["route_config"]["virtual_hosts"]
                 for d in vh["domains"]]


def test_validate_bundle_flags_duplicate_vhost_domains(tmp_path):
    def run(m):
        cert_dir = str(tmp_path / m.tag)
        b = m.envoy.generate_envoy_config(
            rules(m, dict(dst="*.example.com", proto="http", port=80),
                  dict(dst="example.com", proto="http", port=80)),
            cert_dir=cert_dir)
        cfg = yaml.safe_load(b.config_yaml)
        (http,) = [x for x in cfg["static_resources"]["listeners"]
                   if x["name"].startswith("http_")]
        hcm = http["filter_chains"][0]["filters"][0]["typed_config"]
        hcm["route_config"]["virtual_hosts"][0]["domains"].append(
            "example.com")
        broken = m.envoy.EnvoyBundle(config_yaml=yaml.safe_dump(cfg),
                                     tcp_ports=b.tcp_ports)
        return [bundle_doc(b, cert_dir), m.envoy.validate_bundle(b),
                m.envoy.validate_bundle(broken)]

    want, got = both(run)
    assert got == want
    doc, clean, broken = got
    _, domains = _http_domains(doc)
    assert clean == [] and len(domains) == len(set(domains))
    assert any("duplicate vhost domain" in e for e in broken)


def test_same_dst_multi_port_http_rules_render_unique_vhosts(tmp_path):
    def run(m):
        cert_dir = str(tmp_path / m.tag)
        b = m.envoy.generate_envoy_config(rules(
            m, dict(dst="example.com", proto="http", port=80),
            dict(dst="example.com", proto="http", port=8080),
            dict(dst="*.wild.example.net", proto="http", port=80),
            dict(dst="*.wild.example.net", proto="http", port=3000)),
            cert_dir=cert_dir)
        return [bundle_doc(b, cert_dir), m.envoy.validate_bundle(b)]

    want, got = both(run)
    assert got == want and got[1] == []
    _, domains = _http_domains(got[0])
    assert len(domains) == len(set(domains))
    assert "example.com" in domains and "example.com:8080" in domains


# ------------------------------------------------ seeded rule sets


APEXES = ["example.com", "pypi.org", "github.com", "api.example.org",
          "mitm.dev", "plain.site", "registry.npmjs.org", "crates.io"]
PATHS = ["/", "/v1", "/v1/messages", "/repos/", "/simple/", "/api/"]


def draw_rules(seed: int) -> list[dict]:
    """3-10 rules over every lane, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(3, 11))):
        apex = APEXES[int(rng.integers(len(APEXES)))]
        dst = f"*.{apex}" if rng.random() < 0.4 else apex
        lane = int(rng.integers(6))
        spec: dict = {"dst": dst}
        if lane == 0:                       # https passthrough
            spec.update(proto="https", port=int(rng.choice([0, 443, 8443])))
        elif lane == 1:                     # https with path rules (MITM)
            k = int(rng.integers(1, 3))
            spec.update(proto="https", path_rules=[
                {"path": PATHS[int(i)],
                 "action": "allow" if rng.random() < 0.7 else "deny"}
                for i in rng.choice(len(PATHS), k, replace=False)],
                path_default="deny" if rng.random() < 0.5 else "allow")
        elif lane == 2:                     # plain http
            spec.update(proto="http", port=int(rng.choice([0, 80, 8080])))
        elif lane == 3:                     # opaque tcp / ssh
            spec.update(proto=str(rng.choice(["tcp", "ssh"])),
                        port=int(rng.choice([22, 2222, 9000])))
        elif lane == 4:                     # udp
            spec.update(proto="udp", port=int(rng.choice([53, 123])))
        else:                               # a domain-level deny
            spec.update(action="deny")
        out.append(spec)
    return out


@pytest.mark.parametrize("seed", range(24))
def test_seeded_rule_sets_render_the_same_bundles(tmp_path, seed):
    specs = draw_rules(seed)
    gitguard = ("github.com",) if seed % 3 == 0 else ()

    def run(m):
        cert_dir = str(tmp_path / m.tag / "certs")
        rs = []
        for spec in specs:
            spec = dict(spec)
            if "path_rules" in spec:
                spec["path_rules"] = [m.schema.PathRule(**p)
                                      for p in spec["path_rules"]]
            rs.append(m.schema.EgressRule(**spec))
        b = m.envoy.generate_envoy_config(
            rs, cert_dir=cert_dir, gitguard_hosts=gitguard,
            gitguard_socket="/run/clawker/gitguard.sock" if gitguard else "")
        return [bundle_doc(b, cert_dir), m.envoy.validate_bundle(b)]

    want, got = both(run)
    assert got == want
    assert got[1] == [], (specs, got[1])
