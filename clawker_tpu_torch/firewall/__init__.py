"""Firewall subsystem (reference: controlplane/firewall, SURVEY.md 2.8).

The port carries the egress rule store (:mod:`.rules`), which a
worktree swarm's gitguard writes its run-scoped rules into, the PKI
(:mod:`.pki`) that mints the OTLP lanes' client certs, and the egress
lane's user-space model: the zone hash (:mod:`.hashes`), the map ABI
(:mod:`.model`), the map store with its in-memory twin (:mod:`.maps`),
the decision semantics (:mod:`.policy`) and the DNS gate that feeds the
``dns_cache`` map (:mod:`.dnsgate`).  The lanes that would enforce the
rules on a host (Envoy, the handler, the stack, the eBPF loader) are not
ported yet (ROADMAP §1 item 13).
"""
