"""Firewall subsystem (reference: controlplane/firewall, SURVEY.md 2.8).

The port carries the egress rule store (:mod:`.rules`), which a
worktree swarm's gitguard writes its run-scoped rules into, the PKI
(:mod:`.pki`) that mints the OTLP lanes' client certs, and the egress
lane's user-space model: the zone hash (:mod:`.hashes`), the map ABI
(:mod:`.model`), the map store with its in-memory twin (:mod:`.maps`),
the decision semantics (:mod:`.policy`) and the DNS gate that feeds the
``dns_cache`` map (:mod:`.dnsgate`); the enforcement lanes: Envoy
(:mod:`.envoy`), the stack (:mod:`.stack`), enrollment (:mod:`.enroll`),
the handler behind the AdminService's 13 verbs (:mod:`.handler`,
:mod:`.runtime`, :mod:`.lifecycle`) and the eBPF programs with their
loader (:mod:`.bpfasm`, :mod:`.fwprogs`, :mod:`.bpfsys`,
:mod:`.bpfkern`, :mod:`.bpflive`).
"""
