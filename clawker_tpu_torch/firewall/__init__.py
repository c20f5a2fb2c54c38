"""Firewall subsystem (reference: controlplane/firewall, SURVEY.md 2.8).

The port carries the egress rule store (:mod:`.rules`), which a
worktree swarm's gitguard writes its run-scoped rules into, and the PKI
(:mod:`.pki`) that mints the OTLP lanes' client certs.  The lanes that
would enforce the rules (Envoy, the DNS gate, the policy and the stack)
are not ported yet (ROADMAP §1 item 13).
"""
