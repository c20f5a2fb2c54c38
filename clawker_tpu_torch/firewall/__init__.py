"""Firewall subsystem (reference: controlplane/firewall, SURVEY.md 2.8).

The port carries the egress rule store alone (:mod:`.rules`), which a
worktree swarm's gitguard writes its run-scoped rules into.  The lanes
that would enforce them (Envoy, the DNS gate, the policy and the stack)
are not ported yet (ROADMAP §1 item 13).
"""
