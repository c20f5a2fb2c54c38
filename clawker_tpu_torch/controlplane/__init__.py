"""Control plane: only its start-time service hooks (:mod:`.bootstrap`),
its OTLP log lanes (:mod:`.otel`), the create path's identity and agent
registry, and the host half of the agentd session
(:mod:`.session_client`) are ported; the control-plane daemon waits
(ROADMAP §1)."""
