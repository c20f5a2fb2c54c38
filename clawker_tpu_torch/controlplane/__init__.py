"""Control plane: only its start-time service hooks (:mod:`.bootstrap`)
and its OTLP log lanes (:mod:`.otel`) are ported; the control-plane
daemon waits (ROADMAP §1)."""
