"""Control plane: only its start-time service hooks are ported
(:mod:`.bootstrap`); the control-plane daemon waits (ROADMAP §1)."""
