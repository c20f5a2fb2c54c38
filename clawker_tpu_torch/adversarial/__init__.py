"""Adversarial egress suite: exfiltration payload corpus + capture harness.

Parity reference: upstream clawker's test/adversarial (C2 "attacker
server" recording every contact to sqlite + 30 payload directories of
exfiltration techniques, described in that directory's notes).  This build's
corpus expresses each technique as a driver over the enforcement
surface (kernel-policy oracle + DNS gate + route table), records every
attempt in a capture DB, and the report asserts ZERO escapes -- the
same all-must-be-captured bar, runnable both off-box (policy level, in
CI) and on a TPU-VM worker against the live kernel.

The port's copy of ``clawker_tpu/adversarial/__init__.py``, whole, the
upstream project named in place of its checkout's path.
"""

from .harness import CaptureDB, EgressSurface, Outcome, run_corpus

__all__ = ["CaptureDB", "EgressSurface", "Outcome", "run_corpus"]
