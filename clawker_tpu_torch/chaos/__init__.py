"""Chaos injection: the port has the named crash-seam registry only.

``seams`` is the port's copy of ``clawker_tpu/chaos/seams.py``; loopd
fires its two seams through it.  The fault plans, the invariant checker
and the soak runner wait for ROADMAP §1 item 8.
"""
