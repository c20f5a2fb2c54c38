"""agentd: the in-container daemon's wire pieces.

The port has only ``protocol`` so far: the length-prefixed JSON framing
that the loopd socket speaks.  The session daemon, the supervisor client
and the native supervisor wait with the enforcement layer (ROADMAP §1
item 13).
"""
