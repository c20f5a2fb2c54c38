"""Fleet wiring (copied from the reference package).

Ported so far: the dashboard's merged egress feed and the worker-side
egress log path (:mod:`.egress_tail`), the pod topology that placement
reads (:mod:`.inventory`) and the local branch of the side channels
(:mod:`.channels`).  Worker discovery and the SSH transport are not.
"""
