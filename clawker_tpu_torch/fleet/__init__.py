"""Fleet wiring (copied from the reference package).

Ported so far: the worker-side egress log path (:mod:`.egress_tail`),
the pod topology that placement reads (:mod:`.inventory`) and the local
branch of the side channels (:mod:`.channels`).  Worker discovery, the
SSH transport and the dashboard's ``EgressFeed`` are not.
"""
