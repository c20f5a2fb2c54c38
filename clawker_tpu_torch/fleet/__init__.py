"""Fleet wiring shared with the sentinel (copied from the reference package).

Only the worker-side egress log path is ported so far; worker
discovery, the SSH transport and the dashboard's ``EgressFeed`` are not.
"""
