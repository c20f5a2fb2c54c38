"""Worker discovery + pod topology: which hosts make up the TPU pod,
and how they sit on the ICI mesh.

The port's copy of ``clawker_tpu/fleet/inventory.py``, whole: host
discovery (:func:`discover_workers`, for the ``tpu_vm`` driver and the
``fleet`` verbs) and the topology half (:class:`WorkerTopology`,
:func:`pod_topology`, :func:`federation_topology`).

Resolution order for hosts (first hit wins):

1. ``runtime.tpu.workers`` in settings -- explicit host list, the
   escape hatch that also serves CI and non-GCP fleets.
2. The GCE metadata server (only answers ON a TPU-VM): the
   ``worker-network-endpoints`` instance attribute lists every worker
   of the pod this VM belongs to.
3. ``gcloud compute tpus tpu-vm describe`` on the operator machine.

Topology (:func:`pod_topology`) feeds the loop scheduler's ``topology``
placement policy (docs/loop-placement.md): workers are modeled on a 2-D
grid in pod order -- ``runtime.tpu.topology`` ("RxC") when set, else a
near-square grid inferred from the worker count.  Workers sharing a
grid row form one ICI group (co-located on the fast interconnect);
cross-row hops are costed a full row width.  Unknown shapes degrade to
``known=False`` and topology-aware placement falls back to spread.

Parity note: the reference has no analogue (single local daemon); this
is the net-new inventory half of the BASELINE.json north star.
"""

from __future__ import annotations

import json
import subprocess
from dataclasses import dataclass, field
from urllib import error as urlerror
from urllib import request as urlrequest

from .. import consts, logsetup
from ..config.schema import TPUSettings
from ..errors import DriverError

log = logsetup.get("fleet.inventory")

METADATA_URL = (
    f"http://{consts.TPU_METADATA_HOST}/computeMetadata/v1/instance/attributes/"
    "worker-network-endpoints"
)


def parse_worker_endpoints(raw: str) -> list[str]:
    """The metadata attribute is comma-separated ``ip:port:index`` triples
    (historically) or plain IPs; accept both."""
    hosts = []
    for part in raw.strip().split(","):
        part = part.strip()
        if not part:
            continue
        hosts.append(part.split(":")[0])
    return hosts


def parse_describe_json(raw: str) -> list[str]:
    """gcloud describe --format=json -> worker IPs, pod order preserved."""
    data = json.loads(raw)
    out = []
    for ep in data.get("networkEndpoints") or []:
        ip = (ep.get("accessConfig") or {}).get("externalIp") or ep.get("ipAddress")
        if ip:
            out.append(ip)
    return out


def _from_metadata(timeout: float = 2.0) -> list[str]:
    req = urlrequest.Request(METADATA_URL, headers={"Metadata-Flavor": "Google"})
    try:
        with urlrequest.urlopen(req, timeout=timeout) as r:
            return parse_worker_endpoints(r.read().decode())
    except (urlerror.URLError, OSError):
        return []


def _from_gcloud(tpu: TPUSettings, timeout: float = 30.0) -> list[str]:
    if not tpu.pod:
        return []
    cmd = ["gcloud", "compute", "tpus", "tpu-vm", "describe", tpu.pod,
           "--format", "json"]
    if tpu.zone:
        cmd += ["--zone", tpu.zone]
    if tpu.project:
        cmd += ["--project", tpu.project]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise DriverError(f"gcloud describe failed: {e}") from None
    if res.returncode != 0:
        raise DriverError(f"gcloud describe {tpu.pod}: {res.stderr.strip()}")
    return parse_describe_json(res.stdout)


# ---------------------------------------------------------------- topology


@dataclass(frozen=True)
class WorkerTopology:
    """Pod workers on a 2-D grid, row-major in pod worker order.

    ``coords[i]`` is worker i's (row, col); workers on one row share an
    ICI group.  ``known=False`` means no usable shape could be derived
    -- consumers must degrade (the topology placement policy falls back
    to spread), never fail.
    """

    known: bool = False
    rows: int = 0
    cols: int = 0
    coords: dict[int, tuple[int, int]] = field(default_factory=dict)

    def group_of(self, index: int) -> int:
        """ICI group id (grid row) for a worker index; workers beyond
        the known grid get their own singleton groups."""
        c = self.coords.get(index)
        return c[0] if c is not None else self.rows + index

    def distance(self, a: int, b: int) -> int:
        """ICI hop cost between two workers: intra-row hops are cheap,
        a row change costs a full row width (the group boundary)."""
        ca, cb = self.coords.get(a), self.coords.get(b)
        if ca is None or cb is None:
            return 1 << 16
        return abs(ca[0] - cb[0]) * max(1, self.cols) + abs(ca[1] - cb[1])


def _parse_shape(raw: str) -> tuple[int, int] | None:
    """"RxC" -> (rows, cols); None on anything unparseable."""
    parts = raw.lower().replace("*", "x").split("x")
    if len(parts) != 2:
        return None
    try:
        r, c = int(parts[0]), int(parts[1])
    except ValueError:
        return None
    return (r, c) if r > 0 and c > 0 else None


def _near_square(n: int) -> tuple[int, int]:
    """Largest factor pair (rows <= cols) -- 8 -> 2x4, 16 -> 4x4.
    Primes degrade to 1xN (one ICI group, which is truthful: a ring)."""
    best = (1, n)
    r = 1
    while r * r <= n:
        if n % r == 0:
            best = (r, n // r)
        r += 1
    return best


def pod_topology(tpu: TPUSettings, n_workers: int) -> WorkerTopology:
    """Best-effort worker grid for the pod; ``known=False`` when no
    shape fits (zero/one worker, or an explicit shape that does not
    match the worker count -- a wrong topology is worse than none)."""
    if n_workers <= 1:
        return WorkerTopology()
    shape = _parse_shape(tpu.topology) if tpu.topology else None
    if tpu.topology and shape is None:
        log.warning("runtime.tpu.topology %r unparseable (want RxC); "
                    "topology placement falls back to spread", tpu.topology)
        return WorkerTopology()
    if shape is not None and shape[0] * shape[1] != n_workers:
        log.warning("runtime.tpu.topology %r does not cover %d workers; "
                    "topology placement falls back to spread",
                    tpu.topology, n_workers)
        return WorkerTopology()
    rows, cols = shape if shape is not None else _near_square(n_workers)
    coords = {i: (i // cols, i % cols) for i in range(n_workers)}
    return WorkerTopology(known=True, rows=rows, cols=cols, coords=coords)


def federation_topology(shape: str, n_pods: int) -> WorkerTopology:
    """Pod-tier topology for the federation router (docs/federation.md):
    the same 2-D grid model one level up -- grid cells are PODS, a row
    is a DCN-adjacent pod group (co-located pods share the cheaper DCN
    tier the way co-located workers share ICI).  ``shape`` is the
    ``federation.shape`` setting ("RxC"); empty/unparseable/mismatched
    shapes degrade to ``known=False`` exactly like :func:`pod_topology`
    and pod placement falls back to spread."""
    if n_pods <= 1:
        return WorkerTopology()
    parsed = _parse_shape(shape) if shape else None
    if shape and parsed is None:
        log.warning("federation.shape %r unparseable (want RxC); "
                    "pod placement falls back to spread", shape)
        return WorkerTopology()
    if parsed is not None and parsed[0] * parsed[1] != n_pods:
        log.warning("federation.shape %r does not cover %d pods; "
                    "pod placement falls back to spread", shape, n_pods)
        return WorkerTopology()
    rows, cols = parsed if parsed is not None else _near_square(n_pods)
    coords = {i: (i // cols, i % cols) for i in range(n_pods)}
    return WorkerTopology(known=True, rows=rows, cols=cols, coords=coords)


def discover_workers(tpu: TPUSettings) -> list[str]:
    if tpu.workers:
        return list(tpu.workers)
    hosts = _from_metadata()
    if hosts:
        log.info("discovered %d workers via metadata server", len(hosts))
        return hosts
    hosts = _from_gcloud(tpu)
    if hosts:
        log.info("discovered %d workers via gcloud for pod %s", len(hosts), tpu.pod)
    return hosts
