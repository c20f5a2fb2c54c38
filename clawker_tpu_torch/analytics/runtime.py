"""Anomaly runtime on PyTorch: train-on-the-fleet, score, and watch.

Port of ``clawker_tpu/analytics/runtime.py:30-397``.  ``score_windows``
fits the autoencoder on the window set (the fleet's behavior is its own
normal profile -- self-supervised) and returns per-window
reconstruction-error scores normalized as robust z-scores;
``AnomalyWatch`` re-scores an egress jsonl on an interval without
blocking its callers.

Every entry point takes ``device`` (default ``"cuda"``).  Without a GPU
a CUDA device raises: the lane never carries on on the CPU unless the
caller asks for ``device="cpu"``.  On the card the whole fit is one K3
launch that updates the params in place, as the reference's jitted
``lax.scan`` is one device program, and the score one K1 launch
(``kernels/anomaly.py``); there is nothing to compile, so the
reference's jit and XLA caches have no counterpart.  With a ``mesh``
(``analytics/mesh.py``) the fit is K5b over the mesh's shards when it
splits the hidden dimension (model = 2, the reference's layout at an even
count), else K5, and the score one K1 launch per data block: the
reference's sharded SPMD program.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..kernels import anomaly as K
from ..kernels.build import build_all
from . import anomaly
from . import features as F
from . import mesh as M

TRAIN_STEPS = 120
ANOMALY_Z = 3.5          # robust z-score threshold for "anomalous"
DEFAULT_DEVICE = "cuda"
DEVICE_ENV = "CLAWKER_TORCH_DEVICE"     # the entry points' device override
_PAD_BUCKET = 128        # rows padded up to a multiple of this


def accelerator_available() -> bool:
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


def env_device() -> str:
    """The device ``CLAWKER_TORCH_DEVICE`` names, else the card."""
    return os.environ.get(DEVICE_ENV) or DEFAULT_DEVICE


def bring_up(device) -> torch.device:
    """Resolve ``device`` and, on a CUDA device, open its context and
    build (where not built yet) and load every kernel, so that a
    long-running rider's first tick scores at once.  Raises
    ``RuntimeError`` (no GPU, a CUDA error, a failed build) or
    ``OSError`` (a kernel library that does not load)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        build_all()
    return dev


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


@dataclass
class ScoreReport:
    keys: list[F.WindowKey]
    raw: np.ndarray          # per-window reconstruction error
    z: np.ndarray            # robust z-score of raw
    agents: list[F.AgentScore]   # per-agent fold of z
    train_steps: int
    train_ms: float
    score_ms: float
    device: str


def _robust_z(raw: np.ndarray) -> np.ndarray:
    """Median/MAD z-scores: a few hot windows must not drag the scale."""
    if raw.size == 0:
        return raw
    med = float(np.median(raw))
    mad = float(np.median(np.abs(raw - med)))
    scale = 1.4826 * mad if mad > 0 else (float(raw.std()) or 1.0)
    return (raw - med) / scale


def _standardize(X: np.ndarray) -> np.ndarray:
    """Zero-mean/unit-var per feature over the window set, so the
    reconstruction error weights dimensions evenly."""
    mu = X.mean(axis=0) if len(X) else np.zeros(X.shape[1], np.float32)
    sd = X.std(axis=0) if len(X) else np.ones(X.shape[1], np.float32)
    sd = np.where(sd < 1e-6, 1.0, sd).astype(np.float32)
    return ((X - mu) / sd).astype(np.float32)


def _pad_rows(X: np.ndarray, width: int, data: int = 1) -> np.ndarray:
    """Standardize, then edge-replicate rows up to a _PAD_BUCKET multiple,
    rounded up to a multiple of a mesh's ``data`` axis (the reference's
    shapes; padded scores are sliced off)."""
    n = len(X)
    padded = max(_PAD_BUCKET, -(-n // _PAD_BUCKET) * _PAD_BUCKET)
    padded = -(-padded // data) * data
    Xn = _standardize(X)
    if padded != n:
        pad = Xn[np.arange(padded - n) % max(n, 1)] if n else np.zeros(
            (padded, width), np.float32)
        Xn = np.concatenate([Xn, pad], axis=0) if n else pad
    return Xn


def _fit(params: anomaly.AnomalyParams, x: torch.Tensor,
         noises: torch.Tensor, lr: float) -> torch.Tensor:
    """The fit: one denoising step per row of ``noises`` [steps, n, F],
    updating ``params`` in place, in one K3 launch.  -> losses [steps]."""
    losses = torch.empty(len(noises), dtype=torch.float32, device=x.device)
    K.fit_(params, x, noises, lr=lr, sigma=0.25, losses_out=losses)
    return losses


def _draw(seed: int, steps: int, x: torch.Tensor):
    """-> (initial params, the fit's whole [steps, n, F] unit noise), on
    x's device.  The params come from a generator seeded ``seed``, the
    noise -- ONE device op -- from one seeded ``seed + 1``, as the
    reference draws them from keys ``seed`` and ``seed + 1``."""
    dev = x.device
    params = anomaly.init_params(
        torch.Generator(device=dev).manual_seed(seed), feat=x.shape[1])
    noises = torch.randn((steps,) + tuple(x.shape), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 1))
    return params, noises


def _fit_shards(replicas, xs, noise_shards, lr: float,
                mesh: M.Mesh) -> torch.Tensor:
    """The fit over a mesh's shards, every params set updated in place
    (``mesh.fit_``): at model = 2 one K5b launch when the shards lie on
    one card, ``steps`` x (2 S + 2) over several cards; at model = 1 one
    K5 launch, or ``steps`` x (S + 1).  -> losses [steps]."""
    losses = torch.empty(len(noise_shards[0]), dtype=torch.float32,
                         device=xs[0].device)
    M.fit_(replicas, xs, noise_shards, mesh, lr=lr, sigma=0.25,
           losses_out=losses)
    return losses


def _sync(*devs: torch.device) -> None:
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _fit_and_score(X: np.ndarray, *, train_steps: int, lr: float, seed: int,
                   feat: int | None = None, device=DEFAULT_DEVICE,
                   mesh: M.Mesh | None = None):
    """-> (raw_scores[n], params, x_padded, timings).  Rows are padded by
    edge-replication up to _PAD_BUCKET multiples; padded scores are
    sliced off.

    With ``mesh`` (``mesh.fleet_mesh`` or ``virtual_mesh``; ``device`` is
    then not read) the row pad rounds up to a multiple of the mesh's data
    axis, as the reference's does; params and noise are drawn on the first
    shard's device, the params laid out as ``mesh.shard_params`` lays them
    (split over ``model`` at model = 2, else replicated) and x and the
    noise split into the mesh's shards; the fit is K5b at model = 2, else
    K5, and the score K1 per data block.  The params returned are the
    whole params on the first shard's device, x the whole padded batch
    there."""
    dev = resolve_device(mesh.devices[0] if mesh else device)
    n = len(X)
    width = feat or (X.shape[1] if X.ndim == 2 and X.shape[1] else 32)
    Xn = _pad_rows(X, width, mesh.data if mesh else 1)
    x = torch.from_numpy(Xn).to(dev)
    params, noises = _draw(seed, train_steps, x)
    devs = mesh.distinct if mesh else [dev]
    if dev.type == "cuda":
        build_all()     # first use builds/loads the kernels: set-up time
    if mesh:
        replicas = M.shard_params(params, mesh)
        xs = M.shard_rows(x, mesh)
        noise_shards = M.shard_noise(noises, mesh)
    _sync(*devs)

    t0 = time.perf_counter()
    if mesh:
        _fit_shards(replicas, xs, noise_shards, lr, mesh)
    else:
        _fit(params, x, noises, lr)
    _sync(*devs)
    train_ms = (time.perf_counter() - t0) * 1000.0

    t0 = time.perf_counter()
    if mesh:
        wholes = M.whole_params(replicas, mesh)
        params = wholes[0]
        scores = M.score_blocks(wholes, xs[::mesh.model])
    else:
        scores = anomaly.score(params, x)
    raw = scores[:n].cpu().numpy()
    score_ms = (time.perf_counter() - t0) * 1000.0
    name = device_name(dev) + (f" mesh={mesh.desc}" if mesh else "")
    return raw, params, x, {"train_ms": train_ms, "score_ms": score_ms,
                            "device": name}


def score_windows(X: np.ndarray, keys: list[F.WindowKey], *,
                  train_steps: int = TRAIN_STEPS, lr: float = 1e-2,
                  seed: int = 0, device=DEFAULT_DEVICE) -> ScoreReport:
    """Fit on all windows (denoising objective), score all windows."""
    raw, _, _, t = _fit_and_score(X, train_steps=train_steps, lr=lr,
                                  seed=seed, device=device)
    z = _robust_z(raw)
    return ScoreReport(
        keys=keys, raw=raw, z=z, agents=F.summarize(keys, z),
        train_steps=train_steps, train_ms=t["train_ms"],
        score_ms=t["score_ms"], device=t["device"],
    )


def bench_lane(records: list[dict], *, train_steps: int = 100,
               reps: int = 20, device=DEFAULT_DEVICE) -> dict:
    """Featurize + fit + steady-state score timing, the SAME pipeline
    ``monitor anomalies`` runs (denoising fit), for a bench of the port.
    With more than one CUDA device visible the fit and score run sharded
    over the fleet mesh of all of them (``device`` is then not read), as
    the reference shards on any multi-device backend.  The score step is
    the median over ``reps`` synchronized scores."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    keys, X = F.featurize(records)
    featurize_ms = (time.perf_counter() - t0) * 1000.0
    mesh = None
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = M.fleet_mesh()
    raw, params, x, t = _fit_and_score(X, train_steps=train_steps, lr=1e-2,
                                       seed=0, device=dev, mesh=mesh)
    if mesh:
        wholes = M.whole_params(M.shard_params(params, mesh), mesh)
        blocks = M.shard_rows(x, mesh)[::mesh.model]
        devs = mesh.distinct

        def score_step():
            return M.score_blocks(wholes, blocks)
    else:
        devs = [dev]

        def score_step():
            return anomaly.score(params, x)
    score_step()        # warm
    _sync(*devs)
    steps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        score_step()
        _sync(*devs)
        steps.append(time.perf_counter() - t0)
    steps.sort()
    return {
        "windows": len(keys),
        "featurize_ms": round(featurize_ms, 1),
        "train_ms": round(t["train_ms"], 1),
        "train_steps": train_steps,
        "score_step_us": round(steps[len(steps) // 2] * 1e6, 1),
        "device": t["device"],
    }


def score_file(path: str | Path, *, window_s: int = F.WINDOW_S,
               train_steps: int = TRAIN_STEPS, device=DEFAULT_DEVICE,
               ) -> ScoreReport | None:
    """Featurize + score one egress jsonl; None when it yields no windows."""
    keys, X = F.featurize(F.load_jsonl(path), window_s=window_s)
    if not keys:
        return None
    return score_windows(X, keys, train_steps=train_steps, device=device)


class AnomalyWatch:
    """Background re-scorer for the loop dashboard / scheduler.

    Tails the egress jsonl incrementally (byte offset remembered across
    polls; cost is O(new bytes), with a bounded record window), keeps
    the latest per-agent z-scores, and records which agents cross
    ANOMALY_Z.  All the render path touches is a dict under a lock.
    """

    MAX_RECORDS = 100_000

    def __init__(self, egress_path: Path, *, interval_s: float = 15.0,
                 window_s: int = F.WINDOW_S, train_steps: int = 60,
                 on_anomaly=None, on_error=None, device=DEFAULT_DEVICE):
        import collections

        from ..monitor.ledger import TailState

        self.egress_path = Path(egress_path)
        self.interval_s = interval_s
        self.window_s = window_s
        self.train_steps = train_steps
        self.device = device
        self.on_anomaly = on_anomaly or (lambda agent, z: None)
        self.on_error = on_error or (lambda msg: None)
        self._records: collections.deque = collections.deque(
            maxlen=self.MAX_RECORDS)
        self._tail = TailState()
        self._scores: dict[str, F.AgentScore] = {}
        self._flagged: set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_error = ""

    # ------------------------------------------------------------- surface

    def scores(self) -> dict[str, F.AgentScore]:
        with self._lock:
            return dict(self._scores)

    def score_for(self, agent_or_container: str) -> F.AgentScore | None:
        """Match loop agent names against container-named score rows.
        Container names are dot-separated (``clawker.<proj>.<agent>``),
        so match whole segments -- 'loop-1' must never pick up
        'clawker.p.loop-10'."""
        if not agent_or_container:
            return None
        with self._lock:
            hit = self._scores.get(agent_or_container)
            if hit is not None:
                return hit
            for name, sc in self._scores.items():
                if agent_or_container in name.split("."):
                    return sc
        return None

    # ------------------------------------------------------------ lifecycle

    @property
    def _offset(self) -> int:
        """Consumed-bytes cursor (tests/introspection)."""
        return self._tail.offset

    def _tail_new_records(self) -> None:
        """Incremental crash-tolerant tail: a torn line is SKIPPED, not
        fatal.  On truncation/rotation the cursor resets and the bounded
        record window is dropped with it."""
        from ..monitor.ledger import tail_jsonl

        resets = self._tail.resets
        recs = tail_jsonl(self.egress_path, self._tail)
        if self._tail.resets != resets:
            self._records.clear()
        self._records.extend(recs)

    def refresh_once(self) -> int:
        """Synchronous tail + re-score; returns number of scored windows."""
        try:
            self._tail_new_records()
            if not self._records:
                return 0
            keys, X = F.featurize(self._records, window_s=self.window_s)
            if not keys:
                return 0
            rep = score_windows(X, keys, train_steps=self.train_steps,
                                device=self.device)
        except Exception as e:  # noqa: BLE001 - watcher must not die
            msg = f"{e.__class__.__name__}: {e}"
            if msg != self.last_error:   # surface each distinct failure once
                self.last_error = msg
                self.on_error(msg)
            return 0
        self.last_error = ""   # recovered: a recurring failure re-fires
        with self._lock:
            self._scores = {a.agent: a for a in rep.agents}
            newly = [a for a in rep.agents
                     if a.latest >= ANOMALY_Z and a.agent not in self._flagged]
            self._flagged.update(a.agent for a in newly)
        for a in newly:
            self.on_anomaly(a.agent, a.latest)
        return len(rep.keys)

    def start(self) -> "AnomalyWatch":
        self._thread = threading.Thread(target=self._loop,
                                        name="anomaly-watch", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.refresh_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
