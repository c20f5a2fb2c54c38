"""Sentinel scoring engine: one fit + score of the whole fleet per tick.

Port of ``ScoringEngine`` from ``clawker_tpu/sentinel/engine.py:35-181``.
Each tick takes the fused (egress + behavior) window matrix for EVERY
open window of EVERY agent in the fleet and runs the denoising
autoencoder's fit and score over it at F = 40 through the port's
``analytics.runtime._fit_and_score``: on one H100 that is one K3
launch (the whole fit) and one K1 launch, unsharded; on a host with
several cards, K5 and K1 over the fleet mesh of all of them.

Scores normalize in two stages: a robust (median/MAD) z within the
tick, then re-centered against the agent's WORKER's rolling baseline of
recent tick-z values -- a worker whose whole population drifts hot
surfaces even when its agents stay mutually consistent.  Baselines are
plain floats, serialized into the sentinel state file so ``--resume``
continues from the dead run's normal profile instead of re-learning it.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analytics import anomaly
from ..analytics import runtime as art
from ..analytics.features import AgentScore, WindowKey, summarize
from ..analytics.mesh import fleet_mesh
from .features import EXT_FEATURES

BASELINE_MIN = 4          # baseline samples before it re-centers anything
DEFAULT_THRESHOLD = 3.5   # flag at this worker-relative robust z


@dataclass
class TickReport:
    keys: list[WindowKey]
    raw: np.ndarray                 # per-window reconstruction error
    z: np.ndarray                   # worker-relative robust z
    agents: list[AgentScore]        # per-agent fold of z
    supports: np.ndarray | None = None   # per-window evidence weight
    train_ms: float = 0.0
    score_ms: float = 0.0
    device: str = ""
    windows: int = 0


@dataclass
class ScoringEngine:
    train_steps: int = 40
    threshold: float = DEFAULT_THRESHOLD
    baseline_window: int = 256      # per-worker recent tick-z samples kept
    min_support: float = 10.0       # evidence floor before a window may
    #                                 FLAG (it is always scored): a
    #                                 handful-of-records partial window
    #                                 at a stream boundary is legitimately
    #                                 off-manifold but not an incident.
    #                                 Support = egress records + 5x
    #                                 behavioral events (behavioral
    #                                 events are rare and each is heavy).
    seed: int = 0
    lr: float = 1e-2
    device: str = art.DEFAULT_DEVICE
    _baselines: dict = field(default_factory=dict)  # worker -> deque[float]
    # guards _baselines: the tick thread inserts worker keys while
    # status/CLI threads read depth/doc
    _baselines_lock: threading.Lock = field(default_factory=threading.Lock)

    # ------------------------------------------------------------ scoring

    def _mesh(self):
        """The fleet mesh over every visible card when the engine runs on
        CUDA and more than one card is visible; None (unsharded) on one
        card or on the CPU."""
        if (torch.device(self.device).type == "cuda"
                and torch.cuda.device_count() > 1):
            return fleet_mesh()
        return None

    def score_tick(self, keys: list[WindowKey], X: np.ndarray,
                   worker_of: dict[str, str]) -> TickReport | None:
        """Fit + score every open window; None when there is nothing to
        score.  ``worker_of`` maps window agents to worker ids for the
        baseline stage (unknown agents share the '' baseline)."""
        if not keys:
            return None
        raw, params, x, t = art._fit_and_score(
            X, train_steps=self.train_steps, lr=self.lr, seed=self.seed,
            feat=EXT_FEATURES, device=self.device, mesh=self._mesh())
        z_tick = art._robust_z(raw)
        z = np.array([
            self._worker_z(worker_of.get(k.agent, ""), float(zt))
            for k, zt in zip(keys, z_tick)], np.float32)
        # host copies for flag attribution
        self._params = anomaly.params_to_numpy(params)
        self._x_std = x[: len(keys)].cpu().numpy()
        # evidence weight per window, from the PRE-standardized counts:
        # dim 0 is log1p(egress records), the last behavior dim is
        # log1p(total behavioral events)
        supports = (np.expm1(X[:, 0])
                    + 5.0 * np.expm1(X[:, EXT_FEATURES - 1]))
        return TickReport(
            keys=keys, raw=raw, z=z, agents=summarize(keys, z),
            supports=supports.astype(np.float32),
            train_ms=t["train_ms"], score_ms=t["score_ms"],
            device=t["device"], windows=len(keys))

    def _worker_z(self, worker: str, z_tick: float) -> float:
        """Re-center a tick z against the worker's rolling baseline,
        then feed the baseline (post-read: a score never normalizes
        against itself)."""
        with self._baselines_lock:
            base = self._baselines.get(worker)
            if base is None:
                base = self._baselines[worker] = collections.deque(
                    maxlen=self.baseline_window)
            arr = (np.asarray(base, np.float32)
                   if len(base) >= BASELINE_MIN else None)
            base.append(z_tick)
        if arr is None:
            return z_tick
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        scale = max(1.0, 1.4826 * mad)   # a too-quiet baseline must
        #                                  not inflate ordinary noise
        return (z_tick - med) / scale

    # ------------------------------------------------------- attribution

    def flag_kind(self, row_index: int) -> str:
        """'egress' | 'behavior': which feature family dominates the
        flagged window's reconstruction error.  Host-side numpy over
        the tick's fitted params (40x128 -- trivial), only computed for
        rows that actually flag."""
        try:
            p = self._params
            x = self._x_std[row_index]
        except (AttributeError, IndexError):
            return "egress"
        h = np.asarray(x) @ np.asarray(p.w_enc) + np.asarray(p.b_enc)
        h = 0.5 * h * (1.0 + np.tanh(0.7978845608 * (h + 0.044715 * h**3)))
        r = h @ np.asarray(p.w_dec) + np.asarray(p.b_dec)
        err = np.square(r - x)
        from ..analytics.features import FEATURES as EGRESS_DIMS

        return ("behavior" if float(err[EGRESS_DIMS:].sum())
                > float(err[:EGRESS_DIMS].sum()) else "egress")

    # ------------------------------------------------------- persistence

    def baseline_doc(self) -> dict:
        """Serializable rolling baselines (sentinel state file)."""
        with self._baselines_lock:
            return {w: [round(float(v), 4) for v in vals]
                    for w, vals in self._baselines.items()}

    def load_baselines(self, doc: dict) -> int:
        n = 0
        for worker, vals in (doc or {}).items():
            base = collections.deque(maxlen=self.baseline_window)
            for v in vals[-self.baseline_window:]:
                try:
                    base.append(float(v))
                except (TypeError, ValueError):
                    continue
            with self._baselines_lock:
                self._baselines[str(worker)] = base
            n += len(base)
        return n

    def baseline_depth(self, worker: str = "") -> int:
        with self._baselines_lock:
            return sum(len(v) for w, v in self._baselines.items()
                       if not worker or w == worker)
