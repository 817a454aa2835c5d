"""The per-(application, node) RTT predictor, its serving half (a port of
the reference's ``core/predictor.py`` and the fields of
``core/selection.py`` that serving reads).

- :class:`PredictionRecord` and :class:`InferenceArtifact`: one
  prediction's record and the trained state the prediction plane stacks;
- :class:`MinMax`, :class:`SelectedConfig` and :class:`ModelChoice`: the
  feature scaler, the selected (window, metrics) and the chosen model;
- :class:`RTTPredictor`: ``metric_names``, the serial ``predict`` (one
  window through :func:`extract_features` and the zoo's
  ``single_apply``) and ``export_artifact``.

The port's :class:`ModelChoice` holds the chosen family's inference
parameters (the zoo's layout) where the reference holds a fit object:
the predictor's collection, correlation and training are not ported, so
a predictor's trained state comes from the reference
(``repro_torch.interop.predictor_from_reference``) or from seeded
parameters (``repro_torch.testing.make_trained_predictor``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import zoo
from repro_torch.core.features import extract_features
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.monitoring.metrics import MetricsStore, SimClock

__all__ = ["FEATURE_DELAY_PER_METRIC", "MinMax", "SelectedConfig",
           "ModelChoice", "PredictionRecord", "InferenceArtifact",
           "RTTPredictor"]

# modeled feature-extraction cost per selected metric (the same linear
# model Eq. 4's feature_delay budget term uses during (w*, r*, k*)
# selection) — also the t_feature recorded under a simulated clock
FEATURE_DELAY_PER_METRIC = 1e-4


@dataclass
class MinMax:
    lo: np.ndarray = None
    hi: np.ndarray = None

    def fit(self, X):
        self.lo = np.min(X, axis=0)
        self.hi = np.max(X, axis=0)
        return self


@dataclass
class SelectedConfig:
    window_s: float
    method: str
    metric_idx: np.ndarray       # indices of the k* chosen metrics
    total_corr: float
    t_state: float
    t_feature: float


@dataclass
class ModelChoice:
    name: str                    # zoo family
    params: object               # inference parameters (zoo's layout)
    rmse: float
    t_inference: float

    @property
    def sequential(self) -> bool:
        return self.name in zoo.SEQ_MODELS


@dataclass
class PredictionRecord:
    t: float
    rtt_pred: float
    t_state: float
    t_feature: float
    t_inference: float
    basis: str = "modeled"    # "modeled" (SimClock) or "wall" (live serving)
    # measured wall deltas of the implementation, kept apart so that
    # t_prediction never mixes time bases
    t_wall_state: float = 0.0
    t_wall_feature: float = 0.0
    t_wall_inference: float = 0.0

    @property
    def t_prediction(self):
        return self.t_state + self.t_feature + self.t_inference

    @property
    def t_wall_prediction(self):
        return self.t_wall_state + self.t_wall_feature + self.t_wall_inference


@dataclass
class InferenceArtifact:
    """A predictor's trained state, exported for fleet-batched inference:
    pure data the :class:`~repro_torch.core.prediction_plane.
    PredictionPlane` stacks with the other artifacts of its bucket."""
    app: str
    node: str
    family: str                      # zoo model name
    sequential: bool
    metric_names: Tuple[str, ...]
    window_s: float
    params: object                   # torch tree (zoo's layout)
    scaler_lo: Optional[np.ndarray]  # (k*F,) feature MinMax (non-sequential)
    scaler_hi: Optional[np.ndarray]
    seq_lo: Optional[np.ndarray]     # (k, 1) raw-window scale (sequential)
    seq_hi: Optional[np.ndarray]
    y_lo: float
    y_hi: float
    t_inference: float               # modeled per-inference cost (Eq. 6)
    fast_state: bool
    version: int                     # bumped by every (re)training

    @property
    def k(self) -> int:
        return len(self.metric_names)


class RTTPredictor:
    """One predictor for one (application, node) pair, serving half.

    Trained state: ``selected``, ``choice``, ``scaler_X`` (features),
    ``_seq_lo`` / ``_seq_hi`` ((1, k, 1) raw-window scale), ``y_lo`` /
    ``y_hi``; ``artifact_version`` is bumped by every (re)training.
    ``device=None`` runs inference on the CUDA card (RuntimeError without
    one), ``device="cpu"`` on the CPU."""

    def __init__(self, app: str, node: str, store: MetricsStore,
                 clock: Optional[SimClock] = None, fast_state: bool = False,
                 device: DeviceLike = None):
        self.app, self.node = app, node
        self.store = store
        self.clock = clock or store.clock
        self.fast_state = fast_state     # zero-copy state path
        self.device = resolve_device(device)
        self.selected: Optional[SelectedConfig] = None
        self.choice: Optional[ModelChoice] = None
        self.scaler_X: Optional[MinMax] = None
        self._seq_lo = self._seq_hi = None
        self.y_lo = self.y_hi = None
        self.predictions: List[PredictionRecord] = []
        self.artifact_version = 0

    def metric_names(self) -> List[str]:
        """Selected metric names (metric_idx resolved against the store)."""
        names = self.store.names
        return [names[i] for i in self.selected.metric_idx
                if i < len(names)]

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def predict(self) -> Optional[PredictionRecord]:
        """One serial prediction: state retrieval -> features ->
        inference, at B = 1 on the predictor's device.

        One time basis per record: under a simulated clock every
        component is the modeled delay (state from the store's
        RetrievalModel, features from the Eq. 4 term, inference from the
        Eq. 6 cost); under a wall clock every component is the measured
        wall delta, each ended by a wait for the device."""
        if self.choice is None or self.selected is None:
            return None
        sel = self.selected
        names = self.metric_names()
        t0 = time.perf_counter()
        window, modeled_state = self.store.query_window(
            names, sel.window_s, fast=self.fast_state)
        t1 = time.perf_counter()
        x = self._f32(window)
        if self.choice.sequential:
            lo, hi = self._f32(self._seq_lo[0]), self._f32(self._seq_hi[0])
            X = (x - lo) / torch.clamp(hi - lo, min=1e-9)
        else:
            feats = extract_features(x[None]).reshape(-1)       # (k * F,)
            lo = self._f32(self.scaler_X.lo)
            hi = self._f32(self.scaler_X.hi)
            X = (feats - lo) / torch.clamp(hi - lo, min=1e-9)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        y_n = float(zoo.single_apply(self.choice.name)(self.choice.params, X))
        t3 = time.perf_counter()
        rtt = y_n * max(self.y_hi - self.y_lo, 1e-9) + self.y_lo
        if self.clock.simulated:
            rec = PredictionRecord(
                self.clock.now(), rtt, modeled_state,
                FEATURE_DELAY_PER_METRIC * len(names),
                self.choice.t_inference, basis="modeled")
        else:
            rec = PredictionRecord(self.clock.now(), rtt, t1 - t0,
                                   t2 - t1, t3 - t2, basis="wall")
        rec.t_wall_state = t1 - t0
        rec.t_wall_feature = t2 - t1
        rec.t_wall_inference = t3 - t2
        self.predictions.append(rec)
        return rec

    def export_artifact(self) -> Optional[InferenceArtifact]:
        """Trained state as a stackable :class:`InferenceArtifact`, or
        None while untrained."""
        if self.choice is None or self.selected is None:
            return None
        seq = self.choice.sequential
        return InferenceArtifact(
            app=self.app, node=self.node, family=self.choice.name,
            sequential=seq, metric_names=tuple(self.metric_names()),
            window_s=self.selected.window_s, params=self.choice.params,
            scaler_lo=None if seq else np.asarray(self.scaler_X.lo),
            scaler_hi=None if seq else np.asarray(self.scaler_X.hi),
            seq_lo=np.asarray(self._seq_lo[0]) if seq else None,
            seq_hi=np.asarray(self._seq_hi[0]) if seq else None,
            y_lo=float(self.y_lo), y_hi=float(self.y_hi),
            t_inference=float(self.choice.t_inference),
            fast_state=self.fast_state, version=self.artifact_version)
