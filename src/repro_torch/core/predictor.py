"""Per-(application, node) RTT predictor lifecycle (paper §3, Fig. 2), a
port of the reference's ``core/predictor.py``.

Three cooperating processes, driven by a SimClock (cooperative state
machines, in the reference's event order):

  DataCollection (5-min cycle): new-data check -> RTT collection ->
    balance (FD binning) -> metrics collection -> CONFIRM dataset-size
    check -> correlations (perfCorrelate) -> state-delay analysis ->
    (w*, r*, k*) selection (Eqs. 4-5) -> feature extraction -> notify
  Training (event-driven): full training (Table 2 candidates, Eq. 6) or
    re-training; RMSE_change > theta triggers correlation re-evaluation
    (Eq. 7)
  Prediction (on-demand / periodic): state retrieval -> feature
    extraction -> inference; t_prediction = t_state + t_feature + t_inf

The bookkeeping is the reference's host numpy (the balanced dataset, the
CONFIRM bootstrap, the scalers, perfCorrelate's two stages, the
selection); the features, the correlation battery and the fits run on
the predictor's ``device`` (None: the CUDA card, RuntimeError without
one; ``"cpu"``: the CPU).  A predictor's trained state can also come
from the reference (``repro_torch.interop.predictor_from_reference``) or
from seeded parameters (``repro_torch.testing.make_trained_predictor``);
either holds a fit object built by ``zoo.from_params``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import correlate, selection, zoo
from repro_torch.core.binning import BalancedDataset
from repro_torch.core.features import (drop_redundant, extract_features,
                                       select_feature_per_metric)
from repro_torch.core.rng import rng_stream
from repro_torch.core.selection import ModelChoice, SelectedConfig
from repro_torch.core.telemetry import PhaseTimer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.monitoring.metrics import MetricsStore, SimClock

__all__ = ["THETA_RETRAIN", "COLLECTION_PERIOD_S", "CONFIRM_R",
           "CONFIRM_ALPHA", "FEATURE_DELAY_PER_METRIC",
           "confirm_enough_samples", "MinMax", "SelectedConfig",
           "ModelChoice", "PredictionRecord", "InferenceArtifact",
           "RTTPredictor"]

THETA_RETRAIN = 0.10          # Eq. 7 threshold
COLLECTION_PERIOD_S = 300.0   # 5-minute data-collection cycle
CONFIRM_R = 0.05              # median within r% ...
CONFIRM_ALPHA = 0.95          # ... at alpha confidence
# modeled feature-extraction cost per selected metric (the same linear
# model Eq. 4's feature_delay budget term uses during (w*, r*, k*)
# selection) — also the t_feature recorded under a simulated clock
FEATURE_DELAY_PER_METRIC = 1e-4


def confirm_enough_samples(rtts: np.ndarray, r: float = CONFIRM_R,
                           alpha: float = CONFIRM_ALPHA,
                           n_boot: int = 200, seed: int = 0) -> bool:
    """CONFIRM-style check: bootstrap CI of the median within ±r%."""
    rtts = np.asarray(rtts, np.float64)
    if len(rtts) < 20:
        return False
    rng = rng_stream(seed, "confirm-bootstrap")
    meds = np.median(
        rtts[rng.integers(0, len(rtts), size=(n_boot, len(rtts)))], axis=1)
    lo, hi = np.quantile(meds, [(1 - alpha) / 2, 1 - (1 - alpha) / 2])
    med = np.median(rtts)
    return med > 0 and (hi - lo) / 2 <= r * med


@dataclass
class MinMax:
    lo: np.ndarray = None
    hi: np.ndarray = None

    def fit(self, X):
        self.lo = np.min(X, axis=0)
        self.hi = np.max(X, axis=0)
        return self

    def transform(self, X):
        return (X - self.lo) / np.maximum(self.hi - self.lo, 1e-9)

    def inverse_y(self, y):
        return y * np.maximum(self.hi - self.lo, 1e-9) + self.lo


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
    """One predictor for one (application, node) pair.

    Trained state: ``selected``, ``choice`` (its ``model`` a fit object of
    ``zoo.FIT_CLASSES``), ``scaler_X`` (features), ``_seq_lo`` /
    ``_seq_hi`` ((1, k, 1) raw-window scale), ``y_lo`` / ``y_hi``;
    ``artifact_version`` is bumped by every (re)training.  ``device=None``
    extracts features, correlates, trains and predicts on the CUDA card
    (RuntimeError without one), ``device="cpu"`` on the CPU."""

    def __init__(self, app: str, node: str, store: MetricsStore,
                 clock: Optional[SimClock] = None, c_max: Optional[int] = 50,
                 seed: int = 0, fast_state: bool = False,
                 device: DeviceLike = None,
                 timer: Optional[PhaseTimer] = None):
        self.app, self.node = app, node
        self.store = store
        self.clock = clock or store.clock
        self.dataset = BalancedDataset(c_max=c_max, seed=seed)
        self.seed = seed
        self.fast_state = fast_state     # zero-copy state path
        self.device = resolve_device(device)
        # wall seconds of the lifecycle's steps ("collection",
        # "correlations", "training"), each also a torch profiler range
        self.timer = timer or PhaseTimer()
        # lifecycle state
        self.selected: Optional[SelectedConfig] = None
        self.choice: Optional[ModelChoice] = None
        self.scaler_X: Optional[MinMax] = None
        self._seq_lo = self._seq_hi = None
        self.y_lo = self.y_hi = None
        self.rmse_history: List[Tuple[float, float]] = []
        self.full_trainings = 0
        self.retrainings = 0
        self.correlations_valid = False
        self._pending_rtts: List[float] = []
        self._pending_windows: List[Dict[float, np.ndarray]] = []
        self.predictions: List[PredictionRecord] = []
        self._corr_scores: Dict = {}
        self.artifact_version = 0     # bumped by every (re)training

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def _features(self, X: np.ndarray) -> np.ndarray:
        """(..., w) windows -> (..., F) features, extracted on the device."""
        return extract_features(self._f32(X)).cpu().numpy()

    # ------------------------------------------------------------------
    # data collection process
    def observe_task(self, rtt: float, window_by_w: Dict[float, np.ndarray]):
        """Record one completed task: its RTT + pre-submission windows.

        window_by_w: window_s -> (n_metrics, points) raw monitoring slices.
        """
        self._pending_rtts.append(float(rtt))
        self._pending_windows.append(window_by_w)

    def collection_cycle(self) -> bool:
        """One 5-minute cycle.  Returns True if training was notified."""
        if not self._pending_rtts:                  # new data check
            return False
        with self.timer.phase("collection"):
            rtts = np.array(self._pending_rtts)
            payloads = list(self._pending_windows)
            self._pending_rtts, self._pending_windows = [], []
            self.dataset.add_batch(rtts, payloads)  # balance RTT data
            enough = confirm_enough_samples(self.dataset.rtts)
        if not enough:                              # dataset size chk
            return False
        if not self.correlations_valid:             # correlations check
            self._run_correlations()
        return self.selected is not None

    def _mean_rtt(self) -> float:
        return float(np.mean(self.dataset.rtts)) if len(self.dataset.rtts) \
            else 1.0

    def _windows_matrix(self, w: float) -> np.ndarray:
        """Stack stored windows for window length w: (n, k_metrics, points)."""
        return np.stack([p[w] for p in self.dataset.payloads()])

    def _run_correlations(self):
        """perfCorrelate over all (window, method) combos + Eq. 4-5 pick."""
        with self.timer.phase("correlations"):
            rtt = np.asarray(self.dataset.rtts, np.float32)
            corr: Dict[Tuple[float, str], np.ndarray] = {}
            for w in selection.WINDOWS_S:
                X = self._windows_matrix(w)             # (n, m, points)
                feats = self._features(X)               # (n, m, F)
                best_feat, sel = select_feature_per_metric(feats, rtt)
                kept = drop_redundant(
                    sel, np.abs(np.corrcoef(sel.T, rtt)[-1, :-1])
                    if sel.shape[1] > 1 else np.ones(sel.shape[1]))
                scores = correlate.correlate_all(sel[:, kept].T, rtt,
                                                 device=self.device)
                m = X.shape[1]
                for method, vals in scores.items():
                    full = np.zeros(m, np.float32)
                    full[kept] = vals
                    corr[(w, method)] = full
                self._per_window_feat = best_feat
            self._corr_scores = corr
            retr = self.store.retrieval
            self.selected = selection.select_window_metrics(
                corr,
                state_delay=lambda k, w: 0.0 if self.fast_state
                else retr.delay(k, w),
                feature_delay=lambda k, w: FEATURE_DELAY_PER_METRIC * k,
                mean_rtt=self._mean_rtt())
            self.correlations_valid = self.selected is not None

    # ------------------------------------------------------------------
    # training process
    def _training_arrays(self):
        sel = self.selected
        X_raw = self._windows_matrix(sel.window_s)[:, sel.metric_idx]
        feats = self._features(X_raw)                        # (n, k, F)
        X_feat = feats.reshape(len(feats), -1)
        y = np.asarray(self.dataset.rtts, np.float32)
        self.scaler_X = MinMax().fit(X_feat)
        self._seq_lo = X_raw.min(axis=(0, 2), keepdims=True)
        self._seq_hi = X_raw.max(axis=(0, 2), keepdims=True)
        X_seq = (X_raw - self._seq_lo) / np.maximum(
            self._seq_hi - self._seq_lo, 1e-9)
        self.y_lo, self.y_hi = float(y.min()), float(y.max())
        y_n = (y - self.y_lo) / max(self.y_hi - self.y_lo, 1e-9)
        # outlier removal (z > 3) on the target, as in the paper
        z = np.abs((y - y.mean()) / max(y.std(), 1e-9))
        keep = z <= 3
        return (self.scaler_X.transform(X_feat)[keep], X_seq[keep],
                y_n[keep], y[keep])

    def train(self, force_full: bool = False) -> Optional[float]:
        """Full training or re-training; returns new RMSE (normalized)."""
        if self.selected is None:
            return None
        with self.timer.phase("training"):
            X_feat, X_seq, y_n, _ = self._training_arrays()
            mean_rtt = self._mean_rtt()
            full = force_full or self.choice is None
            if full:
                cands = zoo.candidates_for(self.selected.method, len(y_n))
                choice = selection.select_model(cands, X_feat, X_seq, y_n,
                                                mean_rtt, seed=self.seed,
                                                device=self.device)
                if choice is None:
                    return None
                self.choice = choice
                self.full_trainings += 1
            else:
                model = self.choice.model
                X = X_seq if model.sequential else X_feat
                model.partial_fit(X, y_n)
                pred = _host(model.predict(X))
                self.choice.rmse = float(np.sqrt(np.mean((pred - y_n) ** 2)))
                self.retrainings += 1
        new_rmse = self.choice.rmse
        # Eq. 7: regression check against the previous RMSE
        if self.rmse_history:
            prev = self.rmse_history[-1][1]
            change = (new_rmse - prev) / max(prev, 1e-9)
            if change > THETA_RETRAIN and not full:
                self.correlations_valid = False      # re-evaluate correlations
                self._run_correlations()
                if self.selected is not None:
                    return self.train(force_full=True)
        self.rmse_history.append((self.clock.now(), new_rmse))
        self.artifact_version += 1
        return new_rmse

    # ------------------------------------------------------------------
    # prediction process
    def metric_names(self) -> List[str]:
        """Selected metric names (metric_idx resolved against the store)."""
        names = self.store.names
        return [names[i] for i in self.selected.metric_idx
                if i < len(names)]

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
        model = self.choice.model
        if model.sequential:
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
        y_n = float(_host(model.predict(X)).reshape(-1)[0])
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
        None while untrained (or when the model has no parameter export,
        e.g. a test double)."""
        if self.choice is None or self.selected is None:
            return None
        model = self.choice.model
        try:
            params = model.inference_params()
        except (AttributeError, NotImplementedError):
            return None
        seq = bool(model.sequential)
        return InferenceArtifact(
            app=self.app, node=self.node, family=model.name, sequential=seq,
            metric_names=tuple(self.metric_names()),
            window_s=self.selected.window_s, params=params,
            scaler_lo=None if seq else np.asarray(self.scaler_X.lo),
            scaler_hi=None if seq else np.asarray(self.scaler_X.hi),
            seq_lo=np.asarray(self._seq_lo[0]) if seq else None,
            seq_hi=np.asarray(self._seq_hi[0]) if seq else None,
            y_lo=float(self.y_lo), y_hi=float(self.y_hi),
            t_inference=float(self.choice.t_inference),
            fast_state=self.fast_state, version=self.artifact_version)


def _host(pred) -> np.ndarray:
    """A model's predictions as a numpy array (a test double's may
    already be one)."""
    return pred.cpu().numpy() if torch.is_tensor(pred) else np.asarray(pred)
