"""Configuration selection (paper Eqs. 4-6 + Table 2), a port of the
reference's ``core/selection.py``.

(w*, r*, k*): among (window, method, metric-count) combinations whose
state preparation fits the tau_prepare budget, maximize the summed
|correlation| (host numpy, as the reference).  Model selection: every
Table 2 candidate is fitted on the same ``"model-split"`` permutation
(drawn on the host), those within the tau_inference budget are kept,
and the least test RMSE wins.  The fits and predictions run on
``device``; the inference time is a wall time that waits for the device
before each clock read, so it differs from the reference's while the
budget it is held to is the same.

The reference skips any candidate whose fit raises.  Here only the
errors that degenerate data raise in the zoo's candidates are skipped
(:data:`FIT_ERRORS`) and counted in ``select_model.skipped``: a CUDA or
kernel error propagates, so a failed launch never becomes a silently
missing candidate.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import zoo
from repro_torch.core.rng import rng_stream
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["WINDOWS_S", "TAU_PREPARE", "TAU_INFERENCE", "K_STEP",
           "FIT_ERRORS", "SelectedConfig", "ModelChoice",
           "select_window_metrics", "select_model"]

WINDOWS_S = (1.0, 5.0, 20.0, 60.0)    # paper's observation windows
TAU_PREPARE = 0.09                     # ≤ 9% of mean RTT (Eq. 4)
TAU_INFERENCE = 0.01                   # ≤ 1% of mean RTT (Eq. 6)
K_STEP = 5                             # metric count increments (paper)
#: what a candidate's fit raises on degenerate data: the linear solve of
#: ``lr`` on a singular system.  Nothing else is skipped.
FIT_ERRORS = (np.linalg.LinAlgError,)


@dataclass
class SelectedConfig:
    window_s: float
    method: str
    metric_idx: np.ndarray       # indices of the k* chosen metrics
    total_corr: float
    t_state: float
    t_feature: float


def select_window_metrics(
        corr: Dict[Tuple[float, str], np.ndarray],
        state_delay: Callable[[int, float], float],
        feature_delay: Callable[[int, float], float],
        mean_rtt: float,
        tau_prepare: float = TAU_PREPARE,
        k_step: int = K_STEP) -> Optional[SelectedConfig]:
    """Eq. 4-5.  corr maps (window_s, method) -> |corr| per metric."""
    budget = tau_prepare * mean_rtt
    best: Optional[SelectedConfig] = None
    for (w, method), scores in corr.items():
        order = np.argsort(-scores)
        m = len(scores)
        for k in range(k_step, m + k_step, k_step):
            k = min(k, m)
            ts = state_delay(k, w)
            tf = feature_delay(k, w)
            if ts + tf > budget:
                break                       # delays grow with k
            total = float(scores[order[:k]].sum())
            if best is None or total > best.total_corr:
                best = SelectedConfig(w, method, order[:k].copy(), total,
                                      ts, tf)
            if k == m:
                break
    return best


@dataclass
class ModelChoice:
    name: str                    # zoo family
    model: object                # the fit object (zoo.FIT_CLASSES)
    rmse: float
    t_inference: float

    @property
    def params(self):
        """The model's inference parameters (the zoo's layout)."""
        return self.model.inference_params()


def _rmse(pred, y) -> float:
    pred = np.asarray(pred, np.float64)
    y = np.asarray(y, np.float64)
    return float(np.sqrt(np.mean((pred - y) ** 2)))


def _time_inference(model, X1, repeats: int = 5) -> float:
    """Wall seconds of one ``predict`` on one sample, each call read back
    to the host (the reference's ``np.asarray``) before the clock."""
    model.predict(X1).cpu()                  # warm-up
    t0 = time.perf_counter()
    for _ in range(repeats):
        model.predict(X1).cpu()
    return (time.perf_counter() - t0) / repeats


def select_model(candidates: Sequence[str],
                 X_feat, X_seq, y,
                 mean_rtt: float,
                 splits=(0.8, 0.1, 0.1),
                 tau_inference: float = TAU_INFERENCE,
                 seed: int = 0,
                 model_kwargs: Optional[dict] = None,
                 device: DeviceLike = None) -> Optional[ModelChoice]:
    """Eq. 6: full training — train every candidate on ``device`` (None:
    the CUDA card), filter by inference budget, pick min-RMSE on the test
    split.

    X_feat: (n, F) features; X_seq: (n, k, w) raw windows (or None); y:
    (n,); numpy arrays.
    """
    dev = resolve_device(device)
    n = len(y)
    rng = rng_stream(seed, "model-split")
    perm = rng.permutation(n)
    n_tr = int(splits[0] * n)
    n_va = int(splits[1] * n)
    tr, va, te = (perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:])
    if len(te) == 0:
        te = va if len(va) else tr
    best: Optional[ModelChoice] = None
    for name in candidates:
        cls = zoo.FIT_CLASSES[name]
        model = cls(device=dev, **(model_kwargs or {}).get(name, {}))
        X = X_seq if model.sequential else X_feat
        if X is None:
            continue
        try:
            model.fit(X[tr], y[tr])
        except FIT_ERRORS:
            select_model.skipped += 1
            continue
        t_inf = _time_inference(model, X[te[:1]])
        if t_inf > tau_inference * mean_rtt:
            continue
        rmse = _rmse(model.predict(X[te]).cpu(), y[te])
        if best is None or rmse < best.rmse:
            best = ModelChoice(name, model, rmse, t_inf)
    return best


select_model.skipped = 0
