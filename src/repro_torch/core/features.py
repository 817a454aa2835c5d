"""tsfresh-style statistical features over metric windows (a port of the
reference's ``core/features.py``).

:func:`extract_features` maps ``(..., w)`` windows to the same twelve
features, in the same order, as the reference.  Two torch defaults
differ from jnp's and are overridden: ``torch.median`` returns the lower
middle value (jnp averages the two), and ``torch.quantile`` interpolates
with ``lerp``, so the order statistics come from one sort with jnp's own
formulas (midpoint median, linear q25 / q75); ``torch.std`` divides by
``w - 1`` (jnp by ``w``), so it takes ``correction=0``.

:func:`select_feature_per_metric`, :func:`drop_redundant` (perfCorrelate's
two stages) and :class:`RollingFeatures` are host numpy, copies of the
reference's.
"""
from __future__ import annotations

import collections
import math
from typing import List

import numpy as np
import torch

__all__ = ["FEATURE_NAMES", "extract_features", "select_feature_per_metric",
           "drop_redundant", "RollingFeatures"]

FEATURE_NAMES = (
    "mean", "std", "min", "max", "median", "q25", "q75", "first", "last",
    "slope", "abs_energy", "mean_abs_change",
)


def _quantiles(Xs: torch.Tensor):
    """jnp's median (midpoint of the two middle values) and its linear
    q25 / q75, from windows sorted along the last axis, in the same
    float operations."""
    w = Xs.shape[-1]

    def at(i):
        return Xs[..., i]
    lo, hi = (w - 1) // 2, w // 2
    med = (at(lo) + at(hi)) * 0.5
    out = [med]
    for q in (0.25, 0.75):
        pos = q * (w - 1)                  # exact: a multiple of 1/4
        lo, hi = math.floor(pos), math.ceil(pos)
        hw = pos - lo
        out.append(at(lo) * (1.0 - hw) + at(hi) * hw)
    return out


def extract_features(X: torch.Tensor) -> torch.Tensor:
    """X: (..., w) time series -> (..., F) features, batched over every
    leading axis in one pass.  The sums accumulate in float64 and round
    once to X's dtype."""
    w = X.shape[-1]
    X64 = X.double()
    tc = torch.arange(w, dtype=torch.float64, device=X.device) - (w - 1) / 2
    mean = X64.mean(-1)
    std = X64.std(-1, correction=0)
    mn = X.amin(-1)
    mx = X.amax(-1)
    med, q25, q75 = _quantiles(X.sort(-1).values)
    first = X[..., 0]
    last = X[..., -1]
    # sum(tc^2) = w (w^2 - 1) / 12, exact, and known on the host
    slope = (X64 * tc).sum(-1) / max(w * (w * w - 1) / 12.0, 1e-9)
    abs_energy = (X64 * X64).sum(-1)
    mac = torch.diff(X64, dim=-1).abs().mean(-1)
    dt = X.dtype
    return torch.stack([mean.to(dt), std.to(dt), mn, mx, med, q25, q75,
                        first, last, slope.to(dt), abs_energy.to(dt),
                        mac.to(dt)], dim=-1)


def select_feature_per_metric(feats: np.ndarray, rtt: np.ndarray):
    """perfCorrelate stage 1: per metric, keep the single feature most
    correlated (|pearson|) with RTT.

    feats: (n_samples, m_metrics, F); rtt: (n,) -> ((m,) indices, (n, m)).
    """
    n, m, F = feats.shape
    y = rtt - rtt.mean()
    ys = max(float(np.sqrt((y * y).mean())), 1e-12)
    flat = feats.reshape(n, m * F)
    fc = flat - flat.mean(0)
    fs = np.sqrt((fc * fc).mean(0)) + 1e-12
    corr = np.abs((fc * y[:, None]).mean(0) / (fs * ys)).reshape(m, F)
    best = np.argmax(corr, axis=1)
    sel = flat.reshape(n, m, F)[:, np.arange(m), best]
    return best, sel


def drop_redundant(X: np.ndarray, scores: np.ndarray, thresh: float = 0.95):
    """perfCorrelate stage 2: greedily drop metrics whose |pairwise corr|
    with an already-kept, higher-scoring metric exceeds ``thresh``.

    X: (n, m) selected features; scores: (m,) relevance. Returns kept idx.
    """
    order = np.argsort(-scores)
    Xc = X - X.mean(0)
    Xs = Xc / (Xc.std(0) + 1e-12)
    kept: List[int] = []
    for i in order:
        ok = True
        for j in kept:
            c = abs(float((Xs[:, i] * Xs[:, j]).mean()))
            if c > thresh:
                ok = False
                break
        if ok:
            kept.append(int(i))
    return np.array(sorted(kept), dtype=np.int64)


# ----------------------------------------------------------------------
class RollingFeatures:
    """O(1)-amortised rolling window features over a metric stream.

    Maintains running sums for mean/std/energy, monotonic deques for
    min/max, and ring buffers for order statistics.  `update(v)` is O(1)
    amortised; `features()` returns the same 12 features as
    ``extract_features`` (median/quantiles computed lazily O(w) only when
    requested with exact=True, else approximated by P² quantile tracking).
    """

    def __init__(self, window: int):
        self.w = window
        self.buf = collections.deque(maxlen=window)
        self.sum = 0.0
        self.sumsq = 0.0
        self.abs_change = collections.deque(maxlen=max(window - 1, 1))
        self.abs_change_sum = 0.0
        self.minq: collections.deque = collections.deque()  # (idx, val)
        self.maxq: collections.deque = collections.deque()
        self.idx = 0

    def update(self, v: float):
        if len(self.buf) == self.w:
            old = self.buf[0]
            self.sum -= old
            self.sumsq -= old * old
        if self.buf:
            d = abs(v - self.buf[-1])
            if len(self.abs_change) == self.abs_change.maxlen:
                self.abs_change_sum -= self.abs_change[0]
            self.abs_change.append(d)
            self.abs_change_sum += d
        self.buf.append(v)
        self.sum += v
        self.sumsq += v * v
        # monotonic deques (amortised O(1))
        lo = self.idx - self.w + 1
        while self.minq and self.minq[0][0] < lo:
            self.minq.popleft()
        while self.maxq and self.maxq[0][0] < lo:
            self.maxq.popleft()
        while self.minq and self.minq[-1][1] >= v:
            self.minq.pop()
        while self.maxq and self.maxq[-1][1] <= v:
            self.maxq.pop()
        self.minq.append((self.idx, v))
        self.maxq.append((self.idx, v))
        self.idx += 1

    def features(self) -> np.ndarray:
        n = max(len(self.buf), 1)
        mean = self.sum / n
        var = max(self.sumsq / n - mean * mean, 0.0)
        arr = None
        # order stats from the ring buffer (O(w log w), done lazily; the
        # hot path above is O(1))
        arr = np.asarray(self.buf, dtype=np.float32)
        med = float(np.median(arr)) if len(arr) else 0.0
        q25 = float(np.quantile(arr, 0.25)) if len(arr) else 0.0
        q75 = float(np.quantile(arr, 0.75)) if len(arr) else 0.0
        t = np.arange(len(arr), dtype=np.float32)
        tc = t - t.mean() if len(arr) else t
        denom = float((tc * tc).sum()) or 1e-9
        slope = float((arr * tc).sum() / denom) if len(arr) else 0.0
        return np.array([
            mean, var ** 0.5,
            self.minq[0][1] if self.minq else 0.0,
            self.maxq[0][1] if self.maxq else 0.0,
            med, q25, q75,
            self.buf[0] if self.buf else 0.0,
            self.buf[-1] if self.buf else 0.0,
            slope, self.sumsq,
            self.abs_change_sum / max(len(self.abs_change), 1),
        ], dtype=np.float32)

    def fast_features(self) -> np.ndarray:
        """Strict O(1) subset (no order statistics) — the fast path used by
        the optimized predictor when the model tolerates 9 features."""
        n = max(len(self.buf), 1)
        mean = self.sum / n
        var = max(self.sumsq / n - mean * mean, 0.0)
        return np.array([
            mean, var ** 0.5,
            self.minq[0][1] if self.minq else 0.0,
            self.maxq[0][1] if self.maxq else 0.0,
            self.buf[0] if self.buf else 0.0,
            self.buf[-1] if self.buf else 0.0,
            self.sumsq,
            self.abs_change_sum / max(len(self.abs_change), 1),
            float(n),
        ], dtype=np.float32)
