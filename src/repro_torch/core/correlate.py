"""perfCorrelate-style correlation battery (paper §3.1, Table 1), a port
of the reference's ``core/correlate.py``.

Five correlation families between each monitoring metric and RTT, each
batched over the metrics of ``X`` (m, n) in torch on ``X``'s device:

  pearson   linear                      [-1, 1]
  spearman  monotonic (rank)            [-1, 1]
  kendall   ordinal (tau-a, O(n^2))     [-1, 1]
  distance  general dependence (O(n^2)) [0, 1]
  mic       maximal information coefficient (grid approximation) [0, 1]

:func:`correlate_all` returns the absolute values, so every score lands
in [0, 1] (paper: "The absolute values of the correlation scores are
used").

As in the reference: Spearman uses ordinal ranks (no tie averaging) and
MIC the equal-frequency grids under B(n) = n^0.6.  Ranks and bins come
from stable sorts, as ``jnp.argsort``'s (``torch.argsort`` is not stable
by default, and the store's 0/1 metrics are all ties).  Kendall and
distance subsample every ``n // cap``-th sample past ``cap`` = 1024.

MIC's joint counts of every metric go through the segment-sum kernel,
one launch a grid: the rows are the metrics, the ids ``xb * by + yb``.

Precision: the reference reduces in float32.  Pearson, distance and the
mutual information here reduce in float64 and round the score to
float32 once, so they sit within the reference's own float32 rounding
of it (~1e-7 of unit-scale data).  Kendall's concordance count is a
whole number below 2^24, exact on both sides, and its score equal bit
for bit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.segment_sum import segment_sum

__all__ = ["METHODS", "pearson", "spearman", "kendall", "distance_corr",
           "mic", "correlate_all", "best_method_per_metric"]

METHODS = ("pearson", "spearman", "kendall", "distance", "mic")

_KENDALL_CAP = 1024   # subsample cap for the O(n^2) methods
_DIST_CAP = 1024
#: elements of one (metrics, n, n) block of the pairwise methods
_PAIR_BLOCK = 1 << 24


def _std(xc: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(max(var, eps)) of centred rows."""
    return torch.sqrt(torch.clamp((xc * xc).mean(-1), min=eps))


def pearson(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """X: (m, n) metrics; y: (n,) -> (m,) correlations."""
    Xc = X.double() - X.double().mean(-1, keepdim=True)
    yc = y.double() - y.double().mean()
    cov = (Xc * yc).mean(-1)
    return (cov / (_std(Xc) * _std(yc))).to(X.dtype)


def _ranks(x: torch.Tensor) -> torch.Tensor:
    """Ordinal ranks along the last axis, ties in order of position."""
    order = torch.argsort(x, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def spearman(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return pearson(_ranks(X).float(), _ranks(y).float())


def _subsample(X, y, cap: int):
    n = X.shape[-1]
    if n > cap:
        step = n // cap
        return X[:, : cap * step: step], y[: cap * step: step], cap
    return X, y, n


def _blocks(m: int, n: int):
    """Slices of at most ``_PAIR_BLOCK`` pairwise elements over m rows."""
    per = max(1, _PAIR_BLOCK // max(n * n, 1))
    return [slice(i, min(i + per, m)) for i in range(0, m, per)]


def kendall(X: torch.Tensor, y: torch.Tensor,
            cap: int = _KENDALL_CAP) -> torch.Tensor:
    """Kendall tau-a via pairwise sign agreement (O(n^2), subsampled)."""
    X, y, n = _subsample(X, y, cap)
    sy = torch.sign(y[:, None] - y[None, :])                 # (n, n)
    concord = torch.cat([
        (torch.sign(X[s, :, None] - X[s, None, :]) * sy).sum((1, 2))
        for s in _blocks(X.shape[0], n)]) if X.shape[0] else X.new_zeros(0)
    # the reference's compiled division by a constant is a product with
    # its float32 reciprocal
    return concord * float(np.float32(1.0 / (n * (n - 1))))


def _center_dist(d: torch.Tensor) -> torch.Tensor:
    """Doubly-centred pairwise distances, over the last two axes."""
    return d - d.mean(-2, keepdim=True) - d.mean(-1, keepdim=True) \
        + d.mean((-2, -1), keepdim=True)


def distance_corr(X: torch.Tensor, y: torch.Tensor,
                  cap: int = _DIST_CAP) -> torch.Tensor:
    """Distance correlation (Székely), O(n^2) per metric, subsampled:
    dCor = sqrt(dCov / sqrt(dVarX * dVarY))."""
    X, y, n = _subsample(X, y, cap)
    y64 = y.double()
    By = _center_dist((y64[:, None] - y64[None, :]).abs())
    dvy = torch.clamp((By * By).mean(), min=1e-12)
    out = []
    for s in _blocks(X.shape[0], n):
        x = X[s].double()
        Bx = _center_dist((x[:, :, None] - x[:, None, :]).abs())
        dcov = (Bx * By).mean((1, 2))
        dvx = torch.clamp((Bx * Bx).mean((1, 2)), min=1e-12)
        out.append(torch.sqrt(torch.clamp(dcov / torch.sqrt(dvx * dvy),
                                          min=0.0)))
    return (torch.cat(out) if out else X.new_zeros(0, dtype=torch.float64)
            ).to(X.dtype)


def _mic_grids(n: int) -> Tuple[Tuple[int, int], ...]:
    bmax = max(4.0, n ** 0.6)
    grids = []
    for bx in (2, 3, 4, 6, 8, 12, 16, 24, 32):
        for by in (2, 3, 4, 6, 8, 12, 16, 24, 32):
            if bx * by <= bmax and max(bx, by) >= 2:
                grids.append((bx, by))
    return tuple(grids) or ((2, 2),)


def mic(X: torch.Tensor, y: torch.Tensor, grids=None) -> torch.Tensor:
    """Approximate MIC: max over equal-frequency grids of
    I(x; y) / log min(bx, by).  Each grid's joint counts of all m metrics
    are one segment sum, (m, n) ones into bx * by bins."""
    m, n = X.shape
    if grids is None:
        grids = _mic_grids(n)
    rX, ry = _ranks(X), _ranks(y)                # equal-frequency bins
    ones = torch.ones((m, n), dtype=torch.float32, device=X.device)
    best = torch.full((m,), -math.inf, dtype=torch.float64, device=X.device)
    for bx, by in grids:
        xb = torch.clamp(rX * bx // n, max=bx - 1)
        yb = torch.clamp(ry * by // n, max=by - 1)
        ids = (xb * by + yb).to(torch.int32)
        pxy = segment_sum(ones, ids, bx * by).double() / n
        px = pxy.view(m, bx, by).sum(2)
        py = pxy.view(m, bx, by).sum(1)
        denom = (px[:, :, None] * py[:, None, :]).reshape(m, -1)
        term = pxy * torch.log(pxy / torch.clamp(denom, min=1e-12))
        mi = torch.where(pxy > 0, term, 0.0).sum(-1)
        best = torch.maximum(best, mi / math.log(min(bx, by)))
    return torch.clamp(best, 0.0, 1.0).to(X.dtype)


_FNS = {"pearson": pearson, "spearman": spearman, "kendall": kendall,
        "distance": distance_corr, "mic": mic}


# ----------------------------------------------------------------------
def correlate_all(X, y, methods: Iterable[str] = METHODS,
                  device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """|correlation| of every metric with y, per method.  X: (m, n),
    numpy or tensor, scored in float32 on ``device`` (None: the CUDA
    card); each result is a numpy (m,) array."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    out = {}
    for name in methods:
        v = _FNS[name](X, y).cpu().numpy()
        out[name] = np.abs(np.nan_to_num(v))
    return out


def best_method_per_metric(scores: Dict[str, np.ndarray]):
    """Paper Fig. 4: which method wins per metric. Returns (names, argmax)."""
    names = list(scores)
    stack = np.stack([scores[m] for m in names])     # (methods, m)
    return names, np.argmax(stack, axis=0), stack.max(axis=0)
