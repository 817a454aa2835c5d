"""tsfresh-style statistical features over metric windows (a port of the
inference half of the reference's ``core/features.py``).

:func:`extract_features` maps ``(..., w)`` windows to the same twelve
features, in the same order, as the reference.  Two torch defaults
differ from jnp's and are overridden: ``torch.median`` returns the lower
middle value (jnp averages the two), and ``torch.quantile`` interpolates
with ``lerp``, so the order statistics come from one sort with jnp's own
formulas (midpoint median, linear q25 / q75); ``torch.std`` divides by
``w - 1`` (jnp by ``w``), so it takes ``correction=0``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["FEATURE_NAMES", "extract_features"]

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
