"""Dynamic dataset balancing with the Freedman–Diaconis rule (paper §3.1,
Eqs. 1–3).

A copy of the reference's ``core/binning.py`` (host numpy, the same
``"binning-balance"`` stream), so both packages keep the same samples.

Add-only: new samples are admitted per-bin up to the current maximum bin
count C_max; removals are avoided because each RTT's monitoring payload is
~3 orders of magnitude larger than the RTT itself (paper: 77 B vs >500 kB).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.rng import rng_stream


def freedman_diaconis_bins(values: np.ndarray):
    """Eq. 1–2: bin width h = 2*IQR/N^(1/3); returns (n_bins, edges)."""
    v = np.asarray(values, dtype=np.float64)
    n = len(v)
    q75, q25 = np.percentile(v, [75, 25])
    iqr = q75 - q25
    h = 2.0 * iqr / max(n, 1) ** (1.0 / 3.0)
    lo, hi = float(v.min()), float(v.max())
    if h <= 0 or hi <= lo:
        return 1, np.array([lo, max(hi, lo + 1e-9)])
    nb = int(np.ceil((hi - lo) / h))
    nb = max(1, min(nb, 10_000))
    edges = lo + np.arange(nb + 1) * h
    edges[-1] = max(edges[-1], hi)
    return nb, edges


@dataclass
class BalancedDataset:
    """Reservoir of (rtt, payload) kept near-uniform over RTT bins."""
    c_max: Optional[int] = None       # None -> derived as max bin count
    seed: int = 0
    rtts: np.ndarray = field(default_factory=lambda: np.empty((0,), np.float64))
    payload_idx: List[int] = field(default_factory=list)
    _store: List[object] = field(default_factory=list)
    n_seen: int = 0
    n_dropped: int = 0

    def __post_init__(self):
        self._rng = rng_stream(self.seed, "binning-balance")

    def __len__(self):
        return len(self.rtts)

    def payloads(self) -> List[object]:
        return [self._store[i] for i in self.payload_idx]

    def add_batch(self, new_rtts: Sequence[float],
                  new_payloads: Optional[Sequence[object]] = None) -> np.ndarray:
        """Returns boolean mask over new samples: kept or dropped."""
        new_rtts = np.asarray(list(new_rtts), dtype=np.float64)
        if new_payloads is None:
            new_payloads = [None] * len(new_rtts)
        self.n_seen += len(new_rtts)

        if len(self.rtts) == 0:
            # Case 1: no existing data — keep everything (paper §3.1)
            keep = np.ones(len(new_rtts), dtype=bool)
            self._append(new_rtts, new_payloads, keep)
            return keep

        # Case 2: recompute bins over combined data (Eq. 1–2)
        combined = np.concatenate([self.rtts, new_rtts])
        nb, edges = freedman_diaconis_bins(combined)
        old_bins = np.clip(np.digitize(self.rtts, edges[1:-1]), 0, nb - 1)
        new_bins = np.clip(np.digitize(new_rtts, edges[1:-1]), 0, nb - 1)
        counts = np.bincount(old_bins, minlength=nb)
        c_max = self.c_max if self.c_max is not None else int(counts.max())

        keep = np.zeros(len(new_rtts), dtype=bool)
        for b in np.unique(new_bins):
            gap = max(c_max - int(counts[b]), 0)            # Eq. 3
            idx = np.flatnonzero(new_bins == b)
            if gap >= len(idx):
                keep[idx] = True
            elif gap > 0:
                keep[self._rng.choice(idx, size=gap, replace=False)] = True
        if not keep.any() and len(new_rtts):
            # keep one random sample so the dataset keeps evolving (paper)
            keep[self._rng.integers(len(new_rtts))] = True
        self._append(new_rtts, new_payloads, keep)
        return keep

    def _append(self, rtts, payloads, keep):
        kept = np.flatnonzero(keep)
        for i in kept:
            self._store.append(payloads[i])
            self.payload_idx.append(len(self._store) - 1)
        self.rtts = np.concatenate([self.rtts, rtts[kept]])
        self.n_dropped += int(len(rtts) - len(kept))

    @property
    def reduction(self) -> float:
        """Fraction of seen samples dropped (paper Fig. 8)."""
        return self.n_dropped / max(self.n_seen, 1)
