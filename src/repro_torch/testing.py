"""Synthetic stores and predictor artifacts for the port's tests and
card drives (the counterpart of the reference's ``repro/testing.py``).

:func:`make_store` scrapes standard-normal metrics every 200 ms exactly
as the reference's does, draw for draw, so both packages' stores hold
the same samples.  :func:`random_artifact` builds an
:class:`InferenceArtifact` whose scalers are fitted on seeded windows
the way the reference's ``make_trained_predictor`` fits them, and whose
parameters are :func:`random_params`: trained state's shapes, for
machines where the reference cannot train one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import zoo
from repro_torch.core.features import extract_features
from repro_torch.core.predictor import InferenceArtifact
from repro_torch.monitoring.metrics import (SCRAPE_INTERVAL, MetricsStore,
                                            SimClock)

N_METRICS = 10
WINDOW_S = 5.0
K = 4
#: the reference's model sizes (its fit classes' defaults): recurrent
#: hidden width, CNN channels, FNN hidden layers, GBT rounds and bins
HIDDEN = 32
CHANNELS = 32
FNN_HIDDEN = (64, 32)
GBT_ROUNDS = {"xgb": 150, "rf": 80}
GBT_BINS = 32


def make_store(seed: int = 0, n_scrapes: int = 400,
               capacity_s: float = 120.0, n_metrics: int = N_METRICS,
               names: Optional[Sequence[str]] = None) -> MetricsStore:
    """Store scraped with standard-normal metrics every 200 ms (names
    ``m00``, ``m01``, ... unless given)."""
    rng = np.random.default_rng(seed)
    clock = SimClock()
    store = MetricsStore(capacity_s=capacity_s, clock=clock)
    names = list(names) if names is not None \
        else [f"m{i:02d}" for i in range(n_metrics)]
    for _ in range(n_scrapes):
        store.scrape({n: float(v) for n, v in
                      zip(names, rng.standard_normal(len(names)))})
        clock.advance(SCRAPE_INTERVAL)
    return store


def random_params(family: str, k: int, seed: int = 0):
    """Seeded parameters of one model over k metrics, in the reference's
    shapes and dtypes (float32 weights, int32 tree indices): a stand-in
    for trained state where no trained reference exists.  The output
    layer is scaled so that the normalized prediction sits near 0.5, as
    a trained model's does inside its [0, 1] target range; tree edges
    lie in [0, 1], the min-max scaled features' range.  The
    non-sequential families read k * 12 features."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return torch.from_numpy(
            np.asarray(rng.standard_normal(shape) * s, np.float32))

    def half(*shape):
        return torch.full(shape, 0.5)
    d = k * 12
    if family in ("lr", "svm"):
        return torch.cat([n(d, s=0.1 * d ** -0.5), half(1)])
    if family in ("xgb", "rf"):
        T, nb = GBT_ROUNDS[family], GBT_BINS
        edges = np.sort(rng.uniform(0.0, 1.0, (d, nb - 1)), axis=1)
        trees = (torch.from_numpy(rng.integers(0, d, (T, 3), np.int32)),
                 torch.from_numpy(rng.integers(0, nb, (T, 3), np.int32)),
                 n(T, 4, s=0.01))
        return (half(), trees, torch.from_numpy(edges.astype(np.float32)))
    if family == "fnn":
        sizes = (d,) + FNN_HIDDEN
        return [(n(a, b, s=(2.0 / a) ** 0.5), n(b, s=0.1))
                for a, b in zip(sizes[:-1], sizes[1:])] \
            + [(n(sizes[-1], 1, s=0.1 * sizes[-1] ** -0.5), half(1))]
    H = HIDDEN
    head = (n(H, 1, s=0.1 * H ** -0.5), half(1))
    if family == "cnn":
        c = CHANNELS
        return ((n(3, k, c, s=(3 * k) ** -0.5), n(c, s=0.1),
                 n(3, c, c, s=(3 * c) ** -0.5), n(c, s=0.1)), head)
    gates = {"rnn": 1, "gru": 3, "lstm": 4}[family]
    return ((n(k, gates * H, s=H ** -0.5), n(H, gates * H, s=H ** -0.5),
             n(gates * H, s=0.1)), head)


def random_artifact(app: str, node: str, family: str,
                    metric_names: Sequence[str], window_s: float = WINDOW_S,
                    seed: int = 0, n_samples: int = 64,
                    fast_state: bool = True) -> InferenceArtifact:
    """A seeded artifact over ``metric_names``: scalers fitted on
    ``n_samples`` standard-normal windows and targets in [1, 5] s, as
    the reference's ``make_trained_predictor`` fits them; parameters
    from :func:`random_params`; on the CPU."""
    rng = np.random.default_rng(seed)
    k = len(metric_names)
    w_pts = int(round(window_s / SCRAPE_INTERVAL))
    X_raw = rng.standard_normal((n_samples, k, w_pts)).astype(np.float32)
    y = rng.uniform(1.0, 5.0, n_samples).astype(np.float32)
    seq = family in zoo.SEQ_MODELS
    feats = extract_features(torch.from_numpy(X_raw)).numpy().reshape(
        n_samples, -1)
    return InferenceArtifact(
        app=app, node=node, family=family, sequential=seq,
        metric_names=tuple(metric_names), window_s=window_s,
        params=random_params(family, k, seed=seed),
        scaler_lo=None if seq else feats.min(axis=0),
        scaler_hi=None if seq else feats.max(axis=0),
        seq_lo=X_raw.min(axis=(0, 2))[:, None] if seq else None,
        seq_hi=X_raw.max(axis=(0, 2))[:, None] if seq else None,
        y_lo=float(y.min()), y_hi=float(y.max()), t_inference=1e-4,
        fast_state=fast_state, version=1)
