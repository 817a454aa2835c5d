"""Predictor model zoo, the inference side (a port of the functional
half of the reference's ``core/zoo.py``, paper §3.2, Table 2).

Every family's trained state is a parameter tree of torch tensors with
the reference's layout, leaf for leaf (the same tuples and lists):

- ``lr``, ``svm``: ``w`` (d + 1,), trailing bias;
- ``xgb``, ``rf``: ``(base, (feats (T, 3), bins (T, 3), leaves (T, 4)),
  edges (d, n_bins - 1))``, depth-2 trees over binned features;
- ``fnn``: ``[(w, b), ...]``, ReLU between layers;
- ``rnn``, ``gru``, ``lstm``: ``((wx, wh, b), (wo, bo))``, a scan over
  the window's w steps;
- ``cnn``: ``((w1, b1, w2, b2), (wo, bo))``, two causal 1-D
  convolutions over time, a global mean pool and a linear head.

:func:`stacked_apply` is the fleet form: every leaf carries a leading
fleet axis B and each model sees its own sample, in one batched forward
(``bmm`` over the fleet, a Python loop over the w time steps for the
recurrent families).  :func:`single_apply` is the same forward at
B = 1.  The products are ``bmm`` on float32, which PyTorch runs without
TF32 unless the caller enables it; the convolution is the reference's
sum of shifted products, not ``conv1d`` (cuDNN runs TF32 by default).
Training (the fit paths) is not ported yet.
"""
from __future__ import annotations

import functools
from typing import Callable, List

import torch

__all__ = ["NONSEQ_MODELS", "SEQ_MODELS", "ALL_MODELS", "single_apply",
           "stacked_apply", "candidates_for", "tree_map", "tree_leaves",
           "gbt_bins"]

#: the families of the reference's zoo (names only; no fit classes)
NONSEQ_MODELS = ("lr", "svm", "xgb", "rf", "fnn")
SEQ_MODELS = ("rnn", "lstm", "gru", "cnn")
ALL_MODELS = NONSEQ_MODELS + SEQ_MODELS


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of equally shaped trees of tuples, lists
    and dicts, keeping each container's type."""
    t0 = trees[0]
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def tree_leaves(tree) -> List:
    """The leaves of a tree of tuples, lists and dicts, in order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def _mv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-model vector-matrix product: x (B, a), w (B, a, b) -> (B, b)."""
    return torch.bmm(x.unsqueeze(1), w).squeeze(1)


# ----------------------------------------------------------------------
def _linear(w, X):
    """X (B, d), w (B, d + 1) -> (B,)."""
    return _mv(X, w[:, :-1].unsqueeze(-1))[:, 0] + w[:, -1]


def gbt_bins(edges: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Bin indices (B, d) of X (B, d) against edges (B, d, n_bins - 1):
    the number of edges strictly below each value (``np.searchsorted``,
    side left), clipped to the last bin, as the reference's
    ``_gbt_apply``."""
    xb = (edges < X.unsqueeze(-1)).sum(-1)
    return torch.clamp(xb, 0, edges.shape[-1])


def _gbt(params, X):
    """X (B, d) -> (B,): every tree's three tests gathered at once, the
    leaves summed over trees onto the base."""
    base, (feats, bins, leaves), edges = params
    xb = gbt_bins(edges, X)                                  # (B, d)
    B, n_trees = feats.shape[:2]
    xf = torch.gather(xb.unsqueeze(1).expand(B, n_trees, xb.shape[1]), 2,
                      feats.long())                          # (B, T, 3)
    go = xf <= bins
    pred = torch.where(go[..., 0],
                       torch.where(go[..., 1], leaves[..., 0],
                                   leaves[..., 1]),
                       torch.where(go[..., 2], leaves[..., 2],
                                   leaves[..., 3]))          # (B, T)
    return base + pred.sum(-1)


def _mlp(params, X):
    h = X
    for w, b in params[:-1]:
        h = torch.relu(_mv(h, w) + b)
    w, b = params[-1]
    return (_mv(h, w) + b)[:, 0]


def _head(h, out):
    wo, bo = out
    return (_mv(h, wo) + bo)[:, 0]


def _rnn_cell(p, h, x):
    wx, wh, b = p
    return torch.tanh(_mv(x, wx) + _mv(h, wh) + b)


def _gru_cell(p, h, x):
    wx, wh, b = p
    H = wh.shape[1]
    zrg = _mv(x, wx) + _mv(h, wh) + b
    z, r = torch.sigmoid(zrg[:, :H]), torch.sigmoid(zrg[:, H:2 * H])
    g = torch.tanh(_mv(x, wx[:, :, 2 * H:]) + _mv(r * h, wh[:, :, 2 * H:])
                   + b[:, 2 * H:])
    return (1 - z) * h + z * g


def _lstm_cell(p, hc, x):
    wx, wh, b = p
    h, c = hc
    ifgo = _mv(x, wx) + _mv(h, wh) + b
    i, f, g, o = torch.chunk(ifgo, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
    c = f * c + i * torch.tanh(g)
    return (o * torch.tanh(c), c)


_CELLS = {"rnn": _rnn_cell, "gru": _gru_cell, "lstm": _lstm_cell}


def _recurrent(family: str, params, X):
    """X (B, k, w) -> (B,): the cell over the w time steps from a zero
    state (a pair (h, c) for the LSTM)."""
    cell_p, out = params
    cell = _CELLS[family]
    h = X.new_zeros((X.shape[0], cell_p[1].shape[1]))
    state = (h, h.clone()) if family == "lstm" else h
    for t in range(X.shape[-1]):
        state = cell(cell_p, state, X[:, :, t])
    return _head(state[0] if family == "lstm" else state, out)


def _conv(h, w, b):
    """Causal 1-D convolution over time as the reference writes it: the
    left-padded input's W shifted slices times their taps, summed."""
    W, n = w.shape[1], h.shape[1]
    pad = torch.nn.functional.pad(h, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + torch.bmm(pad[:, i:i + n, :], w[:, i])
    return torch.relu(out + b.unsqueeze(1))


def _cnn(params, X):
    (w1, b1, w2, b2), out = params
    h = X.transpose(1, 2)                                    # (B, w, k)
    h = _conv(h, w1, b1)
    h = _conv(h, w2, b2)
    return _head(h.mean(dim=1), out)


# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def stacked_apply(family: str):
    """(stacked params, X (B, ...)) -> (B,) predictions: X is (B, d)
    features for the non-sequential families, (B, k, w) windows for the
    sequential ones; every parameter leaf has the leading fleet axis."""
    if family in ("lr", "svm"):
        return _linear
    if family in ("xgb", "rf"):
        return _gbt
    if family == "fnn":
        return _mlp
    if family == "cnn":
        return _cnn
    if family in _CELLS:
        return functools.partial(_recurrent, family)
    raise KeyError(family)


@functools.lru_cache(maxsize=None)
def single_apply(family: str):
    """(params, x) -> scalar prediction; x is (d,) features for the
    non-sequential families, (k, w) windows for the sequential ones."""
    apply = stacked_apply(family)

    def one(params, x):
        return apply(tree_map(lambda p: p.unsqueeze(0), params),
                     x.unsqueeze(0))[0]
    return one


def candidates_for(corr_method: str, n_samples: int):
    """Paper Table 2: candidate models by correlation type + dataset size."""
    if corr_method == "pearson":
        return ["lr", "xgb"]
    if corr_method in ("spearman", "kendall"):
        return ["rf", "xgb", "svm"]
    # distance / mic (non-linear)
    if n_samples < 1_000:
        return ["xgb"]
    if n_samples < 10_000:
        return ["xgb", "fnn"]
    return ["xgb", "fnn", "rnn", "cnn"]
