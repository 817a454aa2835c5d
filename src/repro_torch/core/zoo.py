"""Predictor model zoo (paper §3.2, Table 2), a port of the reference's
``core/zoo.py``: the fit classes and the functional inference.

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
recurrent families).  The same forwards take one model's tree without
that axis and apply it to a batch of samples: the fit classes train and
predict through them.  :func:`single_apply` is the fleet form at B = 1.
The products run on float32, which PyTorch runs without TF32 unless the
caller enables it; the convolution is the reference's sum of shifted
products, not ``conv1d`` (cuDNN runs TF32 by default).

The fit classes (:data:`FIT_CLASSES`) keep the reference's constructors,
defaults and ``fit`` / ``partial_fit`` / ``predict`` /
``inference_params``, plus ``device`` (None: the CUDA card).  Inputs
may be numpy arrays or tensors; predictions are float32 tensors on the
model's device.  Where the reference computes on the host, so does the
port: ``lr`` solves in float64 numpy, and the trees' edges
(``np.quantile`` / ``np.unique``, padded with +inf) and bins
(``np.searchsorted``, side left, clipped) are numpy.

- The trees' split search sums its histograms with the segment-sum
  kernel: the d count rows and the d residual rows of one search are one
  (2d, n) float64 launch into n_bins bins.  The counts are whole numbers
  (exact); the residual sums are float64 atomics, the gains are compared
  in float64 rounded to 32 significant bits and the leaves rounded to
  float32 (the reference: float32 throughout).  ``argmax`` keeps the
  first maximum, the chosen column is picked with a device tensor and no
  value is read on the host inside the rounds.  Splits that cut the
  training rows alike (identical or mirrored columns) have equal gains
  in exact arithmetic: the rounding makes them tie on every device, so
  the first is taken, where the reference's float32 rounding takes
  either.  Such trees agree with the reference's by the partition of the
  training rows each split makes, not by column index.
- ``fnn`` and the sequential families train by the reference's explicit
  Adam update (eps outside the root, bias corrections in float32) on
  autograd's gradients; on the card one step is a CUDA graph, replayed.
  Their initial parameters come from ``init`` when given (the
  reference's, carried across, to replay its fits), else from a CPU
  ``torch.Generator`` seeded by ``seed`` with the reference's shapes and
  scales (the same on every device; the jax PRNG itself cannot be
  replayed).
- ``svm`` descends the reference's loss by autograd, the hinge as
  ``torch.maximum`` against zeros, which splits a tie 0.5 / 0.5 as
  ``jnp.maximum`` does.
"""
from __future__ import annotations

import functools
from typing import Callable, List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.tree import tree_map

__all__ = ["NONSEQ_MODELS", "SEQ_MODELS", "ALL_MODELS", "FIT_CLASSES",
           "LinearRegression", "SVRLinear", "GBT", "RandTrees", "FNN",
           "RNN", "GRU", "LSTM", "CNN", "from_params", "single_apply",
           "stacked_apply", "candidates_for", "tree_map", "tree_leaves",
           "gbt_bins"]

#: the families of the reference's zoo, by name (the classes:
#: :data:`FIT_CLASSES`)
NONSEQ_MODELS = ("lr", "svm", "xgb", "rf", "fnn")
SEQ_MODELS = ("rnn", "lstm", "gru", "cnn")
ALL_MODELS = NONSEQ_MODELS + SEQ_MODELS


def tree_leaves(tree) -> List:
    """The leaves of a tree of tuples, lists and dicts, in order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def _tree_unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _mv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Vector-matrix products: x (B, a) with w (B, a, b), one matrix per
    row (the fleet), or with w (a, b), one shared matrix -> (B, b)."""
    return torch.matmul(x.unsqueeze(-2), w).squeeze(-2)


# ----------------------------------------------------------------------
def _linear(w, X):
    """X (B, d), w (B, d + 1) or (d + 1,) -> (B,)."""
    return _mv(X, w[..., :-1].unsqueeze(-1))[:, 0] + w[..., -1]


def gbt_bins(edges: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Bin indices (B, d) of X (B, d) against edges (B, d, n_bins - 1)
    or (d, n_bins - 1): the number of edges strictly below each value
    (``np.searchsorted``, side left), clipped to the last bin, as the
    reference's ``_gbt_apply``."""
    xb = (edges < X.unsqueeze(-1)).sum(-1)
    return torch.clamp(xb, 0, edges.shape[-1])


def _gbt_trees(xb: torch.Tensor, base, trees) -> torch.Tensor:
    """Bins xb (B, d) -> (B,): every tree's three tests gathered at once,
    the leaves summed over trees onto the base.  The trees carry the
    fleet axis B, or are one model's, shared by every row."""
    feats, bins, leaves = trees
    if feats.dim() == 2:
        feats = feats.expand(xb.shape[0], *feats.shape)
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


def _gbt(params, X):
    base, trees, edges = params
    return _gbt_trees(gbt_bins(edges, X), base, trees)


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
    H = wh.shape[-2]
    zrg = _mv(x, wx) + _mv(h, wh) + b
    z, r = torch.sigmoid(zrg[:, :H]), torch.sigmoid(zrg[:, H:2 * H])
    g = torch.tanh(_mv(x, wx[..., 2 * H:]) + _mv(r * h, wh[..., 2 * H:])
                   + b[..., 2 * H:])
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
    h = X.new_zeros((X.shape[0], cell_p[1].shape[-2]))
    state = (h, h.clone()) if family == "lstm" else h
    for t in range(X.shape[-1]):
        state = cell(cell_p, state, X[:, :, t])
    return _head(state[0] if family == "lstm" else state, out)


def _conv(h, w, b):
    """Causal 1-D convolution over time as the reference writes it: the
    left-padded input's W shifted slices times their taps, summed."""
    W, n = w.shape[-3], h.shape[1]
    pad = torch.nn.functional.pad(h, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + torch.matmul(pad[:, i:i + n, :], w[..., i, :, :])
    return torch.relu(out + b.unsqueeze(-2))


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
    sequential ones; every parameter leaf has the leading fleet axis.
    Given one model's tree (no fleet axis), it applies that model to
    every row of X."""
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


# ----------------------------------------------------------------------
# the fit classes
class _Base:
    sequential = False
    name = "base"

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _inputs(self, X) -> torch.Tensor:
        X = self._f32(X)
        return X[None] if X.ndim == (2 if self.sequential else 1) else X

    def fit(self, X, y):
        raise NotImplementedError

    def partial_fit(self, X, y):
        return self.fit(X, y)

    def predict(self, X) -> torch.Tensor:
        """(n, ...) samples, or one -> (n,) float32 on the device."""
        return stacked_apply(self.name)(self.inference_params(),
                                        self._inputs(X))

    def inference_params(self):
        """Trained state as the zoo's parameter tree."""
        raise NotImplementedError


class LinearRegression(_Base):
    name = "lr"

    def __init__(self, l2: float = 1e-4, device: DeviceLike = None):
        super().__init__(device)
        self.l2 = l2
        self.w = None

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        A = Xb.T @ Xb + self.l2 * np.eye(Xb.shape[1])
        self.w = self._f32(np.linalg.solve(A, Xb.T @ y))
        return self

    def inference_params(self):
        return self.w


class SVRLinear(_Base):
    """Linear epsilon-insensitive SVR trained by gradient descent (SVM
    stand-in)."""
    name = "svm"

    def __init__(self, epsilon: float = 0.05, l2: float = 1e-4,
                 lr: float = 0.05, epochs: int = 200, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(device)
        self.epsilon, self.l2, self.lr, self.epochs = epsilon, l2, lr, epochs
        self.seed = seed
        self.w = None

    def fit(self, X, y):
        X, y = self._f32(X), self._f32(y)
        w = torch.zeros(X.shape[1] + 1, device=self.device,
                        requires_grad=True)
        for _ in range(self.epochs):
            pred = X @ w[:-1] + w[-1]
            # |pred - y| has its kink where err = -epsilon < 0, on the
            # flat side of the hinge: abs's subgradient there (0 in
            # torch, 1 in jax) is multiplied by 0
            err = (pred - y).abs() - self.epsilon
            loss = torch.maximum(err, torch.zeros_like(err)).mean() \
                + self.l2 * (w[:-1] ** 2).sum()
            g, = torch.autograd.grad(loss, w)
            w = (w - self.lr * g).detach().requires_grad_()
        self.w = w.detach()
        return self

    def partial_fit(self, X, y):
        if self.w is None:
            return self.fit(X, y)
        old = self.w
        self.epochs, e = 50, self.epochs
        self.fit(X, y)
        self.epochs = e
        self.w = 0.5 * old + 0.5 * self.w
        return self

    def inference_params(self):
        return self.w


# ----------------------------------------------------------------------
def _gbt_fit(Xb: torch.Tensor, y: torch.Tensor, n_rounds: int,
             n_bins: int, lr: float):
    """Histogram gradient boosting with depth-2 trees: per round, every
    (feature, bin) split is scored from cumulative sums of the count and
    residual histograms; each child gets a second-level split chosen the
    same way.  Xb: (n, d) int32 bins on the device; y: (n,) float32.
    Returns (base, (feats, bins, leaves)) on the device."""
    n, d = Xb.shape
    ids = Xb.t().contiguous().repeat(2, 1)                   # (2d, n)
    vals = torch.empty((2 * d, n), dtype=torch.float64, device=Xb.device)

    def take(t, i):
        return t.reshape(-1).index_select(0, i)

    def best_split(res, mask):
        """mask: (n,) membership -> (feat, bin, left mean, right mean),
        each a (1,) tensor."""
        vals[:d] = mask
        vals[d:] = mask * res
        h = segment_sum(vals, ids, n_bins)                   # (2d, B)
        ccnt = h[:d].cumsum(1)
        csum = h[d:].cumsum(1)
        tot_c, tot_s = ccnt[:, -1:], csum[:, -1:]
        lc = torch.clamp(ccnt, min=1e-9)
        rc = torch.clamp(tot_c - ccnt, min=1e-9)
        gain = csum ** 2 / lc + (tot_s - csum) ** 2 / rc     # (d, B)
        gain = torch.where((ccnt > 0) & (tot_c - ccnt > 0), gain,
                           -torch.inf)
        # splits that cut the rows alike (identical or mirrored columns)
        # tie in exact arithmetic; their float64 gains differ by the
        # histograms' rounding, whose order differs between the CPU's
        # sums and the card's atomics.  Rounded to 32 significant bits
        # they tie exactly, and argmax takes the first on every device.
        m, e = torch.frexp(gain)
        gain = torch.ldexp(torch.round(m * 2.0 ** 32) / 2.0 ** 32, e)
        flat = gain.reshape(-1).argmax().reshape(1)          # first max
        f, b = flat // n_bins, flat % n_bins
        lmean = take(csum, flat) / take(lc, flat)
        rmean = (take(tot_s, f) - take(csum, flat)) / take(rc, flat)
        return f, b, lmean, rmean

    def below(f, b):
        return Xb.index_select(1, f)[:, 0] <= b

    base = y.mean()
    res = y - base
    full = torch.ones(n, dtype=torch.float32, device=Xb.device)
    feats, bins, leaves = [], [], []
    for _ in range(n_rounds):
        f0, b0, _, _ = best_split(res, full)
        left = below(f0, b0).float()
        right = 1.0 - left
        f1, b1, lm1, rm1 = best_split(res, left)
        f2, b2, lm2, rm2 = best_split(res, right)
        l2, r2 = below(f1, b1), below(f2, b2)
        ll, lr_ = left * l2, left * ~l2
        rl, rr = right * r2, right * ~r2
        leaf = (torch.cat([lm1, rm1, lm2, rm2]) * lr).float()
        res = res - (ll * leaf[0] + lr_ * leaf[1] + rl * leaf[2]
                     + rr * leaf[3])
        feats.append(torch.cat([f0, f1, f2]))
        bins.append(torch.cat([b0, b1, b2]))
        leaves.append(leaf)
    trees = (torch.stack(feats).int(), torch.stack(bins).int(),
             torch.stack(leaves))
    return base, trees


class GBT(_Base):
    """Histogram gradient-boosted depth-2 trees (XGBoost stand-in)."""
    name = "xgb"

    def __init__(self, n_rounds: int = 150, n_bins: int = 32,
                 lr: float = 0.1, device: DeviceLike = None):
        super().__init__(device)
        self.n_rounds, self.n_bins, self.lr = n_rounds, n_bins, lr
        self.edges = None

    def _bin(self, X) -> torch.Tensor:
        X = np.asarray(X, np.float32)
        idx = np.zeros(X.shape, np.int32)
        for j in range(X.shape[1]):
            idx[:, j] = np.clip(np.searchsorted(self.edges[j], X[:, j]),
                                0, self.n_bins - 1)
        return torch.as_tensor(idx, device=self.device)

    def _set_edges(self, edges) -> None:
        self.edges = edges
        # the artifact's edges: every row is padded to n_bins - 1, so the
        # stack is rectangular; float32, as the reference's jnp array
        self._edges_t = self._f32(np.stack(edges))

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        edges = [np.unique(np.quantile(X[:, j], qs))
                 for j in range(X.shape[1])]
        self._set_edges([np.pad(e, (0, self.n_bins - 1 - len(e)),
                                constant_values=np.inf) for e in edges])
        self.base, self.trees = _gbt_fit(self._bin(X), self._f32(y),
                                         self.n_rounds, self.n_bins, self.lr)
        return self

    def partial_fit(self, X, y):
        # boosted trees retrain on the full dataset with kept hyperparams
        return self.fit(X, y)

    def predict(self, X) -> torch.Tensor:
        X = np.asarray(X.cpu() if torch.is_tensor(X) else X, np.float32)
        return _gbt_trees(self._bin(X.reshape(-1, X.shape[-1])), self.base,
                          self.trees)

    def inference_params(self):
        return (self.base, self.trees, self._edges_t)


class RandTrees(GBT):
    """The Random-Forest stand-in: ``GBT`` with 80 rounds at rate 1/80 (as
    the reference's: its docstring's bootstrap is not in its code)."""
    name = "rf"

    def __init__(self, n_rounds: int = 80, n_bins: int = 32,
                 device: DeviceLike = None):
        super().__init__(n_rounds=n_rounds, n_bins=n_bins,
                         lr=1.0 / n_rounds, device=device)


# ----------------------------------------------------------------------
def _bias_correction(beta: float, t: int) -> float:
    """1 - beta^t in float32, as the reference's scan computes it."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(t))


#: Adam steps a fit on the card runs eagerly (on a side stream) before it
#: captures one step in a CUDA graph
_GRAPH_WARMUP = 3


def _adam(forward: Callable, params, X, y, epochs: int, lr: float):
    """``epochs`` full-batch Adam steps on mean((forward(p, X) - y)^2):
    the reference's update, m / v in the parameters' dtype, eps outside
    the root, the bias corrections read from a table by a step counter on
    the device.  On a CUDA card one step is captured in a CUDA graph and
    replayed for the rest: the same kernels in the same order, without
    the host's launches (a recurrent step is ~40 small kernels a time
    step, so the eager loop is bound by the host)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    leaves = [p.detach().clone().requires_grad_()
              for p in tree_leaves(params)]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    corr = torch.tensor([[_bias_correction(b1, t), _bias_correction(b2, t)]
                         for t in range(1, epochs + 1)],
                        dtype=leaves[0].dtype, device=X.device)
    t = torch.zeros(1, dtype=torch.long, device=X.device)

    def step():
        loss = ((forward(_tree_unflatten(params, leaves), X) - y) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
        c1, c2 = corr.index_select(0, t)[0]
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i].mul_(b1).add_((1 - b1) * g)
                v[i].mul_(b2).add_((1 - b2) * g * g)
                leaves[i].sub_(lr * (m[i] / c1)
                               / (torch.sqrt(v[i] / c2) + eps))
            t.add_(1)

    if X.device.type != "cuda" or epochs <= _GRAPH_WARMUP:
        for _ in range(epochs):
            step()
    else:
        side = torch.cuda.Stream(X.device)
        side.wait_stream(torch.cuda.current_stream(X.device))
        with torch.cuda.stream(side):
            for _ in range(_GRAPH_WARMUP):
                step()
        torch.cuda.current_stream(X.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(epochs - _GRAPH_WARMUP):
            graph.replay()
    return _tree_unflatten(params, [p.detach() for p in leaves])


class _Adam(_Base):
    """The families trained by Adam from drawn initial parameters."""
    partial_epochs = 0

    def __init__(self, lr: float, epochs: int, seed: int, init,
                 device: DeviceLike):
        super().__init__(device)
        self.lr, self.epochs, self.seed, self.init = lr, epochs, seed, init
        self.params = None

    def _draw(self, gen: torch.Generator, d_in: int):
        raise NotImplementedError

    def _initial(self, d_in: int):
        if self.init is not None:
            return tree_map(lambda p: self._f32(p).clone(), self.init)
        gen = torch.Generator().manual_seed(self.seed)
        return tree_map(lambda p: p.to(self.device), self._draw(gen, d_in))

    def fit(self, X, y):
        X, y = self._f32(X), self._f32(y)
        self.params = _adam(stacked_apply(self.name),
                            self._initial(X.shape[1]), X, y, self.epochs,
                            self.lr)
        return self

    def partial_fit(self, X, y):
        if self.params is None:
            return self.fit(X, y)
        self.params = _adam(stacked_apply(self.name), self.params,
                            self._f32(X), self._f32(y), self.partial_epochs,
                            self.lr)
        return self

    def inference_params(self):
        return self.params


def _normal(gen, *shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * scale


class FNN(_Adam):
    name = "fnn"
    partial_epochs = 50

    def __init__(self, hidden=(64, 32), lr=1e-3, epochs=300, seed=0,
                 init=None, device: DeviceLike = None):
        super().__init__(lr, epochs, seed, init, device)
        self.hidden = hidden

    def _draw(self, gen, d_in):
        sizes = (d_in, *self.hidden, 1)
        return [(_normal(gen, a, b, scale=(2.0 / a) ** 0.5), torch.zeros(b))
                for a, b in zip(sizes[:-1], sizes[1:])]


class _Recurrent(_Adam):
    """Shared scaffolding of RNN / GRU / LSTM / CNN over (n, k_metrics, w)
    windows."""
    sequential = True
    hidden = 32
    gates = 1
    partial_epochs = 40

    def __init__(self, lr=1e-2, epochs=300, seed=0, init=None,
                 device: DeviceLike = None):
        super().__init__(lr, epochs, seed, init, device)

    def _draw(self, gen, d_in):
        H, G = self.hidden, self.gates
        s = H ** -0.5
        cell = (_normal(gen, d_in, G * H, scale=s),
                _normal(gen, H, G * H, scale=s), torch.zeros(G * H))
        return (cell, (_normal(gen, H, 1, scale=s), torch.zeros(1)))


class RNN(_Recurrent):
    name = "rnn"


class GRU(_Recurrent):
    name = "gru"
    gates = 3


class LSTM(_Recurrent):
    name = "lstm"
    gates = 4


class CNN(_Recurrent):
    """1-D conv over the time axis, 2 layers + global pool + linear."""
    name = "cnn"
    channels = 32

    def _draw(self, gen, d_in):
        c = self.channels
        return ((_normal(gen, 3, d_in, c, scale=(d_in * 3) ** -0.5),
                 torch.zeros(c),
                 _normal(gen, 3, c, c, scale=(c * 3) ** -0.5),
                 torch.zeros(c)),
                (_normal(gen, c, 1, scale=c ** -0.5), torch.zeros(1)))


#: family name -> fit class
FIT_CLASSES = {"lr": LinearRegression, "svm": SVRLinear, "xgb": GBT,
               "rf": RandTrees, "fnn": FNN, "rnn": RNN, "lstm": LSTM,
               "gru": GRU, "cnn": CNN}


def from_params(family: str, params):
    """A fit object of ``family`` holding ``params`` (the zoo's layout)
    as its trained state, on the device of its leaves: what a predictor
    whose parameters were carried across or seeded holds as its model."""
    dev = tree_leaves(params)[0].device
    if family in ("lr", "svm"):
        model = FIT_CLASSES[family](device=dev)
        model.w = params
    elif family in ("xgb", "rf"):
        base, model_trees, edges = params
        model = FIT_CLASSES[family](n_bins=edges.shape[-1] + 1, device=dev)
        model.base, model.trees = base, model_trees
        model._set_edges(list(edges.cpu().numpy()))
    else:
        kw = {"hidden": tuple(w.shape[-1] for w, _ in params[:-1])} \
            if family == "fnn" else {}
        model = FIT_CLASSES[family](device=dev, **kw)
        model.params = params
    return model


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
