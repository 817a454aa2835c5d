"""Closed-loop online prediction: the batched core's lowering of the
reference's ``core/online.py`` (``OnlineFleet``, ``RollingAccuracy``).

In the closed loop, ``predicted`` comes from one ridge predictor per
(trial, app) trained on the RTTs the simulation itself observes, not
from the Eq. 12 accuracy draw.  Its features for a candidate are a
one-hot of the candidate's node plus the per-app busy counts on that
node (D = N + A), read from the same (stale, outage-frozen) occupancy
the Eq. 12 path would use.  A rolling-accuracy tracker per (app, trial)
folds each routed request's relative error once it has completed; with
``fallback_threshold > 0`` trials whose accuracy falls below it route by
queue wait alone (least_conn).

Everything here is a tensor on the core's device with a leading trial
axis; what the host knows before the loop (the retrain steps, which app
each step routed) stays on the host, so nothing here needs a host sync:

* the observation ring holds the last ``Wn = min(online_window, J)``
  routed requests (features, RTT, completion time), slot ``j % Wn`` —
  the reference's rolling list;
* a retrain is one ridge solve per app over the ring's completed rows of
  that app, by Cholesky without its error check (which would sync);
* the tracker folds, at every step, all earlier requests that completed
  since the step before — in request order, as the serial
  ``fold_pending`` does, but vectorised: each app's newly completed
  requests are ranked by a running count and written to ``(pos + rank)
  % Wa``, keeping only the last ``Wa`` when more land in one step (the
  last writer wins).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

#: the reference's defaults (``OnlineFleet(lam=1e-3, min_obs=8)``,
#: ``RollingAccuracy(min_count=8)``)
LAM = 1e-3
MIN_OBS = 8
MIN_COUNT = 8


def retrain_schedule(cfg, req_t: np.ndarray) -> np.ndarray:
    """(J,) bool retrain flags replicating ``OnlineFleet.maybe_retrain``:
    first at ``online_warmup_s``, then every ``retrain_every_s`` (0:
    once, then frozen)."""
    out = np.zeros(len(req_t), bool)
    nxt = float(cfg.online_warmup_s)
    for j, now in enumerate(req_t):
        if now < nxt:
            continue
        out[j] = True
        if cfg.retrain_every_s > 0:
            while nxt <= now:
                nxt += cfg.retrain_every_s
        else:
            nxt = np.inf
    return out


def obs_window(cfg) -> int:
    """Length of the observation ring (the reference's ``online_window``
    list, never longer than the run)."""
    return max(1, min(int(cfg.online_window), int(cfg.n_requests)))


class RollingAccuracy:
    """Rolling relative accuracy per (app, trial) over the last
    ``window`` completed requests (the reference's ``RollingAccuracy``,
    one per app, stacked).

    ``err`` is an (A, Wa + 1, T) ring whose spare slot ``Wa`` takes the
    writes that a later write of the same fold overtakes; ``accuracy =
    1 - mean(min(err, 1))`` over each ring's filled slots, 1.0 where
    nothing was observed; a (app, trial) with fewer than ``MIN_COUNT``
    lifetime observations is always viable."""

    def __init__(self, n_apps: int, n_trials: int, window: int,
                 device=None):
        self.window = max(int(window), 1)
        self.err = torch.zeros((n_apps, self.window + 1, n_trials),
                               dtype=torch.float64, device=device)
        self.pos = torch.zeros((n_apps, n_trials), dtype=torch.int64,
                               device=device)
        self.count = torch.zeros_like(self.pos)

    def fold(self, err: torch.Tensor, new: torch.Tensor,
             app: torch.Tensor) -> None:
        """Fold the requests marked in ``new`` (S, T), in request order:
        request ``s`` of app ``app[s]`` with relative error ``err[s]``.
        Equal to folding them one at a time."""
        A, Wa = self.pos.shape[0], self.window
        S, T = new.shape
        a_idx = app[:, None].expand(S, T)
        hit = new[None] & (app[None, :, None]
                           == torch.arange(A, device=app.device)[:, None,
                                                                 None])
        running = hit.cumsum(1)                               # (A, S, T)
        n = running[:, -1]                                    # (A, T)
        rank = running.gather(0, a_idx[None])[0] - 1         # (S, T)
        keep = new & (rank >= n.gather(0, a_idx) - Wa)
        slot = torch.where(keep, (self.pos.gather(0, a_idx) + rank) % Wa,
                           Wa)
        trial = torch.arange(T, device=app.device)[None, :].expand(S, T)
        self.err.index_put_((a_idx, slot, trial),
                            err.abs().clamp(max=1.0))
        self.pos = (self.pos + n) % Wa
        self.count += n

    def accuracy(self, a: Optional[int] = None) -> torch.Tensor:
        """(A, T) rolling accuracy, or (T,) for app ``a``."""
        err, count = self.err[:, :self.window], self.count
        if a is not None:
            err, count = err[a:a + 1], count[a:a + 1]
        filled = count.clamp(max=self.window)
        slots = torch.arange(self.window, device=err.device)
        valid = slots[None, :, None] < filled[:, None, :]
        esum = torch.where(valid, err, 0.0).sum(1)
        acc = 1.0 - esum / filled.clamp(min=1)
        acc = torch.where(filled > 0, acc, 1.0)
        return acc if a is None else acc[0]

    def viable(self, a: int, threshold: float) -> torch.Tensor:
        """(T,) bool: app ``a``'s accuracy is at least ``threshold``, or
        it has too few observations to say."""
        return (self.count[a] < MIN_COUNT) \
            | (self.accuracy(a) >= threshold)


class OnlineFleet:
    """Per-(trial, app) online ridge predictors on one device: the
    batched core's form of the reference's ``OnlineFleet``.

    ``prior`` (A,) is the app-mean RTT an untrained (trial, app)
    predicts.  The core calls, at each step ``j`` in this order:
    :meth:`fold_pending`, :meth:`retrain` on the host's retrain steps,
    :meth:`predict`, then after the pick :meth:`observe`; after the last
    step a final :meth:`fold_pending` at ``now = inf`` and
    :meth:`stats`."""

    def __init__(self, n_nodes: int, n_apps: int, n_trials: int,
                 n_requests: int, prior, *, obs_window: int,
                 acc_window: int, device=None):
        self.N, self.A = int(n_nodes), int(n_apps)
        self.D = self.N + self.A
        self.Wn = int(obs_window)
        T, J, D = n_trials, int(n_requests), self.D
        f64 = dict(dtype=torch.float64, device=device)
        self.prior = torch.as_tensor(np.asarray(prior, float), **f64)
        self.W = torch.zeros((T, self.A, D), **f64)
        self.trained = torch.zeros((T, self.A), dtype=torch.bool,
                                   device=device)
        # the observation ring: features, RTT, completion time, app
        self.obs_X = torch.zeros((self.Wn, T, D), **f64)
        self.obs_y = torch.zeros((self.Wn, T), **f64)
        self.obs_fin = torch.full((self.Wn, T), float("inf"), **f64)
        self.obs_app = torch.full((self.Wn,), -1, dtype=torch.int64,
                                  device=device)
        # every routed request's relative error and completion time,
        # folded into the tracker once it has completed
        self.pd_err = torch.zeros((J, T), **f64)
        self.pd_fin = torch.full((J, T), float("inf"), **f64)
        self.tracker = RollingAccuracy(self.A, T, acc_window, device=device)
        self._eye = LAM * torch.eye(D, **f64)
        self._trial = torch.arange(T, device=device)

    # ------------------------------------------------------------------
    def fold_pending(self, j: int, now: float, prev: float,
                     req_app: torch.Tensor) -> None:
        """Fold into the tracker every request before ``j`` that has
        completed by ``now`` but had not by ``prev`` (the previous
        step's time; request ``j - 1`` was never checked before)."""
        if j == 0:
            return
        fin = self.pd_fin[:j]
        new = fin <= now
        new[:j - 1] &= fin[:j - 1] > prev
        self.tracker.fold(self.pd_err[:j], new, req_app[:j])

    def retrain(self, now: float) -> None:
        """One ridge solve per (trial, app) over the ring's rows of that
        app that have completed by ``now``; a (trial, app) with fewer
        than ``MIN_OBS`` such rows keeps its weights."""
        done = self.obs_fin <= now                            # (Wn, T)
        for a in range(self.A):
            m = (done & (self.obs_app == a)[:, None]).to(torch.float64)
            Xm = self.obs_X * m[:, :, None]
            G = torch.einsum("wtd,wte->tde", Xm, self.obs_X) + self._eye
            b = torch.einsum("wtd,wt->td", Xm, self.obs_y)
            # G is symmetric positive definite: Cholesky and two
            # triangular solves (cuSOLVER / cuBLAS on the card; the LU
            # of torch.linalg.solve goes to MAGMA there, which blocks
            # the host until the device's queue drains)
            L = torch.linalg.cholesky_ex(G, check_errors=False)[0]
            z = torch.linalg.solve_triangular(L, b[..., None], upper=False)
            Wa = torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]
            ok = m.sum(0) >= MIN_OBS                          # (T,)
            self.W[:, a] = torch.where(ok[:, None], Wa, self.W[:, a])
            self.trained[:, a] |= ok

    def predict(self, a: int, counts: torch.Tensor,
                nodes: torch.Tensor) -> torch.Tensor:
        """(T, K) predicted RTT of app ``a``'s candidates on ``nodes``
        (T, K) under the (A, T, N) busy ``counts``: ``features @ W``
        floored at 1e-3, the app-mean prior where untrained."""
        Wa = self.W[:, a]                                     # (T, D)
        cc = counts.gather(2, nodes[None].expand(self.A, -1, -1))
        y = Wa[:, :self.N].gather(1, nodes) \
            + (cc.to(torch.float64) * Wa[:, self.N:].T[:, :, None]).sum(0)
        y = y.clamp(min=1e-3)
        return torch.where(self.trained[:, a, None], y, self.prior[a])

    def observe(self, j: int, a: int, counts: torch.Tensor,
                node: torch.Tensor, rtt: torch.Tensor, finish: torch.Tensor,
                pred: torch.Tensor) -> None:
        """Record step ``j``'s routed request of every trial: the picked
        candidate's features (its node ``node`` (T,), the busy counts
        there before the dispatch), its true RTT, its completion time
        and what the fleet predicted for it."""
        slot = j % self.Wn
        x = self.obs_X[slot]
        x.zero_()
        x.scatter_(1, node[:, None], 1.0)
        x[:, self.N:] = counts[:, self._trial, node].T.to(torch.float64)
        self.obs_y[slot] = rtt
        self.obs_fin[slot] = finish
        self.obs_app[slot].fill_(a)
        self.pd_err[j] = (pred - rtt).abs() / rtt.clamp(min=1e-9)
        self.pd_fin[j] = finish

    def viable(self, a: int, threshold: float) -> torch.Tensor:
        return self.tracker.viable(a, threshold)

    def stats(self, req_app: np.ndarray, req_t: np.ndarray,
              retrain: np.ndarray) -> Dict[str, object]:
        """The reference's ``OnlineFleet.stats()`` (call it after the
        final fold, at ``now = inf``): per-app versions (one per retrain
        that found rows of the app in the window), the retrain times, the
        trained share of (trial, app) pairs and the (A, T) rolling
        accuracy."""
        steps = np.flatnonzero(retrain)
        versions = np.zeros(self.A, np.int64)
        for j in steps:
            versions[np.unique(req_app[max(0, j - self.Wn):j])] += 1
        return {"versions": versions,
                "retrain_times": [float(req_t[j]) for j in steps],
                "trained_frac": float(self.trained.double().mean()),
                "accuracy": self.tracker.accuracy().cpu().numpy()}
