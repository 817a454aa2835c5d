"""The port's closed-loop fleet (``repro_torch.core.online``) against the
JAX package's ``OnlineFleet`` and ``RollingAccuracy`` (numpy, no jax).

Inputs are made with numpy from a seed and handed to both sides; the
port runs on the CPU.  The tracker folds several completed requests per
step in one vectorised pass; it must equal the reference's one-by-one
updates exactly, also when more requests than the ring holds land in
one step.  The ridge retrain, the features and the prediction agree to
rounding (1e-9 relative on the weights, 1e-10 on predictions: the
solves are well conditioned at these sizes).
"""
import numpy as np
import pytest
import torch

from repro.core.online import OnlineFleet as RefFleet
from repro.core.online import RollingAccuracy as RefAccuracy
from repro_torch.core.online import (OnlineFleet, RollingAccuracy,
                                     retrain_schedule)
from repro_torch.core.scenarios import get_scenario


@pytest.mark.parametrize("window", [1, 3, 7, 40])
def test_rolling_accuracy_fold_matches_one_by_one(window):
    rng = np.random.default_rng(window)
    A, T = 3, 5
    ref = [RefAccuracy(window, n=T) for _ in range(A)]
    port = RollingAccuracy(A, T, window)
    biggest = 0
    for _ in range(30):
        S = int(rng.integers(0, 3 * A * window + 4))
        app = rng.integers(0, A, size=S)
        err = rng.random((S, T)) * 1.6 - 0.3     # some past 1, some < 0
        new = rng.random((S, T)) < 0.6
        for s in range(S):
            ref[app[s]].update(err[s], new[s])
        if S:
            port.fold(torch.as_tensor(err), torch.as_tensor(new),
                      torch.as_tensor(app))
            per_cell = [(new[app == a].sum(0)).max() for a in range(A)]
            biggest = max(biggest, max(per_cell))
        want = np.stack([r.accuracy() for r in ref])
        np.testing.assert_allclose(port.accuracy().numpy(), want,
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(port.count.numpy(),
                                      np.stack([r.count for r in ref]))
        for a in range(A):
            np.testing.assert_array_equal(port.viable(a, 0.6).numpy(),
                                          ref[a].viable(0.6))
    assert biggest > window      # more folds than the ring in one step


def _counts(busy_until, now, node_of, app_of, A, N):
    """(A, T, N) busy replicas per (app, node)."""
    T = len(node_of)
    out = np.zeros((A, T, N), np.int32)
    t, r = np.nonzero(busy_until > now)
    np.add.at(out, (app_of[r], t, node_of[t, r]), 1)
    return out


@pytest.mark.parametrize("window", [30, 400])
def test_fleet_retrain_features_predict_match_reference(window):
    """Random routing through both fleets: features, predictions, the
    ridge weights after every retrain, the tracker after every fold and
    the final stats.  ``window`` 30 wraps the observation ring."""
    rng = np.random.default_rng(7)
    T, A, K, N, J = 4, 3, 5, 6, 60
    node_of = rng.integers(0, N, size=(T, A * K))
    app_of = np.repeat(np.arange(A), K)
    prior = np.array([1.0, 2.0, 0.6])
    ref = RefFleet(node_of, app_of, N, A, prior, warmup_s=6.0,
                   retrain_every_s=4.0, window=window, accuracy_window=9)
    Wn = min(window, J)
    port = OnlineFleet(N, A, T, J, prior, obs_window=Wn, acc_window=9)
    req_app = rng.integers(0, A, size=J)
    req_t = np.cumsum(rng.exponential(0.5, size=J))
    cfg = get_scenario("drift-fallback").compile(
        seed=0, online_warmup_s=6.0, retrain_every_s=4.0, n_requests=J)
    retrain = retrain_schedule(cfg, req_t)
    app_dev = torch.as_tensor(req_app)
    busy = np.zeros((T, A * K))
    trial = np.arange(T)
    n_retrains = 0
    for j in range(J):
        a, now = int(req_app[j]), float(req_t[j])
        prev = float(req_t[j - 1]) if j else -np.inf
        ref.fold_pending(now)
        port.fold_pending(j, now, prev, app_dev)
        assert ref.maybe_retrain(now) == retrain[j]
        if retrain[j]:
            port.retrain(now)
            n_retrains += 1
            np.testing.assert_allclose(port.W.numpy(), ref.W, rtol=1e-9,
                                       atol=1e-9)
            np.testing.assert_array_equal(port.trained.numpy(), ref.trained)
        cand = np.arange(a * K, (a + 1) * K)
        X = ref.features(a, cand, busy, now)
        want = ref.predict(a, X)
        counts = torch.as_tensor(_counts(busy, now, node_of, app_of, A, N))
        nodes = torch.as_tensor(node_of[:, cand])
        got = port.predict(a, counts, nodes)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-12)
        picks = rng.integers(0, K, size=T)
        rtt = rng.gamma(2.0, prior[a] / 2.0, size=T)
        finish = np.maximum(now, busy[trial, cand[picks]]) + rtt
        ref.observe(a, X[trial, picks], rtt, finish, want[trial, picks])
        port.observe(j, a, counts, nodes[trial, picks], torch.as_tensor(rtt),
                     torch.as_tensor(finish), got[trial, picks])
        np.testing.assert_array_equal(port.obs_X[j % Wn].numpy(),
                                      X[trial, picks])
        busy[trial, cand[picks]] = finish
        for a_ in range(A):
            np.testing.assert_allclose(port.tracker.accuracy(a_).numpy(),
                                       ref.accuracy(a_), rtol=1e-12)
    assert n_retrains >= 5 and ref.trained.all()
    ref.fold_pending(np.inf)
    port.fold_pending(J, np.inf, float(req_t[-1]), app_dev)
    want, got = ref.stats(), port.stats(req_app, req_t, retrain)
    np.testing.assert_array_equal(got["versions"], want["versions"])
    np.testing.assert_allclose(got["retrain_times"], want["retrain_times"])
    assert got["trained_frac"] == want["trained_frac"]
    np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                               rtol=1e-12)


def test_retrain_schedule_matches_maybe_retrain():
    rng = np.random.default_rng(3)
    req_t = np.cumsum(rng.exponential(1.0, size=300))
    for warmup, every in ((40.0, 12.0), (20.0, 0.0), (0.0, 5.0)):
        cfg = get_scenario("tier-drift").compile(
            seed=0, online_warmup_s=warmup, retrain_every_s=every)
        ref = RefFleet(np.zeros((1, 4), int), np.arange(4), 1, 4,
                       np.ones(4), warmup_s=warmup, retrain_every_s=every)
        want = np.array([ref.maybe_retrain(float(t)) for t in req_t])
        np.testing.assert_array_equal(retrain_schedule(cfg, req_t), want)
