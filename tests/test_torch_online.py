"""The port's closed-loop fleet (``repro_torch.core.online``) against the
JAX package's ``OnlineFleet`` and ``RollingAccuracy`` (numpy, no jax):
the stacked tracker of the batched core and the router's (n,)-axis
copy.

Inputs are made with numpy from a seed and handed to both sides; the
port runs on the CPU.  The tracker folds several completed requests per
step in one vectorised pass; it must equal the reference's one-by-one
updates exactly, also when more requests than the ring holds land in
one step.  The ridge retrain, the features and the prediction agree to
rounding (1e-9 relative on the weights, 1e-10 on predictions: the
solves are well conditioned at these sizes).

The serving side's ``OnlineAdapter`` and ``PredictionManager.
online_adapter`` replay the reference's ``tests/test_online.py`` hot-swap,
cadence, manager and viability tests on port predictors
(``repro_torch.testing.make_trained_predictor``) and planes, on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core.online import OnlineFleet as RefFleet
from repro.core.online import RollingAccuracy as RefAccuracy
from repro_torch.core.features import extract_features
from repro_torch.core.manager import PredictionManager
from repro_torch.core.online import (OnlineAdapter, OnlineFleet,
                                     RollingAccuracy, StackedAccuracy,
                                     retrain_schedule)
from repro_torch.core.prediction_plane import PredictionPlane
from repro_torch.core.scenarios import get_scenario
from repro_torch.testing import make_store, make_trained_predictor


@pytest.mark.parametrize("window", [1, 3, 7, 40])
def test_rolling_accuracy_fold_matches_one_by_one(window):
    rng = np.random.default_rng(window)
    A, T = 3, 5
    ref = [RefAccuracy(window, n=T) for _ in range(A)]
    port = StackedAccuracy(A, T, window)
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


@pytest.mark.parametrize("window,n", [(1, 1), (5, 3), (40, 4)])
def test_router_rolling_accuracy_matches_reference(window, n):
    """The (n,)-axis tracker the router folds into: the reference's
    ``update`` / ``accuracy`` / ``viable`` / ``count`` exactly, with and
    without masks, past the ring's wrap and the evidence floor."""
    rng = np.random.default_rng(window * 10 + n)
    ref, port = RefAccuracy(window, n=n), RollingAccuracy(window, n=n)
    assert port.min_count == ref.min_count and port.window == ref.window
    for step in range(3 * window + 12):
        err = rng.random(n) * 1.6 - 0.3
        mask = None if step % 3 == 0 else rng.random(n) < 0.5
        ref.update(err, mask)
        port.update(err, mask)
        np.testing.assert_array_equal(port.accuracy(), ref.accuracy())
        np.testing.assert_array_equal(port.count, ref.count)
        for thr in (0.3, 0.6, 0.9):
            np.testing.assert_array_equal(port.viable(thr), ref.viable(thr))


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


# ---------------------------------------------------------------------------
# artifact hot-swap (OnlineAdapter -> PredictionPlane), tests/test_online.py
# ---------------------------------------------------------------------------
def _trained(app, seed, store_seed, **kw):
    return make_trained_predictor(app, make_store(seed=store_seed), "lr",
                                  seed=seed, device="cpu", **kw)


def test_hot_swap_version_monotonic_and_served():
    """Retraining bumps artifact_version monotonically and the plane
    serves the NEW artifact after re-registration (bucket restack)."""
    pred = _trained("hotswap", 31, 30, n_samples=48)
    plane = PredictionPlane(device="cpu")
    assert plane.register_predictor(pred)
    v0 = pred.artifact_version
    before = plane.predict_all()[("hotswap", "node-0")].rtt_pred
    rng = np.random.default_rng(7)
    w_pts = int(round(5.0 / 0.2))
    versions = [v0]
    for _ in range(2):
        for _ in range(40):
            pred.observe_task(10.0 + rng.uniform(0, 2),
                              {w: rng.standard_normal((10, w_pts))
                               for w in (5.0,)})
        X = rng.standard_normal((48, 4, w_pts)).astype(np.float32)
        y = rng.uniform(8.0, 12.0, 48).astype(np.float32)
        feats = extract_features(torch.from_numpy(X)).numpy().reshape(48, -1)
        pred.scaler_X.fit(feats)
        pred.y_lo, pred.y_hi = float(y.min()), float(y.max())
        pred.choice.model.fit(pred.scaler_X.transform(feats),
                              (y - pred.y_lo) / (pred.y_hi - pred.y_lo))
        pred.artifact_version += 1
        versions.append(pred.artifact_version)
        assert plane.register_predictor(pred)     # hot swap
    after = plane.predict_all()[("hotswap", "node-0")].rtt_pred
    assert versions == sorted(set(versions))      # strictly increasing
    assert after != pytest.approx(before, rel=1e-3)
    assert 5.0 < after < 16.0                     # serves the new scale


def test_online_adapter_retrains_and_swaps_on_cadence():
    pred = _trained("adapt", 41, 40, n_samples=48)
    pred.correlations_valid = True     # keep the injected (w, k) choice
    plane = PredictionPlane(device="cpu")
    plane.register_predictor(pred)
    adapter = OnlineAdapter(plane, retrain_every_s=30.0)
    adapter.track(pred)
    v0 = pred.artifact_version
    rng = np.random.default_rng(8)
    w_pts = int(round(5.0 / 0.2))
    for _ in range(60):
        # tight RTT spread so the CONFIRM bootstrap check passes
        adapter.observe("adapt", "node-0", float(rng.uniform(2.0, 2.2)),
                        {w: rng.standard_normal((10, w_pts))
                         for w in (5.0,)}, predicted=2.1)
    t0 = pred.store.clock.now()
    assert adapter.maybe_retrain(t0) == []        # first call arms cadence
    assert adapter.maybe_retrain(t0 + 10.0) == []  # not due yet
    swapped = adapter.maybe_retrain(t0 + 31.0)
    assert swapped == [("adapt", "node-0")]
    assert pred.artifact_version > v0
    assert adapter.swaps[-1][2] == pred.artifact_version
    assert 0.0 < adapter.accuracy("adapt", "node-0") <= 1.0
    # the swapped artifact is the retrained model, served by the plane
    assert pred.choice.name == "lr" and pred.retrainings == 1
    rec = plane.predict_all()[("adapt", "node-0")]
    assert rec.rtt_pred == pytest.approx(pred.predict().rtt_pred, rel=1e-5)


def test_manager_builds_adapter_over_active_predictors():
    store = make_store(seed=60)
    mgr = PredictionManager(device="cpu")
    for i in range(3):
        p = make_trained_predictor(f"m{i}", store, "lr", seed=60 + i,
                                   device="cpu")
        mgr.predictors[(f"m{i}", "node-0")] = p
        mgr.paused[(f"m{i}", "node-0")] = False
    mgr.pause("m2", "node-0")
    adapter = mgr.online_adapter(retrain_every_s=42.0)
    assert set(adapter.predictors) == {("m0", "node-0"), ("m1", "node-0")}
    assert adapter.plane is mgr.plane
    assert adapter.retrain_every_s == 42.0


def test_adapter_viability_rule():
    adapter = OnlineAdapter(PredictionPlane(device="cpu"), min_count=2)
    pred = _trained("via", 51, 50)
    adapter.track(pred)
    assert adapter.viable("via", "node-0", 0.9)      # no evidence
    for _ in range(4):
        adapter.trackers[("via", "node-0")].update(np.array([0.9]))
    assert not adapter.viable("via", "node-0", 0.5)
    assert adapter.viable("unknown", "nowhere", 0.99)  # untracked
    assert adapter.accuracy("unknown", "nowhere") == 1.0
