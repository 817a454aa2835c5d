"""The port's predictor lifecycle against the JAX package's, on the CPU:
workload -> collection -> correlations -> selection -> training ->
plane -> knowledge base, through ``PredictionManager`` on one node.

Nodes: ``tests/test_predictor.py``'s fixture (seed 3, 8 noise metrics,
120 s of noisy load, 4 cycles of 240 s), which trains one predictor, and
the same node with 4 noise metrics, which trains three, re-trains and
re-selects.  (Two 120 s cycles after a 60 s bootstrap train no predictor
in either package: the CONFIRM check wants more samples.)

What is held, and why:

- As the reference is: the datasets (bit for bit), the selections
  (window, method, metric indices), the families, the counts of full
  and re-trainings and the ``rmse_history`` times, on the fixture node.
- On the same features: the reference's float32 features differ from
  the port's by rounding (~1e-7, ``tests/test_torch_features.py``), and
  where the exact features tie (the std of a 0/1 metric over windows
  with the same count), that rounding breaks the ties.  Ranks, MIC's
  bins and the trees' quantile bins follow the order of tied values, so
  the reference's selection and trees can move with its rounding.  With
  the reference's ``extract_features`` replaced by the port's, both
  sides see the same features and everything above is held on both
  nodes, plus the correlation scores (``tests/test_torch_correlate.py``'s
  tolerances), the training arrays, every in-sample RMSE (re-trainings)
  to 1e-4, and:
- Every tree fit of the lifecycle (each candidate's and each
  re-training's, in order): the same arrays and bin edges, and every one
  of the ensemble's trees gives every training sample the same output
  (1e-5), so each split cuts the training samples alike and the leaves
  agree.  The (column, bin) of a split need not agree: mirrored or
  duplicated features (``mean`` and ``abs_energy`` of a 0/1 metric) cut
  the training samples alike with equal gains, and float32 against
  float64 rounding of those gains picks one or the other (31-48 of the
  150 trees of each fit here).  A held-out sample can fall on either
  side of two such cuts, so a tree family's held-out RMSE (a full
  training's) and its served predictions are held against the
  reference's own inference of the port's trees: the reference's
  binning and ``_gbt_predict`` (1e-5).  A family that is not a tree is
  held on its training split's predictions (1e-5) and its RMSE (1e-4).
- The plane: every trained predictor's batched prediction against the
  port's own serial one (1e-5) and against the reference predictor's
  serial prediction on the same store and features, with the port's
  trees for a tree family (1e-5) or its own model otherwise (1e-4).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.predictor as ref_predictor
import repro.core.selection as ref_selection
import repro.core.zoo as ref_zoo
import repro_torch.core.selection as port_selection
import repro_torch.core.zoo as port_zoo
from repro.core.manager import PredictionManager as RefManager
from repro.core.predictor import MinMax as RefMinMax
from repro.core.predictor import confirm_enough_samples as ref_confirm
from repro.core.rng import rng_stream
from repro.core.workload import NodeWorkload as RefNode
from repro.monitoring.metrics import SimClock as RefClock
from repro_torch.core.features import extract_features
from repro_torch.core.manager import PredictionManager
from repro_torch.core.predictor import MinMax, confirm_enough_samples
from repro_torch.core.workload import NodeWorkload
from repro_torch.monitoring.metrics import SimClock

FIXTURE = dict(seed=3, n_noise_metrics=8)
SMALL = dict(seed=3, n_noise_metrics=4)
CORR_TOL = {"pearson": 1e-5, "spearman": 1e-5, "kendall": 1e-5,
            "distance": 1e-4, "mic": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The fits are many small ops: one thread each runs them faster, and
    several test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(manager, node_cls, clock_cls, node_kw, selection_module,
         tree_cls, features=None, **kw):
    """One lifecycle; every full training's arrays and choice recorded
    (``fits``), in order, through a wrapper of ``select_model``, and every
    tree fit's model, arrays and fitted copy (``tree_fits``), through a
    wrapper of ``tree_cls.fit``."""
    fits, tree_fits = [], []
    select, tree_fit = selection_module.select_model, tree_cls.fit

    def recording(cands, X_feat, X_seq, y, *args, **kwargs):
        choice = select(cands, X_feat, X_seq, y, *args, **kwargs)
        # a copy: a later re-training refits the chosen model in place
        fits.append((list(cands), X_feat, X_seq, y, copy.deepcopy(choice)))
        return choice

    def recording_fit(model, X, y):
        out = tree_fit(model, X, y)
        tree_fits.append((model, np.array(X, np.float32),
                          np.array(y, np.float32), copy.deepcopy(model)))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(selection_module, "select_model", recording)
        mp.setattr(tree_cls, "fit", recording_fit)
        if features is not None:
            mp.setattr(ref_predictor, "extract_features", features)
        node = node_cls("worker-1", instances_per_app=1, clock=clock_cls(),
                        **node_kw)
        mgr = manager(c_max=40, seed=0, **kw)
        cb = mgr.attach(node)
        mgr.bootstrap_noise(node, load=3.0, duration_s=120, on_complete=cb)
        history = mgr.run_cycles(node, n_cycles=4, cycle_s=240,
                                 on_complete=cb)
    return node, mgr, history, fits, tree_fits


def _port_features(X):
    return extract_features(torch.as_tensor(np.asarray(X),
                                            dtype=torch.float32)).numpy()


def _assert_trees_agree(X, y, ref, port):
    """Both ensembles fit on (X, y): the same bin edges, and tree by tree,
    all the way, every training sample gets the same output (1e-5).  The
    split's (column, bin) may differ where two columns cut the samples
    alike (see the module's docstring)."""
    assert len(port.edges) == len(ref.edges)
    for e_port, e_ref in zip(port.edges, ref.edges):
        np.testing.assert_array_equal(e_port, e_ref)
    Xb = np.asarray(ref._bin(X))
    np.testing.assert_array_equal(port._bin(X).numpy(), Xb)
    rf, rb, rl = (np.asarray(t) for t in ref.trees)
    pf, pb, pl = (t.numpy() for t in port.trees)
    assert rf.shape == pf.shape and pl.shape == rl.shape

    def out(f, b, lv, t):
        left = Xb[:, f[t, 0]] <= b[t, 0]
        return np.where(left, np.where(Xb[:, f[t, 1]] <= b[t, 1], lv[t, 0],
                                       lv[t, 1]),
                        np.where(Xb[:, f[t, 2]] <= b[t, 2], lv[t, 2],
                                 lv[t, 3]))
    for t in range(len(rf)):
        np.testing.assert_allclose(out(pf, pb, pl, t), out(rf, rb, rl, t),
                                   rtol=1e-5, atol=1e-6, err_msg=f"tree {t}")
    assert float(port.base) == pytest.approx(float(np.asarray(ref.base)),
                                             rel=1e-6)


def _ref_with_port_trees(ref, port):
    """The reference's tree model, holding the port's trained trees."""
    m = copy.copy(ref)
    m.base = jnp.asarray(port.base.numpy())
    m.trees = tuple(jnp.asarray(t.numpy()) for t in port.trees)
    return m


@pytest.fixture(scope="module")
def as_is():
    return (_run(RefManager, RefNode, RefClock, FIXTURE, ref_selection,
                 ref_zoo.GBT),
            _run(PredictionManager, NodeWorkload, SimClock, FIXTURE,
                 port_selection, port_zoo.GBT, device="cpu"))


@pytest.fixture(scope="module", params=["fixture", "small"])
def same_features(request):
    node_kw = FIXTURE if request.param == "fixture" else SMALL
    return (_run(RefManager, RefNode, RefClock, node_kw, ref_selection,
                 ref_zoo.GBT, features=_port_features),
            _run(PredictionManager, NodeWorkload, SimClock, node_kw,
                 port_selection, port_zoo.GBT, device="cpu"))


def _assert_lifecycles_equal(ref, port):
    (rnode, rmgr, rhist, *_), (pnode, pmgr, phist, *_) = ref, port
    assert [(t, a) for t, a, _ in phist] == [(t, a) for t, a, _ in rhist]
    assert list(pmgr.predictors) == list(rmgr.predictors)
    trained = 0
    for key, a in rmgr.predictors.items():
        b = pmgr.predictors[key]
        np.testing.assert_array_equal(b.dataset.rtts, a.dataset.rtts)
        assert (b.dataset.n_seen, b.dataset.n_dropped) == \
            (a.dataset.n_seen, a.dataset.n_dropped)
        assert (a.selected is None) == (b.selected is None), key
        if a.selected is not None:
            assert (b.selected.window_s, b.selected.method) == \
                (a.selected.window_s, a.selected.method), key
            np.testing.assert_array_equal(b.selected.metric_idx,
                                          a.selected.metric_idx)
        assert (a.choice is None) == (b.choice is None), key
        if a.choice is not None:
            trained += 1
            assert b.choice.name == a.choice.name, key
            assert b.choice.model.name == b.choice.name
        assert (b.full_trainings, b.retrainings, b.artifact_version) == \
            (a.full_trainings, a.retrainings, a.artifact_version), key
        assert [t for t, _ in b.rmse_history] == \
            [t for t, _ in a.rmse_history], key
    assert pnode.clock.now() == rnode.clock.now()
    return trained


def test_lifecycle_matches_reference_as_is(as_is):
    ref, port = as_is
    assert _assert_lifecycles_equal(ref, port) >= 1


def test_lifecycle_matches_reference_on_the_same_features(same_features):
    ref, port = same_features
    assert _assert_lifecycles_equal(ref, port) >= 1
    for key, a in ref[1].predictors.items():
        b = port[1].predictors[key]
        assert set(b._corr_scores) == set(a._corr_scores)
        for (w, method), want in a._corr_scores.items():
            np.testing.assert_allclose(b._corr_scores[w, method], want,
                                       rtol=CORR_TOL[method], atol=1e-6)
        if a.retrainings and a.rmse_history[-1][1] == a.choice.rmse:
            # a re-training scores the model on its own training data
            assert b.choice.rmse == pytest.approx(a.choice.rmse, rel=1e-4)
    # every tree fit, in order: the same arrays, the trees alike
    (*_, ref_fits, ref_trees), (*_, port_fits, port_trees) = ref, port
    assert len(port_trees) == len(ref_trees) >= 1
    for (_, Xa, ya, a), (_, Xb, yb, b) in zip(ref_trees, port_trees):
        assert b.name == a.name
        np.testing.assert_array_equal(Xb, Xa)
        np.testing.assert_array_equal(yb, ya)
        _assert_trees_agree(Xb, yb, a, b)
    # every full training: the same arrays and candidates, the same pick,
    # the chosen models alike
    assert len(port_fits) == len(ref_fits) >= 1
    for (ca, Xa, Sa, ya, a), (cb, Xb, Sb, yb, b) in zip(ref_fits, port_fits):
        assert cb == ca
        for x, y in ((Xb, Xa), (Sb, Sa), (yb, ya)):
            np.testing.assert_array_equal(x, y)
        assert b.name == a.name
        X = Sb if b.model.sequential else Xb
        n = len(yb)
        perm = rng_stream(0, "model-split").permutation(n)
        tr, te = perm[:int(0.8 * n)], perm[int(0.8 * n) + int(0.1 * n):]
        if b.name in ("xgb", "rf"):
            # the held-out RMSE, by the reference's inference of the
            # port's trees
            want = _ref_with_port_trees(a.model, b.model).predict(X[te])
            assert b.rmse == pytest.approx(
                ref_selection._rmse(want, yb[te]), rel=1e-5)
        else:
            np.testing.assert_allclose(b.model.predict(X[tr]).numpy(),
                                       np.asarray(a.model.predict(X[tr])),
                                       rtol=1e-5, atol=1e-6)
            assert b.rmse == pytest.approx(a.rmse, rel=1e-4)
    # the plane serves what the predictors predict one by one, and what
    # the reference's predictor predicts from the same state
    (_, rmgr, *_), (_, pmgr, *_) = ref, port
    recs = pmgr.plane.predict_all()
    assert set(recs) == {k for k, p in pmgr.predictors.items()
                         if p.choice is not None} != set()
    for key, rec in recs.items():
        b = pmgr.predictors[key]
        a = rmgr.predictors[key]
        serial = b.predict()
        assert rec.rtt_pred == pytest.approx(serial.rtt_pred, rel=1e-5)
        assert pmgr.kb.latest(*key) is not None
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_predictor, "extract_features", _port_features)
            if b.choice.name in ("xgb", "rf"):
                mp.setattr(a.choice, "model", _ref_with_port_trees(
                    a.choice.model, b.choice.model))
                rtol = 1e-5
            else:
                rtol = 1e-4
            want = a.predict()
        assert rec.rtt_pred == pytest.approx(want.rtt_pred, rel=rtol), key


def test_plane_is_on_the_managers_device(as_is):
    _, (pnode, pmgr, *_) = as_is
    assert pmgr.device == torch.device("cpu")
    assert pmgr.plane.device == pmgr.device
    for p in pmgr.predictors.values():
        assert p.device == pmgr.device


def test_lifecycle_steps_are_timed(as_is):
    """The manager's ``PhaseTimer``, shared by its predictors, holds the
    wall seconds of every step the lifecycle ran."""
    _, (_, pmgr, *_) = as_is
    assert set(pmgr.timer.summary()) == {"workload", "collection",
                                         "correlations", "training",
                                         "plane"}
    assert all(v > 0 for v in pmgr.timer.wall.values())
    for p in pmgr.predictors.values():
        assert p.timer is pmgr.timer


# ---- tests/test_predictor.py, replayed on the port ---------------------
def test_minmax_inverse_roundtrip_multifeature():
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 7, size=(50, 4))
    sc = MinMax().fit(X)
    Z = sc.transform(X)
    assert Z.min() >= 0.0 and Z.max() <= 1.0 + 1e-12
    np.testing.assert_allclose(sc.inverse_y(Z), X, rtol=1e-9, atol=1e-9)
    y = rng.uniform(1, 5, size=30)
    sy = MinMax().fit(y)
    np.testing.assert_allclose(sy.inverse_y(sy.transform(y)), y, rtol=1e-9)
    want = RefMinMax().fit(X)
    np.testing.assert_array_equal(Z, want.transform(X))


def test_confirm_check():
    rng = np.random.default_rng(0)
    assert not confirm_enough_samples(rng.normal(10, 5, 10))
    assert confirm_enough_samples(rng.normal(10, 0.5, 500))
    for n, s in ((25, 0.5), (60, 2.0), (200, 1.0), (500, 0.4)):
        x = rng.normal(10, s, n)
        assert confirm_enough_samples(x) == ref_confirm(x)


def test_predictions_within_range(as_is):
    _, (node, mgr, *_) = as_is
    for p in mgr.predictors.values():
        if p.choice is None:
            continue
        rec = p.predict()
        lo, hi = p.dataset.rtts.min(), p.dataset.rtts.max()
        assert 0.2 * lo <= rec.rtt_pred <= 3 * hi


def test_prediction_delay_breakdown(as_is):
    _, (node, mgr, *_) = as_is
    p = next(p for p in mgr.predictors.values() if p.choice is not None)
    rec = p.predict()
    assert rec.t_state > 0
    assert rec.t_inference < rec.t_state


def test_rmse_regression_triggers_full_training(as_is):
    _, (node, mgr, *_) = as_is
    p = next(p for p in mgr.predictors.values() if p.choice is not None)
    full0 = p.full_trainings

    class Bad:
        sequential = False
        name = "bad"

        def partial_fit(self, X, y):
            return self

        def predict(self, X):
            return np.full((len(np.atleast_2d(X)),), 1e3, np.float32)
    p.choice.model = Bad()
    p.choice.rmse = 1e3
    p.rmse_history.append((0.0, 0.01))
    p.train(force_full=False)
    assert p.full_trainings > full0
    assert p.choice.model.name in ("lr", "svm", "xgb", "rf", "fnn")
