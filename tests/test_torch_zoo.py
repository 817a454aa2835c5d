"""The port's zoo against the JAX package's, every family: inference and
the fit paths.

Inference: each family's reference predictor is trained by
``repro.testing.make_trained_predictor`` (a seed per family), its
``inference_params()`` carried across by
``repro_torch.interop.params_from_reference``, and the port's
``single_apply`` and ``stacked_apply`` (B = 5, one sample each) compared
with the reference's.  Tolerances: rtol 1e-5 for lr, svm, xgb, rf and
fnn; 1e-4 for rnn, gru, lstm and cnn over the 25-step scan.

Fits, on the CPU, on the same numpy data given to both sides (the
reference's ``tests/test_zoo.py`` draws): ``lr`` and ``svm`` weights to
rtol 1e-5 / 1e-4 (atol 1e-6 / 1e-5); ``xgb`` and ``rf`` base and leaves to
1e-5, trees by column and bin where no two columns bin alike, else by
the partition of the training samples each tree makes (its predictions
on them, 1e-5); ``fnn``, ``rnn``, ``gru``, ``lstm`` and ``cnn`` from the
reference's own initial parameters at 30 epochs, weights to 1e-4
(``fnn``) and 1e-3 (the rest; atol 1e-5), and the reference's
learnability bars at the default epochs, ``partial_fit`` included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zoo as ref_zoo
from repro.testing import K, WINDOW_S, make_store, make_trained_predictor
from repro_torch.core import zoo
from repro_torch.interop import params_from_reference
from repro_torch.testing import random_params

W_PTS = int(round(WINDOW_S / 0.2))
RTOL = {**{f: 1e-5 for f in ref_zoo.NONSEQ_MODELS},
        **{f: 1e-4 for f in ref_zoo.SEQ_MODELS}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The fits are many small ops: one thread each runs them faster, and
    several test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    store = make_store()
    return {fam: make_trained_predictor(f"app_{fam}", store, fam, seed=i)
            .choice.model.inference_params()
            for i, fam in enumerate(ref_zoo.ALL_MODELS)}


def _samples(fam, B, seed):
    rng = np.random.default_rng(seed)
    shape = (B, K, W_PTS) if fam in ref_zoo.SEQ_MODELS else (B, K * 12)
    # the plane feeds min-max scaled inputs, around [0, 1]
    return rng.uniform(-0.2, 1.2, shape).astype(np.float32)


def test_family_names_match():
    assert zoo.NONSEQ_MODELS == tuple(ref_zoo.NONSEQ_MODELS)
    assert zoo.SEQ_MODELS == tuple(ref_zoo.SEQ_MODELS)
    assert zoo.ALL_MODELS == tuple(ref_zoo.ALL_MODELS)
    for method in ("pearson", "spearman", "kendall", "distance", "mic"):
        for n in (500, 5_000, 50_000):
            assert zoo.candidates_for(method, n) \
                == ref_zoo.candidates_for(method, n)


@pytest.mark.parametrize("fam", list(ref_zoo.ALL_MODELS))
def test_params_carry_across_leaf_for_leaf(trained, fam):
    ref = trained[fam]
    port = params_from_reference(ref, "cpu")
    flat, _ = jax.tree.flatten(ref)
    leaves = zoo.tree_leaves(port)
    assert len(leaves) == len(flat)
    for a, b in zip(flat, leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert _containers(port) == _containers(ref)


def _containers(tree):
    """A tree's tuples and lists, leaves as None."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), [_containers(t) for t in tree])
    return None


@pytest.mark.parametrize("fam", list(ref_zoo.ALL_MODELS))
def test_single_apply_matches_reference(trained, fam):
    params = params_from_reference(trained[fam], "cpu")
    X = _samples(fam, 3, seed=7)
    for x in X:
        want = float(ref_zoo.single_apply(fam)(trained[fam], jnp.asarray(x)))
        got = zoo.single_apply(fam)(params, torch.from_numpy(x))
        assert got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=RTOL[fam],
                                   atol=1e-6, err_msg=fam)


@pytest.mark.parametrize("fam", list(ref_zoo.ALL_MODELS))
def test_stacked_apply_matches_reference(trained, fam):
    """B = 5 models, one sample each: the reference's params perturbed
    per model so that every row of the fleet differs."""
    B = 5
    rng = np.random.default_rng(11)

    def spread(x):
        x = np.asarray(x)
        reps = np.stack([x] * B)
        if np.issubdtype(x.dtype, np.floating):
            reps = reps * (1 + 0.1 * rng.standard_normal(reps.shape)
                           ).astype(x.dtype)
        return reps
    ref_stacked = jax.tree.map(lambda x: jnp.asarray(spread(x)),
                               trained[fam])
    X = _samples(fam, B, seed=13)
    want = np.asarray(ref_zoo.stacked_apply(fam)(ref_stacked,
                                                 jnp.asarray(X)))
    got = zoo.stacked_apply(fam)(params_from_reference(ref_stacked, "cpu"),
                                 torch.from_numpy(X))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[fam],
                               atol=1e-6, err_msg=fam)


@pytest.mark.parametrize("fam", ["xgb", "rf"])
def test_gbt_bins_equal_reference(trained, fam):
    _base, _trees, edges = trained[fam]
    X = _samples(fam, 6, seed=17)
    # values on the edges themselves and past the last one too
    e = np.asarray(edges)
    X[0] = e[np.arange(e.shape[0]), 3]
    X[1] = 1e6
    want = np.stack([
        np.clip(np.sum(e < x[:, None], axis=1), 0, e.shape[1]) for x in X])
    for x, w in zip(X, want):     # the reference's own binning, per sample
        np.testing.assert_array_equal(
            np.asarray(jnp.clip(jnp.sum(edges < jnp.asarray(x)[:, None],
                                        axis=1), 0, edges.shape[1])), w)
    got = zoo.gbt_bins(torch.from_numpy(np.stack([e] * len(X))),
                       torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fam", list(ref_zoo.ALL_MODELS))
def test_random_params_have_the_reference_layout(trained, fam):
    """``random_params`` (the card's stand-in for trained state) has the
    trained reference's containers, shapes and dtypes."""
    ref_leaves, _ = jax.tree.flatten(trained[fam])
    rnd = random_params(fam, K, seed=0)
    got = zoo.tree_leaves(rnd)
    assert [tuple(a.shape) for a in ref_leaves] \
        == [tuple(b.shape) for b in got]
    assert [np.asarray(a).dtype.name for a in ref_leaves] \
        == [str(b.dtype).replace("torch.", "") for b in got]
    assert _containers(rnd) == _containers(trained[fam])


# ----------------------------------------------------------------------
# the fit paths
def _tabular(n=400, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] ** 2
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    y = (y - y.min()) / (y.max() - y.min())
    return X, y


def _seq(n=200, k=3, w=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, k, w)).astype(np.float32)
    y = X[:, 0].mean(-1) + 0.3 * X[:, 1, -1]
    y = (y - y.min()) / (y.max() - y.min())
    return X.astype(np.float32), y.astype(np.float32)


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_fit_classes_match_the_reference():
    import inspect
    assert list(zoo.FIT_CLASSES) == list(ref_zoo.ALL_MODELS)
    for fam, cls in zoo.FIT_CLASSES.items():
        ref_cls = ref_zoo.ALL_MODELS[fam]
        assert cls.name == ref_cls.name and \
            cls.sequential == ref_cls.sequential
        want = {k: p.default for k, p in
                inspect.signature(ref_cls).parameters.items()}
        got = {k: p.default for k, p in inspect.signature(cls).parameters
               .items() if k not in ("device", "init")}
        assert got == want, fam


@pytest.mark.parametrize("fam,rtol,atol", [("lr", 1e-5, 1e-6),
                                           ("svm", 1e-4, 1e-5)])
def test_linear_fits_match_reference(fam, rtol, atol):
    X, y = _tabular()
    ref = ref_zoo.ALL_MODELS[fam]().fit(X[:300], y[:300])
    port = zoo.FIT_CLASSES[fam](device="cpu").fit(X[:300], y[:300])
    np.testing.assert_allclose(port.w.numpy(), np.asarray(ref.w),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(port.predict(X[300:]).numpy(),
                               np.asarray(ref.predict(X[300:])),
                               rtol=rtol, atol=atol)
    # the warm update: svm averages a 50-epoch refit into the old weights
    ref.partial_fit(X[100:], y[100:])
    port.partial_fit(X[100:], y[100:])
    np.testing.assert_allclose(port.w.numpy(), np.asarray(ref.w),
                               rtol=rtol, atol=atol)


def _tree_predictions(Xb, base, trees):
    """(n, T) each tree's output on binned samples, plus the base."""
    f, b, lv = (np.asarray(t) for t in trees)
    out = []
    for t in range(len(f)):
        left = Xb[:, f[t, 0]] <= b[t, 0]
        out.append(np.where(left, np.where(Xb[:, f[t, 1]] <= b[t, 1],
                                           lv[t, 0], lv[t, 1]),
                            np.where(Xb[:, f[t, 2]] <= b[t, 2],
                                     lv[t, 2], lv[t, 3])))
    return float(np.asarray(base)), np.stack(out, 1)


@pytest.mark.parametrize("fam", ["xgb", "rf"])
@pytest.mark.parametrize("alike", [False, True])
def test_tree_fits_match_reference(fam, alike):
    """``alike``: a duplicated column and a mirrored one (1 - x, whose
    splits are the first's partitions mirrored), so that distinct
    (column, bin) picks split the training samples the same way."""
    X, y = _tabular(n=300, d=5, seed=2)
    if alike:
        X = np.concatenate([X, X[:, :1], 1 - X[:, :1]], axis=1)
    ref = ref_zoo.ALL_MODELS[fam]().fit(X, y)
    port = zoo.FIT_CLASSES[fam](device="cpu").fit(X, y)
    for e_ref, e_port in zip(ref.edges, port.edges):
        np.testing.assert_array_equal(e_port, e_ref)
    Xb = np.asarray(ref._bin(X))
    np.testing.assert_array_equal(port._bin(X).numpy(), Xb)
    b_ref, per_ref = _tree_predictions(Xb, ref.base, ref.trees)
    b_port, per_port = _tree_predictions(Xb, port.base, port.trees)
    assert b_port == pytest.approx(b_ref, rel=1e-6)
    np.testing.assert_allclose(per_port, per_ref, rtol=1e-5, atol=1e-6)
    if not alike:
        for a, b in zip(port.trees[:2], ref.trees[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(port.trees[2].numpy(),
                                   np.asarray(ref.trees[2]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(port.predict(X).numpy(),
                               np.asarray(ref.predict(X)), rtol=1e-5,
                               atol=1e-6)
    params = port.inference_params()
    got = zoo.stacked_apply(fam)(params, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), port.predict(X).numpy(),
                               rtol=1e-6, atol=1e-6)


def _ref_init(fam, d_in):
    model = ref_zoo.ALL_MODELS[fam]()
    key = jax.random.PRNGKey(model.seed)
    if fam == "fnn":
        return ref_zoo._mlp_init(key, (d_in, *model.hidden, 1))
    return model._init(key, d_in)


@pytest.mark.parametrize("fam", ["fnn", "rnn", "gru", "lstm", "cnn"])
def test_adam_fits_match_reference_from_its_inits(fam):
    seq = fam in ref_zoo.SEQ_MODELS
    X, y = _seq(n=60, w=12) if seq else _tabular(n=80)
    init = _ref_init(fam, X.shape[1])
    ref = ref_zoo.ALL_MODELS[fam](epochs=30).fit(X, y)
    port = zoo.FIT_CLASSES[fam](epochs=30, device="cpu",
                                init=params_from_reference(init, "cpu"))
    port.fit(X, y)
    rtol = 1e-4 if fam == "fnn" else 1e-3
    assert _containers(port.params) == _containers(ref.params)
    for a, b in zip(zoo.tree_leaves(port.params), _np(ref.params)):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(port.predict(X).numpy(),
                               np.asarray(ref.predict(X)), rtol=rtol,
                               atol=1e-5)
    # a warm update from the trained state (50 / 40 epochs)
    ref.partial_fit(X, y)
    port.partial_fit(X, y)
    for a, b in zip(zoo.tree_leaves(port.params), _np(ref.params)):
        np.testing.assert_allclose(a.numpy(), b, rtol=10 * rtol, atol=1e-4)


@pytest.mark.parametrize("fam", ["fnn", "rnn", "gru", "lstm", "cnn"])
def test_default_inits_have_the_reference_shapes(fam):
    d_in = 3 if fam in ref_zoo.SEQ_MODELS else 7
    want = _np(_ref_init(fam, d_in))
    got = zoo.FIT_CLASSES[fam](device="cpu")._initial(d_in)
    again = zoo.FIT_CLASSES[fam](device="cpu")._initial(d_in)
    other = zoo.FIT_CLASSES[fam](device="cpu", seed=1)._initial(d_in)
    leaves = zoo.tree_leaves(got)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in want]
    for a, b, c, w in zip(leaves, zoo.tree_leaves(again),
                          zoo.tree_leaves(other), want):
        assert torch.equal(a, b)                     # seeded
        if np.abs(w).max() == 0:
            assert not a.any()                       # the zero biases
        else:
            assert not torch.equal(a, c)
            # the reference's scale, within the spread of the draws
            assert 0.5 < float(a.std()) / float(np.std(w)) < 2.0


@pytest.mark.parametrize("fam", ["lr", "svm", "xgb", "rf", "fnn"])
def test_nonseq_models_learn(fam):
    X, y = _tabular()
    model = zoo.FIT_CLASSES[fam](device="cpu").fit(X[:300], y[:300])
    pred = model.predict(X[300:]).numpy()
    rmse = float(np.sqrt(np.mean((pred - y[300:]) ** 2)))
    base = float(np.sqrt(np.mean((y[300:].mean() - y[300:]) ** 2)))
    assert rmse < 0.8 * base, (fam, rmse, base)


@pytest.mark.parametrize("fam", ["rnn", "lstm", "gru", "cnn"])
def test_seq_models_learn(fam):
    X, y = _seq()
    model = zoo.FIT_CLASSES[fam](device="cpu").fit(X[:150], y[:150])
    pred = model.predict(X[150:]).numpy()
    rmse = float(np.sqrt(np.mean((pred - y[150:]) ** 2)))
    base = float(np.sqrt(np.mean((y[150:].mean() - y[150:]) ** 2)))
    assert rmse < 0.9 * base, (fam, rmse, base)


def test_partial_fit_improves_or_holds():
    X, y = _tabular(seed=1)
    m = zoo.FNN(epochs=100, device="cpu")
    m.fit(X[:200], y[:200])
    r1 = float(np.sqrt(np.mean((m.predict(X[300:]).numpy() - y[300:]) ** 2)))
    m.partial_fit(X[200:300], y[200:300])
    r2 = float(np.sqrt(np.mean((m.predict(X[300:]).numpy() - y[300:]) ** 2)))
    assert r2 < r1 * 1.3


def test_single_sample_predict():
    X, y = _tabular()
    m = zoo.LinearRegression(device="cpu").fit(X, y)
    assert tuple(m.predict(X[0]).shape) == (1,)
    s = zoo.RNN(epochs=2, device="cpu").fit(*_seq(n=8))
    assert tuple(s.predict(_seq(n=8)[0][0]).shape) == (1,)


@pytest.mark.parametrize("fam", list(ref_zoo.ALL_MODELS))
def test_from_params_predicts_as_the_apply(trained, fam):
    params = params_from_reference(trained[fam], "cpu")
    model = zoo.from_params(fam, params)
    assert model.name == fam and model.device == torch.device("cpu")
    X = _samples(fam, 4, seed=19)
    want = np.asarray(ref_zoo.stacked_apply(fam)(
        jax.tree.map(lambda x: jnp.stack([x] * 4), trained[fam]),
        jnp.asarray(X)))
    np.testing.assert_allclose(model.predict(X).numpy(), want,
                               rtol=RTOL[fam], atol=1e-6)
    for a, b in zip(zoo.tree_leaves(model.inference_params()),
                    zoo.tree_leaves(params)):
        assert torch.equal(a, b)
