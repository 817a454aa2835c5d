"""The port's zoo inference against the JAX package's, every family.

Each family's reference predictor is trained by
``repro.testing.make_trained_predictor`` (a seed per family), its
``inference_params()`` carried across by
``repro_torch.interop.params_from_reference``, and the port's
``single_apply`` and ``stacked_apply`` (B = 5, one sample each) compared
with the reference's.  Tolerances: rtol 1e-5 for lr, svm, xgb, rf and
fnn; 1e-4 for rnn, gru, lstm and cnn over the 25-step scan.
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
