"""The port's correlation battery (``repro_torch.core.correlate``, on the
CPU) against the JAX package's, and the reference's
``tests/test_correlate.py`` replayed on the port.

Inputs come from numpy seeds and go to both sides as float32: linear,
monotone, quadratic and noise metrics, 0/1 metrics (all ties), a
rounded metric (ties) and a constant one, at n below and above the 1024
cap of kendall and distance.  Tolerances: rtol 1e-5 for pearson,
spearman and kendall, 1e-4 for distance and mic, each with an absolute
floor of 1e-6: the reference reduces in float32, and near 0 (a noise
metric, a constant one) its own rounding is that large.  Kendall's
counts are whole numbers, so it must be equal bit for bit.  MIC's joint
counts go through the segment sum's plain version on the CPU.
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

from repro.core import correlate as ref
from repro_torch.core import correlate
from repro_torch.kernels.segment_sum import segment_sum

RTOL = {"pearson": 1e-5, "spearman": 1e-5, "kendall": 1e-5,
        "distance": 1e-4, "mic": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The fits are many small ops: one thread each runs them faster, and
    several test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    X = np.stack([2.0 * x + 0.1 * rng.standard_normal(n),
                  np.exp(x) + 0.1 * rng.standard_normal(n),
                  x ** 2 + 0.1 * rng.standard_normal(n),
                  rng.standard_normal(n),
                  (rng.random(n) < 0.3).astype(float),
                  (x > 0.5).astype(float),
                  np.round(x),
                  np.full(n, 0.3)]).astype(np.float32)
    return X, x.astype(np.float32)


def test_methods_and_grids_match():
    assert correlate.METHODS == ref.METHODS
    for n in (10, 50, 300, 1025, 5000, 10_000):
        assert correlate._mic_grids(n) == ref._mic_grids(n)


@pytest.mark.parametrize("n,seed", [(50, 0), (300, 1), (1500, 2),
                                    (2049, 3)])
def test_correlate_all_matches_reference(n, seed):
    X, y = _metrics(n, seed)
    want = ref.correlate_all(X, y)
    before = segment_sum.plain_calls
    got = correlate.correlate_all(X, y, device="cpu")
    assert segment_sum.plain_calls - before == len(correlate._mic_grids(n))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.float32 and got[name].shape == (len(X),)
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL[name],
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got["kendall"], want["kendall"])


@pytest.mark.parametrize("name", ["pearson", "spearman", "kendall"])
def test_signed_scores_match_reference(name):
    X, y = _metrics(400, 7)
    X[1] = -X[1]
    want = np.asarray(getattr(ref, name)(X, y))
    got = getattr(correlate, name)(torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[name], atol=1e-6)
    assert (np.sign(got.numpy()[:2]) == np.sign(want[:2])).all()


def test_ranks_are_stable_on_ties():
    x = torch.tensor([[1.0, 0.0, 1.0, 0.0, 1.0]])
    assert correlate._ranks(x).tolist() == [[2, 0, 3, 1, 4]]


def test_best_method_per_metric_matches_reference():
    X, y = _metrics(300, 4)
    scores = correlate.correlate_all(X, y, device="cpu")
    names, winner, vals = correlate.best_method_per_metric(scores)
    want = ref.best_method_per_metric(ref.correlate_all(X, y))
    assert names == want[0]
    np.testing.assert_allclose(vals, want[2], rtol=1e-4, atol=1e-6)


# ---- tests/test_correlate.py, replayed on the port ---------------------
def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    lin = 2.0 * x + 0.1 * rng.standard_normal(n)
    mono = np.exp(x) + 0.1 * rng.standard_normal(n)
    quad = x ** 2 + 0.1 * rng.standard_normal(n)
    noise = rng.standard_normal(n)
    return x, lin, mono, quad, noise


def _port(X, x, method):
    return correlate.correlate_all(X, x, methods=(method,),
                                   device="cpu")[method]


def test_pearson_matches_scipy():
    x, lin, mono, quad, noise = _data()
    X = np.stack([lin, mono, quad, noise])
    want = [abs(st.pearsonr(m, x)[0]) for m in X]
    np.testing.assert_allclose(_port(X, x, "pearson"), want, atol=1e-4)


def test_spearman_matches_scipy():
    x, lin, mono, quad, noise = _data()
    X = np.stack([lin, mono, noise])
    want = [abs(st.spearmanr(m, x)[0]) for m in X]
    np.testing.assert_allclose(_port(X, x, "spearman"), want, atol=5e-3)


def test_kendall_matches_scipy():
    x, lin, mono, quad, noise = _data(n=300)
    X = np.stack([lin, noise])
    want = [abs(st.kendalltau(m, x)[0]) for m in X]
    np.testing.assert_allclose(_port(X, x, "kendall"), want, atol=2e-2)


def test_distance_corr_detects_nonlinear():
    x, lin, mono, quad, noise = _data()
    X = np.stack([quad, noise])
    d = _port(X, x, "distance")
    p = _port(X, x, "pearson")
    assert d[0] > 0.3 and p[0] < 0.2
    assert d[0] > d[1] + 0.2


def test_mic_detects_nonlinear_and_bounded():
    x, lin, mono, quad, noise = _data()
    m = _port(np.stack([lin, quad, noise]), x, "mic")
    assert np.all((m >= 0) & (m <= 1))
    assert m[0] > 0.5
    assert m[1] > m[2] + 0.15


def test_all_scores_absolute_range():
    x, lin, mono, quad, noise = _data(n=256)
    X = np.stack([lin, -lin, mono, quad, noise])
    for name, v in correlate.correlate_all(X, x, device="cpu").items():
        assert np.all(v >= 0) and np.all(v <= 1 + 1e-6), name
