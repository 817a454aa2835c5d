"""The port's FD-rule dynamic balancing (``repro_torch.core.binning``)
against the JAX package's (numpy, no jax), and the reference's
``tests/test_binning.py`` replayed on the port.

Both draw from ``rng_stream(seed, "binning-balance")``: bins, kept masks,
kept RTTs and payload order must be equal bit for bit (tolerance 0).
"""
import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as hst
except ImportError:                      # dependency-free fallback
    from _hypothesis_shim import given, settings, strategies as hst

from repro.core.binning import BalancedDataset as RefDataset
from repro.core.binning import freedman_diaconis_bins as ref_fd
from repro_torch.core.binning import BalancedDataset, freedman_diaconis_bins


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fd_bins_equal(seed):
    rng = np.random.default_rng(seed)
    for v in (rng.lognormal(0, 0.5, 1000), rng.uniform(0, 1, 7),
              np.full(5, 2.0), np.array([1.0])):
        nb, edges = freedman_diaconis_bins(v)
        want_nb, want_edges = ref_fd(v)
        assert nb == want_nb
        np.testing.assert_array_equal(edges, want_edges)


@pytest.mark.parametrize("c_max,seed", [(40, 0), (5, 1), (None, 2), (1, 3)])
def test_add_batch_keeps_equal(c_max, seed):
    rng = np.random.default_rng(seed + 10)
    ref, port = RefDataset(c_max=c_max, seed=seed), \
        BalancedDataset(c_max=c_max, seed=seed)
    for b in range(25):
        n = int(rng.integers(0, 40))
        rtts = rng.lognormal(1.0, 0.3 if b % 3 else 0.05, n)
        pay = [f"p{b}-{i}" for i in range(n)]
        np.testing.assert_array_equal(port.add_batch(rtts, pay),
                                      ref.add_batch(rtts, pay))
    np.testing.assert_array_equal(port.rtts, ref.rtts)
    assert port.payloads() == ref.payloads()
    assert (port.n_seen, port.n_dropped) == (ref.n_seen, ref.n_dropped)
    assert port.reduction == ref.reduction


# ---- tests/test_binning.py, replayed on the port ----------------------
def test_fd_rule_matches_numpy():
    rng = np.random.default_rng(0)
    v = rng.lognormal(0, 0.5, size=1000)
    nb, edges = freedman_diaconis_bins(v)
    q75, q25 = np.percentile(v, [75, 25])
    h = 2 * (q75 - q25) / 1000 ** (1 / 3)
    assert abs((edges[1] - edges[0]) - h) < 1e-9
    assert nb == int(np.ceil((v.max() - v.min()) / h))


def test_case1_keeps_everything():
    ds = BalancedDataset(c_max=5)
    keep = ds.add_batch([1.0, 2.0, 3.0, 100.0])
    assert keep.all()
    assert len(ds) == 4


def test_skewed_stream_is_rebalanced():
    ds = BalancedDataset(c_max=10, seed=1)
    rng = np.random.default_rng(0)
    ds.add_batch(rng.uniform(0, 10, 50))
    for _ in range(20):
        ds.add_batch(rng.normal(5.0, 0.1, 100))   # heavily skewed arrivals
    assert ds.reduction > 0.5
    kept = ds.add_batch([42.0])                     # rare values get in
    assert kept.all()


def test_always_keeps_at_least_one_when_full():
    ds = BalancedDataset(c_max=1)
    ds.add_batch([1.0, 1.1, 1.2])
    keep = ds.add_batch([1.05, 1.15])
    assert keep.sum() >= 1


@settings(max_examples=30, deadline=None)
@given(hst.lists(hst.floats(min_value=0.01, max_value=100.0,
                            allow_nan=False), min_size=1, max_size=60),
       hst.lists(hst.floats(min_value=0.01, max_value=100.0,
                            allow_nan=False), min_size=1, max_size=60))
def test_property_add_only_and_lengths(first, second):
    ds = BalancedDataset(c_max=8)
    ref = RefDataset(c_max=8)
    k1 = ds.add_batch(first)
    assert k1.all()                         # case 1: keep all
    n1 = len(ds)
    k2 = ds.add_batch(second)
    assert len(ds) == n1 + int(k2.sum())    # add-only (never drops old)
    assert ds.n_seen == len(first) + len(second)
    assert 0 <= ds.reduction <= 1
    ref.add_batch(first)
    np.testing.assert_array_equal(k2, ref.add_batch(second))


@settings(max_examples=20, deadline=None)
@given(hst.integers(min_value=2, max_value=40),
       hst.integers(min_value=1, max_value=10))
def test_property_payload_alignment(n, c_max):
    ds = BalancedDataset(c_max=c_max)
    rtts = np.linspace(1, 10, n)
    ds.add_batch(rtts, [f"p{i}" for i in range(n)])
    ds.add_batch(rtts + 0.5, [f"q{i}" for i in range(n)])
    assert len(ds.payloads()) == len(ds.rtts)
