"""The port's ``extract_features`` against the JAX package's.

Seeded (3, 4, w) windows for w in {1, 2, 24, 25}: both parities of w,
so both of jnp's median cases (the middle value, the midpoint of two)
are covered, and w = 1, where the mean absolute change is NaN on both
sides.  Float32 throughout.  The tolerance is 1e-6 relative with an
absolute floor of 1e-6 on unit-scale data: the mean, q25 and slope of a
zero-mean window cancel, and there the reference's own float32 rounding
(a sequential sum, a fused multiply-add) is larger than 1e-6 of the
result.

perfCorrelate's two stages (``select_feature_per_metric``,
``drop_redundant``) and ``RollingFeatures`` are host numpy copies: on the
same inputs they must equal the reference's exactly, and the reference's
``tests/test_features.py`` properties are replayed on them.
"""
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as hst
except ImportError:                      # dependency-free fallback
    from _hypothesis_shim import given, settings, strategies as hst

from repro.core import features as ref
from repro.core.features import FEATURE_NAMES as REF_NAMES
from repro.core.features import extract_features as ref_extract
from repro_torch.core.features import (FEATURE_NAMES, RollingFeatures,
                                       drop_redundant, extract_features,
                                       select_feature_per_metric)


def test_feature_names_match():
    assert FEATURE_NAMES == REF_NAMES


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [1, 2, 24, 25])
def test_extract_features_matches_reference(w, seed):
    X = np.random.default_rng([seed, w]).standard_normal(
        (3, 4, w)).astype(np.float32)
    want = np.asarray(ref_extract(X))
    got = extract_features(torch.from_numpy(X))
    assert got.dtype == torch.float32 and got.shape == (3, 4, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    # the order statistics are jnp's own formulas on the sorted window
    for f in ("min", "max", "median", "first", "last"):
        i = FEATURE_NAMES.index(f)
        np.testing.assert_array_equal(got.numpy()[..., i], want[..., i])


def test_median_averages_the_middle_pair():
    X = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    med = extract_features(X)[0, FEATURE_NAMES.index("median")]
    assert float(med) == 2.5                 # torch.median would give 2
    std = extract_features(X)[0, FEATURE_NAMES.index("std")]
    assert float(std) == pytest.approx(np.std([1, 2, 3, 4]))   # ddof 0


@pytest.mark.parametrize("seed", [0, 1])
def test_perfcorrelate_stages_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n, m = 120, 9
    rtt = rng.uniform(1, 5, n).astype(np.float32)
    feats = rng.standard_normal((n, m, 12)).astype(np.float32)
    feats[:, 0, 3] += rtt                       # one informative feature
    feats[:, 1] = feats[:, 0] * 2.0             # a redundant metric
    best, sel = select_feature_per_metric(feats, rtt)
    want_best, want_sel = ref.select_feature_per_metric(feats, rtt)
    np.testing.assert_array_equal(best, want_best)
    np.testing.assert_array_equal(sel, want_sel)
    scores = np.abs(np.corrcoef(sel.T, rtt)[-1, :-1])
    for thresh in (0.95, 0.5):
        np.testing.assert_array_equal(
            drop_redundant(sel, scores, thresh),
            ref.drop_redundant(sel, scores, thresh))


@settings(max_examples=15, deadline=None)
@given(hst.lists(hst.floats(min_value=-50, max_value=50, allow_nan=False,
                            width=32), min_size=1, max_size=40),
       hst.integers(min_value=1, max_value=12))
def test_rolling_features_equal_reference(stream, window):
    port, want = RollingFeatures(window), ref.RollingFeatures(window)
    for v in stream:
        port.update(float(v))
        want.update(float(v))
        np.testing.assert_array_equal(port.features(), want.features())
        np.testing.assert_array_equal(port.fast_features(),
                                      want.fast_features())


# ---- tests/test_features.py:24-70, replayed on the port ----------------
@settings(max_examples=25, deadline=None)
@given(hst.lists(hst.floats(min_value=-50, max_value=50, allow_nan=False,
                            width=32), min_size=8, max_size=64))
def test_rolling_matches_batch(stream):
    roll = RollingFeatures(window=len(stream))
    for v in stream:
        roll.update(float(np.float32(v)))
    want = extract_features(torch.tensor([[stream]],
                                         dtype=torch.float32))[0, 0]
    np.testing.assert_allclose(roll.features(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_rolling_window_eviction():
    roll = RollingFeatures(window=4)
    for v in [1, 2, 3, 4, 100]:
        roll.update(float(v))
    f = roll.features()
    assert f[3] == 100.0        # max
    assert f[2] == 2.0          # min (1 evicted)


def test_select_feature_per_metric_prefers_informative():
    rng = np.random.default_rng(0)
    n, w = 200, 16
    rtt = rng.uniform(1, 5, n).astype(np.float32)
    informative = np.repeat(rtt[:, None], w, 1) + \
        0.05 * rng.standard_normal((n, w)).astype(np.float32)
    noise = rng.standard_normal((n, w)).astype(np.float32)
    X = np.stack([informative, noise], axis=1)      # (n, 2, w)
    feats = extract_features(torch.from_numpy(X)).numpy()
    best, sel = select_feature_per_metric(feats, rtt)
    c0 = abs(np.corrcoef(sel[:, 0], rtt)[0, 1])
    c1 = abs(np.corrcoef(sel[:, 1], rtt)[0, 1])
    assert c0 > 0.95 and c0 > c1


def test_drop_redundant():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(300)
    X = np.stack([a, a * 2 + 1e-3, rng.standard_normal(300)], axis=1)
    kept = drop_redundant(X, scores=np.array([0.9, 0.8, 0.5]))
    assert 0 in kept and 1 not in kept and 2 in kept
