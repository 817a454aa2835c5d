"""The port's ``extract_features`` against the JAX package's.

Seeded (3, 4, w) windows for w in {1, 2, 24, 25}: both parities of w,
so both of jnp's median cases (the middle value, the midpoint of two)
are covered, and w = 1, where the mean absolute change is NaN on both
sides.  Float32 throughout.  The tolerance is 1e-6 relative with an
absolute floor of 1e-6 on unit-scale data: the mean, q25 and slope of a
zero-mean window cancel, and there the reference's own float32 rounding
(a sequential sum, a fused multiply-add) is larger than 1e-6 of the
result.
"""
import numpy as np
import pytest
import torch

from repro.core.features import FEATURE_NAMES as REF_NAMES
from repro.core.features import extract_features as ref_extract
from repro_torch.core.features import FEATURE_NAMES, extract_features


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
