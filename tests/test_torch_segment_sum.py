"""The port's segment sum against the JAX package's Pallas kernel.

Inputs are made with numpy from a seed and handed to both sides.  The
JAX side runs the Pallas kernel in interpret mode and the jnp oracle
``repro.kernels.ref.segment_sum_ref`` under a scoped ``jax.enable_x64``.
On the CPU the port's wrapper takes its plain version; the CUDA kernel
is held against the plain version in ``test_torch_cuda.py``.

Tolerances: 0/1 f64 masks are integer sums, exact on every path; other
f64 values 1e-12 relative; f32 1e-6 relative (the plain version and the
Pallas kernel add in different orders).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.segment_sum import segment_sum as pallas_segment_sum
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain

SHAPES = [(8, 128, 128), (3, 50, 20), (16, 300, 60), (1, 1, 1)]


def _inputs(T, R, B, dtype, seed=0, mask=False, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, B if hi is None else hi, size=(T, R))
    vals = (rng.random((T, R)) < 0.5).astype(np.float64) if mask \
        else rng.standard_normal((T, R))
    return vals.astype(dtype), ids.astype(np.int32)


def _jax_side(vals, ids, B):
    with jax.enable_x64(True):
        pallas = np.asarray(pallas_segment_sum(vals, ids, B, interpret=True))
        oracle = np.asarray(ref.segment_sum_ref(vals, ids, B))
    return pallas, oracle


def _port(vals, ids, B):
    return segment_sum(torch.from_numpy(vals), torch.from_numpy(ids),
                       B).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("T,R,B", SHAPES)
def test_plain_matches_pallas_and_oracle(T, R, B, dtype):
    vals, ids = _inputs(T, R, B, dtype)
    got = _port(vals, ids, B)
    pallas, oracle = _jax_side(vals, ids, B)
    assert got.shape == (T, B) and got.dtype == dtype
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, pallas, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got, oracle, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("T,R,B", SHAPES + [(256, 1000, 1250)])
def test_mask_sums_exact(T, R, B):
    """The core feeds 0/1 busy masks: integer sums, exact."""
    vals, ids = _inputs(T, R, B, np.float64, seed=1, mask=True)
    got = _port(vals, ids, B)
    pallas, oracle = _jax_side(vals, ids, B)
    np.testing.assert_array_equal(got, oracle)
    if T * R <= 16 * 300:           # interpret mode is slow at full width
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_out_of_range_ids_add_nothing(dtype):
    vals, ids = _inputs(16, 300, 60, dtype, seed=2, lo=-7, hi=67)
    got = _port(vals, ids, 60)
    pallas, oracle = _jax_side(vals, ids, 60)
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, oracle, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got, pallas, rtol=rtol, atol=rtol)
    ones = np.ones((2, 10), dtype)
    line = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    np.testing.assert_array_equal(_port(ones, line, 4), np.ones((2, 4)))


def test_cpu_wrapper_counts_plain_calls_not_launches():
    vals, ids = _inputs(3, 50, 20, np.float64)
    before = (segment_sum.plain_calls, segment_sum.launches)
    _port(vals, ids, 20)
    assert segment_sum.plain_calls == before[0] + 1
    assert segment_sum.launches == before[1]


@pytest.mark.parametrize("bad", ["shape", "ndim", "dtype", "ids", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    v = torch.zeros((4, 6), dtype=torch.float64)
    i = torch.zeros((4, 6), dtype=torch.int32)
    if bad == "shape":
        i = torch.zeros((6, 4), dtype=torch.int32)
    elif bad == "ndim":
        v, i = v.reshape(-1), i.reshape(-1)
    elif bad == "dtype":
        v = v.to(torch.float16)
    elif bad == "ids":
        i = i.long()
    else:
        v, i = v.t(), i.t()
    with pytest.raises((ValueError, TypeError)):
        segment_sum(v, i, 5)

