"""The port's attention kernels (plain versions, on the CPU) against the
JAX package's Pallas kernels and their jnp oracles.

Inputs are made with numpy from a seed and handed to both sides (bf16
cases round the same f32 values on each side).  The JAX side runs the
Pallas kernels in interpret mode and ``repro.kernels.ref``.  On the CPU
the port's wrappers take their plain versions; the CUDA kernels are held
against the plain versions in ``test_torch_cuda.py``.

Tolerances are ``tests/test_kernels.py``'s: 2e-5 in f32 and 2e-2 in bf16
(rtol and atol), for the same reason: the sums run in another order, and
bf16 rounds the output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode_attention
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash_attention
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# (B, S, H, KV, D, block_q, block_k): tests/test_kernels.py's sweep, then
# a ragged length the Pallas kernel takes only as one block
FLASH_SHAPES = [
    (1, 128, 4, 4, 32, 64, 64),      # MHA
    (2, 256, 8, 2, 64, 128, 128),    # GQA
    (1, 128, 8, 1, 16, 32, 64),      # MQA
    (2, 100, 4, 2, 32, 100, 100),    # ragged
]
# (B, S, H, KV, D, block): tests/test_kernels.py's sweep
DECODE_SHAPES = [(2, 128, 4, 4, 32, 64), (1, 256, 8, 2, 64, 128),
                 (3, 64, 8, 1, 16, 32)]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _flash_inputs(B, S, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [_both(_normal(rng, s), dtype)
            for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,D,bq,bk", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_pallas_and_oracle(dtype, B, S, H, KV, D, bq, bk,
                                               causal):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(B, S, H, KV, D, dtype)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (B, S, H, D) and got.dtype == tq.dtype
    pallas = pallas_flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                    block_k=bk, interpret=True)
    oracle = ref.attention_ref(jq, jk, jv, causal=causal)
    got = got.float().numpy()
    _close(got, pallas, dtype)
    _close(got, oracle, dtype)


def _decode_lengths(B, S, mode):
    if mode == "sweep":              # tests/test_kernels.py's lengths
        return np.minimum(np.arange(1, B + 1) * (S // 2), S)
    return np.full(B, 1 if mode == "one" else S)


@pytest.mark.parametrize("mode", ["sweep", "one", "full"])
@pytest.mark.parametrize("B,S,H,KV,D,blk", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_pallas_and_oracle(dtype, B, S, H, KV, D, blk,
                                                mode):
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = [
        _both(_normal(rng, s), dtype)
        for s in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D))]
    lens = _decode_lengths(B, S, mode).astype(np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == (B, 1, H, D) and got.dtype == tq.dtype
    jl = jnp.asarray(lens)
    pallas = pallas_decode_attention(jq, jk, jv, jl, block=blk,
                                     interpret=True)
    oracle = ref.decode_attention_ref(jq, jk, jv, jl)
    got = got.float().numpy()
    _close(got, pallas, dtype)
    _close(got, oracle, dtype)


def test_decode_every_length_matches_oracle():
    """kv_len from 1 to S, one row each, f32."""
    S, H, KV, D = 40, 4, 2, 16
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = [
        _both(_normal(rng, s), "float32")
        for s in ((S, 1, H, D), (S, S, KV, D), (S, S, KV, D))]
    lens = np.arange(1, S + 1, dtype=np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens)).numpy()
    _close(got, ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)),
           "float32")


def test_causal_needs_equal_lengths():
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 12, 2, 16))
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention(q, kv, kv, causal=True)
    assert flash_attention(q, kv, kv, causal=False).shape == (1, 8, 2, 16)


def test_cpu_wrappers_count_plain_calls_not_launches():
    q = torch.randn((1, 8, 4, 16))
    kv = torch.randn((1, 8, 2, 16))
    before = (flash_attention.plain_calls, flash_attention.launches,
              decode_attention.plain_calls, decode_attention.launches)
    flash_attention(q, kv, kv)
    decode_attention(q[:, :1], kv, kv, torch.tensor([5], dtype=torch.int32))
    assert (flash_attention.plain_calls, flash_attention.launches,
            decode_attention.plain_calls, decode_attention.launches) == \
        (before[0] + 1, before[1], before[2] + 1, before[3])


def test_plain_versions_are_what_the_wrappers_return():
    q = torch.randn((2, 8, 4, 16))
    kv = torch.randn((2, 8, 2, 16))
    lens = torch.tensor([3, 8], dtype=torch.int32)
    assert torch.equal(flash_attention(q, kv, kv),
                       flash_attention_plain(q, kv, kv))
    assert torch.equal(decode_attention(q[:, :1], kv, kv, lens),
                       decode_attention_plain(q[:, :1], kv, kv, lens))


@pytest.mark.parametrize("bad", ["rank", "groups", "head_dim", "too_wide",
                                 "dtype", "mixed_dtype", "strided",
                                 "batch"])
def test_wrappers_reject_bad_inputs(bad):
    q = torch.zeros((2, 8, 4, 16))
    k = torch.zeros((2, 8, 2, 16))
    v = torch.zeros((2, 8, 2, 16))
    if bad == "rank":
        q = q[0]
    elif bad == "groups":
        k = v = torch.zeros((2, 8, 3, 16))
    elif bad == "head_dim":
        k = torch.zeros((2, 8, 2, 8))
    elif bad == "too_wide":
        q, k, v = (torch.zeros(t.shape[:3] + (264,)) for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "strided":
        q = torch.zeros((2, 8, 16, 4)).transpose(2, 3)
    else:
        k = v = torch.zeros((3, 8, 2, 16))
    lens = torch.full((2,), 4, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, causal=False)
    with pytest.raises((ValueError, TypeError)):
        decode_attention(q[:, :1], k, v, lens)


@pytest.mark.parametrize("bad", ["two_queries", "len_dtype", "len_shape"])
def test_decode_rejects_bad_query_or_lengths(bad):
    q = torch.zeros((2, 1, 4, 16))
    kv = torch.zeros((2, 8, 2, 16))
    lens = torch.full((2,), 4, dtype=torch.int32)
    if bad == "two_queries":
        q = torch.zeros((2, 2, 4, 16))
    elif bad == "len_dtype":
        lens = lens.long()
    else:
        lens = lens[:1]
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, lens)
