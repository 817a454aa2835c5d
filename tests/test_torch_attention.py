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

The int8 KV cache (qwen2-vl-7b's smoke config, f32) is held against the
reference model: its quantisation bit for bit, decode from ``init_cache``
(``_torch_parity.TOL``), and the refusals where the reference cannot
decode (after prefill) or serve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, batches, flat, models, rel, tokens
from repro.kernels import ref
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode_attention
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash_attention
from repro.models import model as JM
from repro_torch.kernels.decode_attention import TILE as DECODE_TILE
from repro_torch.kernels.decode_attention import _splits as decode_splits
from repro_torch.kernels.decode_attention import _variant as decode_variant
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (_variant, flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import model as TM
from repro_torch.models.attention import quantize_rows
from repro_torch.serving.engine import ServingEngine

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


def _variant_of(q, k, v):
    """The variant the wrapper would pick for these tensors on a card."""
    strides = [t.stride(d) for t in (q, k, v) for d in (0, 1, 2)]
    return _variant(q.dtype, q.shape[3], v.shape[3], q.shape[2] // k.shape[2],
                    strides, [t.data_ptr() for t in (q, k, v)])


@pytest.mark.parametrize("case,want", [
    ("f32", "fma"), ("bf16", "tc"), ("bf16_d40", "fma"),
    ("bf16_dv40", "fma"), ("bf16_d16", "tc"), ("bf16_d256", "tc"),
    ("bf16_fused_qkv", "tc"), ("bf16_stride_off8", "fma"),
    ("bf16_ptr_off16", "fma"), ("bf16_zero_stride", "fma"),
    ("bf16_g128", "tc"), ("bf16_g256", "fma")])
def test_flash_variant_rule(case, want):
    """bf16 with D and Dv multiples of 16, at most 128 query heads per kv
    head and 16-byte aligned rows takes the tensor-core kernel; f32, other
    widths, larger groups and misaligned rows the FMA kernel."""
    B, S, H, KV, D, Dv = 2, 8, 4, 2, 128, 128
    if case in ("bf16_g128", "bf16_g256"):
        H, KV = int(case[6:]), 1
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    if case == "bf16_d40":
        D = Dv = 40
    elif case == "bf16_dv40":
        Dv = 40
    elif case == "bf16_d16":
        D = Dv = 16
    elif case == "bf16_d256":
        D = Dv = 256
    q = torch.zeros((B, S, H, D), dtype=dtype)
    k = torch.zeros((B, S, KV, D), dtype=dtype)
    v = torch.zeros((B, S, KV, Dv), dtype=dtype)
    if case == "bf16_fused_qkv":
        qkv = torch.zeros((B, S, H + 2 * KV, D), dtype=dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    elif case == "bf16_stride_off8":      # rows 260 bytes apart
        k = torch.zeros((B, S, KV, D + 2), dtype=dtype)[..., :D]
    elif case == "bf16_ptr_off16":        # base 2 bytes past alignment
        flat = torch.zeros(B * S * H * D + 8, dtype=dtype)
        q = flat[1:1 + B * S * H * D].view(B, S, H, D)
    elif case == "bf16_zero_stride":      # one key row broadcast
        k = torch.zeros((B, 1, KV, D), dtype=dtype).expand(B, S, KV, D)
    assert _variant_of(q, k, v) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_count_neither_variant(dtype):
    """On the CPU both dtypes take the plain version: ``plain_calls``
    moves, no launch counter does."""
    q = torch.randn((1, 8, 4, 16)).to(dtype)
    kv = torch.randn((1, 8, 2, 16)).to(dtype)
    counters = ("plain_calls", "launches", "tc_launches", "fma_launches")
    before = [getattr(flash_attention, c) for c in counters]
    flash_attention(q, kv, kv)
    after = [getattr(flash_attention, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 0]


@pytest.mark.parametrize("B,KV,n_sm", [(8, 4, 132), (1, 1, 132),
                                        (100, 2, 132), (3, 4, 8),
                                        (1, 8, 1)])
def test_decode_splits_rule(B, KV, n_sm):
    """CTAs per (batch, kv head): as many as fit on the card at once, two
    per SM, over the B * KV pairs, never fewer than 1 nor more than the
    cache's tiles, for every S from 1 to 4096 (the number depends on the
    shapes and the card, not on kv_len)."""
    resident = 2 * n_sm // (B * KV)
    for S in range(1, 4097):
        n = decode_splits(B, KV, S, n_sm)
        assert 1 <= n <= -(-S // DECODE_TILE)
        assert n == max(1, min(resident, -(-S // DECODE_TILE)))
        assert n == 1 or B * KV * n <= 2 * n_sm
    assert decode_splits(8, 4, 2048, 132) == 8   # the serving path: 256 CTAs


def _decode_variant_of(q, k, v):
    """The variant the decode wrapper would pick for these tensors."""
    strides = [q.stride(0), q.stride(2)] + \
        [t.stride(d) for t in (k, v) for d in (0, 1, 2)]
    return decode_variant(q.dtype, q.shape[3], v.shape[3],
                          q.shape[2] // k.shape[2], strides,
                          [t.data_ptr() for t in (q, k, v)])


@pytest.mark.parametrize("case,want", [
    ("f32", "fma"), ("bf16", "mma"), ("bf16_d40", "fma"),
    ("bf16_d16", "mma"), ("bf16_d256", "mma"), ("bf16_g16", "mma"),
    ("bf16_g17", "fma"), ("bf16_stride_off8", "fma"),
    ("bf16_ptr_off16", "fma")])
def test_decode_variant_rule(case, want):
    """bf16 with D and Dv multiples of 16, at most 16 query heads per kv
    head and 16-byte aligned rows takes the mma kernel; f32, other widths,
    larger groups and misaligned rows the FMA kernel."""
    B, S, H, KV, D = 2, 8, 28, 4, 128
    if case in ("bf16_g16", "bf16_g17"):
        H, KV = int(case[6:]), 1
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    D = {"bf16_d40": 40, "bf16_d16": 16, "bf16_d256": 256}.get(case, D)
    q = torch.zeros((B, 1, H, D), dtype=dtype)
    k = torch.zeros((B, S, KV, D), dtype=dtype)
    v = torch.zeros((B, S, KV, D), dtype=dtype)
    if case == "bf16_stride_off8":        # rows 260 bytes apart
        k = torch.zeros((B, S, KV, D + 2), dtype=dtype)[..., :D]
    elif case == "bf16_ptr_off16":        # base 2 bytes past alignment
        flat = torch.zeros(B * H * D + 8, dtype=dtype)
        q = flat[1:1 + B * H * D].view(B, 1, H, D)
    assert _decode_variant_of(q, k, v) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_cpu_calls_count_neither_variant(dtype):
    """On the CPU decode runs the plain version: ``plain_calls`` moves, no
    launch counter does."""
    q = torch.randn((1, 1, 4, 16)).to(dtype)
    kv = torch.randn((1, 8, 2, 16)).to(dtype)
    counters = ("plain_calls", "launches", "mma_launches", "fma_launches")
    before = [getattr(decode_attention, c) for c in counters]
    decode_attention(q, kv, kv, torch.tensor([5], dtype=torch.int32))
    after = [getattr(decode_attention, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 0]


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


# ----------------------------------------------------------------------
# the serving forms this slice adds: cross-attention (non-causal, Sq !=
# Skv), MLA's prefill (Dv != D) and Zamba2's head dim of 160
@pytest.mark.parametrize("Sq,Skv,H,KV,D,Dv,causal", [
    (24, 8, 4, 4, 16, 16, False),      # cross-attention over 8 frames
    (8, 24, 4, 2, 16, 16, False),
    (20, 20, 4, 4, 24, 8, True),       # MLA: qk_nope + qk_rope, v_head
    (64, 64, 2, 2, 160, 160, True),    # Zamba2's shared block
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_takes_the_new_serving_forms(dtype, Sq, Skv, H, KV, D,
                                                 Dv, causal):
    rng = np.random.default_rng(4)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, s), dtype)
        for s in ((2, Sq, H, D), (2, Skv, KV, D), (2, Skv, KV, Dv)))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (2, Sq, H, Dv)
    _close(got.float().numpy(), ref.attention_ref(jq, jk, jv, causal=causal),
           dtype)


# ----------------------------------------------------------------------
# the int8 KV cache
def _reference_quantize(x):
    """The reference's per-token int8 quantisation, its lines of
    ``models/attention.py::attention_decode``, compiled as there."""

    @jax.jit
    def q(k):
        s = jnp.max(jnp.abs(k), axis=-1) / 127.0 + 1e-9
        kq = jnp.clip(jnp.round(k / s[..., None]), -127, 127).astype(jnp.int8)
        return kq, s.astype(jnp.float32)
    return q(x)


@pytest.mark.parametrize("B,KV,dh,scale", [(3, 2, 16, 1.0), (8, 4, 128, 3.0),
                                           (5, 1, 64, 1e-3)])
def test_int8_quantisation_is_the_reference_rounding(B, KV, dh, scale):
    x = scale * np.random.default_rng(B).standard_normal(
        (B, KV, dh)).astype(np.float32)
    x[0, 0, :3] = [0.5, -0.5, 0.0]          # ties round half to even
    jq, js = _reference_quantize(jnp.asarray(x))
    tq, ts = quantize_rows(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


INT8_ARCH = "qwen2-vl-7b"


def _int8_model():
    return models(INT8_ARCH, kv_cache_dtype="int8")


def test_int8_init_cache_matches_reference():
    jcfg, tcfg, _, _ = _int8_model()
    theirs = flat(JM.init_cache(jcfg, 3, 16))
    ours = flat(TM.init_cache(tcfg, 3, 16, device="cpu"))
    assert set(ours) == set(theirs)
    for name, x in theirs.items():
        assert tuple(ours[name].shape) == x.shape, name
        assert str(ours[name].dtype)[6:] == str(x.dtype), name


def test_int8_decode_from_init_cache_matches_reference():
    """Decode steps from the zeroed int8 cache, feeding the reference's
    greedy tokens to both: logits within 1e-4 of the largest, identical
    tokens, identical int8 rows; the scales to 1e-6 relative (they are
    taken from k and v, which differ by the order of the sums)."""
    jcfg, tcfg, jparams, tparams = _int8_model()
    B, S, V = 3, 16, tcfg.vocab_size
    jc, tc = JM.init_cache(jcfg, B, S), TM.init_cache(tcfg, B, S,
                                                      device="cpu")
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    tok = np.random.default_rng(0).integers(0, V, B).astype(np.int32)
    for _ in range(6):
        jl, jc = decode(jparams, jc, jnp.asarray(tok[:, None]))
        tl, tc = TM.decode_step(tparams, tcfg, tc, torch.tensor(tok[:, None]))
        assert rel(tl.numpy(), jl) < TOL["float32"]
        tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
        np.testing.assert_array_equal(tl[:, :V].argmax(-1).numpy(), tok)
        for k in ("k", "v"):
            assert tc[k].dtype == torch.int8
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=0)
    assert int(tc["len"][0]) == 6 and tc["k"][:, :, 6:].abs().sum() == 0


def test_int8_decode_after_prefill_raises():
    """Prefill keeps the model's dtype and no scales, as the reference's;
    the reference's decode then fails on the missing scales (IndexError),
    the port's raises ValueError saying so."""
    jcfg, tcfg, jparams, tparams = _int8_model()
    nft = tcfg.num_frontend_tokens
    jb, tb = batches(tokens(0, 2, 12, tcfg.vocab_size),
                     vision_embeds=np.zeros((2, nft, tcfg.d_model),
                                            np.float32))
    _, jc = JM.prefill(jparams, jcfg, jb, cache_len=16)
    with pytest.raises(IndexError):
        JM.decode_step(jparams, jcfg, jc, jnp.zeros((2, 1), jnp.int32))
    _, tc = TM.prefill(tparams, tcfg, tb, cache_len=16)
    assert set(tc) == {"k", "v", "len"} and tc["k"].dtype == torch.float32
    with pytest.raises(ValueError, match="int8"):
        TM.decode_step(tparams, tcfg, tc, torch.zeros((2, 1),
                                                      dtype=torch.int64))


def test_engine_refuses_an_int8_cache():
    _, tcfg, _, tparams = _int8_model()
    with pytest.raises(ValueError, match="int8"):
        ServingEngine(tcfg, tparams, device="cpu")
