"""The backward passes of the port's flash attention and ``gmm`` kernels
against the JAX package, on the CPU, where both wrappers run their plain
versions.

- ``flash_attention_bwd_plain`` against ``jax.vjp`` of the model's
  ``models/attention.py::blockwise_attention`` (causal aligned at 0, as
  the kernels; GQA by repeating the kv heads, as its callers do, so the
  vjp sums the G heads): causal Sq = Skv, non-causal Sq != Skv
  (cross-attention), D != Dv (MLA), GQA.  The forward's log-sum-exp
  against ``jax.nn.logsumexp`` of the scaled scores.
- ``gmm_bwd_plain`` against ``jax.vjp`` of ``ref.gmm_ref``, C ragged;
  ``gmm.py::_bwd_variant``'s choice by dtype and alignment, and a CPU
  call moving only ``gmm_bwd.plain_calls``.
- ``FlashAttention`` and ``GMM`` (the autograd functions the models go
  through under grad) with ``torch.autograd.gradcheck`` in f64.

Inputs are made with numpy from a seed and handed to both sides.
Tolerance: the largest absolute difference over the largest absolute
reference value, 1e-5 in f32 (only the order of sums differs; the
reference's blockwise backward recomputes its tiles).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models.attention import blockwise_attention
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 _bwd_variant,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels import gmm as gmm_mod
from repro_torch.kernels.gmm import GMM, gmm, gmm_bwd, gmm_bwd_plain

TOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _attn_inputs(B, Sq, Skv, H, KV, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv),
             (B, Sq, H, Dv))]


def _reference_attention(causal, q_chunk, kv_chunk, G):
    def f(q, k, v):
        return blockwise_attention(q, jnp.repeat(k, G, axis=2),
                                   jnp.repeat(v, G, axis=2), causal=causal,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk)
    return f


# (B, Sq, Skv, H, KV, D, Dv, causal, q_chunk, kv_chunk)
ATTN_CASES = {
    "causal": (2, 16, 16, 4, 4, 8, 8, True, 8, 4),
    "causal_gqa": (2, 24, 24, 8, 2, 16, 16, True, 8, 8),
    "cross": (2, 12, 8, 4, 4, 16, 16, False, 4, 4),
    "cross_gqa": (1, 10, 6, 6, 3, 8, 8, False, 5, 3),
    "mla_widths": (2, 16, 16, 4, 4, 24, 16, True, 16, 8),
    "gqa_one_kv_head": (1, 8, 8, 4, 1, 12, 8, True, 4, 4),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_backward_plain_matches_blockwise_vjp(case):
    B, Sq, Skv, H, KV, D, Dv, causal, qc, kc = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(B, Sq, Skv, H, KV, D, Dv)
    f = _reference_attention(causal, qc, kc, H // KV)
    want_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, causal, return_lse=True)
    assert _rel(o, want_o) < TOL
    got = flash_attention_bwd_plain(tq, tk, tv, o, torch.as_tensor(do), lse,
                                    causal)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) < TOL, (name, _rel(g, w))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_is_the_scaled_scores_logsumexp(causal):
    B, S, H, KV, D = 2, 12, 4, 2, 8
    q, k, v, _ = _attn_inputs(B, S, S, H, KV, D, D, seed=1)
    kr = np.repeat(k, H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr).astype(np.float64) * D ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1))
    _, lse = flash_attention_plain(*map(torch.as_tensor, (q, k, v)), causal,
                                   return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


def test_flash_attention_under_grad_takes_the_autograd_function():
    q, k, v, do = (torch.as_tensor(a) for a in
                   _attn_inputs(1, 8, 8, 4, 2, 8, 8, seed=2))
    q.requires_grad_()
    before = (flash_attention.plain_calls, flash_attention_bwd.plain_calls)
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(do)
    assert (flash_attention.plain_calls - before[0],
            flash_attention_bwd.plain_calls - before[1]) == (1, 1)
    assert q.grad is not None and k.grad is None
    with torch.no_grad():
        again = flash_attention(q, k, v, causal=True)
    assert again.grad_fn is None and torch.equal(again, out.detach())


@pytest.mark.parametrize("causal,Sq,Skv,KV,Dv",
                         [(True, 5, 5, 2, 3), (False, 4, 6, 1, 5),
                          (False, 3, 7, 4, 4)])
def test_flash_attention_function_gradcheck_f64(causal, Sq, Skv, KV, Dv):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, Sq, 4, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    k = torch.randn(2, Skv, KV, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    v = torch.randn(2, Skv, KV, Dv, dtype=torch.float64, generator=g,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttention.apply(a, b, c, causal), (q, k, v))


@pytest.mark.parametrize("E,C,D,F", [(2, 64, 32, 48), (3, 1, 32, 16),
                                     (4, 20, 48, 80), (2, 7, 16, 16)])
def test_gmm_backward_plain_matches_gmm_ref_vjp(E, C, D, F):
    rng = np.random.default_rng(E * 100 + C)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((E, C, D), (E, D, F)))
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    _, vjp = jax.vjp(ref.gmm_ref, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    dx, dw = gmm_bwd_plain(*map(torch.as_tensor, (x, w, dy)))
    assert _rel(dx, want_dx) < TOL and _rel(dw, want_dw) < TOL
    # the wrapper on CPU tensors is the plain version, counted
    before = gmm_bwd.plain_calls
    gx, gw = gmm_bwd(*map(torch.as_tensor, (x, w, dy)))
    assert gmm_bwd.plain_calls == before + 1
    assert torch.equal(gx, dx) and torch.equal(gw, dw)


@pytest.mark.parametrize("dtype,C,D,F,ptrs,want", [
    (torch.bfloat16, 320, 2048, 768, (0, 256, 4096), "wgmma"),  # training
    (torch.bfloat16, 320, 768, 2048, (16, 32, 48), "wgmma"),    # wo
    (torch.bfloat16, 1, 48, 144, (0, 0, 0), "wgmma"),           # ragged
    (torch.float32, 320, 2048, 768, (0, 256, 4096), "fma"),
    (torch.float32, 17, 48, 16, (4, 8, 12), "fma"),             # 4-byte
    (torch.float32, 1, 16, 16, (0, 2, 0), "fma")])
def test_gmm_bwd_variant_rule(dtype, C, D, F, ptrs, want):
    """bf16 with 16-byte-aligned x, w and dy takes the wgmma backward at
    every shape, f32 the FMA kernel at any alignment; ``"mma"`` (the
    earlier bf16 kernel) is never chosen."""
    assert gmm_mod._bwd_variant(dtype, C, D, F, ptrs) == want


@pytest.mark.parametrize("ptrs", [(8, 0, 0), (0, 2, 0), (0, 0, 30)])
def test_gmm_bwd_variant_refuses_unaligned_bf16(ptrs):
    """TMA needs 16-byte-aligned bf16 bases: the wrapper raises, as the
    forward does, rather than take another kernel."""
    with pytest.raises(ValueError):
        gmm_mod._bwd_variant(torch.bfloat16, 320, 2048, 768, ptrs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_bwd_cpu_calls_count_neither_variant(dtype):
    """On the CPU both dtypes take the plain backward: ``plain_calls``
    moves, no launch counter does."""
    rng = np.random.default_rng(5)
    x, w, dy = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                .to(dtype) for s in ((3, 17, 48), (3, 48, 144), (3, 17, 144)))
    counters = ("plain_calls", "launches", "wgmma_launches", "fma_launches")
    before = [getattr(gmm_bwd, c) for c in counters]
    gmm_bwd(x, w, dy)
    after = [getattr(gmm_bwd, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 0]


def test_gmm_bwd_bf16_rounds_once():
    rng = np.random.default_rng(3)
    x, w, dy = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                .bfloat16() for s in ((2, 12, 16), (2, 16, 32), (2, 12, 32)))
    dx, dw = gmm_bwd_plain(x, w, dy)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dx, torch.bmm(dy.float(), w.float().transpose(1, 2))
                       .bfloat16())
    assert torch.equal(dw, torch.bmm(x.float().transpose(1, 2), dy.float())
                       .bfloat16())


@pytest.mark.parametrize("case", ["dy_shape", "dy_dtype"])
def test_gmm_bwd_refuses(case):
    x = torch.zeros((2, 4, 16))
    w = torch.zeros((2, 16, 32))
    dy, err = {"dy_shape": (torch.zeros((2, 4, 16)), ValueError),
               "dy_dtype": (torch.zeros((2, 4, 32), dtype=torch.float16),
                            TypeError)}[case]
    with pytest.raises(err):
        gmm_bwd(x, w, dy)


def test_gmm_function_gradcheck_f64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(2, 16, 16, dtype=torch.float64, generator=g,
                    requires_grad=True)
    assert torch.autograd.gradcheck(GMM.apply, (x, w))
    out = gmm(x, w)
    assert "GMM" in type(out.grad_fn).__name__


def test_f32_logits_product_backward():
    """``models.common._MatmulF32`` (the card's bf16 x bf16 -> f32 logits
    product under grad; on the CPU its ``_mm_f32`` upcasts) against
    ``jax.vjp`` of the reference's ``logits_from_hidden`` at bf16 params
    and an f32 cotangent: the reference multiplies the f32 cotangent, so
    rounding it to bf16 first would miss on about half the elements; the
    port's three-part split keeps it whole.  Every gradient element within
    one bf16 ulp of the reference's and at most 1% off it.  The padded
    vocabulary is written on a copy (autograd forbids writing a Function's
    output in place) with zero gradient there."""
    from types import SimpleNamespace
    from repro.models.common import logits_from_hidden
    from repro_torch.models import common
    cfg = SimpleNamespace(tie_embeddings=True, vocab_size=32,
                          padded_vocab=40)
    rng = np.random.default_rng(0)
    h_np = rng.standard_normal((2, 8, 64)).astype(np.float32)
    t_np = (0.1 * rng.standard_normal((40, 64))).astype(np.float32)
    gy_np = (1e-3 * rng.standard_normal((2, 8, 40))).astype(np.float32)
    h_j, t_j = jnp.asarray(h_np, jnp.bfloat16), jnp.asarray(t_np, jnp.bfloat16)
    _, vjp = jax.vjp(lambda h, t: logits_from_hidden({"tok": t}, cfg, h),
                     h_j, t_j)
    want_h, want_t = (np.asarray(x.astype(jnp.float32))
                      for x in vjp(jnp.asarray(gy_np)))

    h = torch.from_numpy(h_np).bfloat16().requires_grad_()
    table = torch.from_numpy(t_np).bfloat16().requires_grad_()
    y = common._MatmulF32.apply(h, table.t())
    assert y.dtype == torch.float32
    y = y.clone()
    y[..., 32:] = common.PAD_LOGIT
    y.backward(torch.from_numpy(gy_np))
    for got, want in ((h.grad, want_h), (table.grad, want_t)):
        got = got.float().numpy()
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - want) <= ulp)
        assert np.mean(got != want) <= 0.01
    assert torch.equal(table.grad[32:], torch.zeros_like(table.grad[32:]))
    gy = torch.from_numpy(gy_np)
    parts = list(common._split_f32(gy, torch.bfloat16))
    assert torch.equal(sum(p.float() for p in parts), gy)


@pytest.mark.parametrize("dtype,D,Dv,strides,ptrs,want", [
    (torch.bfloat16, 128, 128, (), (), "tc"),     # qwen3-moe-30b-a3b
    (torch.bfloat16, 96, 64, (), (), "tc"),       # MLA
    (torch.bfloat16, 160, 160, (), (), "tc"),
    (torch.bfloat16, 256, 256, (), (), "tc"),
    (torch.float32, 128, 128, (), (), "fma"),
    (torch.bfloat16, 12, 12, (), (), "fma"),      # D not 16k
    (torch.bfloat16, 16, 8, (), (), "fma"),       # Dv not 16k
    (torch.bfloat16, 128, 128, (1024, 128, 130), (), "fma"),
    (torch.bfloat16, 128, 128, (0, 128, 128), (), "fma"),
    (torch.bfloat16, 128, 128, (), (0, 0, 2, 0), "fma")])
def test_flash_bwd_variant_rule(dtype, D, Dv, strides, ptrs, want):
    """bf16 with D and Dv multiples of 16 and 16-byte rows of q, k, v and
    do takes the tensor-core backward; the rest the FMA kernel."""
    assert _bwd_variant(dtype, D, Dv, strides, ptrs) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_cpu_calls_count_neither_variant(dtype):
    """On the CPU both dtypes take the plain backward: ``plain_calls``
    moves, no launch counter does."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _attn_inputs(1, 16, 16, 4, 2, 16, 16, seed=4))
    o, lse = flash_attention_plain(q, k, v, True, return_lse=True)
    counters = ("plain_calls", "launches", "tc_launches", "fma_launches")
    before = [getattr(flash_attention_bwd, c) for c in counters]
    flash_attention_bwd(q, k, v, o, do, lse, True)
    after = [getattr(flash_attention_bwd, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 0]
