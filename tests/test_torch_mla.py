"""The port's Multi-head Latent Attention against the JAX package, on the
CPU, at minicpm3-4b's smoke config: the expanded prefill form
(``mla_fwd``) and the absorbed-matrix decode (``mla_decode``) layer by
layer, then the model (prefill, decode, the latent caches) and the
serving engine.  Tolerances are ``_torch_parity.TOL``; layer outputs the
same, as the largest absolute difference over the largest reference
value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (TOL, batches, configs, engine_parity, flat,
                           models, prompts, rel, run_side_by_side, tokens)
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

ARCH = "minicpm3-4b"


def test_config_is_the_reference_config():
    for smoke in (True, False):
        theirs, ours = configs(ARCH, smoke=smoke)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    _, cfg = configs(ARCH, "bfloat16", smoke=False)
    m = cfg.mla
    assert (cfg.num_layers, cfg.num_heads, m.kv_lora_rank,
            m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim) == \
        (62, 40, 256, 64, 32, 64)


@pytest.mark.parametrize("dtype", list(TOL))
def test_init_params_has_the_reference_tree(dtype):
    _, tcfg, jparams, _ = models(ARCH, dtype)
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    flat_ref, flat_ours = flat(jparams), flat(ours)
    assert set(flat_ours) == set(flat_ref)
    for name, x in flat_ref.items():
        assert tuple(flat_ours[name].shape) == x.shape, name
        assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name
    attn = ours["layers"]["attn"]
    assert torch.equal(attn["q_norm"], torch.ones_like(attn["q_norm"]))
    r = tcfg.mla.kv_lora_rank
    assert 0.7 * r ** -0.5 < attn["wukv"].float().std() < r ** -0.5


def _layer(dtype):
    """Layer 0's attention parameters on both sides."""
    jcfg, tcfg, jparams, tparams = models(ARCH, dtype)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_fwd_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _layer(dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    jout, (jckv, jkpe) = JA.mla_fwd(jp, jcfg, jx, jnp.asarray(pos))
    before = flash_attention.plain_calls
    tout, (tckv, tkpe) = TA.mla_fwd(tp, tcfg, tx, torch.as_tensor(pos))
    assert flash_attention.plain_calls == before + 1
    for got, want in ((tout, jout), (tckv, jckv), (tkpe, jkpe)):
        assert tuple(got.shape) == want.shape
        assert rel(got.float().numpy(), want) < TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_decode_matches_the_reference_absorbed_form(dtype):
    """One absorbed decode step over a half-filled latent cache with
    ragged lengths, against the reference's ``mla_decode``."""
    jcfg, tcfg, jp, tp = _layer(dtype)
    m, B, S = tcfg.mla, 3, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((B, S, m.qk_rope_head_dim)).astype(np.float32)
    lens = np.array([0, 5, S - 1], np.int32)
    jt = jnp.dtype(jcfg.dtype)
    tt = getattr(torch, dtype)
    jout, jckv, jkpe = JA.mla_decode(
        jp, jcfg, jnp.asarray(x).astype(jt), jnp.asarray(lens),
        jnp.asarray(ckv).astype(jt), jnp.asarray(kpe).astype(jt),
        jnp.asarray(lens))
    before = decode_attention.plain_calls
    tout, tckv, tkpe = TA.mla_decode(
        tp, tcfg, torch.as_tensor(x).to(tt), torch.as_tensor(lens),
        torch.as_tensor(ckv).to(tt), torch.as_tensor(kpe).to(tt),
        torch.as_tensor(lens))
    assert decode_attention.plain_calls == before   # no kernel: torch ops
    assert rel(tout.float().numpy(), jout) < TOL[dtype]
    assert rel(tckv.float().numpy(), jckv) < TOL[dtype]
    assert rel(tkpe.float().numpy(), jkpe) < TOL[dtype]


def _check_cache(tc, jc, tol):
    assert set(tc) == set(jc) == {"ckv", "kpe", "len"}
    for k in ("ckv", "kpe"):
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert rel(tc[k].float().numpy(), jc[k]) < tol, k


@pytest.mark.parametrize("dtype", list(TOL))
def test_prefill_and_decode_match_reference(dtype):
    m = models(ARCH, dtype)
    tcfg = m[1]
    jb, tb = batches(tokens(0, 3, 13, tcfg.vocab_size))
    before = (flash_attention.plain_calls, decode_attention.plain_calls)
    run_side_by_side(m, jb, tb, cache_len=24,
                     on_step=lambda tc, jc: _check_cache(tc, jc, TOL[dtype]))
    assert (flash_attention.plain_calls - before[0],
            decode_attention.plain_calls - before[1]) == (tcfg.num_layers, 0)


def test_init_cache_matches_reference():
    jcfg, tcfg, _, _ = models(ARCH)
    theirs = JM.init_cache(jcfg, 3, 16)
    ours = TM.init_cache(tcfg, 3, 16, device="cpu")
    flat_ref, flat_ours = flat(theirs), flat(ours)
    assert set(flat_ours) == set(flat_ref)
    for name, x in flat_ref.items():
        assert tuple(flat_ours[name].shape) == x.shape, name
        assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name


def test_engine_matches_reference_engine_f32():
    m = models(ARCH)
    engine_parity(m, prompts(7, (9, 13, 11), m[1].vocab_size), (4, 3, 5),
                  max_seq=32)


@pytest.mark.parametrize("smoke,want", [(False, "tc"), (True, "fma")])
def test_prefill_views_take_the_tensor_cores(smoke, want):
    """In bf16 at full width, ``mla_fwd``'s q and k and the v view of the
    expanded latent meet the tensor-core flash kernel's rules (head dims
    96 and 64, 16-byte aligned rows), so v needs no copy; the smoke
    config's head dims (16, 8) take the FMA kernel.  Read off tensors
    laid out as the prefill makes them."""
    _, cfg = configs(ARCH, "bfloat16", smoke=smoke)
    m, H = cfg.mla, cfg.padded_heads
    q = torch.zeros((1, 4, H, m.qk_nope_head_dim + m.qk_rope_head_dim),
                    dtype=torch.bfloat16)
    kv = torch.zeros((1, 4, H, m.qk_nope_head_dim + m.v_head_dim),
                     dtype=torch.bfloat16)
    v = kv[..., m.qk_nope_head_dim:]
    strides = [t.stride(d) for t in (q, q, v) for d in (0, 1, 2)]
    ptrs = (q.data_ptr(), q.data_ptr(), v.data_ptr())
    assert flash_mod._variant(torch.bfloat16, q.shape[3], v.shape[3], 1,
                              strides, ptrs) == want
