"""The port's encoder-decoder (``encdec``) family against the JAX
package, on the CPU, at seamless-m4t-medium's smoke config: the encoder,
prefill and decode (logits, self and cross caches) and the serving
engine.

The reference's engine feeds the encoder zero frames, and the encoder's
output is then zero (rmsnorm, attention and the GELU of 0 are 0), so
cross-attention over an engine wave adds nothing.  The model-level
comparisons therefore take seeded normal frames (numpy), the same on
both sides, and ``test_dropping_cross_attention_is_seen`` shows the
comparison fails when the port's cross-attention is dropped.  Tolerances
are ``_torch_parity.TOL``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (TOL, batches, configs, engine_parity, flat,
                           models, prompts, rel, run_side_by_side, tokens)
from repro.models import encdec as JE
from repro.models import model as JM
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import encdec
from repro_torch.models import model as TM

ARCH = "seamless-m4t-medium"


def _frames(B, S_enc, D, seed=5):
    return np.random.default_rng(seed).standard_normal((B, S_enc, D)) \
        .astype(np.float32)


def test_config_is_the_reference_config():
    for smoke in (True, False):
        theirs, ours = configs(ARCH, smoke=smoke)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    _, cfg = configs(ARCH, "bfloat16", smoke=False)
    assert (cfg.enc_layers, cfg.num_layers, cfg.d_model, cfg.vocab_size,
            cfg.padded_vocab, cfg.tie_embeddings) == (12, 12, 1024, 256206,
                                                      256256, False)


@pytest.mark.parametrize("S", [1, 8, 4096, 5000])
def test_enc_len_for_matches_reference(S):
    assert encdec.enc_len_for(S) == JE.enc_len_for(S)


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
    assert "wg" not in ours["enc_layers"]["mlp"]    # GELU, no gate


@pytest.mark.parametrize("dtype", list(TOL))
def test_encoder_matches_reference(dtype):
    jcfg, tcfg, jparams, tparams = models(ARCH, dtype)
    fr = _frames(2, 8, tcfg.d_model)
    want = JE.encode(jparams, jcfg, jnp.asarray(fr).astype(jcfg.dtype))
    got = encdec.encode(tparams, tcfg,
                        torch.as_tensor(fr).to(getattr(torch, dtype)))
    assert rel(got.float().numpy(), want) < TOL[dtype]


def test_bf16_frames_in_an_f32_model():
    """The engine's frames are bf16 whatever the model's dtype.  The
    reference's scanned encoder refuses bf16 frames in an f32 model (the
    scan's carry turns f32 after the first residual add); unscanned
    (``scan_layers=False``) it promotes them, and the port matches that
    through prefill and decode."""
    jcfg, _, jparams, _ = models(ARCH)
    with pytest.raises(TypeError, match="carry"):
        JE.encode(jparams, jcfg, jnp.zeros((2, 8, jcfg.d_model),
                                           jnp.bfloat16))
    m = models(ARCH, scan_layers=False)
    tcfg = m[1]
    jb, tb = batches(tokens(0, 3, 13, tcfg.vocab_size), "bfloat16",
                     enc_frames=_frames(3, 8, tcfg.d_model))
    run_side_by_side(m, jb, tb, cache_len=24)


@pytest.mark.parametrize("dtype", list(TOL))
def test_zero_frames_encode_to_zeros(dtype):
    """The engine's frames, bf16 zeros, give an all-zero encoder output
    on both sides, so an engine wave's cross-attention adds nothing."""
    jcfg, tcfg, jparams, tparams = models(ARCH, dtype, scan_layers=False)
    want = JE.encode(jparams, jcfg, jnp.zeros((2, 8, tcfg.d_model),
                                              jnp.bfloat16))
    got = encdec.encode(tparams, tcfg, torch.zeros(
        (2, 8, tcfg.d_model), dtype=torch.bfloat16))
    assert not np.asarray(want).any() and not got.any()


def _check_cache(tc, jc, tol):
    assert set(tc) == set(jc) == {"k", "v", "ck", "cv", "len"}
    for k in ("k", "v", "ck", "cv"):
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert rel(tc[k].float().numpy(), jc[k]) < tol, k


@pytest.mark.parametrize("S_enc", [8, 20])
@pytest.mark.parametrize("dtype", list(TOL))
def test_prefill_and_decode_match_reference(dtype, S_enc):
    m = models(ARCH, dtype)
    tcfg = m[1]
    jb, tb = batches(tokens(0, 3, 13, tcfg.vocab_size), dtype,
                     enc_frames=_frames(3, S_enc, tcfg.d_model))
    L = tcfg.num_layers
    before = (flash_attention.plain_calls, decode_attention.plain_calls)
    run_side_by_side(m, jb, tb, cache_len=24,
                     on_step=lambda tc, jc: _check_cache(tc, jc, TOL[dtype]))
    # prefill: flash once an encoder layer and twice a decoder layer (self,
    # cross); each decode step: the decode kernel twice a decoder layer
    assert (flash_attention.plain_calls - before[0],
            decode_attention.plain_calls - before[1]) == \
        (tcfg.enc_layers + 2 * L, 4 * 2 * L)


def test_dropping_cross_attention_is_seen():
    """The comparison above sees the cross-attention: the port without
    it (its output projection zeroed) misses the reference by far more
    than the tolerance, and the reference's logits move with the frames."""
    jcfg, tcfg, jparams, tparams = models(ARCH)
    toks = tokens(0, 3, 13, tcfg.vocab_size)
    fr = _frames(3, 8, tcfg.d_model)
    jb, tb = batches(toks, enc_frames=fr)
    jl, _ = JM.prefill(jparams, jcfg, jb)
    jl0, _ = JM.prefill(jparams, jcfg, {**jb, "enc_frames": jnp.zeros_like(
        jb["enc_frames"])})
    assert rel(jl0, jl) > 100 * TOL["float32"]
    dec = tparams["dec_layers"]
    dropped = {**tparams, "dec_layers": {**dec, "cross": {
        **dec["cross"], "wo": torch.zeros_like(dec["cross"]["wo"])}}}
    tl, _ = TM.prefill(dropped, tcfg, tb)
    assert rel(tl.numpy(), jl) > 100 * TOL["float32"]
    tl, _ = TM.prefill(tparams, tcfg, tb)
    assert rel(tl.numpy(), jl) < TOL["float32"]


def test_init_cache_matches_reference():
    jcfg, tcfg, _, _ = models(ARCH)
    for kw in ({}, {"enc_len": 8}):
        theirs = JE.init_cache(jcfg, 3, 16, **kw)
        ours = encdec.init_cache(tcfg, 3, 16, device="cpu", **kw)
        flat_ref, flat_ours = flat(theirs), flat(ours)
        assert set(flat_ours) == set(flat_ref)
        for name, x in flat_ref.items():
            assert tuple(flat_ours[name].shape) == x.shape, name
            assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name
    assert TM.init_cache(tcfg, 3, 16, device="cpu")["ck"].shape[2] == 16


def test_engine_matches_reference_engine_f32():
    """An engine wave: the zero bf16 frames (B, 8, D) on both sides (the
    reference's engine unscanned, see above)."""
    m = models(ARCH, scan_layers=False)
    before = flash_attention.plain_calls
    engine_parity(m, prompts(7, (9, 13, 11), m[1].vocab_size), (4, 3, 5),
                  max_seq=32)
    assert flash_attention.plain_calls - before == \
        m[1].enc_layers + 2 * m[1].num_layers


def test_family_modules_refuse_other_families():
    from repro_torch.models import hybrid
    _, cfg = configs("qwen2-vl-7b")
    with pytest.raises(ValueError, match="encdec"):
        encdec.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        hybrid.init_cache(cfg, 1, 8, device="cpu")
