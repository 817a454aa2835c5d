"""The port's Zamba2 (``hybrid``) family against the JAX package, on the
CPU, at zamba2-2.7b's smoke config: the parameter tree, prefill and
decode (logits, Mamba2 states, the shared block's k/v), the serving
engine, and the shared block's LoRA path.

The reference initialises the LoRA ``qb`` / ``ib`` at zeros, so with
init weights the per-group deltas add exactly 0 and a comparison would
not see them: every comparison here first fills them with seeded numpy
values (``_lora``), the same on both sides, and
``test_dropping_the_lora_path_is_seen`` shows the comparison fails when
the port's deltas are dropped.  Tolerances are ``_torch_parity.TOL``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (TOL, batches, configs, engine_parity, flat,
                           models, prompts, rel, run_side_by_side, tokens)
from repro.models import model as JM
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd
from repro_torch.models import hybrid
from repro_torch.models import model as TM
from repro_torch.monitoring.metrics import SimClock
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "zamba2-2.7b"
MAX_SEQ = 96


def _lora(tree, scale=0.5, seed=3):
    """Seeded nonzero LoRA ``qb`` / ``ib`` (numpy, in their dtype)."""
    rng = np.random.default_rng(seed)
    for name in ("qb", "ib"):
        x = tree["lora"][name]
        tree["lora"][name] = (scale * rng.standard_normal(x.shape)) \
            .astype(x.dtype)


def _model(dtype="float32", edit=_lora):
    return models(ARCH, dtype, edit=edit)


def test_config_is_the_reference_config():
    for smoke in (True, False):
        theirs, ours = configs(ARCH, smoke=smoke)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    _, cfg = configs(ARCH, "bfloat16", smoke=False)
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim) == (54, 2560, 160)
    assert hybrid._n_groups(cfg) == 9
    assert (cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
            cfg.ssm.d_state, cfg.ssm.chunk_size) == (80, 64, 64, 256)


def test_groups_must_divide_the_layers():
    _, cfg = configs(ARCH)
    bad = dataclasses.replace(cfg, num_layers=5)
    with pytest.raises(ValueError, match="groups"):
        hybrid.init_cache(bad, 1, 8, device="cpu")


@pytest.mark.parametrize("dtype", list(TOL))
def test_init_params_has_the_reference_tree(dtype):
    _, tcfg, jparams, _ = _model(dtype, edit=None)
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    flat_ref, flat_ours = flat(jparams), flat(ours)
    assert set(flat_ours) == set(flat_ref)
    for name, x in flat_ref.items():
        assert tuple(flat_ours[name].shape) == x.shape, name
        assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name
    G, per = hybrid._n_groups(tcfg), tcfg.hybrid.shared_every
    assert ours["mamba"]["mixer"]["in_x"].shape[:2] == (G, per)
    assert ours["lora"]["qa"].shape[0] == G
    # the reference's LoRA b matrices start at zeros: the deltas add 0
    assert not ours["lora"]["qb"].any() and not ours["lora"]["ib"].any()
    assert ours["lora"]["qa"].float().std() > 0
    w = ours["shared"]["attn"]["wq"].float()
    std = (2 * tcfg.d_model) ** -0.5
    assert w.abs().max() <= 2 * std * (1 + 1e-2)     # truncated at 2 sigma


def _check_cache(tc, jc, tol):
    for k in ("x", "B", "C"):
        assert tuple(tc["conv"][k].shape) == jc["conv"][k].shape, k
        assert rel(tc["conv"][k].numpy(), jc["conv"][k]) < tol, k
    for k in ("ssm", "k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert rel(tc[k].float().numpy(), jc[k]) < tol, k


@pytest.mark.parametrize("S", [13, 64])    # one partial chunk; two chunks
@pytest.mark.parametrize("dtype", list(TOL))
def test_prefill_and_decode_match_reference(dtype, S):
    m = _model(dtype)
    tcfg = m[1]
    jb, tb = batches(tokens(0, 3, S, tcfg.vocab_size))
    G = hybrid._n_groups(tcfg)
    before = (ssd.plain_calls, flash_attention.plain_calls,
              decode_attention.plain_calls)
    run_side_by_side(m, jb, tb, cache_len=S + 8,
                     on_step=lambda tc, jc: _check_cache(tc, jc, TOL[dtype]))
    # prefill: the SSD scan once a layer and flash once a group; each
    # decode step: the decode kernel once a group
    assert (ssd.plain_calls - before[0], flash_attention.plain_calls
            - before[1], decode_attention.plain_calls - before[2]) == \
        (tcfg.num_layers, G, 4 * G)


@pytest.mark.parametrize("drop", ["qb", "ib"])
def test_dropping_the_lora_path_is_seen(drop):
    """The comparison above sees the LoRA deltas: the port with one of
    them dropped misses the reference by far more than the tolerance."""
    jcfg, tcfg, jparams, tparams = _model()
    toks = tokens(0, 3, 13, tcfg.vocab_size)
    jb, tb = batches(toks)
    jl, _ = JM.prefill(jparams, jcfg, jb)
    dropped = {**tparams, "lora": {**tparams["lora"],
                                   drop: torch.zeros_like(
                                       tparams["lora"][drop])}}
    tl, _ = TM.prefill(dropped, tcfg, tb)
    assert rel(tl.numpy(), jl) > 100 * TOL["float32"]
    tl, _ = TM.prefill(tparams, tcfg, tb)
    assert rel(tl.numpy(), jl) < TOL["float32"]


def test_init_cache_matches_reference():
    jcfg, tcfg, _, _ = _model(edit=None)
    theirs = JM.init_cache(jcfg, 3, 16)
    ours = TM.init_cache(tcfg, 3, 16, device="cpu")
    flat_ref, flat_ours = flat(theirs), flat(ours)
    assert set(flat_ours) == set(flat_ref)
    for name, x in flat_ref.items():
        assert tuple(flat_ours[name].shape) == x.shape, name
        assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name
        assert not flat_ours[name].any(), name


# ----------------------------------------------------------------------
# the serving engine: ragged prompts left-padded to 64 = 2 chunks of 32
LENGTHS, NEW = (20, 64, 37), (4, 3, 5)


def test_engine_matches_reference_engine_f32():
    m = _model()
    done = engine_parity(m, prompts(7, LENGTHS, m[1].vocab_size), NEW,
                         MAX_SEQ)
    assert [len(r.output) for r in done] == list(NEW)


@pytest.mark.parametrize("plen,match", [(40, "chunk"), (2, "conv")])
def test_wave_of_wrong_padded_length_raises(plen, match):
    _, tcfg, _, tparams = _model()
    eng = ServingEngine(tcfg, tparams, device="cpu", max_batch=3,
                        max_seq=MAX_SEQ, clock=SimClock())
    eng.submit(Request(rid=0, tokens=np.ones(plen, np.int32),
                       max_new_tokens=2))
    with pytest.raises(ValueError, match=match):
        eng.step_wave()
    assert eng.pending() == 1
