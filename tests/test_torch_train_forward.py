"""``train_forward`` of the port's decoder-only families (dense, vlm,
MLA, moe) against the JAX package on the CPU at each arch's f32 smoke
config: the loss and metrics, and every gradient leaf against
``jax.value_and_grad`` on parameters carried across by ``interop``.
Tolerances in ``tests/_torch_train.py`` (MoE: 1e-2 upstream of a MoE
layer, 1e-4 for the last layer's experts and router); the loss within
1e-5.  The ssm, hybrid and encdec families are in
``tests/test_torch_train_forward_other.py``.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_train import (LOSS_TOL, TOL, arch_models, check_grads,
                          make_batch, port_value_and_grad,
                          reference_value_and_grad, rel)
from repro.models import model as JM
from repro_torch.configs.base import available_archs, get_config
from repro_torch.models import model as TM

DEC_ARCHS = [a for a in available_archs()
             if get_config(a).family in ("dense", "moe", "vlm")]


def _compare(arch, mask=False, **changes):
    jcfg, tcfg, jp, tp = arch_models(arch, **changes)
    jb, tb = make_batch(tcfg, 2, 16, mask=mask)
    jl, jm, jg = reference_value_and_grad(jcfg, jp, jb)
    tl, tm, tg = port_value_and_grad(tcfg, tp, tb)
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    for k in ("loss", "aux_loss", "tokens"):
        assert tm[k].dtype == torch.float32 and tm[k].shape == ()
        assert abs(float(tm[k]) - float(jm[k])) < LOSS_TOL, k
    return check_grads(tcfg, tg, jg)


def test_the_decoder_archs_are_the_registry_s():
    assert len(DEC_ARCHS) == 7


@pytest.mark.parametrize("arch", DEC_ARCHS)
def test_train_forward_matches_reference(arch):
    _compare(arch)


def test_train_forward_loss_mask_and_chunks():
    """A loss mask, and a sequence of two loss chunks."""
    _compare("deepseek-67b", mask=True, loss_chunk=8)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policies_give_the_same_numbers(remat):
    """``maybe_remat``: "full" (the default), "dots" and "none" give the
    same loss and gradients on the port."""
    _, tcfg, _, tp = arch_models("qwen3-moe-30b-a3b")
    _, tb = make_batch(tcfg, 2, 16)
    base = port_value_and_grad(tcfg, tp, tb)
    _, other_cfg, _, _ = arch_models("qwen3-moe-30b-a3b", remat=remat)
    other = port_value_and_grad(other_cfg, tp, tb)
    assert torch.equal(base[0], other[0])
    for k, g in base[2].items():
        assert torch.equal(other[2][k], g), k


def test_aux_loss_gradient_reaches_the_router():
    """The MoE aux loss's gradient is the reference's and is part of the
    total's: without it the last layer's router gradient would miss the
    reference's by more than the tolerance."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg, jp, tp = arch_models(arch)
    jb, tb = make_batch(tcfg, 2, 16, seed=3)
    want_aux = jax.grad(lambda p: JM.train_forward(p, jcfg, jb)[1]
                        ["aux_loss"])(jp)["layers"]["ffn"]["router"]
    _, _, got_aux = port_value_and_grad(tcfg, tp, tb, of="aux_loss")
    got_aux = got_aux["['layers']['ffn']['router']"].numpy()
    assert np.abs(want_aux).max() > 0
    assert rel(got_aux, want_aux) < TOL
    _, _, jg = reference_value_and_grad(jcfg, jp, jb)
    _, _, tg = port_value_and_grad(tcfg, tp, tb)
    total = jg["['layers']['ffn']['router']"][-1]
    got = tg["['layers']['ffn']['router']"][-1].numpy()
    assert rel(got, total) < TOL
    # dropping the aux term would move the router's gradient this far
    assert rel(got - np.asarray(want_aux)[-1], total) > 10 * TOL


def test_dense_aux_loss_is_zero_and_tokens_count_the_mask():
    _, tcfg, _, tp = arch_models("qwen2-vl-7b")
    _, tb = make_batch(tcfg, 2, 16, mask=True)
    with torch.no_grad():
        loss, metrics = TM.train_forward(tp, tcfg, tb)
    assert float(metrics["aux_loss"]) == 0.0
    assert float(metrics["tokens"]) == float(tb["loss_mask"].sum())
    assert torch.equal(loss, metrics["loss"])


def test_sequence_must_tile_the_loss_chunk():
    _, tcfg, _, tp = arch_models("deepseek-67b", loss_chunk=6)
    _, tb = make_batch(tcfg, 1, 16)
    with pytest.raises(ValueError, match="loss_chunk"):
        TM.train_forward(tp, tcfg, tb)
