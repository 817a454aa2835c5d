"""``train_forward`` of the port's ssm (Mamba2), hybrid (Zamba2) and
encdec (SeamlessM4T) families against the JAX package on the CPU at each
arch's f32 smoke config: loss, metrics and every gradient leaf (1e-4,
``tests/_torch_train.py``), the SSD scan through its plain version.
Zamba2's LoRA ``qb`` / ``ib`` start at zeros (their own gradients are
still nonzero), and are seeded nonzero too so that the LoRA path carries
gradient into ``qa`` / ``ia``; seamless runs against the unscanned
reference, on f32 frames.
"""
import numpy as np
import pytest

from _torch_train import (LOSS_TOL, arch_models, check_grads, make_batch,
                          port_value_and_grad, reference_value_and_grad)


def _lora(tree, scale=0.5, seed=3):
    """Seeded nonzero LoRA ``qb`` / ``ib`` (numpy, in their dtype)."""
    rng = np.random.default_rng(seed)
    for name in ("qb", "ib"):
        x = tree["lora"][name]
        tree["lora"][name] = (scale * rng.standard_normal(x.shape)) \
            .astype(x.dtype)


def _compare(arch, S=16, edit=None, **changes):
    jcfg, tcfg, jp, tp = arch_models(arch, edit=edit, **changes)
    jb, tb = make_batch(tcfg, 2, S)
    jl, jm, jg = reference_value_and_grad(jcfg, jp, jb)
    tl, tm, tg = port_value_and_grad(tcfg, tp, tb)
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    for k in ("loss", "aux_loss", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) < LOSS_TOL, k
    check_grads(tcfg, tg, jg)
    return tg


@pytest.mark.parametrize("arch,S", [("mamba2-1.3b", 16),
                                    ("mamba2-1.3b", 64),
                                    ("zamba2-2.7b", 16),
                                    ("seamless-m4t-medium", 16)])
def test_train_forward_matches_reference(arch, S):
    _compare(arch, S=S)


def test_zamba2_lora_carries_gradient():
    tg = _compare("zamba2-2.7b", edit=_lora)
    for k in ("['lora']['qa']", "['lora']['ia']"):
        assert float(tg[k].abs().max()) > 0, k

