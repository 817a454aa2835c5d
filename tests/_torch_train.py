"""Shared helpers of the port's training tests: ``train_forward`` and its
gradients on both sides, the reference's parameters carried across.

Tolerances (the largest absolute difference over the largest absolute
reference value of each gradient leaf): 1e-4 in f32.  The MoE layer
rounds its dispatched tokens to bf16 on both sides, so each slot's
cotangent is rounded to bf16 and a 1e-7 difference upstream can flip an
ulp (2^-8 of the value): every leaf upstream of a MoE layer is held to
1e-2.  The leaves downstream of every MoE layer are held to 1e-4: the
final norm, the untied LM head (``DOWNSTREAM_LEAVES``) and the last
layer's expert and router slices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import models
from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.tree import keystr, leaves_with_path, unflatten

TOL = 1e-4
MOE_UPSTREAM_TOL = 1e-2
LOSS_TOL = 1e-5
EXPERT_LEAVES = ("router", "wi", "wg", "wo")
#: leaves past the last layer: downstream of every MoE layer
DOWNSTREAM_LEAVES = ("['final_norm']", "['embed']['head']")


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def arch_models(arch: str, **changes):
    """(jcfg, tcfg, jparams, tparams) in f32; seamless against the
    unscanned reference (its scanned encoder's carry changes dtype)."""
    if arch.startswith("seamless"):
        changes.setdefault("scan_layers", False)
    return models(arch, "float32", **changes)


def make_batch(tcfg, B: int, S: int, seed: int = 0, mask: bool = False):
    """(reference batch, port batch): tokens and labels (the tokens
    shifted), encoder frames for ``encdec``, vision embeds for ``vlm``
    and a loss mask when asked, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if tcfg.family == "encdec":
        arrays["enc_frames"] = rng.standard_normal(
            (B, 8, tcfg.d_model)).astype(np.float32)
    if tcfg.family == "vlm":
        arrays["vision_embeds"] = 0.02 * rng.standard_normal(
            (B, 4, tcfg.d_model)).astype(np.float32)
    if mask:
        arrays["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def reference_value_and_grad(jcfg, jparams, jbatch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JM.train_forward(p, jcfg, b), has_aux=True))
    (loss, metrics), grads = fn(jparams, jbatch)
    return loss, metrics, {keystr(tuple(getattr(k, "key", k) for k in p)):
                           np.asarray(g) for p, g in
                           jax.tree_util.tree_flatten_with_path(grads)[0]}


def port_value_and_grad(tcfg, tparams, tbatch, of="total"):
    """(loss, metrics, {keystr: grad}) of ``train_forward``; ``of``
    picks what the gradients are of: the total, or a metric's name."""
    xs = [(p, x.detach().clone().requires_grad_())
          for p, x in leaves_with_path(tparams)]
    tree = unflatten(tparams, [x for _, x in xs])
    loss, metrics = TM.train_forward(tree, tcfg, tbatch)
    target = loss if of == "total" else metrics[of]
    gs = torch.autograd.grad(target, [x for _, x in xs], allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        keystr(p): (torch.zeros_like(x) if g is None else g)
        for (p, x), g in zip(xs, gs)}


def check_grads(tcfg, got: dict, want: dict) -> float:
    """Every leaf within its tolerance; returns the worst drift of the
    leaves held to 1e-4."""
    assert set(got) == set(want), set(got) ^ set(want)
    worst = 0.0
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if tcfg.moe is None:
            worst = max(worst, rel(g, w))
            assert rel(g, w) < TOL, (k, rel(g, w))
            continue
        if k.startswith(DOWNSTREAM_LEAVES):
            worst = max(worst, rel(g, w))
            assert rel(g, w) < TOL, (k, "downstream", rel(g, w))
            continue
        assert rel(g, w) < MOE_UPSTREAM_TOL, (k, rel(g, w))
        if k.startswith("['layers']['ffn']") and \
                any(f"['{n}']" in k for n in EXPERT_LEAVES):
            e = rel(g[-1], w[-1])
            worst = max(worst, e)
            assert e < TOL, (k, "last layer", e)
    return worst
