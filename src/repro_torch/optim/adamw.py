"""AdamW with f32 master weights, bias correction, global-norm clipping
and a warmup + cosine schedule: the port of the reference's
``optim/adamw.py``.

The optimizer state is ``{"master", "m", "v": trees like the params,
"step": int32 scalar}``.  :func:`adamw_update` runs the reference's
arithmetic leaf by leaf in plain PyTorch ops, in the same order: the
gradients up-cast to f32 and clipped by their global norm, the moments
updated and stored in ``moment_dtype``, the bias corrections
``1 - beta ** step`` in f32 at the incremented step, decay on the leaves
whose key path (the reference's ``jax.tree_util.keystr``, see
:mod:`repro_torch.tree`) names no norm, scale, bias or SSM constant, the
new master cast to the params' dtypes.

Where the reference returns new arrays, :func:`adamw_update` writes each
leaf's new master, moments and parameter into the state's and the
params' own tensors, by in-place ops that round as the reference's do
(one rounding a product, a sum, a quotient): at qwen3-moe-30b-a3b's full
width a second copy of the f32 master and moments would not fit beside
the first on one card, and every copy is a pass over 1.9 B elements.  A
caller that needs the old state keeps a copy.

The reference's ``constrain_opt`` / ``constrain_param`` hooks place the
state under a multi-device sharding (ZeRO-1: master and moments split
over the data axis, the params as the rules lay them out).  Their
counterparts here are ``opt_shardings`` / ``param_shardings``, trees of
``parallel.sharding.Sharding`` beside the leaves, which then are this
rank's shards: the gradients arrive in the optimizer's layout (the train
step reduce-scattered them), the clip's global norm sums each leaf's
squares over the ranks that split it and counts a leaf no rank splits
once, the update runs on the local shard, and a parameter whose layout
differs from its master's is all-gathered from the new master along the
dims they split differently (cast to its dtype first, as the
reference's) and cut to its own layout.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.tree import keystr, leaves, leaves_with_path, tree_map

_NO_DECAY = ("norm", "scale", "bias", "A_log", "dt_bias", "Dskip")


def lr_schedule(tcfg) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> the f32 learning rate: linear warmup to
    ``learning_rate`` over ``warmup_steps``, then a cosine to 0 at
    ``total_steps``."""
    base, warm, total = tcfg.learning_rate, tcfg.warmup_steps, \
        tcfg.total_steps

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warmup = base * step / max(warm, 1)
        t = ((step - warm) / max(total - warm, 1)).clamp(0.0, 1.0)
        cosine = 0.5 * base * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warm, warmup, cosine)

    return fn


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares
    (:func:`leaf_square_sums`), the leaves' sums added in the tree's
    order."""
    return torch.stack(leaf_square_sums(tree, shardings)).sum().sqrt()


def clip_scale(gnorm: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """The factor the gradients are clipped by: ``grad_clip / gnorm``,
    at most 1."""
    return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)


def leaf_square_sums(tree, shardings=None) -> list:
    """Each leaf's f32 sum of squares (f32 scalars, in the tree's order),
    summed in the leaf's row-major order whatever its strides: a sum
    adds in memory order, and a gradient may come back transposed (on
    the card the logits product's, ``models.common._MatmulF32``) where
    the sharded step's is contiguous (``Sharding.sum_into``), which put
    the two steps' norms one ulp apart in some runs.  With ``shardings``
    the leaves are shards: the sums of the leaves split over the same
    mesh axes are all-reduced together over those axes, and a leaf split
    over none is counted once."""
    sq = [x.to(torch.float32, memory_format=torch.contiguous_format)
          .square().sum() for x in leaves(tree)]
    if shardings is not None:
        import torch.distributed as dist
        from repro_torch.parallel.sharding import axis_group
        by_axes: dict = {}
        for i, sh in enumerate(leaves(shardings)):
            by_axes.setdefault(sh.axes(), (sh.mesh, []))[1].append(i)
        for axes, (mesh, idx) in by_axes.items():
            if not axes:
                continue
            t = torch.stack([sq[i] for i in idx])
            dist.all_reduce(t, group=axis_group(mesh, axes))
            for j, i in enumerate(idx):
                sq[i] = t[j]
    return sq


def adamw_init(params, master_fp32: bool = True,
               moment_dtype: str = "float32") -> dict:
    """The state of a new run: the master copy (f32, or the params' own
    dtype with ``master_fp32=False``), zero moments in ``moment_dtype``
    and step 0, on the params' device."""
    mdt = getattr(torch, moment_dtype)
    zeros = lambda x: torch.zeros(x.shape, dtype=mdt, device=x.device)
    if master_fp32:
        master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                          params)
    else:
        master = tree_map(lambda x: x.detach().clone(), params)
    device = leaves(params)[0].device
    return {"master": master, "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _decay_mask(path: str) -> bool:
    """No weight decay on norms / biases / 1-d params."""
    return not any(k in path for k in _NO_DECAY)


def adamw_update(params, grads, opt: dict, tcfg, eps: float = 1e-8, *,
                 opt_shardings=None, param_shardings=None):
    """One AdamW step, written into ``params`` and ``opt`` in place.
    Returns (params, opt, metrics ``grad_norm`` and ``lr``, f32
    scalars); ``opt["step"]`` is a new tensor.  ``opt_shardings`` /
    ``param_shardings``: the layouts of the master (and of ``grads``, m
    and v) and of the params when the leaves are shards (see above)."""
    step = opt["step"] + 1
    lr = lr_schedule(tcfg)(step)
    gnorm = global_norm(grads, opt_shardings)  # f32 sums of the f32 grads
    scale = clip_scale(gnorm, tcfg.grad_clip)

    b1, b2, wd = tcfg.beta1, tcfg.beta2, tcfg.weight_decay
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32,
                             device=stepf.device) ** stepf
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32,
                             device=stepf.device) ** stepf

    def moment(x, beta, update):
        """``beta * x + update`` (x up-cast to f32), into x when x is f32:
        the reference's roundings, one per product and sum."""
        if x.dtype == torch.float32:
            return x.mul_(beta).add_(update)
        out = (beta * x.to(torch.float32)).add_(update)
        x.copy_(out)
        return out

    def write_param(p, mst, psh, osh):
        if psh is None or psh == osh:
            p.copy_(mst)
        else:
            p.copy_(osh.reshard(mst.to(p.dtype), psh))

    def upd(path, p, mst, g, m, v, psh, osh):
        g = g.to(torch.float32) * scale  # a new f32 leaf: grads stay as given
        v32 = moment(v, b2, g.square().mul_(1 - b2))
        m32 = moment(m, b1, g.mul_(1 - b1))
        del g
        delta = torch.div(m32, bc1).div_(torch.div(v32, bc2).sqrt_()
                                          .add_(eps))
        if _decay_mask(keystr(path)):
            delta.add_(torch.mul(mst.to(torch.float32), wd))
        delta.mul_(lr)
        if mst.dtype == torch.float32:
            mst.sub_(delta)
        else:
            mst.copy_(mst.to(torch.float32).sub_(delta))
        write_param(p, mst, psh, osh)

    n = len(leaves(params))
    psh = leaves(param_shardings) if param_shardings is not None \
        else [None] * n
    osh = leaves(opt_shardings) if opt_shardings is not None else [None] * n
    with torch.no_grad():
        for (path, p), mst, g, m, v, ps, os_ in zip(
                leaves_with_path(params), leaves(opt["master"]),
                leaves(grads), leaves(opt["m"]), leaves(opt["v"]), psh,
                osh):
            upd(path, p, mst, g, m, v, ps, os_)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}
