"""The train step of the port: value and grad of ``train_forward``,
global-norm clipping and AdamW, with optional microbatch accumulation.

Translated from the reference's ``training/train_step.py``:

- :func:`make_train_state` draws the parameters (``models.model.
  init_params``) and the optimizer state (``optim.adamw.adamw_init``);
- :func:`value_and_grad` gives one batch's loss, metrics and gradients;
- :func:`make_train_step` returns ``train_step(state, batch) -> (state,
  metrics)``.  The gradients come from autograd through the models'
  kernels (``FlashAttention``, ``GMM``: their backward kernels on the
  card, their plain versions on the CPU).  With ``microbatches = n > 1``
  the batch splits into n equal parts along its first axis, the
  gradients accumulate in f32 and are averaged, the loss is the mean and
  the other metrics are the last microbatch's.  The metrics are the
  model's (``loss``, ``aux_loss``, ``tokens``), the optimizer's
  (``grad_norm``, ``lr``) and ``total_loss`` (the loss the gradients are
  of, aux loss included), as detached f32 scalars.

The step writes the new parameters and optimizer state into the state's
own tensors (see :func:`repro_torch.optim.adamw.adamw_update`) and
returns the same dict.  The reference's multi-device placement
(``rules``, ZeRO-1 / FSDP constraints) and the int8 gradient compression
need collectives across cards, which the port has not yet (ROADMAP Queue
1 item 9): both raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.tree import leaves, tree_map, unflatten


def make_train_state(cfg, tcfg, generator: torch.Generator,
                     device=None) -> dict:
    """``{"params", "opt"}``: parameters drawn from ``generator`` on
    ``device`` (None: the CUDA card) and a new AdamW state."""
    params = M.init_params(cfg, generator, device)
    return {"params": params,
            "opt": adamw_init(params, tcfg.master_fp32, tcfg.moment_dtype)}


def value_and_grad(cfg, params, batch):
    """(loss, metrics, grads in the params' dtypes) of one batch; a leaf
    the loss does not reach gets zeros."""
    xs = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.train_forward(unflatten(params, xs), cfg, batch)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = unflatten(params, [torch.zeros_like(x) if g is None else g
                               for x, g in zip(xs, gs)])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, tcfg, rules: Optional[object] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``."""
    if rules is not None:
        raise NotImplementedError(
            "sharding rules place the step across several cards; the port "
            "trains on one (ROADMAP Queue 1 item 9)")
    if tcfg.grad_compression:
        raise NotImplementedError(
            "int8 gradient compression is a cross-card all-reduce; the port "
            "trains on one card (ROADMAP Queue 1 item 9)")
    n = tcfg.microbatches

    def compute_grads(params, batch):
        if n <= 1:
            return value_and_grad(cfg, params, batch)
        acc, loss_sum = None, 0.0
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics, grads = value_and_grad(cfg, params, mb)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
            acc = grads if acc is None else tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        return loss_sum / n, metrics, tree_map(lambda g: g / n, acc)

    def train_step(state, batch):
        loss, metrics, grads = compute_grads(state["params"], batch)
        params, opt, opt_metrics = adamw_update(state["params"], grads,
                                                state["opt"], tcfg)
        metrics = dict(metrics)
        metrics.update({k: v.detach() for k, v in opt_metrics.items()})
        metrics["total_loss"] = loss
        state["params"], state["opt"] = params, opt
        return state, metrics

    return train_step
