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
returns the same dict.

With ``rules`` (``parallel.sharding.make_rules`` on a ``(data, model)``
or ``(pod, data, model)`` mesh) the step is the reference's ZeRO-1 /
FSDP step, its collectives explicit on ``torch.distributed``; every rank
calls it with the same *global* batch:

- the state is held in the reference's argument layouts
  (:func:`state_shardings`): the params by ``params_logical`` (``embed ->
  data`` under FSDP), master / m / v with ``embed -> opt_embed`` (ZeRO-1);
  :func:`make_train_state` places a new state, and
  ``parallel.sharding.gather`` gathers one back;
- the params the forward takes are whole over the data-parallel axes,
  layer by layer under FSDP, as the reference's GSPMD schedules its
  scanned body: each stacked layer leaf that a data-parallel axis splits
  (:func:`layer_gathered`) stays this rank's shard and is all-gathered
  for one layer inside that layer's ``maybe_remat`` body
  (``models.common.layer_params``, ``parallel.sharding.LayerGather``), in
  the forward and again in the recompute, per microbatch, and freed
  after use; its gradient is reduced into the f32 accumulator as soon
  as autograd produces it (below).  Under ``remat="none"`` autograd
  keeps every layer's gathered weights from the forward to the
  backward.  The other leaves (the embedding, ``final_norm``, Zamba2's
  ``shared`` block, the norms, and everything under ZeRO-1) are
  all-gathered once a step, before the first microbatch;
- microbatches are split from the global batch first and then over the
  data-parallel ranks, as the reference reshapes the global batch to
  ``(n, B/n, ...)`` and shards each microbatch: rank ``r`` takes rows
  ``i*B/n + r*B/(n*dp)`` on of microbatch ``i``;
- the loss and the MoE statistics are the global batch's (the models'
  ``dp_sum``): each rank's loss is its share, so the shares' gradients
  add up to the global gradient;
- each microbatch's f32 gradients are reduce-scattered into the
  optimizer's layout and all-reduced over the other data-parallel axes
  (``pod``), and over ``model`` where the leaf is replicated there, as
  the reference's ``c_opt`` places them, and summed into an f32
  accumulator in that layout: a layer-gathered leaf's layer by layer
  from the backward (``LayerGather.reduce``), the others after the
  microbatch's backward;
- AdamW updates the local shard (the clip's norm global), and the params
  keep their shard under FSDP or are all-gathered from the new master
  (ZeRO-1).

It is the single-device step's body: without rules every split and
collective above is the identity.

The metrics are the reference's and the same on every rank: ``loss``,
``aux_loss`` and ``tokens`` of the last microbatch, ``total_loss`` the
mean, ``grad_norm`` and ``lr``, each of the global batch.

The ``model`` axis is tensor parallelism (Megatron's, with the
sequence-parallel residual), for every family: a leaf whose layout
splits a dim over ``model`` (heads, mlp, vocab, experts, ``ssm_inner``)
stays this rank's block, the models compute on their blocks with
explicit collectives over the model axis (``models.model._dec_layer``,
``models.hybrid``, ``models.encdec``), and the params are gathered over
the data-parallel axes only.  A leaf replicated over ``model`` has a
partial gradient on each model rank (the norms under the sequence split,
the kv projections that each rank slices to its q heads' kv heads, the
router's combine part, MLA's latent projections and norms, Mamba2's
``in_B`` / ``in_C`` / ``in_dt``, ``conv_B`` / ``conv_C`` and its
per-head ``A_log`` / ``Dskip`` / ``dt_bias`` cut to the rank's heads,
Zamba2's LoRA ``qa`` / ``ia`` and ``down``, the encoder-decoder's ``wk``
/ ``wv`` of both stacks, its ``ln1``-``ln3``, ``enc_norm`` and
``final_norm``; the aux loss enters each rank's backward at ``1 / tp``,
``parallel.sharding.replicated_term``), so it is summed over the model
axis with the data-parallel ones.  The encoder's output is gathered
whole on every rank; its gradient, partial on each (the rank's kv heads
of every cross-attention), is reduce-scattered once into the encoder's
sequence blocks inside the model (``models.encdec.encode``).  Heads that
do not split (Mamba2's, Zamba2's shared block's) raise ``ValueError``
(``models.model.check_tp``, which prefill, decode and ``init_cache``
share), and so does a config whose model-split dims do not divide the
axis (resolve it with ``tp``), and a sequence (the encoder's frames too)
that does not split over it.  Serving under tensor parallelism (prefill
and decode with the sequence-parallel KV cache) is ``models.model``'s.

``tcfg.grad_compression`` raises ``NotImplementedError``: the
reference's step never reads the flag (its int8 all-reduce,
``optim.compression``, is called by hand), and a step that accepted it
and did nothing would hide that.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.parallel.sharding import (MODEL, AxisRules, LayerGather,
                                           LayerLeaf, Sharding, axis_index,
                                           axis_rules, axis_size,
                                           current_layer_gather, dp_sum,
                                           layer_gather, map_logical,
                                           mesh_axes, place)
from repro_torch.tree import (keystr, leaves, leaves_with_path, tree_map,
                              unflatten)


def state_shardings(cfg, rules: AxisRules) -> dict:
    """The train state's layouts under ``rules``, the reference's
    ``build_cell`` argument shardings: the params by ``params_logical``,
    master / m / v with ``embed`` read as ``opt_embed``, the step
    replicated (a mesh axis that does not divide a dim is dropped)."""
    from repro_torch.launch.specs import arg_sharding
    shapes = M.init_params(cfg, torch.Generator(), "meta")
    p_logical = M.params_logical(cfg)
    swap = {"embed": "opt_embed"}

    def par(axes, x):
        return arg_sharding(tuple(x.shape), axes, rules)

    def opt(axes, x):
        return arg_sharding(tuple(x.shape),
                            tuple(swap.get(a, a) for a in axes), rules)

    o = map_logical(opt, p_logical, shapes)
    return {"params": map_logical(par, p_logical, shapes),
            "opt": {"master": o, "m": o, "v": o,
                    "step": Sharding(rules.mesh, ())}}


def make_train_state(cfg, tcfg, generator: torch.Generator,
                     device=None, rules: Optional[AxisRules] = None) -> dict:
    """``{"params", "opt"}``: parameters drawn from ``generator`` on
    ``device`` (None: the CUDA card) and a new AdamW state.  With
    ``rules`` every rank draws the same full state and keeps its shards
    (:func:`state_shardings`)."""
    params = M.init_params(cfg, generator, device)
    state = {"params": params,
             "opt": adamw_init(params, tcfg.master_fp32, tcfg.moment_dtype)}
    if rules is None:
        return state
    return place(state, state_shardings(cfg, rules))


def value_and_grad(cfg, params, batch):
    """(loss, metrics, grads in the params' dtypes) of one batch; a leaf
    the loss does not reach gets zeros.  Under the FSDP step's layer
    gather (``parallel.sharding.LayerGather``) a leaf it gathers layer by
    layer gets None: the backward reduced its gradient into the step's
    accumulator."""
    lg = current_layer_gather()
    paths = [p for p, _ in leaves_with_path(params)]
    xs = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.train_forward(unflatten(params, xs), cfg, batch)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    out = []
    for path, x, g in zip(paths, xs, gs):
        if lg is not None and path in lg.leaves:
            if g is not None:
                raise RuntimeError(f"{keystr(path)} was read outside its "
                                   f"layer's gather (models.common."
                                   f"layer_params)")
            out.append(None)
        else:
            out.append(torch.zeros_like(x) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, out))


def _summed_axes(rules: AxisRules, s: Sharding) -> tuple:
    """The mesh axes a gradient in the optimizer's layout ``s`` is summed
    over: the data-parallel ones and, where the leaf is replicated over
    the model axis (its gradient partial on each model rank), that."""
    if MODEL in s.axes():
        return rules.batch_axes
    return tuple(a for a in rules.mesh.mesh_dim_names
                 if a in rules.batch_axes or a == MODEL)


def layer_gathered(cfg, rules: AxisRules) -> dict:
    """{key path: ``parallel.sharding.LayerLeaf``} of the stacked leaves
    that the FSDP step keeps as this rank's shards and gathers layer by
    layer: those whose params' layout splits a dim over a data-parallel
    axis (none under ZeRO-1).  Both layouts drop the model axis (a
    model-split dim stays this rank's block)."""
    sh = state_shardings(cfg, rules)

    def entry(axes, p, o):
        k = 0
        while k < len(axes) and axes[k] == "layers":
            k += 1
        if not k or not set(p.axes()) & set(rules.batch_axes):
            return None
        return LayerLeaf(p.without((MODEL,)), o.without((MODEL,)),
                         _summed_axes(rules, o), k)

    tree = map_logical(entry, M.params_logical(cfg), sh["params"],
                       sh["opt"]["master"])
    return {p: e for p, e in leaves_with_path(tree) if e is not None}


def _check_rules(cfg, rules: AxisRules) -> None:
    sizes = mesh_axes(rules.mesh)
    if set(sizes) - {"pod", "data", MODEL}:
        raise ValueError(f"the train step takes a (pod,) data, model mesh, "
                         f"not {tuple(sizes)}")
    tp = sizes.get(MODEL, 1)
    if tp == 1:
        return
    M.check_tp(cfg, tp)
    sh = state_shardings(cfg, rules)["params"]
    split = map_logical(
        lambda axes, s: any(rules.physical(a) == MODEL for a in axes if a)
        and MODEL not in s.axes(), M.params_logical(cfg), sh)
    bad = [keystr(p) for p, x in leaves_with_path(split) if x]
    if bad:
        raise ValueError(
            f"{cfg.name}: {', '.join(bad)} do not split over a model axis "
            f"of {tp}; resolve the config with tp={tp}")


def make_train_step(cfg, tcfg, rules: Optional[AxisRules] = None,
                    grad_fn: Callable = value_and_grad,
                    on_grads: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; with
    ``rules`` the data-parallel step over their mesh.  ``grad_fn(cfg,
    params, batch) -> (loss, metrics, grads)`` gives each microbatch's
    gradients (:func:`value_and_grad`; a test may hand two steps the
    same ones): with ``rules``, ``params`` holds the leaves the step
    gathers layer by layer (:func:`layer_gathered`) as this rank's shards
    and every other leaf whole over the data-parallel axes, and ``grads``
    is each leaf's gradient in that whole layout, or None for a
    layer-gathered leaf, whose gradient goes into the step's accumulator
    through the active ``parallel.sharding.LayerGather`` (by the
    backward, or by hand: ``LayerGather.reduce_stack``);
    ``on_grads(grads, shardings)``, where given, sees the
    gradients AdamW takes (in the optimizer's layout, ``shardings`` None
    without rules) before it takes them."""
    if tcfg.grad_compression:
        raise NotImplementedError(
            "grad_compression is read by no train step, the reference's "
            "included (its int8 all-reduce, optim.compression."
            "make_compressed_allreduce, is called by hand); the port "
            "refuses the flag rather than ignore it")
    n = max(tcfg.microbatches, 1)
    p_sh = o_sh = None
    if rules is not None:
        _check_rules(cfg, rules)
        sh = state_shardings(cfg, rules)
        p_sh, o_sh = sh["params"], sh["opt"]["master"]
        # the params are gathered over the data-parallel axes only (a
        # model-split dim stays this rank's block), and each gradient is
        # summed over them and, where the leaf is replicated over the
        # model axis (its gradient partial on each model rank), over it;
        # the stacked leaves FSDP splits stay shards, gathered layer by
        # layer inside the models (``LayerGather``)
        layered = layer_gathered(cfg, rules)
        g_sh = tree_map(lambda s: s.without((MODEL,)), p_sh)

        def reduce(g, s):
            return s.without((MODEL,)).sum_into(g, _summed_axes(rules, s))

        def forward_params(params):
            """The params the forward takes: every leaf gathered over the
            data-parallel axes but the layer-gathered ones."""
            return unflatten(params, [
                x if path in layered else s.gather(x)
                for (path, x), s in zip(leaves_with_path(params),
                                        leaves(g_sh))])

        def accumulator(state):
            """A new step's ``LayerGather``: its f32 accumulators in the
            optimizer's layout (the master's shard shapes), zeros."""
            if not layered:
                return None
            master = dict(leaves_with_path(state["opt"]["master"]))
            return LayerGather(rules.mesh, layered, {
                p: torch.zeros(master[p].shape, dtype=torch.float32,
                               device=master[p].device) for p in layered})

    def rows(batch, i, dp, r):
        out = {}
        for k, v in batch.items():
            B = v.shape[0]
            if B % (n * dp):
                raise ValueError(f"a global batch of {B} rows does not "
                                 f"split into {n} microbatches over {dp} "
                                 f"data-parallel ranks")
            per = B // (n * dp)
            out[k] = v.narrow(0, i * (B // n) + r * per, per)
        return out

    def to_opt(grads):
        """One microbatch's gradients in the optimizer's layout: as they
        are for one microbatch on one device, else in f32 (and under
        rules summed over the ranks, ``reduce``); a None (a leaf the
        backward already reduced) stays None."""
        if rules is None:
            return grads if n == 1 else tree_map(
                lambda g: g.to(torch.float32), grads)
        return tree_map(lambda g, s: None if g is None
                        else reduce(g.to(torch.float32), s), grads, o_sh)

    def train_step(state, batch):
        if rules is None:
            dp, r, params, lg = 1, 0, state["params"], None
        else:
            dp = axis_size(rules.mesh, rules.batch_axes)
            r = axis_index(rules.mesh, rules.batch_axes)
            params, lg = forward_params(state["params"]), accumulator(state)
        acc, loss_sum = None, 0.0
        for i in range(n):
            if lg is not None:
                lg.first = i == 0
            with axis_rules(rules), layer_gather(lg):
                loss, metrics, grads = grad_fn(cfg, params,
                                               rows(batch, i, dp, r))
                loss = dp_sum(loss)
                metrics = {k: v if k == "tokens" else dp_sum(v)
                           for k, v in metrics.items()}
            grads = to_opt(grads)
            acc = grads if acc is None else tree_map(
                lambda a, g: a if g is None else torch.add(a, g), acc, grads)
            loss_sum = loss_sum + loss
        if n > 1:
            acc = tree_map(lambda g: None if g is None else g / n, acc)
            if lg is not None:
                # the layer-gathered leaves' accumulators, divided in
                # place (no second copy of them)
                for t in lg.acc.values():
                    t.div_(n)
            loss_sum = loss_sum / n
        if lg is not None:
            acc = unflatten(acc, [lg.acc[p] if g is None else g
                                  for p, g in leaves_with_path(acc)])
            del lg
        del params
        if on_grads is not None:
            on_grads(acc, o_sh)
        new_params, opt, opt_metrics = adamw_update(
            state["params"], acc, state["opt"], tcfg, opt_shardings=o_sh,
            param_shardings=p_sh)
        metrics = dict(metrics)
        metrics.update({k: v.detach() for k, v in opt_metrics.items()})
        metrics["total_loss"] = loss_sum
        state["params"], state["opt"] = new_params, opt
        return state, metrics

    return train_step
