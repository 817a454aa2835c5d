"""The rule half of the reference's ``launch/specs.py``: which layout a
cell takes, the argument shardings of a state or batch, and the inputs'
stand-ins.

Translated from ``src/repro/launch/specs.py:29-139``.  ``input_specs``
gives tensors on the ``meta`` device (shape and dtype, no storage) where
the reference has ``ShapeDtypeStruct``.  :func:`cache_shardings` and
:func:`serve_param_shardings` are the serving cells' argument layouts
(the reference's ``build_cell``, ``specs.py:204-227``), which the port's
prefill and decode take under tensor parallelism.  The reference's
``build_cell`` / ``lower_cell`` (the dry-run's compiled step) have no
counterpart yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.encdec import enc_len_for
from repro_torch.parallel.sharding import (MODEL, AxisRules, Sharding,
                                           axis_rules, make_rules,
                                           map_logical, mesh_axes)
from repro_torch.tree import tree_map


def use_fsdp(cfg: ModelConfig, kind: str) -> bool:
    """Shard weight d_model dims over the dp axis.

    train: params + optimizer (master/m/v = 12 B/param fp32) must fit
    16 GB/chip -> FSDP for everything over ~8B params.
    serve: bf16 params / tp must leave room for the KV cache.
    """
    n = cfg.param_count()
    if kind == "train":
        return n > 8e9
    return n * 2 / 16 > 8e9        # tp=16 fixed in the production mesh


def rules_for(cfg: ModelConfig, mesh, kind: str) -> AxisRules:
    mesh_axes_ = tuple(mesh.mesh_dim_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_axes_)
    mode = "train" if kind == "train" else ("decode" if kind == "decode"
                                            else "prefill")
    return make_rules(mesh, mode=mode, fsdp=use_fsdp(cfg, kind),
                      zero1=True, dp_axes=dp_axes)


def arg_sharding(shape: Tuple[int, ...], axes, rules: AxisRules) -> Sharding:
    """The sharding of a step *argument*: drops axes that don't divide."""
    sizes = mesh_axes(rules.mesh)
    parts = []
    used = set()
    for dim, name in zip(shape, axes):
        phys = rules.physical(name) if name else None
        cand = phys if isinstance(phys, tuple) else ((phys,) if phys else ())
        cand = tuple(a for a in cand if a not in used)
        total = math.prod(sizes[a] for a in cand) if cand else 1
        if cand and dim % total == 0:
            used.update(cand)
            parts.append(cand if len(cand) > 1 else cand[0])
        else:
            parts.append(None)
    return Sharding(rules.mesh, tuple(parts))


def tree_arg_shardings(tree, logical_tree, rules: AxisRules):
    """:func:`arg_sharding` of each leaf of ``tree`` (tensors, meta ones
    included, or anything with a ``shape``) by its logical axes."""
    return map_logical(lambda axes, x: arg_sharding(tuple(x.shape), axes,
                                                    rules),
                       logical_tree, tree)


def cache_shardings(cfg: ModelConfig, rules: AxisRules, B: int, S: int,
                    enc_len: Optional[int] = None) -> Dict[str, Sharding]:
    """The layouts of a serving cache of ``B`` sequences and ``S``
    positions under ``rules``: :func:`tree_arg_shardings` of the cache's
    leaves by ``cache_logical`` (the reference's ``build_cell`` decode
    cache sharding: rows over the data-parallel axes where ``B`` splits,
    ``kv_seq`` and ``ssm_inner -> model``), which ``models.model``'s
    ``init_cache``, ``prefill`` and ``decode_step`` hold each rank's block
    of.  An ``encdec`` cache's cross rows ``ck`` / ``cv`` number
    ``enc_len`` (the encoder's frames; default ``enc_len_for(S)``).  Two
    departures: ``len`` splits like the cache's rows (a rank holds its
    rows' lengths; the reference's is replicated), and a cache with rows
    (``kv_seq``) whose ``S`` (or ``enc_len``) does not split over the
    model axis raises ``ValueError`` where the reference would replicate
    the cache (the ``ssm`` family's cache has no rows, and any ``S``)."""
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    sizes = mesh_axes(rules.mesh)
    tp = sizes.get(MODEL, 1)
    M.check_tp(cfg, tp)
    logical = M.cache_logical(cfg)
    has_rows = any("kv_seq" in v for v in logical.values()
                   if isinstance(v, tuple))
    rows = (S, enc_len_for(S) if enc_len is None else enc_len) \
        if cfg.family == "encdec" else (S,)
    for n in rows if has_rows and rules.physical("kv_seq") == MODEL else ():
        if n % tp:
            raise ValueError(f"a KV cache of {n} rows does not split over "
                             f"{tp} model ranks (kv_seq -> model)")
    with axis_rules(None):
        shapes = (encdec.init_cache(cfg, B, S, device="meta", enc_len=rows[1])
                  if cfg.family == "encdec"
                  else M.init_cache(cfg, B, S, device="meta"))
    sh = tree_arg_shardings(shapes, logical, rules)
    if "len" in sh:
        sh["len"] = arg_sharding((B,), ("batch",), rules)
    return sh


def serve_param_shardings(cfg: ModelConfig, rules: AxisRules):
    """The layouts of the params that prefill and decode take under
    ``rules``: each leaf's ``arg_sharding`` by ``params_logical`` (heads,
    mlp, vocab and experts split over ``model``) with the data-parallel
    axes dropped, so a rank holds its model block of each leaf whole
    along them.  The reference's serving FSDP (``embed -> data`` past
    64 B parameters, :func:`use_fsdp`) gathers every weight inside the
    step instead."""
    from repro_torch.models import model as M
    shapes = M.init_params(cfg, torch.Generator(), "meta")
    sh = tree_arg_shardings(shapes, M.params_logical(cfg), rules)
    return tree_map(lambda s: s.without(rules.batch_axes), sh)


# ----------------------------------------------------------------------
def batch_logical(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    lg: Dict[str, tuple] = {}
    if kind == "train":
        lg["tokens"] = ("batch", None)
        lg["labels"] = ("batch", None)
        if cfg.family == "vlm":
            lg["vision_embeds"] = ("batch", None, None)
            lg["positions"] = ("batch", None, None)
            lg["loss_mask"] = ("batch", None)
        if cfg.family == "encdec":
            lg["enc_frames"] = ("batch", None, None)
    elif kind == "prefill":
        lg["tokens"] = ("batch", None)
        if cfg.family == "vlm":
            lg["vision_embeds"] = ("batch", None, None)
            lg["positions"] = ("batch", None, None)
        if cfg.family == "encdec":
            lg["enc_frames"] = ("batch", None, None)
    else:  # decode
        lg["tokens"] = ("batch", None)
    return lg


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        batch = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = sds((B, cfg.num_frontend_tokens,
                                          cfg.d_model), bf16)
            batch["positions"] = sds((B, S, 3), i32)
            batch["loss_mask"] = sds((B, S), torch.float32)
        if cfg.family == "encdec":
            batch["enc_frames"] = sds((B, enc_len_for(S), cfg.d_model), bf16)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": sds((B, S), i32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = sds((B, cfg.num_frontend_tokens,
                                          cfg.d_model), bf16)
            batch["positions"] = sds((B, S, 3), i32)
        if cfg.family == "encdec":
            batch["enc_frames"] = sds((B, enc_len_for(S), cfg.d_model), bf16)
        return batch
    # decode: one new token against a seq_len KV cache
    return {"tokens": sds((B, 1), i32)}
