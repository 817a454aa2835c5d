"""Cell construction for the dry-run: which layout a cell takes, the
argument shardings of a state, batch or cache, the inputs' stand-ins, and
the step of each (architecture x shape x mesh) with this rank's
arguments.

Translated from ``src/repro/launch/specs.py``.  ``input_specs`` gives
tensors on the ``meta`` device (shape and dtype, no storage) where the
reference has ``ShapeDtypeStruct``.  :func:`cache_shardings` and
:func:`serve_param_shardings` are the serving cells' argument layouts,
which the port's prefill and decode take under tensor parallelism.

:func:`build_cell` resolves a cell as the reference's does and holds the
step and *one rank's* arguments: each leaf this rank's block, allocated
at its layout's shard shape on the device and drawn from a seeded
generator (no rank ever holds the full state).  The reference lowers the
step for a compiler; the port has none, and :func:`lower_cell` returns
the callable that runs the step once on this rank, under
``launch.counts.Counts``.  The mesh may be an ``AbstractMesh`` to resolve
and lay out a cell; running it needs a process group
(``launch.dryrun_lib.fake_group``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      TrainConfig, get_config)
from repro_torch.device import resolve_device
from repro_torch.models.encdec import enc_len_for
from repro_torch.parallel.sharding import (MODEL, AxisRules, Sharding,
                                           axis_rules, make_rules,
                                           map_logical, mesh_axes)
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten


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


def rules_for(cfg: ModelConfig, mesh, kind: str,
              fsdp: Optional[bool] = None) -> AxisRules:
    """The cell's rules; ``fsdp`` None takes :func:`use_fsdp` of ``cfg``
    (the reference's rule), a bool sets it."""
    mesh_axes_ = tuple(mesh.mesh_dim_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_axes_)
    mode = "train" if kind == "train" else ("decode" if kind == "decode"
                                            else "prefill")
    if fsdp is None:
        fsdp = use_fsdp(cfg, kind)
    return make_rules(mesh, mode=mode, fsdp=fsdp, zero1=True,
                      dp_axes=dp_axes)


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
    sh = tree_arg_shardings(_full_cache(cfg, B, S, rows[-1]), logical, rules)
    if "len" in sh:
        sh["len"] = arg_sharding((B,), ("batch",), rules)
    return sh


def _full_cache(cfg: ModelConfig, B: int, S: int, enc_len: int):
    """The whole cache of ``B`` sequences and ``S`` positions (an
    ``encdec`` cache's cross rows ``enc_len``) on the meta device."""
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    with axis_rules(None):
        if cfg.family == "encdec":
            return encdec.init_cache(cfg, B, S, device="meta",
                                     enc_len=enc_len)
        return M.init_cache(cfg, B, S, device="meta")


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


# ----------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    """Everything needed to run one (arch x shape x mesh) combination on
    one rank (the reference's fields; ``args`` this rank's tensors, and
    ``tcfg`` the train cells' ``TrainConfig``)."""
    cfg: ModelConfig
    shape: ShapeSpec
    rules: AxisRules
    fn: Any                   # the step
    args: tuple               # this rank's argument trees
    in_shardings: tuple
    kind: str
    donate: tuple = ()        # donated arg indices (state / KV cache)
    out_shardings: Any = None # donated outputs keep their input layouts
    tcfg: Optional[TrainConfig] = None


#: the standard deviation of the dry-run's weight draws
WEIGHT_STD = 0.02


def _draw(path, shape, dtype, cfg, gen, dev) -> torch.Tensor:
    """One rank's block ``shape`` of the leaf at ``path``: a draw that
    keeps the step finite (the dry-run counts work; its values need not be
    the model's init), by the leaf's role: norm scales and ``Dskip`` ones,
    biases and the LoRA ``qb`` / ``ib`` zeros, Mamba2's ``A_log`` and
    ``dt_bias`` in their init ranges, every other weight a normal
    truncated to [-2, 2] times :data:`WEIGHT_STD`."""
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    name = path[-1]
    if name in ("scale", "norm", "Dskip"):
        return torch.ones(shape, dtype=dtype, device=dev)
    if name in ("bq", "bk", "bv", "qb", "ib") or name.endswith("_b"):
        return torch.zeros(shape, dtype=dtype, device=dev)
    x = torch.empty(shape, dtype=torch.float32, device=dev)
    if name == "A_log":
        return x.uniform_(*cfg.ssm.a_init_range, generator=gen).log_().to(
            dtype)
    if name == "dt_bias":
        lo, hi = math.log(cfg.ssm.dt_min), math.log(cfg.ssm.dt_max)
        dt = x.uniform_(0.0, 1.0, generator=gen).mul_(hi - lo).add_(lo).exp_()
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(WEIGHT_STD).to(dtype)


def _local_tree(shapes, shardings, cfg, gen, dev, dtype=None, zeros=False):
    """This rank's block of each leaf of the full-shape tree ``shapes``
    (meta tensors) in its layout: drawn by :func:`_draw`, or zeros;
    ``dtype`` in place of each leaf's own."""
    flat = dict(leaves_with_path(shapes))
    sh = dict(leaves_with_path(shardings))

    def one(path):
        x = flat[path]
        shape = sh[path].shard_shape(tuple(x.shape))
        dt = dtype or x.dtype
        if zeros:
            return torch.zeros(shape, dtype=dt, device=dev)
        return _draw(path, shape, dt, cfg, gen, dev)

    return unflatten(shapes, [one(p) for p in flat])


def _batch(cfg, shape: ShapeSpec, shardings, gen, dev, local: bool) -> dict:
    """The cell's batch, drawn: the global batch (``local`` False: the
    train step takes it whole on every rank and narrows its rows) or this
    rank's rows of it (prefill and decode); tokens and labels uniform over
    the vocabulary, M-RoPE positions 0..S-1 on each axis, a loss mask of
    ones, normal vision embeddings and encoder frames."""
    out = {}
    for k, x in input_specs(cfg, shape).items():
        full = tuple(x.shape)
        shp = shardings[k].shard_shape(full) if local else full
        if dev.type == "meta":
            out[k] = torch.empty(shp, dtype=x.dtype, device=dev)
        elif k in ("tokens", "labels"):
            out[k] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                   device=dev, dtype=x.dtype)
        elif k == "positions":
            out[k] = torch.arange(shp[1], dtype=x.dtype, device=dev)[
                None, :, None].expand(shp).contiguous()
        elif k == "loss_mask":
            out[k] = torch.ones(shp, dtype=x.dtype, device=dev)
        else:
            out[k] = torch.randn(shp, generator=gen, device=dev).to(x.dtype)
    return out


def build_cell(arch: str, shape_name: str, mesh,
               overrides: Optional[dict] = None,
               cfg: Optional[ModelConfig] = None,
               tcfg_overrides: Optional[dict] = None,
               device=None, seed: int = 0,
               fsdp: Optional[bool] = None) -> Cell:
    """The cell ``arch`` x ``shape_name`` (a ``SHAPES`` name, or a
    ``ShapeSpec`` of its own) on ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``), resolved as the reference's ``build_cell``:
    ``cfg.resolve(tp, dp)``, :func:`rules_for` (``fsdp`` None: the
    reference's choice on the resolved config, which a depth override
    can flip to ZeRO-1; a bool keeps a production cell's layout at a cut
    depth); train with 8
    microbatches, a bf16 master and bf16 moments where 14 bytes a
    parameter over the chips reach 11 GB (else 4, f32 and f32), its state
    donated; decode donating its cache.  The arguments are this rank's
    blocks on ``device`` (None: the card; ``"meta"``: shapes only), drawn
    from a generator seeded by ``seed``: the train state in
    ``training.train_step.state_shardings``' layout and the global batch
    (the port's step narrows it to the rank's rows); the serving params in
    :func:`serve_param_shardings`' layout (the reference's FSDP layout
    gives way to it, ROADMAP Queue 3 item 25), prefill's rows of the
    batch, decode's cache in :func:`cache_shardings`' layout with every
    row at ``seq_len - 1`` positions (one new token against a full cache)
    and its rows of the tokens."""
    from repro_torch.models import model as M
    from repro_torch.training.train_step import (make_train_step,
                                                 state_shardings)
    shape = shape_name if isinstance(shape_name, ShapeSpec) \
        else SHAPES[shape_name]
    sizes = mesh_axes(mesh)
    tp = sizes.get(MODEL, 1)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if cfg is None:
        cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg = cfg.resolve(tp=tp, dp=dp)
    kind = shape.kind
    rules = rules_for(cfg, mesh, kind, fsdp)
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed)
    b_shard = tree_arg_shardings(input_specs(cfg, shape),
                                 batch_logical(cfg, kind), rules)
    with axis_rules(None):
        p_full = M.init_params(cfg, torch.Generator(), "meta")

    if kind == "train":
        chips = math.prod(sizes.values())
        hbm_bound = cfg.param_count() * 14 / chips >= 11e9
        tkw = dict(microbatches=8 if hbm_bound else 4,
                   master_fp32=not hbm_bound,
                   moment_dtype="bfloat16" if hbm_bound else "float32")
        tkw.update(tcfg_overrides or {})
        tcfg = TrainConfig(**tkw)
        state_shard = state_shardings(cfg, rules)
        o_sh = state_shard["opt"]["master"]
        params = _local_tree(p_full, state_shard["params"], cfg, gen, dev)
        master = _local_tree(p_full, o_sh, cfg, gen, dev,
                             dtype=torch.float32 if tcfg.master_fp32
                             else None)
        mdt = getattr(torch, tcfg.moment_dtype)
        state = {"params": params,
                 "opt": {"master": master,
                         "m": _local_tree(p_full, o_sh, cfg, gen, dev, mdt,
                                          zeros=True),
                         "v": _local_tree(p_full, o_sh, cfg, gen, dev, mdt,
                                          zeros=True),
                         "step": torch.zeros((), dtype=torch.int32,
                                             device=dev)}}
        batch = _batch(cfg, shape, b_shard, gen, dev, local=False)
        step = make_train_step(cfg, tcfg, rules)

        def fn(state, batch):
            with axis_rules(rules):
                return step(state, batch)

        return Cell(cfg, shape, rules, fn, (state, batch),
                    (state_shard, b_shard), kind, donate=(0,),
                    out_shardings=(state_shard, None), tcfg=tcfg)

    params_shard = serve_param_shardings(cfg, rules)
    params = _local_tree(p_full, params_shard, cfg, gen, dev)
    batch = _batch(cfg, shape, b_shard, gen, dev, local=True)

    if kind == "prefill":
        def fn(params, batch):
            with axis_rules(rules):
                return M.prefill(params, cfg, batch)

        return Cell(cfg, shape, rules, fn, (params, batch),
                    (params_shard, b_shard), kind)

    # decode: one new token against a seq_len KV cache
    B, S = shape.global_batch, shape.seq_len
    cache_shard = cache_shardings(cfg, rules, B, S)
    cache = _local_tree(_full_cache(cfg, B, S, enc_len_for(S)), cache_shard,
                        cfg, gen, dev, zeros=True)
    if "len" in cache:
        cache["len"].fill_(S - 1)

    def fn(params, cache, tokens):
        with axis_rules(rules):
            return M.decode_step(params, cfg, cache, tokens)

    return Cell(cfg, shape, rules, fn, (params, cache, batch["tokens"]),
                (params_shard, cache_shard, b_shard["tokens"]), kind,
                donate=(1,), out_shardings=(None, cache_shard))


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors."""
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


@dataclasses.dataclass
class CellRun:
    """One run of a cell's step on this rank: its output, its counts
    (``launch.counts.Counts``: collectives, flops, bytes), its seconds and
    its memory in the reference's ``memory_analysis`` terms."""
    out: Any
    counts: Any
    seconds: float
    memory: Dict[str, Optional[int]]


def lower_cell(cell: Cell):
    """The reference lowers the step for XLA and compiles it; the port has
    no compiler to ask.  This returns the callable that runs
    ``cell.fn(*cell.args)`` once on this rank under ``launch.counts.
    Counts`` (its collectives, flops and bytes) and returns a
    :class:`CellRun`.  Its memory: the arguments' bytes (this rank's
    blocks as the cell holds them), the output's, the donated arguments'
    (the port updates them in place: the reference's alias), and on a
    card the peak allocated over the run (``torch.cuda.
    max_memory_allocated`` after ``reset_peak_memory_stats``) less the
    arguments (None on the CPU); no generated code.  A second call runs
    on the state or cache the first one updated."""
    from repro_torch.launch.counts import Counts

    def run() -> CellRun:
        dev = next(x for x in leaves(cell.args)
                   if isinstance(x, torch.Tensor)).device
        cuda = dev.type == "cuda"
        args_b = tree_bytes(cell.args)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with Counts() as counts:
            out = cell.fn(*cell.args)
            if cuda:
                torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        memory = {
            "argument_size_in_bytes": args_b,
            "output_size_in_bytes": tree_bytes(out),
            "alias_size_in_bytes": sum(tree_bytes(cell.args[i])
                                       for i in cell.donate),
            "temp_size_in_bytes": (torch.cuda.max_memory_allocated(dev)
                                   - args_b) if cuda else None,
            "generated_code_size_in_bytes": 0}
        return CellRun(out, counts, seconds, memory)

    return run
