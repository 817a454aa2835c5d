"""Logical-axis sharding of the port, on ``torch.distributed``.

Translated from the reference's ``parallel/sharding.py`` (t5x-style,
minimal).  Model code names tensor dims by *logical* axes; a rule set maps
them onto the physical axes of a device mesh.  The rules live in a context
variable, so the same code runs on one device (no rules) and on a mesh.

Logical axes used across the framework:

  batch      global batch                 -> ("pod","data") / ("data",)
  act_seq    activation sequence dim      -> None (kept local)
  kv_seq     KV-cache sequence dim        -> "model" (sequence-parallel cache)
  heads      q attention heads            -> "model"
  kv_heads   kv heads (GQA, small)        -> None (replicated)
  mlp        FFN hidden                   -> "model"
  vocab      vocabulary                   -> "model"
  experts    MoE experts                  -> "model"  (expert parallelism)
  groups     MoE dispatch groups          -> dp axes
  embed      weight d_model dim           -> "data" when FSDP else None
  ssm_inner  mamba inner channels         -> "model"
  layers     stacked-layer leading dim    -> None

The reference hands its layouts to GSPMD, which inserts the collectives.
Here a rank holds local shards and the collectives are explicit:

- a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh.
  make_mesh``), or an :class:`AbstractMesh` (shape and axis names, no
  process group) where only layouts are computed;
- :class:`Sharding` (mesh + spec) is the counterpart of a
  ``NamedSharding``: ``local`` slices a full tensor to this rank's shard,
  ``gather`` all-gathers a shard back to the full tensor, and
  :func:`place` / :func:`gather` do so over trees;
- under FSDP the train step keeps each stacked layer leaf that a
  data-parallel axis splits as this rank's shard: :class:`LayerGather`
  all-gathers one layer of it inside the layer's body and reduces the
  layer's gradient into the step's f32 accumulator from the backward;
- :func:`dp_sum` sums a statistic over the data-parallel ranks (the ranks
  of the ``batch`` axes); without rules it is the identity.  The models
  use it where a loss or a router statistic is a mean over the *global*
  batch (``models.common.chunked_cross_entropy``, ``models.moe``);
- :func:`shard` checks an activation's rank against its logical axes and
  returns it: the port's tensors are already local shards, and the train
  step sets their layout (``training.train_step``);
- tensor parallelism over ``model`` (Megatron's, with its sequence-parallel
  residual) is explicit in the models: :func:`tp_size` / :func:`tp_index`
  and the differentiable collectives over the model axis,
  :func:`gather_seq` / :func:`scatter_seq` (an all-gather along the
  sequence whose backward reduce-scatters, and the reverse: Megatron's
  ``f`` and ``g`` under its sequence-parallel residual; under the decode
  rules, which keep the residual whole, the identity and an all-reduce),
  :func:`take_seq_block` (a rank's block of a sequence whole on every
  rank, whose backward all-gathers), :func:`reduce_from_model` (an
  all-reduce whose backward passes the cotangent on) and
  :func:`sum_over_model` (an all-reduce whose backward all-reduces too);
  :func:`model_block` cuts a replicated per-head vector to the rank's
  heads, and :func:`check_seq_split` refuses a training sequence that
  does not split.  Each captures its process group in its forward: a
  CUDA backward (and ``maybe_remat``'s recompute with it) runs on
  autograd's own thread, which does not see the caller's rules;
- the serving cache is sequence-parallel (``kv_seq -> model``): a model
  rank holds the contiguous block :func:`kv_block` of the cache's rows for
  every kv head, attends over it alone, and :func:`combine_over_model`
  merges the ranks' partial attentions by their log-sum-exps
  (flash-decoding's combine across ranks).

A spec is a plain tuple whose entries equal the reference's
``PartitionSpec``'s: an axis name, a tuple of names, or None.  A tuple
entry splits its dim over those axes, the first the slowest, and a rank's
index over them is its rank in the group of those axes (the ranks of a
mesh made by ``init_device_mesh`` ascend in row-major order, so that is
its row-major coordinate).  Every collective runs over the axes a spec
names, whatever their size: on a one-rank mesh the step still runs each
of them, over one-rank groups.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.tree import tree_map

Physical = Union[None, str, Tuple[str, ...]]


class AbstractMesh:
    """A mesh's shape and axis names, with no devices or process group:
    enough to compute rules, specs and shard shapes (the reference's
    ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             f"in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axis_names)

    def __repr__(self):
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class AxisRules:
    def __init__(self, mesh, rules: Dict[str, Physical]):
        self.mesh = mesh
        self.rules = dict(rules)

    @functools.cached_property
    def model_axis(self):
        """(group, size, this rank's index) of the mesh's model axis, or
        None without one; found once a rule set (a decode step asks for
        it dozens of times a layer)."""
        if MODEL not in mesh_axes(self.mesh):
            return None
        return (axis_group(self.mesh, (MODEL,)),
                axis_size(self.mesh, (MODEL,)),
                axis_index(self.mesh, (MODEL,)))

    def physical(self, logical: Optional[str]) -> Physical:
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"no rule for logical axis {logical!r}")
        return self.rules[logical]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the global batch splits over (the data-parallel
        axes)."""
        return _axes(self.physical("batch"))


_ACTIVE: contextvars.ContextVar[Optional[AxisRules]] = contextvars.ContextVar(
    "axis_rules", default=None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


def current_rules() -> Optional[AxisRules]:
    return _ACTIVE.get()


def _axes(entry: Physical) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def logical_to_pspec(axes: Sequence[Optional[str]],
                     rules: Optional[AxisRules] = None) -> tuple:
    """The spec of a tensor whose dims carry the logical ``axes``: a mesh
    axis is used by the first dim that names it, later dims drop it.  A
    dim left with one mesh axis names it alone, as ``PartitionSpec``
    normalises a one-axis tuple."""
    rules = rules or current_rules()
    if rules is None:
        return ()
    parts, used = [], set()
    for name in axes:
        phys = rules.physical(name)
        if isinstance(phys, tuple):
            phys = tuple(a for a in phys if a not in used)
            used.update(phys)
            parts.append(None if not phys else
                         phys[0] if len(phys) == 1 else phys)
        else:
            if phys in used:
                phys = None
            if phys is not None:
                used.add(phys)
            parts.append(phys)
    return tuple(parts)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Check activation ``x`` against its logical axes and return it.

    No-op outside an ``axis_rules`` context.  Inside one the port's
    tensors are already this rank's shards (the step placed them), so
    there is no constraint to apply; the rank check is the reference's.
    """
    if current_rules() is None:
        return x
    assert x.ndim == len(axes), (tuple(x.shape), axes)
    return x


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_logical(fn, logical_tree, *trees):
    """``fn(axes, *leaves)`` over a tree of logical-axis tuples and trees
    of the same structure."""
    if _is_axes_leaf(logical_tree):
        return fn(logical_tree, *trees)
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, *(t[k] for t in trees))
                for k, v in logical_tree.items()}
    return type(logical_tree)(map_logical(fn, v, *(t[i] for t in trees))
                              for i, v in enumerate(logical_tree))


def specs_for_tree(logical_tree, rules: AxisRules):
    """Map a tree of logical-axis tuples to :class:`Sharding` objects.

    Argument shardings must divide evenly, so this is used for params /
    caches / inputs whose dims were padded at config-resolution time.
    """
    return map_logical(
        lambda axes: Sharding(rules.mesh, logical_to_pspec(axes, rules)),
        logical_tree)


# ----------------------------------------------------------------------
def make_rules(mesh, *, mode: str, fsdp: bool, zero1: bool = True,
               dp_axes: Tuple[str, ...] = ("data",)) -> AxisRules:
    """Build the rule set for ``mode`` in {"train","prefill","decode"}.

    fsdp:  shard weight `embed` dims over the data axis (params + grads);
    zero1: shard *optimizer state* over the data axis even when params are
           replicated (applied in the optimizer, uses the "opt_embed" rule).
    """
    rules: Dict[str, Physical] = {
        "batch": dp_axes,
        "act_seq": None,
        # sequence-parallel residual stream (Megatron-SP), train and
        # prefill; decode activations are a single position
        "residual_seq": "model" if mode in ("train", "prefill") else None,
        "kv_seq": "model",
        "heads": "model",
        "kv_heads": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "groups": dp_axes,
        "layers": None,
        "ssm_inner": "model",
        "embed": "data" if fsdp else None,
        "opt_embed": "data" if (fsdp or zero1) else None,
        "noshard": None,
    }
    if mode in ("decode", "prefill"):
        # no optimizer in serving; FSDP-style 2D weights only if requested
        rules["opt_embed"] = rules["embed"]
    return AxisRules(mesh, rules)


# ----------------------------------------------------------------------
# process groups and placement
def axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank over the mesh ``axes`` (the ranks
    that differ only in those coordinates): the mesh's own for one axis;
    for several, made by every rank in the same order on first use and
    kept on the mesh."""
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in groups:
        import torch.distributed as dist
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(rest + dims).reshape(
            -1, math.prod(mesh.mesh.shape[d] for d in dims))
        groups[axes], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[axes]


def axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index over the mesh ``axes``, the first the slowest."""
    import torch.distributed as dist
    return dist.get_group_rank(axis_group(mesh, axes), dist.get_rank())


def axis_size(mesh, axes: Sequence[str]) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


class Sharding:
    """A tensor's layout on a mesh: ``spec[d]`` names the mesh axes dim
    ``d`` splits over (a spec shorter than the tensor leaves the rest
    whole), the counterpart of the reference's ``NamedSharding``."""

    def __init__(self, mesh, spec: Sequence[Physical]):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, Sharding) and self.mesh is other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return f"Sharding({self.spec})"

    def parts(self, ndim: int) -> Tuple[Tuple[str, ...], ...]:
        """Each dim's axes (empty when whole)."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than {ndim} dims")
        return tuple(_axes(e) for e in self.spec) + ((),) * (
            ndim - len(self.spec))

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the tensor is split over, in the mesh's order."""
        names = tuple(self.mesh.mesh_dim_names)
        used = {a for e in self.spec for a in _axes(e)}
        return tuple(a for a in names if a in used)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        sizes = mesh_axes(self.mesh)
        out = []
        for n, ax in zip(shape, self.parts(len(shape))):
            k = math.prod(sizes[a] for a in ax)
            if n % k:
                raise ValueError(f"dim {n} does not split over {ax} ({k})")
            out.append(n // k)
        return tuple(out)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor ``x`` (a copy; ``x``
        itself when nothing splits)."""
        sizes = mesh_axes(self.mesh)
        out = x
        for d, ax in enumerate(self.parts(x.ndim)):
            if not ax:
                continue
            k = math.prod(sizes[a] for a in ax)
            if x.shape[d] % k:
                raise ValueError(f"dim {x.shape[d]} does not split over "
                                 f"{ax} ({k})")
            n = x.shape[d] // k
            out = out.narrow(d, axis_index(self.mesh, ax) * n, n)
        return x if out is x else out.contiguous().clone()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard ``x`` (an all-gather
        over each split dim's axes; ``x`` itself when nothing splits)."""
        for d, ax in enumerate(self.parts(x.ndim)):
            if ax:
                x = _all_gather(x, d, axis_group(self.mesh, ax),
                                axis_size(self.mesh, ax))
        return x

    def without(self, axes: Sequence[str]) -> "Sharding":
        """This layout with the mesh ``axes`` dropped from every dim: the
        layout of a shard that is already local along them."""
        parts = []
        for e in self.spec:
            ax = tuple(a for a in _axes(e) if a not in axes)
            parts.append(None if not ax else ax[0] if len(ax) == 1 else ax)
        return Sharding(self.mesh, parts)

    def reshard(self, x: torch.Tensor, target: "Sharding") -> torch.Tensor:
        """This rank's shard ``x`` in this layout, cut to ``target``'s: a
        dim split alike in both is left as it is, any other all-gathered
        over this layout's axes and sliced to the target's."""
        want = target.parts(x.ndim)
        for d, ax in enumerate(self.parts(x.ndim)):
            if ax == want[d]:
                continue
            if ax:
                x = _all_gather(x, d, axis_group(self.mesh, ax),
                                axis_size(self.mesh, ax))
            x = Sharding(self.mesh, (None,) * d + (want[d] or None,)).local(x)
        return x

    def sum_into(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Each rank's full-shape term ``x``, summed over the ranks of the
        mesh ``axes`` and returned in this layout: along a dim split over
        some of ``axes``, this rank's block of the dim's other axes
        reduce-scattered over those; an all-reduce over the rest of
        ``axes``; this rank's slice along the spec's other axes."""
        import torch.distributed as dist
        names = tuple(self.mesh.mesh_dim_names)
        sizes = mesh_axes(self.mesh)
        x = x.contiguous()
        done = []
        for d, ax in enumerate(self.parts(x.ndim)):
            red = tuple(a for a in names if a in ax and a in axes)
            if not red:
                continue
            # the dim as a grid over its axes (the first the slowest): keep
            # this rank's index along the axes that do not reduce, move the
            # ones that do in front in the mesh's order, and reduce-scatter
            n = x.shape[d]
            k = math.prod(sizes[a] for a in ax)
            if n % k:
                raise ValueError(f"dim {n} does not split over {ax} ({k})")
            g = x.reshape(*x.shape[:d], *(sizes[a] for a in ax), n // k,
                          *x.shape[d + 1:])
            for i in reversed(range(len(ax))):
                if ax[i] not in red:
                    g = g.narrow(d + i, axis_index(self.mesh, (ax[i],)), 1)
            keep = [ax.index(a) for a in red]
            g = g.movedim([d + i for i in keep], list(range(d, d + len(red))))
            g = g.reshape(*x.shape[:d], -1, *x.shape[d + 1:])
            x = _reduce_scatter(g, d, axis_group(self.mesh, red),
                                axis_size(self.mesh, red))
            done += ax
        rest = tuple(a for a in names if a in axes and a not in done)
        if rest:
            dist.all_reduce(x, group=axis_group(self.mesh, rest))
        return self.without(done).local(x)


def place(tree, shardings):
    """Each full leaf of ``tree`` cut to this rank's shard (the
    counterpart of ``jax.device_put`` with shardings)."""
    return tree_map(lambda x, s: s.local(x), tree, shardings)


# ----------------------------------------------------------------------
# FSDP: the stacked layers' weights gathered one layer at a time
class _GatherLayer(torch.autograd.Function):
    """One layer's shard of a stacked leaf all-gathered over the
    data-parallel axes; the backward reduces the layer's gradient into
    the step's accumulator (:meth:`LayerGather.reduce`) and passes
    nothing on.  The gather, the accumulator and whether this is the
    step's first microbatch are bound here, at the forward: a CUDA
    backward runs on autograd's own thread, without the caller's
    context."""

    @staticmethod
    def forward(ctx, x, lg, path, idx):
        ctx.lg, ctx.path, ctx.idx, ctx.first = lg, path, idx, lg.first
        return lg.layout(path, "param", idx).gather(x)

    @staticmethod
    def backward(ctx, g):
        ctx.lg.reduce(ctx.path, ctx.idx, g, ctx.first)
        return None, None, None, None


@dataclasses.dataclass(frozen=True)
class LayerLeaf:
    """A stacked leaf the FSDP step gathers layer by layer: ``param``,
    its layout as the forward takes it (the params' with the model axis
    dropped, so a model-split dim stays this rank's block); ``opt``, the
    optimizer's layout of its gradient (the model axis dropped too);
    ``summed``, the mesh axes its gradient is summed over; ``k``, its
    number of leading layer dims."""
    param: "Sharding"
    opt: "Sharding"
    summed: Tuple[str, ...]
    k: int


class LayerGather:
    """The FSDP train step's stacked leaves that a data-parallel axis
    splits, kept as this rank's shards and gathered layer by layer, as
    the reference's GSPMD gathers them inside its scanned, rematerialised
    body (``training.train_step.make_train_step``).

    ``leaves`` maps a leaf's key path to its :class:`LayerLeaf`, ``acc``
    to its f32 accumulator in the optimizer's layout, stacked like the
    leaf.  :meth:`layer` gathers one layer of a
    stack (``models.common.layer_params``, inside the layer's
    ``maybe_remat`` body: the recompute gathers again); each layer's
    gradient is reduced as soon as autograd produces it (:meth:`reduce`):
    cast to f32, reduce-scattered over the data-parallel axes that split
    it and all-reduced over the rest of the summed axes
    (:meth:`Sharding.sum_into`), then written into the layer's slot of
    the accumulator on the step's first microbatch (``first``) and added
    to it on the others: the arithmetic and the order of the sums of the
    whole-stack reduction it replaces, element by element."""

    def __init__(self, mesh, leaves: dict, acc: dict):
        self.mesh = mesh
        self.leaves = leaves
        self.acc = acc
        self.first = True
        self._cut = {}

    def layout(self, path, kind: str, idx) -> Sharding:
        """The ``kind`` ("param" or "opt") layout of one layer of the leaf
        at ``path``: its stacked layout without the ``len(idx)`` leading
        (layer) dims, which no rule splits."""
        k = 1 if isinstance(idx, int) else len(idx)
        key = (path, kind, k)
        if key not in self._cut:
            s = getattr(self.leaves[path], kind)
            if any(_axes(e) for e in s.spec[:k]):
                raise ValueError(f"{path}: a layer dim is split ({s.spec})")
            self._cut[key] = Sharding(self.mesh, s.spec[k:])
        return self._cut[key]

    def layer(self, tree: dict, path: tuple, idx) -> dict:
        """Layer ``idx`` (an int, or a tuple of leading indices) of the
        stacked ``tree`` at key path ``path``: each leaf this step keeps
        as a shard all-gathered over the data-parallel axes, the others
        as views."""
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = self.layer(v, p, idx)
            elif p in self.leaves:
                out[k] = _GatherLayer.apply(v[idx], self, p, idx)
            else:
                out[k] = v[idx]
        return out

    def reduce(self, path: tuple, idx, g: torch.Tensor, first: bool) -> None:
        """One layer's gradient ``g`` (this rank's term, whole over the
        data-parallel axes) summed into layer ``idx``'s slot of the
        accumulator of the leaf at ``path``; on the step's ``first``
        microbatch written into the slot instead of added to it."""
        s = self.layout(path, "opt", idx)
        r = s.sum_into(g.to(torch.float32), self.leaves[path].summed)
        slot = self.acc[path][idx]
        if first:
            slot.copy_(r)
        else:
            slot.add_(r)

    def reduce_stack(self, path: tuple, g: torch.Tensor) -> None:
        """A whole stack's gradient ``g`` of the leaf at ``path`` (this
        rank's term, whole over the data-parallel axes) reduced layer by
        layer, as the backward reduces each layer's: for a caller that
        hands the step gradients it computed itself
        (``testing.sharded_step_parity``)."""
        k = self.leaves[path].k
        for idx in itertools.product(*map(range, g.shape[:k])):
            self.reduce(path, idx[0] if k == 1 else idx, g[idx],
                        self.first)


_LAYERS: contextvars.ContextVar[Optional[LayerGather]] = \
    contextvars.ContextVar("layer_gather", default=None)


@contextlib.contextmanager
def layer_gather(lg: Optional[LayerGather]):
    """``lg`` active inside: the models gather their layers through it
    (``models.common.layer_params``)."""
    token = _LAYERS.set(lg)
    try:
        yield lg
    finally:
        _LAYERS.reset(token)


def current_layer_gather() -> Optional[LayerGather]:
    return _LAYERS.get()


def gather(tree, shardings):
    """The full leaves of a tree of this rank's shards (every rank gets
    them; a collective, so every rank calls it)."""
    return tree_map(lambda x, s: s.gather(x), tree, shardings)


# ----------------------------------------------------------------------
# data-parallel statistics under the active rules
def dp_size() -> int:
    """The number of data-parallel ranks (1 without rules)."""
    rules = current_rules()
    if rules is None:
        return 1
    return axis_size(rules.mesh, rules.batch_axes)


def dp_index() -> int:
    """This rank's index over the data-parallel axes (0 without rules)."""
    rules = current_rules()
    if rules is None:
        return 0
    return axis_index(rules.mesh, rules.batch_axes)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; its backward reduce-scatters (sums) the
    cotangent back to each rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim``; its backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _reduce_scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    y = x.detach().clone()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
    return y


class _Reduce(torch.autograd.Function):
    """All-reduce (sum); its backward passes the cotangent on."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def dp_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data-parallel rank's rows of ``x``, in rank order (the
    global batch's rows), differentiably: the gradient of each rank's
    rows is summed over the ranks.  ``x`` itself without rules."""
    rules = current_rules()
    if rules is None:
        return x
    axes = rules.batch_axes
    return _Gather.apply(x, 0, axis_group(rules.mesh, axes),
                         axis_size(rules.mesh, axes))


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel ranks (a detached copy), or
    ``x`` itself without rules.  For statistics that carry no gradient:
    token counts, router fractions, metrics."""
    rules = current_rules()
    if rules is None:
        return x
    return _all_reduce(x, axis_group(rules.mesh, rules.batch_axes))


# ----------------------------------------------------------------------
# tensor parallelism over the model axis (Megatron, sequence-parallel)
#: the mesh axis that heads, mlp, vocab and experts split over
MODEL = "model"


def _model(rules: Optional[AxisRules]):
    """(group, size) of the model axis under ``rules``, or None without
    rules or without a model axis in their mesh."""
    m = None if rules is None else rules.model_axis
    return None if m is None else m[:2]


def model_group():
    """The process group of the model axis, or None (no rules, or no
    model axis in their mesh)."""
    m = _model(current_rules())
    return None if m is None else m[0]


def tp_size() -> int:
    """The number of tensor-parallel ranks (1 without rules)."""
    m = _model(current_rules())
    return 1 if m is None else m[1]


def tp_index() -> int:
    """This rank's index over the model axis (0 without rules)."""
    rules = current_rules()
    m = None if rules is None else rules.model_axis
    return 0 if m is None else m[2]


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``g``: the model ranks' partial ``x`` summed; its
    gradient passed on as it is (each rank's is already whole)."""
    m = _model(current_rules())
    return x if m is None else _Reduce.apply(x, m[0])


class _SumBoth(torch.autograd.Function):
    """All-reduce (sum); its backward all-reduces the cotangent too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' partial ``x`` summed, where each rank goes on
    with the sum in a part of the graph of its own (the gated norm's sum
    of squares over ``ssm_inner`` channels split over the ranks, each
    rank normalising its own channels by it): the gradient of each
    rank's term is then the ranks' cotangents summed, so the backward
    all-reduces as well.  (:func:`reduce_from_model` passes the cotangent
    on, which is right only where everything downstream is the same on
    every rank.)  ``x`` itself without a model axis."""
    m = _model(current_rules())
    return x if m is None else _SumBoth.apply(x, m[0])


def model_block(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This model rank's block of a replicated ``x`` along ``dim``: rows
    ``[r n / tp, (r + 1) n / tp)`` of its ``n`` (a per-head vector such as
    Mamba2's ``dt_bias``, ``A_log`` and ``Dskip``, ``("noshard",)`` in the
    reference, cut to the rank's heads; its gradient is zero elsewhere,
    and the step sums a replicated leaf's over the model axis).  ``x``
    itself with one model rank; ``ValueError`` where ``n`` does not
    split."""
    tp = tp_size()
    if tp == 1:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"{n} rows do not split over {tp} model ranks")
    return x.narrow(dim, tp_index() * (n // tp), n // tp)


def _seq_split(rules: Optional[AxisRules]) -> bool:
    """Whether ``rules`` split the residual stream's sequence over the
    model axis (train and prefill; the decode rules keep it whole)."""
    return rules.rules.get("residual_seq") == MODEL


def seq_block(S: int) -> Tuple[int, int]:
    """(first position, rows) of this model rank's block of a residual
    sequence of ``S`` positions: ``ceil(S / tp)`` rows a rank, the last
    blocks padded past ``S`` (as GSPMD pads an uneven split); (0, S)
    without a sequence split."""
    rules = current_rules()
    m = _model(rules)
    if m is None or not _seq_split(rules):
        return 0, S
    n = -(-S // m[1])
    return tp_index() * n, n


def check_seq_split(S: int, what: str = "tokens") -> None:
    """``ValueError`` where a training sequence of ``S`` ``what`` does not
    split evenly over the tensor-parallel ranks (prefill pads the last
    block instead)."""
    tp = tp_size()
    if S % tp:
        raise ValueError(f"a sequence of {S} {what} does not split over "
                         f"{tp} tensor-parallel ranks")


def gather_seq(x: torch.Tensor, dim: int = 1,
               length: Optional[int] = None) -> torch.Tensor:
    """The whole sequence from each model rank's block of it (the
    sequence-parallel residual entering a column-parallel product); the
    gradient reduce-scattered back to each rank's block.  ``length``
    trims the padding of an uneven split (:func:`seq_block`).  The
    identity under rules that keep the residual whole (decode)."""
    rules = current_rules()
    m = _model(rules)
    if m is None or not _seq_split(rules):
        return x
    y = _Gather.apply(x, dim, *m)
    if length is None or y.shape[dim] == length:
        return y
    return y.narrow(dim, 0, length)


def scatter_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The model ranks' partial sums of a whole sequence (a row-parallel
    product's output), summed and split along the sequence into each
    rank's block (:func:`seq_block`: an uneven sequence padded with
    zeros first); the gradient all-gathered.  Under rules that keep the
    residual whole (decode) the partial sums all-reduced
    (:func:`reduce_from_model`)."""
    rules = current_rules()
    m = _model(rules)
    if m is None:
        return x
    if not _seq_split(rules):
        return _Reduce.apply(x, m[0])
    pad = -x.shape[dim] % m[1]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    return _Scatter.apply(x, dim, *m)


class _TakeBlock(torch.autograd.Function):
    """This rank's block of a whole ``x`` along ``dim`` (zeros past its
    end); the backward all-gathers the blocks' cotangents, trimmed to
    ``x``'s length."""

    @staticmethod
    def forward(ctx, x, dim, group, n, r):
        ctx.dim, ctx.group, ctx.n, ctx.S = dim, group, n, x.shape[dim]
        blk = -(-ctx.S // n)
        pad = blk * n - ctx.S
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim)
        return x.narrow(dim, r * blk, blk).contiguous()

    @staticmethod
    def backward(ctx, g):
        g = _all_gather(g, ctx.dim, ctx.group, ctx.n)
        return g.narrow(ctx.dim, 0, ctx.S), None, None, None, None


def take_seq_block(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This model rank's block (:func:`seq_block`) of a sequence that is
    whole on every rank (the encoder's frames entering the
    sequence-parallel residual), padded with zeros past its end as
    :func:`scatter_seq` pads.  :func:`scatter_seq` sums partial sums and
    would add whole frames tp times.  The gradient is all-gathered, so a
    replicated input's gradient is whole on every rank, as
    :func:`reduce_from_model` leaves it.  ``x`` itself without a sequence
    split."""
    rules = current_rules()
    m = _model(rules)
    if m is None or not _seq_split(rules):
        return x
    return _TakeBlock.apply(x, dim, *m, tp_index())


def seq_row(x: torch.Tensor, j: int, dim: int = 1) -> torch.Tensor:
    """Position ``j`` of the sequence whose block (:func:`seq_block`) this
    model rank holds in ``x``, on every model rank: the owner's row,
    summed with the others' zeros.  ``x.narrow(dim, j, 1)`` without a
    sequence split, copied as the all-reduce copies it, so one rank's
    products downstream take the same layout and give the same bits."""
    rules = current_rules()
    m = _model(rules)
    if m is None or not _seq_split(rules):
        return x.narrow(dim, j, 1).contiguous()
    n = x.shape[dim]
    at = j - tp_index() * n
    row = (x.narrow(dim, at, 1) if 0 <= at < n
           else torch.zeros_like(x.narrow(dim, 0, 1)))
    return _Reduce.apply(row, m[0])


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks of ``x`` along ``dim`` concatenated in rank
    order (heads, vocabulary), every rank getting them; ``x`` itself
    without a model axis."""
    m = _model(current_rules())
    return x if m is None else _Gather.apply(x, dim, *m)


def kv_split() -> bool:
    """Whether the active rules split the KV cache's rows over a model
    axis (``kv_seq -> model``, any size)."""
    rules = current_rules()
    return _model(rules) is not None and rules.physical("kv_seq") == MODEL


def kv_offset(n: int) -> int:
    """The first row of this model rank's block when each rank holds
    ``n`` rows of the sequence-parallel cache (0 without a split)."""
    return tp_index() * n if kv_split() else 0


def kv_block(S: int) -> Tuple[int, int]:
    """(first row, rows) of this model rank's block of a KV cache of ``S``
    rows under ``kv_seq -> model`` (the sequence-parallel cache); (0, S)
    without rules or a model axis.  ``ValueError`` where ``S`` does not
    split evenly: the reference's ``arg_sharding`` would replicate such a
    cache on every rank instead."""
    if not kv_split():
        return 0, S
    tp = tp_size()
    if S % tp:
        raise ValueError(f"a KV cache of {S} rows does not split over "
                         f"{tp} model ranks (kv_seq -> model): give a "
                         f"cache length that is a multiple of {tp}")
    n = S // tp
    return tp_index() * n, n


def combine_over_model(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Flash-decoding's combine across the model ranks: each rank's
    attention ``out`` (B, 1, H, Dv) over its block of the cache, with the
    log-sum-exp ``lse`` (B, H) f32 of its scores, merged into the
    attention over the whole cache.  ``M`` the all-reduced maximum of
    ``lse``, ``w = exp(lse - M)``; the all-reduced ``sum w * out`` over the
    all-reduced ``sum w`` (the two sums in one all-reduce), in f32,
    returned in ``out``'s dtype.  A rank
    whose block holds no valid row carries ``lse = -inf`` and weighs
    nothing.  On one rank ``w`` is 1 and the result is ``out`` bit for
    bit.  ``out`` itself without a model axis.  Serving only: no
    gradient."""
    import torch.distributed as dist
    m = _model(current_rules())
    if m is None:
        return out
    M = _all_reduce(lse, m[0], dist.ReduceOp.MAX).clamp_min_(-1e30)
    w = torch.exp(lse - M)[:, None, :, None]
    # sum w * out and sum w in one all-reduce
    both = torch.cat([out.float() * w, w], dim=-1)
    dist.all_reduce(both, group=m[0])
    return (both[..., :-1] / both[..., -1:].clamp_min(1e-30)).to(out.dtype)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def replicated_term(x: torch.Tensor) -> torch.Tensor:
    """``x``, a loss term every model rank computes in full from the same
    replicated inputs (the MoE aux loss), with its gradient divided by
    the model ranks: the collectives' backward sums the ranks' gradients
    of the replicated inputs, which would count it once a rank.  ``x``
    itself with one model rank."""
    n = tp_size()
    return x if n == 1 else _ScaleGrad.apply(x, 1.0 / n)
