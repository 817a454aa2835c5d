"""Shared building blocks of the port's models: initializers, stacked
layer trees, RMSNorm, RoPE / M-RoPE, embeddings and logits, the MLP
(SwiGLU or GELU), and for training the chunked cross-entropy and the
per-layer rematerialisation (``maybe_remat``).

Translated from the reference's ``models/common.py``; the tensor layouts
and the parameter leaf names are the reference's, so a parameter tree
carried across by :func:`repro_torch.interop.params_from_reference` runs
here unchanged.  Random draws take an explicit ``torch.Generator``: the
port cannot replay the reference's jax PRNG streams, so the tests hand
both sides the same weights instead.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.parallel.sharding import (axis_rules, current_layer_gather,
                                           current_rules, dp_sum,
                                           gather_model, layer_gather,
                                           model_group, reduce_from_model,
                                           tp_index)

#: logits of the padded vocabulary rows (as the reference's ``-1e30``)
PAD_LOGIT = -1e30


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal_init(shape: Sequence[int], stddev: float, dtype: torch.dtype,
                generator: torch.Generator,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``stddev`` x a normal truncated to [-2, 2], drawn in f32 on the
    generator's device, then cast to ``dtype`` and moved to ``device``.
    On the meta device nothing is drawn: the shape and dtype only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x.mul_(stddev)).to(dtype=dtype, device=device or x.device)


def stacked_init(init_layer: Callable[[], dict], n: int) -> dict:
    """``n`` layers drawn one at a time by ``init_layer()``, each cast
    into its slot of leaves stacked on a leading layer axis, so no list
    of per-layer copies is ever held."""
    def stack(x):
        if isinstance(x, dict):
            return {k: stack(v) for k, v in x.items()}
        out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
        out[0] = x
        return out

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    layers = stack(init_layer())
    for i in range(1, n):
        fill(layers, init_layer(), i)
    return layers


def stacked_logical(lg: dict) -> dict:
    """A layer's logical-axis tree with ``"layers"`` in front of every
    leaf: the tree of its stacked leaves (the reference's
    ``stacked_logical``)."""
    return {k: stacked_logical(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in lg.items()}


def layer_slice(tree: dict, i) -> dict:
    """Layer ``i`` (an int, or a tuple of leading indices) of a stacked
    layer tree (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_params(params: dict, stack: str, i) -> dict:
    """Layer ``i`` of the stack ``params[stack]`` for a training layer's
    body: :func:`layer_slice`'s views, but under the FSDP train step's
    layer gather (``parallel.sharding.LayerGather``) each leaf the step
    keeps as this rank's shard all-gathered over the data-parallel axes
    for this layer alone, its gradient reduced into the step's
    accumulator by the backward.  Called inside the layer's
    :func:`maybe_remat` body, so the recompute gathers again and nothing
    gathered outlives the layer's forward or its backward (under
    ``remat="none"`` autograd keeps every layer's gathered weights for
    the backward)."""
    lg = current_layer_gather()
    if lg is None:
        return layer_slice(params[stack], i)
    return lg.layer(params[stack], (stack,), i)


# ----------------------------------------------------------------------
# RMSNorm
def init_rmsnorm(d: int, device=None) -> dict:
    """The scale is kept in f32 whatever the model's dtype."""
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_logical() -> dict:
    return {"scale": ("noshard",)}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ----------------------------------------------------------------------
# Rotary embeddings
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


@functools.lru_cache(maxsize=64)
def _rope_tables(head_dim: int, theta: float, sections: Optional[tuple],
                 device: torch.device):
    """The inverse frequencies (D/2,) and, for M-RoPE, the position
    component each channel takes (D/2,) int64, built once per shape and
    device: building them on the card for every call costs launches, and
    ``repeat_interleave`` with repeats on the card syncs with the host."""
    inv = rope_freqs(head_dim, theta, device)
    if sections is None:
        return inv, None
    owner = [c for c, n in enumerate(sections) for _ in range(n)]
    return inv, torch.tensor(owner, dtype=torch.int64, device=device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x`` (B, S, H, D) by ``ang`` (B, S, D/2)."""
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int -> rotated x."""
    inv, _ = _rope_tables(x.shape[-1], theta, None, x.device)   # (D/2,)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions: (B, S, 3) — (temporal, height, width) position ids.  The
    D/2 frequency channels are partitioned into ``sections`` (t, h, w);
    each partition takes its angle from the corresponding component.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {half}")
    inv, sel = _rope_tables(x.shape[-1], theta, tuple(sections), x.device)
    # the section-owner component of each channel, times its frequency
    ang = positions.float()[..., sel] * inv                      # (B,S,D/2)
    return _rotate(x, ang)


def default_positions(cfg, B: int, S: int, device=None) -> torch.Tensor:
    """(B, S) int32 positions, or (B, S, 3) for M-RoPE."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] \
        .expand(B, S)
    if cfg.mrope:
        return pos[..., None].expand(B, S, 3)
    return pos


# ----------------------------------------------------------------------
# Embedding + logits (padded vocab)
def init_embedding(cfg, generator: torch.Generator, device=None) -> dict:
    dt = dtype_of(cfg)
    V, D = cfg.padded_vocab, cfg.d_model
    p = {"tok": normal_init((V, D), 0.02, dt, generator, device)}
    if not cfg.tie_embeddings:
        p["head"] = normal_init((V, D), cfg.d_model ** -0.5, dt, generator,
                                device)
    return p


def embedding_logical(cfg) -> dict:
    lg = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        lg["head"] = ("vocab", "embed")
    return lg


def embed_tokens(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the table, by ``index_select``: its backward is
    an ``index_add`` (atomics on the card), where indexing's is a sort.

    Under tensor parallelism the table is this rank's block of the
    vocabulary (``vocab -> model``): a token outside it gives a zero row,
    so the rows are partial sums over the model ranks (the caller sums
    them, ``parallel.sharding.scatter_seq``: reduce-scattered into the
    sequence blocks in train and prefill, all-reduced in decode)."""
    tok = p["tok"]
    V = tok.shape[0]
    lo = tp_index() * V
    if lo == 0 and V >= cfg.padded_vocab:
        return tok.index_select(0, tokens.reshape(-1)).view(
            *tokens.shape, tok.shape[-1])
    ids = tokens.reshape(-1).long() - lo
    mine = (ids >= 0) & (ids < V)
    rows = tok.index_select(0, torch.where(mine, ids, 0))
    return torch.where(mine[:, None], rows, 0).view(*tokens.shape,
                                                    tok.shape[-1])


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) x (K, N) -> (..., N) f32 from operands of one dtype (on
    the card ``out_dtype``: f32 sums of the operands as they are; the CPU
    has no such product and upcasts them, which gives the same
    function)."""
    if not a.is_cuda:
        return a.float() @ b.float()
    return torch.mm(a.reshape(-1, a.shape[-1]), b,
                    out_dtype=torch.float32).reshape(*a.shape[:-1],
                                                      b.shape[-1])


def _split_f32(g: torch.Tensor, dtype):
    """f32 ``g`` as three tensors of ``dtype``, one at a time, whose sum
    is ``g``: for bf16 each takes the next 8 of f32's 24 significand bits,
    so the sum is exact (bf16 has f32's exponent range)."""
    r = g
    for _ in range(3):
        p = r.to(dtype)
        yield p
        r = r - p.to(torch.float32)


class _MatmulF32(torch.autograd.Function):
    """:func:`_mm_f32` with its backward.  The reference's autodiff
    multiplies the f32 cotangent with the other operand; here the
    cotangent is split into three parts of the operands' dtype
    (:func:`_split_f32`), each product summed in f32 on the tensor cores
    and the three added, so no bit of the cotangent is lost.  Each
    gradient is then cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        a2 = a.reshape(-1, a.shape[-1]).t()
        ga = gb = None
        for p in _split_f32(g, a.dtype):
            pa = _mm_f32(p, b.t())
            pb = _mm_f32(a2, p.reshape(-1, p.shape[-1]))
            ga = pa if ga is None else ga.add_(pa)
            gb = pb if gb is None else gb.add_(pb)
        return ga.to(a.dtype), gb.to(b.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32, as the reference's
    ``preferred_element_type=jnp.float32``.  On the card a bf16 product
    keeps its operands (``out_dtype``, under grad through
    :class:`_MatmulF32`); the CPU upcasts them, which gives the same
    function."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return _mm_f32(a, b)
    return a.float() @ b.float()


def logits_from_hidden(p, cfg, h: torch.Tensor) -> torch.Tensor:
    """h: (B, S, D) -> logits (B, S, V_padded) f32 (padded vocab = -1e30).
    Under tensor parallelism the table is this rank's block of the
    vocabulary, and so are the logits' columns."""
    table = p["tok"] if cfg.tie_embeddings else p["head"]
    logits = matmul_f32(h, table.t())
    pad = cfg.vocab_size - tp_index() * table.shape[0]
    if pad < logits.shape[-1]:
        if logits.requires_grad:
            # the product may be an autograd.Function's output, which
            # autograd does not let be written in place: write a copy
            logits = logits.clone()
        logits[..., max(pad, 0):] = PAD_LOGIT
    return logits


def whole_logits(p, cfg, h: torch.Tensor) -> torch.Tensor:
    """h (B, 1, D), the same on every model rank -> the logits (B,
    V_padded) f32 of the whole vocabulary on every rank: under tensor
    parallelism each rank's block of the vocabulary (:func:`
    logits_from_hidden`) all-gathered, so greedy tokens agree across the
    ranks."""
    return gather_model(logits_from_hidden(p, cfg, h)[:, 0], -1)


# ----------------------------------------------------------------------
# MLP: SwiGLU, or GELU (tanh approximation) without the gate
def init_mlp(cfg, generator: torch.Generator, device=None,
             d_ff: Optional[int] = None, d_in: Optional[int] = None,
             swiglu: bool = True) -> dict:
    """Draws in order: wi, wo, then wg for SwiGLU."""
    dt = dtype_of(cfg)
    D, Fd = d_in or cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": normal_init((D, Fd), D ** -0.5, dt, generator, device),
         "wo": normal_init((Fd, D), Fd ** -0.5, dt, generator, device)}
    if swiglu:
        p["wg"] = normal_init((D, Fd), D ** -0.5, dt, generator, device)
    return p


def mlp_logical(swiglu: bool = True) -> dict:
    lg = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if swiglu:
        lg["wg"] = ("embed", "mlp")
    return lg


def mlp(p, x: torch.Tensor, swiglu: bool = True) -> torch.Tensor:
    """SwiGLU, or ``jax.nn.gelu``'s default, the tanh approximation."""
    if swiglu:
        return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]


# ----------------------------------------------------------------------
# Training: the chunked cross-entropy and per-layer rematerialisation
class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of logits whose columns are
    split over ``group``'s ranks: the max and the sum of exponentials
    all-reduced, the gradient ``exp(x - lse)`` on this rank's columns, as
    ``logsumexp``'s own (every rank holds the whole ``lse`` and its whole
    gradient).  With no group, the same operations in the same order as
    ``logsumexp``, so the value is its own bit for bit."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        m = x.amax(dim=-1, keepdim=True)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = (x - m).exp_().sum(dim=-1)
        if group is not None:
            dist.all_reduce(s, group=group)
        lse = s.log_().add_(m.squeeze(-1))
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - lse.unsqueeze(-1)).exp(), None


def chunked_cross_entropy(logits_fn: Callable, h: torch.Tensor,
                          labels: torch.Tensor, cfg,
                          valid_mask: Optional[torch.Tensor] = None):
    """Cross-entropy over sequence chunks of ``min(cfg.loss_chunk, S)``
    positions, as the reference's scan: no (B, S, V) f32 logits at once.

    logits_fn: h chunk (B, C, D) -> logits (B, C, V) f32; labels (B, S)
    int.  Returns (mean nll over the valid positions, their count), both
    f32 scalars: each chunk's nll summed, then added in chunk order.

    Under sharding rules ``h`` holds this rank's rows of the global batch:
    the count is summed over the data-parallel ranks first
    (``parallel.sharding.dp_sum``), and the loss returned is this rank's
    share, its rows' nll over the global count, so the ranks' shares add
    up to the global batch's mean and their gradients to its gradient.

    Under tensor parallelism ``logits_fn`` gives this rank's block of the
    vocabulary (Megatron's vocab-parallel loss): the max and the sum of
    exponentials are all-reduced over the model ranks, the label's logit
    is the owning rank's (summed, the others' zero), and every model rank
    returns the same loss, whose gradient reaches only its own columns."""
    B, S, _ = h.shape
    C = min(cfg.loss_chunk, S)
    if S % C:
        raise ValueError(f"the sequence ({S}) must be a multiple of "
                         f"loss_chunk ({cfg.loss_chunk}) or shorter")
    group, rank = model_group(), tp_index()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, C):
        logits = logits_fn(h[:, i:i + C])
        lse = _LogSumExp.apply(logits, group)
        V = logits.shape[-1]
        lc = labels[:, i:i + C].long() - rank * V
        mine = (lc >= 0) & (lc < V)
        picked = logits.gather(-1, torch.where(mine, lc, 0)[..., None])[..., 0]
        picked = reduce_from_model(torch.where(mine, picked, 0.0))
        nll = lse - picked
        if valid_mask is None:
            vc = torch.ones_like(nll)
        else:
            vc = valid_mask[:, i:i + C].to(torch.float32)
            nll = nll * vc
        tot = tot + nll.sum()
        cnt = cnt + vc.sum()
    cnt = dp_sum(cnt)
    return tot / cnt.clamp_min(1.0), cnt


#: the matmuls with no batch dims: what ``remat="dots"`` keeps (the
#: reference's ``checkpoint_dots_with_no_batch_dims``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(cfg, fn: Callable) -> Callable:
    """``fn`` under the config's rematerialisation, as the reference's
    ``maybe_remat``: ``"full"`` keeps only its inputs and runs it again in
    the backward pass (``torch.utils.checkpoint``, non-reentrant),
    ``"dots"`` keeps the outputs of its plain matmuls and recomputes the
    rest, ``"none"`` keeps everything.  The numbers are the same in all
    three.  Without grad (serving) ``fn`` runs as it is.

    The recompute runs in the backward pass, which for CUDA tensors runs
    on autograd's own thread, where the caller's context variables are
    not set; so the sharding rules and the FSDP layer gather active at
    the forward are bound to it and entered again around the
    recompute."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        rules, layers = current_rules(), current_layer_gather()

        def under_rules(*a):
            with axis_rules(rules), layer_gather(layers):
                return fn(*a)

        return checkpoint(under_rules, *args, use_reentrant=False, **kw)

    return wrapped
