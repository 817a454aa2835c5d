"""Attention of the port: the GQA block (init, QKV projection, RoPE /
M-RoPE, the prefill and decode forms, cross-attention, the int8 KV cache)
and Multi-head Latent Attention.

Translated from the reference's ``models/attention.py`` (``init_attention``,
``_project_qkv``, ``_rope_qk``, ``attention_fwd``, ``attention_decode``,
``init_mla``, ``_mla_q``, ``_mla_latent``, ``mla_fwd``, ``mla_decode``).
Where the reference calls its XLA ``blockwise_attention`` and
``decode_attention``, the port calls its kernels: ``kernels.
flash_attention`` on the GQA k/v as they are (no kv-head repeat) and
``kernels.decode_attention`` on the layer's cache.  On CUDA tensors the
kernels always launch; on CPU tensors their plain versions run.

MLA's prefill (``mla_fwd``) expands the latent into per-head k and v and
calls the flash kernel at D = qk_nope + qk_rope, Dv = v_head_dim, whose
own ``D ** -0.5`` is the reference's scale.  Its decode (``mla_decode``)
attends in the latent space with the absorbed matrices, as the reference
does outside any kernel: PyTorch ops in the reference's order.

The int8 KV cache quantises each new k / v row per token and kv head
(symmetric, ``max |x| / 127``, rounded half to even as ``jnp.round``;
the scale rounded as the reference's compiled multiply-add) and
dequantises the layer's cache to q's dtype before the decode kernel, as
the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dtype_of,
                                       init_rmsnorm, normal_init, rmsnorm)
from repro_torch.parallel.sharding import (combine_over_model, gather_model,
                                           kv_offset, kv_split, tp_index,
                                           tp_size)

#: the model families the port lowers: the reference's catalogue
LOWERED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
#: the reference's masked-score value
NEG_INF = -1e30


def check_lowered(cfg) -> None:
    """Raise ``NotImplementedError`` for a family outside the catalogue."""
    if cfg.family not in LOWERED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not in the catalogue (the port "
            f"serves {', '.join(LOWERED_FAMILIES)})")


def init_attention(cfg, generator: torch.Generator, device=None,
                   d_in: Optional[int] = None, d_out: Optional[int] = None,
                   num_heads: Optional[int] = None,
                   num_kv_heads: Optional[int] = None,
                   head_dim: Optional[int] = None) -> dict:
    """Draws in order: wq, wk, wv, wo.  The widths default to the
    config's (padded heads); Zamba2's shared block passes its own."""
    dt = dtype_of(cfg)
    D, Dout = d_in or cfg.d_model, d_out or cfg.d_model
    H = num_heads or cfg.padded_heads
    true_H = num_heads or cfg.num_heads
    KV, dh = num_kv_heads or cfg.padded_kv, head_dim or cfg.head_dim
    p = {"wq": normal_init((D, H, dh), D ** -0.5, dt, generator, device),
         "wk": normal_init((D, KV, dh), D ** -0.5, dt, generator, device),
         "wv": normal_init((D, KV, dh), D ** -0.5, dt, generator, device),
         "wo": normal_init((H, dh, Dout), (true_H * dh) ** -0.5, dt,
                           generator, device)}
    if H > true_H:  # padded heads contribute exactly zero
        p["wq"][:, true_H:] = 0
        p["wo"][true_H:] = 0
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, dh), dtype=dt, device=p["wq"].device)
        p["bk"] = torch.zeros((KV, dh), dtype=dt, device=p["wq"].device)
        p["bv"] = torch.zeros((KV, dh), dtype=dt, device=p["wq"].device)
    return p


def attention_logical(cfg) -> dict:
    lg = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
          "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    if cfg.qkv_bias:
        lg.update(bq=("heads", None), bk=("kv_heads", None),
                  bv=("kv_heads", None))
    return lg


def mla_logical() -> dict:
    return {"wdq": ("embed", None), "wuq": (None, "heads", None),
            "wdkv": ("embed", None), "wukv": (None, "heads", None),
            "wo": ("heads", None, "embed"),
            "q_norm": ("noshard",), "kv_norm": ("noshard",)}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    D, H, dh = w.shape
    return (x @ w.reshape(D, H * dh)).reshape(*x.shape[:-1], H, dh)


def local_kv_heads(H_local: int, KV: int, tp: int = 1, rank: int = 0):
    """The kv heads that tensor-parallel rank ``rank`` of ``tp`` reads
    with its ``H_local`` q heads (q head ``h`` reads kv head ``h // (H /
    KV)``, H = H_local x tp): a ``slice`` of them when each kv head read
    serves the same number of its q heads, else an index tensor of one kv
    head a q head (group 1).  ``slice(0, KV)`` on one rank."""
    H = H_local * tp
    if H % KV:
        raise ValueError(f"{H} q heads do not group over {KV} kv heads")
    G = H // KV
    lo = rank * H_local
    if lo % G == 0 and H_local % G == 0:
        return slice(lo // G, (lo + H_local) // G)
    if (lo + H_local - 1) // G == lo // G:
        return slice(lo // G, lo // G + 1)
    return torch.arange(lo, lo + H_local) // G


def local_kv(p, names=("wk", "wv")) -> dict:
    """``p`` with its replicated kv leaves ``names`` cut to the kv heads
    this rank's q heads read (:func:`local_kv_heads`: ``wq`` is this
    rank's block of the heads); ``p`` itself where those are all of
    them (one rank)."""
    KV = p["wk"].shape[1]
    kv = local_kv_heads(p["wq"].shape[1], KV, tp_size(), tp_index())
    if not isinstance(kv, slice):
        return {**p, **{n: p[n].index_select(-2, kv.to(p[n].device))
                        for n in names}}
    if kv != slice(0, KV):
        return {**p, **{n: p[n][..., kv, :] for n in names}}
    return p


def _project_qkv(p, cfg, x: torch.Tensor, x_kv: Optional[torch.Tensor] = None):
    """q on the rank's own heads, k and v on the kv heads those read
    (:func:`local_kv_heads`; all of them on one rank): ``wq`` / ``bq`` are
    this rank's block of the heads, ``wk`` / ``wv`` / ``bk`` / ``bv``
    replicated, as the reference lays them out."""
    x_kv = x if x_kv is None else x_kv
    p = local_kv(p, ("wk", "wv", "bk", "bv") if cfg.qkv_bias
                 else ("wk", "wv"))
    q, k, v = _proj(x, p["wq"]), _proj(x_kv, p["wk"]), _proj(x_kv, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _rope(cfg, x, positions):
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _rope_qk(cfg, q, k, positions):
    if positions is None:
        return q, k
    return _rope(cfg, q, positions), _rope(cfg, k, positions)


def _all_kv(p) -> bool:
    """Whether this rank's q heads read every kv head (one rank, or kv
    heads few enough that one serves all of a rank's q heads)."""
    KV = p["wk"].shape[1]
    kv = local_kv_heads(p["wq"].shape[1], KV, tp_size(), tp_index())
    return isinstance(kv, slice) and kv == slice(0, KV)


def _project_kv(p, cfg, x: torch.Tensor):
    """k and v of every kv head (``wk`` / ``wv`` are replicated)."""
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)`` as one matmul."""
    H, dh, D = wo.shape
    return out.reshape(*out.shape[:-2], H * dh) @ wo.reshape(H * dh, D)


def attention_fwd(p, cfg, x: torch.Tensor, positions, *, causal=True,
                  x_kv: Optional[torch.Tensor] = None, use_rope=True,
                  kv_rows: Optional[tuple] = None):
    """Full-sequence attention (prefill, encoder, cross).  x: (B, S, D);
    ``x_kv`` (B, Skv, D) gives the keys and values of cross-attention
    (non-causal, ``use_rope=False``).

    Returns (out (B, S, D), (k, v)) with k, v (B, Skv, KV, dh) as the
    layer's cache rows; ``kv_rows = (lo, hi)`` gives instead the rows
    [lo, hi) of the keys' sequence (``x_kv``'s, else ``x``'s) for every
    kv head (a prefill's block of the sequence-parallel cache).  Under
    tensor parallelism the flash kernel runs on this rank's heads and
    ``out`` is the row-parallel o-projection's partial sum over the model
    ranks (the caller reduce-scatters it); ``x`` and ``x_kv`` are whole
    sequences (gathered), so the cache block's rows come from them and
    the replicated ``wk`` / ``wv`` with no collective of their own."""
    q, k, v = _project_qkv(p, cfg, x, x_kv)
    if use_rope:
        q, k = _rope_qk(cfg, q, k, positions)
    out = flash_attention(q, k, v, causal=causal)
    if kv_rows is not None:
        lo, hi = kv_rows
        if _all_kv(p):
            k, v = k[:, lo:hi], v[:, lo:hi]
        else:
            src = x if x_kv is None else x_kv
            k, v = _project_kv(p, cfg, src[:, lo:hi])
            if use_rope and positions is not None:
                k = _rope(cfg, k, positions[:, lo:hi])
    return _out_proj(out, p["wo"]), (k, v)


#: the reference's compiled int8 scale ``max |x| / 127 + 1e-9`` is one
#: fused multiply-add of max |x|, the f32 reciprocal of 127 and f32 1e-9
_INV_127 = float(torch.tensor(1 / 127, dtype=torch.float32))
_SCALE_EPS = float(torch.tensor(1e-9, dtype=torch.float32))


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantisation of x (B, KV, dh), as the
    reference's ``attention_decode`` rounds it: the scale ``max |x| / 127
    + 1e-9`` (the product and sum rounded once, in f64, to x's dtype), the
    row ``clip(round(x / scale), -127, 127)``.  Returns (int8 rows, f32
    scales (B, KV))."""
    amax = x.abs().amax(dim=-1).double()
    scale = (amax * _INV_127 + _SCALE_EPS).to(x.dtype)
    q = torch.round(x / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale.float()


def attention_decode(p, cfg, x: torch.Tensor, pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, update_cache=True,
                     use_rope=True, scales=None, block=None):
    """Single-token decode.  x: (B, 1, D); caches (B, S, KV, dh); pos and
    cache_len (B,) int32 (pos == cache_len for self-attention).

    With ``update_cache`` writes row ``cache_len[b]`` of ``k_cache`` /
    ``v_cache`` in place (and of ``scales`` = (k_scale, v_scale), (B, S,
    KV) f32, when the cache is int8), then attends over the first
    ``cache_len + 1`` rows.  Returns (out (B, 1, D), k_cache, v_cache):
    the same cache tensors.

    Without ``update_cache`` (cross-attention over the encoder's k / v)
    no row is written and k / v of ``x`` are not computed.

    Under rules that split ``kv_seq`` over a model axis the caches are
    this rank's block of ``S`` rows (``parallel.sharding.kv_block``, from
    row ``r * S``) for every kv head, and ``x`` is whole on every rank.
    The rank's q heads are all-gathered to all H (the reference
    replicates q), the new row's k and v computed for every kv head, and
    only the rank whose block holds row ``cache_len`` writes it (its
    scales too).  The kernel attends over the block's valid rows
    (``clamp(cache_len + 1 - r * S, 0, S)``, 0 for a block still empty)
    and returns its log-sum-exp; ``combine_over_model`` merges the ranks'
    results.  ``out`` is then this rank's heads through the row-parallel
    ``wo``: its partial sum over the model ranks, which the caller
    all-reduces (``parallel.sharding.scatter_seq`` under decode rules).
    ``block`` is :func:`decode_block`'s for this step, which a model's
    layers share (found here when not given).  Without ``update_cache``
    the block is read only: the kernel attends over all its rows on
    every rank (``cache_len`` is not read), and the ranks' results are
    merged the same way."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if use_rope:
        pos_r = (pos[:, None, None].expand(pos.shape[0], 1, 3) if cfg.mrope
                 else pos[:, None])
        q = _rope(cfg, q, pos_r)
    if not update_cache:
        kf, vf = _dequant(k_cache, v_cache, scales, q.dtype)
        if kv_split():
            rows = torch.full((q.shape[0],), k_cache.shape[1],
                              dtype=torch.int32, device=q.device)
            return _attend_blocks(p, q, kf, vf, rows), k_cache, v_cache
        return (_out_proj(decode_attention(q, kf, vf, cache_len + 1),
                          p["wo"]), k_cache, v_cache)
    k, v = _project_kv(p, cfg, x)
    if use_rope:
        k = _rope(cfg, k, pos_r)
    if kv_split():
        if block is None:
            block = decode_block(cache_len, k_cache.shape[1])
        return _decode_block(p, q, k, v, k_cache, v_cache, block,
                             scales), k_cache, v_cache
    # In place: the reference updates the cache functionally
    # (``k_cache.at[b, cache_len].set``) and returns a new array; writing
    # the one row per sequence here saves copying the cache.
    b_idx = torch.arange(k_cache.shape[0], device=k_cache.device)
    idx = cache_len.long()
    if scales is not None:
        (kq, ks), (vq, vs) = quantize_rows(k[:, 0]), quantize_rows(v[:, 0])
        k_cache[b_idx, idx], v_cache[b_idx, idx] = kq, vq
        scales[0][b_idx, idx], scales[1][b_idx, idx] = ks, vs
    else:
        k_cache[b_idx, idx] = k[:, 0].to(k_cache.dtype)
        v_cache[b_idx, idx] = v[:, 0].to(v_cache.dtype)
    kf, vf = _dequant(k_cache, v_cache, scales, q.dtype)
    out = decode_attention(q, kf, vf, cache_len + 1)
    return _out_proj(out, p["wo"]), k_cache, v_cache


def _dequant(k_cache, v_cache, scales, dtype):
    """The layer's cache in ``dtype`` (an int8 cache times its scales)."""
    if scales is None:
        return k_cache.to(dtype), v_cache.to(dtype)
    return (k_cache.to(dtype) * scales[0][..., None].to(dtype),
            v_cache.to(dtype) * scales[1][..., None].to(dtype))


def decode_block(cache_len: torch.Tensor, S_blk: int) -> dict:
    """Where a decode step's new rows go in this model rank's block of
    ``S_blk`` rows of the sequence-parallel cache, the same for every
    layer: ``rows`` (batch index, row index clamped into the block),
    ``mine`` (B, 1, 1) whether the block holds row ``cache_len``, and
    ``kv_len`` the block's valid rows after the write."""
    at = cache_len.long() - kv_offset(S_blk)
    return {"rows": (torch.arange(at.shape[0], device=at.device),
                     at.clamp(0, S_blk - 1)),
            "mine": ((at >= 0) & (at < S_blk))[:, None, None],
            "kv_len": (at + 1).clamp_(0, S_blk).to(torch.int32)}


def _decode_block(p, q, k, v, k_cache, v_cache, block, scales):
    """:func:`attention_decode` on this model rank's block of the
    sequence-parallel cache: q (B, 1, H_local, dh) on the rank's heads, k
    and v (B, 1, KV, dh) the new row of every kv head.  Returns the
    row-parallel o-projection's partial (B, 1, D)."""
    # the row goes to the block that holds it; a write elsewhere puts the
    # row's old value back (no host sync to find the owner)
    rows, mine = block["rows"], block["mine"]
    if scales is not None:
        (kq, ks), (vq, vs) = quantize_rows(k[:, 0]), quantize_rows(v[:, 0])
        writes = ((k_cache, kq), (v_cache, vq), (scales[0], ks),
                  (scales[1], vs))
    else:
        writes = ((k_cache, k[:, 0].to(k_cache.dtype)),
                  (v_cache, v[:, 0].to(v_cache.dtype)))
    for cache, new in writes:
        keep = mine if new.ndim == 3 else mine[..., 0]
        cache[rows] = torch.where(keep, new, cache[rows])
    kf, vf = _dequant(k_cache, v_cache, scales, q.dtype)
    return _attend_blocks(p, q, kf, vf, block["kv_len"])


def _attend_blocks(p, q, kf, vf, kv_len):
    """Attention of q (B, 1, H_local, dh), this model rank's heads, over
    every rank's block of the cache: q all-gathered to all H heads, the
    decode kernel over the first ``kv_len`` rows of this rank's block
    (``kf`` / ``vf``) with its log-sum-exp, the ranks' results merged by
    ``combine_over_model``.  Returns this rank's heads through the
    row-parallel ``wo``: its partial sum (B, 1, D) over the model
    ranks."""
    Hl = q.shape[2]
    q = gather_model(q, 2)                                 # all H heads
    out, lse = decode_attention(q, kf, vf, kv_len, return_lse=True)
    out = combine_over_model(out, lse)
    r = tp_index()
    return _out_proj(out[:, :, r * Hl:(r + 1) * Hl], p["wo"])


# ----------------------------------------------------------------------
# Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)
def init_mla(cfg, generator: torch.Generator, device=None) -> dict:
    """Draws in order: wdq, wuq, wdkv, wukv, wo; the norms' scales are
    ones in f32."""
    m = cfg.mla
    dt = dtype_of(cfg)
    D, H = cfg.d_model, cfg.padded_heads or cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def w(shape, std):
        return normal_init(shape, std, dt, generator, device)

    p = {"wdq": w((D, m.q_lora_rank), D ** -0.5),
         "wuq": w((m.q_lora_rank, H, qk), m.q_lora_rank ** -0.5),
         "wdkv": w((D, m.kv_lora_rank + m.qk_rope_head_dim), D ** -0.5),
         "wukv": w((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                   m.kv_lora_rank ** -0.5),
         "wo": w((H, m.v_head_dim, D), (cfg.num_heads * m.v_head_dim) ** -0.5)}
    if H > cfg.num_heads:  # padded heads contribute exactly zero
        for name in ("wuq", "wukv"):
            p[name][:, cfg.num_heads:] = 0
        p["wo"][cfg.num_heads:] = 0
    dev = p["wdq"].device
    p["q_norm"] = init_rmsnorm(m.q_lora_rank, dev)["scale"]
    p["kv_norm"] = init_rmsnorm(m.kv_lora_rank, dev)["scale"]
    return p


def _mla_q(p, cfg, x: torch.Tensor, positions):
    m = cfg.mla
    qa = rmsnorm({"scale": p["q_norm"]}, x @ p["wdq"], cfg.norm_eps)
    q = _proj(qa, p["wuq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, cfg, x: torch.Tensor, positions):
    m = cfg.mla
    kva = x @ p["wdkv"]
    c_kv = rmsnorm({"scale": p["kv_norm"]}, kva[..., :m.kv_lora_rank],
                   cfg.norm_eps)
    k_pe = apply_rope(kva[..., None, m.kv_lora_rank:], positions,
                      cfg.rope_theta)[..., 0, :]                # (B,S,rope)
    return c_kv, k_pe


def mla_fwd(p, cfg, x: torch.Tensor, positions, *, causal=True,
            kv_rows: Optional[tuple] = None):
    """Expanded MLA for prefill.  Returns (out (B, S, D), (c_kv (B, S,
    kv_lora_rank), k_pe (B, S, qk_rope))); ``kv_rows = (lo, hi)`` gives
    the latent rows of positions [lo, hi) instead (a prefill's block of
    the sequence-parallel cache).

    Under tensor parallelism ``wuq``, ``wukv`` and ``wo`` are this rank's
    blocks of the heads and the latent (``wdq``, ``wdkv``, the norms)
    replicated: the latent is computed in full from the gathered ``x``,
    the flash kernel runs on the rank's H / tp heads, and ``out`` is the
    row-parallel ``wo``'s partial sum over the model ranks."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_pe = _mla_latent(p, cfg, x, positions)
    kv = _proj(c_kv, p["wukv"])
    H = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :m.qk_nope_head_dim],
                   k_pe[:, :, None, :].expand(-1, -1, H, -1)], dim=-1)
    # v is a view of kv: its head stride qk_nope + v_head_dim and its
    # offset qk_nope elements keep rows 16-byte aligned at the catalogue's
    # widths, so the tensor-core kernel reads it without a copy
    v = kv[..., m.qk_nope_head_dim:]
    out = flash_attention(q, k, v, causal=causal)
    if kv_rows is not None:
        lo, hi = kv_rows
        c_kv, k_pe = c_kv[:, lo:hi], k_pe[:, lo:hi]
    return _out_proj(out, p["wo"]), (c_kv, k_pe)


def mla_decode(p, cfg, x: torch.Tensor, pos: torch.Tensor,
               ckv_cache: torch.Tensor, kpe_cache: torch.Tensor,
               cache_len: torch.Tensor, block: Optional[dict] = None):
    """Absorbed-matrix MLA decode, attending in the latent space over the
    caches (B, S, kv_lora_rank) and (B, S, qk_rope).  Writes row
    ``cache_len[b]`` of both in place and returns (out (B, 1, D),
    ckv_cache, kpe_cache).  Scores and softmax in f32; the probabilities
    and the latent cache in x's dtype for the product, as the reference.

    With ``block`` (:func:`decode_block`'s, under rules that split
    ``kv_seq`` over a model axis) the caches are this rank's block of
    rows: the new latent row is written on its owner only, q's latent and
    rotary parts (the rank's heads) are all-gathered to all H heads, the
    softmax runs over the block's valid rows with its log-sum-exp (-inf
    for an empty block, which then weighs 0), ``combine_over_model``
    merges the ranks' latent outputs, and the rank's heads go through
    ``w_uv`` and the row-parallel ``wo``: ``out`` is the partial sum over
    the model ranks.  Per block the probabilities round to x's dtype
    before the product, where the reference rounds the whole cache's, so
    bf16 differs in the last bits; with one rank the result is the
    unsplit path's bit for bit.  Without ``block`` the row is an indexed
    write and no log-sum-exp is taken: the block path's where-write and
    log-sum-exp are ~10 more small ops a layer, which made minicpm3-4b's
    single-device decode ~11 % slower on an H100, where decode is bound
    by the host's launches (``experiments/decode_step_ab.py``)."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None])
    c_kv_new, k_pe_new = _mla_latent(p, cfg, x, pos[:, None])
    if block is None:
        b_idx = torch.arange(ckv_cache.shape[0], device=ckv_cache.device)
        idx = cache_len.long()
        ckv_cache[b_idx, idx] = c_kv_new[:, 0].to(ckv_cache.dtype)
        kpe_cache[b_idx, idx] = k_pe_new[:, 0].to(kpe_cache.dtype)
        kv_len = cache_len + 1
    else:
        rows, mine = block["rows"], block["mine"][..., 0]
        for cache, new in ((ckv_cache, c_kv_new), (kpe_cache, k_pe_new)):
            cache[rows] = torch.where(mine, new[:, 0].to(cache.dtype),
                                      cache[rows])
        kv_len = block["kv_len"]
    S = ckv_cache.shape[1]
    w_uk = p["wukv"][..., :m.qk_nope_head_dim]                  # (r,H,n)
    Hl = q_nope.shape[2]
    # every head's query: contiguous on both paths, so the products below
    # take one layout with or without the gather
    q_lat = gather_model(torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
                         .contiguous(), 2)
    q_rope = gather_model(q_rope.contiguous(), 2)
    # the reference's f32 products (preferred_element_type): exact
    # products of the operands, summed in f32
    s = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), ckv_cache.float())
         + torch.einsum("bqhp,bkp->bhqk", q_rope.float(), kpe_cache.float()))
    s = s * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    mask = torch.arange(S, device=s.device)[None, :] < kv_len[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", probs.to(x.dtype),
                         ckv_cache.to(x.dtype))
    if block is not None:
        lse = torch.logsumexp(s[:, :, 0], dim=-1)               # (B, H)
        lse = torch.where(kv_len[:, None] > 0, lse, float("-inf"))
        o_lat = combine_over_model(o_lat, lse)
    r = tp_index()
    o_lat = o_lat.contiguous()[:, :, r * Hl:(r + 1) * Hl]
    w_uv = p["wukv"][..., m.qk_nope_head_dim:]                  # (r,H,v)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
    return _out_proj(o, p["wo"]), ckv_cache, kpe_cache
