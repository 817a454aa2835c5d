"""GQA attention of the port: init, QKV projection, RoPE / M-RoPE, the
prefill and decode forms.

Translated from the reference's ``models/attention.py`` (``init_attention``,
``_project_qkv``, ``_rope_qk``, ``attention_fwd``, ``attention_decode``).
Where the reference calls its XLA ``blockwise_attention`` and
``decode_attention``, the port calls its kernels: ``kernels.
flash_attention`` on the GQA k/v as they are (no kv-head repeat) and
``kernels.decode_attention`` on the layer's cache.  On CUDA tensors the
kernels always launch; on CPU tensors their plain versions run.

Not lowered (each raises ``NotImplementedError`` naming it): the int8 KV
cache, MLA, MoE, and the ``ssm`` / ``hybrid`` / ``encdec`` families.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dtype_of,
                                       normal_init)

#: the model families whose attention the port lowers
LOWERED_FAMILIES = ("dense", "vlm")


def check_lowered(cfg) -> None:
    """Raise ``NotImplementedError`` for a feature of ``cfg`` the port
    does not lower yet."""
    if cfg.family not in LOWERED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (the port serves "
            f"{', '.join(LOWERED_FAMILIES)})")
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    if cfg.moe is not None:
        raise NotImplementedError("the MoE feed-forward is not ported yet")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache "
                                  "(kv_cache_dtype='int8') is not ported yet")


def init_attention(cfg, generator: torch.Generator, device=None) -> dict:
    check_lowered(cfg)
    dt = dtype_of(cfg)
    D, H, true_H = cfg.d_model, cfg.padded_heads, cfg.num_heads
    KV, dh = cfg.padded_kv, cfg.head_dim
    p = {"wq": normal_init((D, H, dh), D ** -0.5, dt, generator, device),
         "wk": normal_init((D, KV, dh), D ** -0.5, dt, generator, device),
         "wv": normal_init((D, KV, dh), D ** -0.5, dt, generator, device),
         "wo": normal_init((H, dh, D), (true_H * dh) ** -0.5, dt, generator,
                           device)}
    if H > true_H:  # padded heads contribute exactly zero
        p["wq"][:, true_H:] = 0
        p["wo"][true_H:] = 0
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, dh), dtype=dt, device=p["wq"].device)
        p["bk"] = torch.zeros((KV, dh), dtype=dt, device=p["wq"].device)
        p["bv"] = torch.zeros((KV, dh), dtype=dt, device=p["wq"].device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    D, H, dh = w.shape
    return (x @ w.reshape(D, H * dh)).reshape(*x.shape[:-1], H, dh)


def _project_qkv(p, cfg, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _rope_qk(cfg, q, k, positions):
    if positions is None:
        return q, k
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)`` as one matmul."""
    H, dh, D = wo.shape
    return out.reshape(*out.shape[:-2], H * dh) @ wo.reshape(H * dh, D)


def attention_fwd(p, cfg, x: torch.Tensor, positions, *, causal=True):
    """Full-sequence attention (prefill).  x: (B, S, D).

    Returns (out (B, S, D), (k, v)) with k, v (B, S, KV, dh) as the
    layer's cache rows."""
    check_lowered(cfg)
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = flash_attention(q, k, v, causal=causal)
    return _out_proj(out, p["wo"]), (k, v)


def attention_decode(p, cfg, x: torch.Tensor, pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor):
    """Single-token decode.  x: (B, 1, D); caches (B, S, KV, dh); pos and
    cache_len (B,) int32 (pos == cache_len for self-attention).

    Writes row ``cache_len[b]`` of ``k_cache`` / ``v_cache`` in place,
    then attends over the first ``cache_len + 1`` rows.  Returns
    (out (B, 1, D), k_cache, v_cache): the same cache tensors."""
    check_lowered(cfg)
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.mrope:
        pos3 = pos[:, None, None].expand(pos.shape[0], 1, 3)
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    # In place: the reference updates the cache functionally
    # (``k_cache.at[b, cache_len].set``) and returns a new array; writing
    # the one row per sequence here saves copying the layer's cache.
    b_idx = torch.arange(k_cache.shape[0], device=k_cache.device)
    idx = cache_len.long()
    k_cache[b_idx, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[b_idx, idx] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                           cache_len + 1)
    return _out_proj(out, p["wo"]), k_cache, v_cache
