"""Shared building blocks of the port's models: initializers, RMSNorm,
RoPE / M-RoPE, embeddings and logits, the SwiGLU MLP.

Translated from the reference's ``models/common.py``; the tensor layouts
and the parameter leaf names are the reference's, so a parameter tree
carried across by :func:`repro_torch.interop.params_from_reference` runs
here unchanged.  Random draws take an explicit ``torch.Generator``: the
port cannot replay the reference's jax PRNG streams, so the tests hand
both sides the same weights instead.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

#: logits of the padded vocabulary rows (as the reference's ``-1e30``)
PAD_LOGIT = -1e30


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal_init(shape: Sequence[int], stddev: float, dtype: torch.dtype,
                generator: torch.Generator,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``stddev`` x a normal truncated to [-2, 2], drawn in f32 on the
    generator's device, then cast to ``dtype`` and moved to ``device``."""
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x.mul_(stddev)).to(dtype=dtype, device=device or x.device)


# ----------------------------------------------------------------------
# RMSNorm
def init_rmsnorm(d: int, device=None) -> dict:
    """The scale is kept in f32 whatever the model's dtype."""
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


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


def embed_tokens(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32, as the reference's
    ``preferred_element_type=jnp.float32``.  On the card a bf16 product
    keeps its operands (``out_dtype``); the CPU has no such product and
    upcasts them, which gives the same function."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(*a.shape[:-1],
                                                          b.shape[-1])
    return a.float() @ b.float()


def logits_from_hidden(p, cfg, h: torch.Tensor) -> torch.Tensor:
    """h: (B, S, D) -> logits (B, S, V_padded) f32 (padded vocab = -1e30)."""
    table = p["tok"] if cfg.tie_embeddings else p["head"]
    logits = matmul_f32(h, table.t())
    if cfg.padded_vocab > cfg.vocab_size:
        logits[..., cfg.vocab_size:] = PAD_LOGIT
    return logits


# ----------------------------------------------------------------------
# SwiGLU MLP
def init_mlp(cfg, generator: torch.Generator, device=None) -> dict:
    dt = dtype_of(cfg)
    D, Fd = cfg.d_model, cfg.d_ff
    return {"wi": normal_init((D, Fd), D ** -0.5, dt, generator, device),
            "wo": normal_init((Fd, D), Fd ** -0.5, dt, generator, device),
            "wg": normal_init((D, Fd), D ** -0.5, dt, generator, device)}


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
