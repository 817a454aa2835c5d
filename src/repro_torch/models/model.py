"""Model assembly of the port: family dispatch, and the decoder-only
families (``dense`` / ``moe`` / ``vlm``).

Translated from the reference's ``models/model.py``.  Public API:

  init_params(cfg, generator, device=None) -> params (nested dicts)
  prefill(params, cfg, batch, cache_len=None) -> (last_logits (B, V), cache)
  decode_step(params, cfg, cache, tokens)  -> (logits (B, V), cache)
  init_cache(cfg, B, S, dtype=bf16, device=None) -> zeroed cache

The ``ssm`` family (Mamba2) goes to :mod:`repro_torch.models.hybrid`, as
in the reference.  The decoder-only parameters keep the reference's leaf
names and stacked shapes (``embed.tok``, ``embed.head``,
``layers.attn.wq`` (L, D, H, dh), ..., ``layers.ln1.scale``,
``layers.ffn.wi``, ``final_norm.scale``; an ``moe`` layer's ``ffn``
holds ``router``, ``wi``, ``wg`` and ``wo`` stacked over its experts),
so a tree carried across by
:func:`repro_torch.interop.params_from_reference` runs here as it is.
The layers are a Python loop over the stacked leaves (the reference
scans them).  The cache is ``{"k", "v": (L, B, S, KV, dh), "len": (B,)
int32}``; prefill allocates it at its padded length and fills the first
S rows (the reference pads afterwards, ``_pad_seq``), and a decode step
writes its row of each layer's cache in place (the reference threads the
cache through its scan carry).

An ``moe`` layer's feed-forward is :func:`repro_torch.models.moe.moe_ffn`
(its expert products through the ``gmm`` kernel) where a dense layer's is
the SwiGLU MLP; prefill and decode drop its aux loss, as the reference's
do.

Not lowered: MLA, the int8 KV cache and the ``hybrid`` / ``encdec``
families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import hybrid
from repro_torch.models.attention import (attention_decode, attention_fwd,
                                          check_lowered, init_attention)
from repro_torch.models.common import (embed_tokens, init_embedding,
                                       init_mlp, init_rmsnorm, layer_slice,
                                       logits_from_hidden, mlp, rmsnorm,
                                       stacked_init)
from repro_torch.models.moe import init_moe, moe_ffn


def default_positions(cfg, B: int, S: int, device=None) -> torch.Tensor:
    """(B, S) int32 positions, or (B, S, 3) for M-RoPE."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] \
        .expand(B, S)
    if cfg.mrope:
        return pos[..., None].expand(B, S, 3)
    return pos


# ----------------------------------------------------------------------
# decoder-only layer
def _init_dec_layer(cfg, generator: torch.Generator, device) -> dict:
    init_ffn = init_moe if cfg.moe is not None else init_mlp
    return {"attn": init_attention(cfg, generator, device),
            "ln1": init_rmsnorm(cfg.d_model, device),
            "ln2": init_rmsnorm(cfg.d_model, device),
            "ffn": init_ffn(cfg, generator, device)}


def _ffn(lp, cfg, x: torch.Tensor) -> torch.Tensor:
    """The layer's feed-forward: the MoE layer (its aux loss dropped) or
    the SwiGLU MLP."""
    if cfg.moe is not None:
        return moe_ffn(lp["ffn"], cfg, x)[0]
    return mlp(lp["ffn"], x)


def _merge_vision(cfg, h: torch.Tensor, batch) -> torch.Tensor:
    """The vision stub: the leading ``vision_embeds.shape[1]`` positions
    take the given embeddings."""
    ve = batch.get("vision_embeds")
    if ve is None or cfg.num_frontend_tokens == 0:
        return h
    n = ve.shape[1]
    if n > h.shape[1]:
        raise ValueError(f"{n} vision embeddings do not fit a sequence of "
                         f"{h.shape[1]} tokens")
    return torch.cat([ve.to(h.dtype), h[:, n:, :]], dim=1)


def _dec_backbone(params, cfg, batch, cache: Optional[dict] = None):
    """The final-normed hidden states (B, S, D); each layer's k/v go to
    rows [0, S) of ``cache`` when one is given."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed_tokens(params["embed"], cfg, tokens)
    if cfg.family == "vlm":
        h = _merge_vision(cfg, h, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, B, S, device=h.device)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        a, (k, v) = attention_fwd(lp["attn"], cfg,
                                  rmsnorm(lp["ln1"], h, cfg.norm_eps),
                                  positions, causal=cfg.causal)
        h = h + a
        h = h + _ffn(lp, cfg, rmsnorm(lp["ln2"], h, cfg.norm_eps))
        if cache is not None:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)


def _dec_prefill(params, cfg, batch, cache_len: Optional[int] = None):
    B, S = batch["tokens"].shape
    tok = params["embed"]["tok"]
    cache = _dec_init_cache(cfg, B, max(S, cache_len or 0), tok.dtype,
                            tok.device)
    h = _dec_backbone(params, cfg, batch, cache)
    logits = logits_from_hidden(params["embed"], cfg, h[:, -1:, :])[:, 0]
    cache["len"].fill_(S)
    return logits, cache


def _dec_decode(params, cfg, cache, tokens: torch.Tensor):
    h = embed_tokens(params["embed"], cfg, tokens)          # (B, 1, D)
    pos = cache["len"]
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        a, _, _ = attention_decode(lp["attn"], cfg,
                                   rmsnorm(lp["ln1"], h, cfg.norm_eps), pos,
                                   cache["k"][i], cache["v"][i], cache["len"])
        h = h + a
        h = h + _ffn(lp, cfg, rmsnorm(lp["ln2"], h, cfg.norm_eps))
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = logits_from_hidden(params["embed"], cfg, h)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": cache["len"] + 1}


def _dec_init_params(cfg, generator: torch.Generator, device) -> dict:
    """Draws in order: the embedding (tok, head), then layer by layer
    (wq, wk, wv, wo, then the MLP's wi, wo, wg or the MoE layer's router,
    wi, wg, wo), each layer drawn in f32 on the generator's device and
    cast into its slot of the stacked leaves."""
    embed = init_embedding(cfg, generator, device)
    layers = stacked_init(lambda: _init_dec_layer(cfg, generator, device),
                          cfg.num_layers)
    return {"embed": embed, "layers": layers,
            "final_norm": init_rmsnorm(cfg.d_model, device)}


def _dec_init_cache(cfg, B: int, S: int, dtype=torch.bfloat16, device=None):
    shape = (cfg.num_layers, B, S, cfg.padded_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((B,), dtype=torch.int32, device=device)}


# ----------------------------------------------------------------------
# public dispatch
def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Random parameters for ``cfg`` on ``device`` (None: the CUDA card),
    drawn from ``generator`` on its own device one layer at a time, so no
    f32 copy of the whole model is ever held."""
    check_lowered(cfg)
    if cfg.family == "ssm":
        return hybrid.init_params(cfg, generator, resolve_device(device))
    return _dec_init_params(cfg, generator, resolve_device(device))


def prefill(params, cfg, batch, cache_len: Optional[int] = None):
    """batch: ``tokens`` (B, S) int, optional ``vision_embeds`` (B, n, D)
    and ``positions``, on the parameters' device.  Returns the last
    position's logits (B, V_padded) f32 and the cache, padded to
    ``cache_len`` rows (the ``ssm`` family's cache has no rows)."""
    check_lowered(cfg)
    if cfg.family == "ssm":
        return hybrid.prefill(params, cfg, batch, cache_len)
    return _dec_prefill(params, cfg, batch, cache_len)


def decode_step(params, cfg, cache, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, V_padded) f32, cache).  The returned
    cache holds the same state tensors, updated in place, and
    ``len + 1``."""
    check_lowered(cfg)
    if cfg.family == "ssm":
        return hybrid.decode_step(params, cfg, cache, tokens)
    return _dec_decode(params, cfg, cache, tokens)


def init_cache(cfg, B: int, S: int, dtype=torch.bfloat16, device=None):
    check_lowered(cfg)
    if cfg.family == "ssm":
        return hybrid.init_cache(cfg, B, S, dtype, resolve_device(device))
    return _dec_init_cache(cfg, B, S, dtype, resolve_device(device))
