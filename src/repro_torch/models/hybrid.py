"""The ``ssm`` family (Mamba2) of the port.

Translated from the ``ssm`` half of the reference's ``models/hybrid.py``:
``init_params``, ``prefill``, ``decode_step`` and ``init_cache`` for a
stack of Mamba2 blocks (pre-norm, residual) between the embedding and
the tied logits.  The parameters keep the reference's leaf names and
stacked shapes (``embed.tok``, ``layers.ln.scale``, ``layers.mixer.in_z``
(L, D, d_inner), ..., ``final_norm.scale``).

The cache is ``{"conv": {"x", "B", "C": (L, B, W-1, C) f32}, "ssm":
(L, B, H, P, N) f32, "len": (B,) int32}``: each layer's raw pre-conv
tails and SSD state.  Prefill writes each layer's slice as the layer
runs; a decode step updates them in place (the reference threads them
through its scan carry).  The cache has no sequence axis, so prefill's
``cache_len`` is accepted and ignored, as in the reference.

Zamba2's shared attention block (``family == "hybrid"``) is not ported
yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import (embed_tokens, init_embedding,
                                       init_rmsnorm, layer_slice,
                                       logits_from_hidden, rmsnorm,
                                       stacked_init)
from repro_torch.models.ssm import init_mamba2, mamba2_decode, mamba2_fwd


def _check_ssm(cfg) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported: Zamba2's shared "
            f"attention block over the Mamba2 backbone is still to come"
            if cfg.family == "hybrid" else
            f"models/hybrid.py serves the 'ssm' family, not {cfg.family!r}")


# ----------------------------------------------------------------------
def _init_mamba_layer(cfg, generator: torch.Generator, device) -> dict:
    return {"ln": init_rmsnorm(cfg.d_model, device),
            "mixer": init_mamba2(cfg, generator, device)}


def _mamba_layer_fwd(cfg, lp, h: torch.Tensor):
    y, states = mamba2_fwd(lp["mixer"], cfg,
                           rmsnorm(lp["ln"], h, cfg.norm_eps))
    return h + y, states


def _mamba_layer_decode(cfg, lp, h: torch.Tensor, conv_s: dict,
                        ssm_s: torch.Tensor):
    y, conv_s, ssm_s = mamba2_decode(
        lp["mixer"], cfg, rmsnorm(lp["ln"], h, cfg.norm_eps), conv_s, ssm_s)
    return h + y, conv_s, ssm_s


def _layer_cache(cache: dict, i: int):
    """Layer ``i``'s conv tails and SSD state: views into ``cache``."""
    return {k: v[i] for k, v in cache["conv"].items()}, cache["ssm"][i]


# ----------------------------------------------------------------------
def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Parameters on ``device`` (None: the CUDA card).  Draws in order:
    the embedding, then layer by layer (each Mamba2 block as
    ``init_mamba2`` draws it) into stacked leaves."""
    _check_ssm(cfg)
    device = resolve_device(device)
    return {"embed": init_embedding(cfg, generator, device),
            "layers": stacked_init(
                lambda: _init_mamba_layer(cfg, generator, device),
                cfg.num_layers),
            "final_norm": init_rmsnorm(cfg.d_model, device)}


def _backbone(params, cfg, batch, cache: Optional[dict] = None):
    """The final-normed hidden states (B, S, D); each layer's conv tails
    and final SSD state go to its slice of ``cache`` when one is given."""
    h = embed_tokens(params["embed"], cfg, batch["tokens"])
    for i in range(cfg.num_layers):
        h, (tails, state) = _mamba_layer_fwd(
            cfg, layer_slice(params["layers"], i), h)
        if cache is not None:
            conv, ssm = _layer_cache(cache, i)
            for name, t in zip(("x", "B", "C"), tails):
                conv[name].copy_(t)
            ssm.copy_(state)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)


def prefill(params, cfg, batch, cache_len: Optional[int] = None):
    """batch: ``tokens`` (B, S) int on the parameters' device.  Returns
    the last position's logits (B, V_padded) f32 and the cache."""
    _check_ssm(cfg)
    B, S = batch["tokens"].shape
    tok = params["embed"]["tok"]
    cache = init_cache(cfg, B, S, tok.dtype, tok.device)
    h = _backbone(params, cfg, batch, cache)
    logits = logits_from_hidden(params["embed"], cfg, h[:, -1:, :])[:, 0]
    cache["len"].fill_(S)
    return logits, cache


def decode_step(params, cfg, cache, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, V_padded) f32, cache).  The returned
    cache holds the same conv and SSD tensors, updated in place, and
    ``len + 1``."""
    _check_ssm(cfg)
    h = embed_tokens(params["embed"], cfg, tokens)          # (B, 1, D)
    for i in range(cfg.num_layers):
        h, _, _ = _mamba_layer_decode(
            cfg, layer_slice(params["layers"], i), h, *_layer_cache(cache, i))
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = logits_from_hidden(params["embed"], cfg, h)[:, 0]
    return logits, {"conv": cache["conv"], "ssm": cache["ssm"],
                    "len": cache["len"] + 1}


def init_cache(cfg, B: int, S: int, dtype=torch.bfloat16, device=None):
    """The zeroed cache on ``device`` (None: the CUDA card); ``S`` and
    ``dtype`` are unused (the state has no sequence axis and is kept in
    f32), as in the reference."""
    _check_ssm(cfg)
    device = resolve_device(device)
    s = cfg.ssm
    D, L, W = cfg.d_model, cfg.num_layers, s.d_conv
    di, gn = s.d_inner(D), s.n_groups * s.d_state
    H, P, N = s.n_heads(D), s.head_dim, s.d_state
    f32 = torch.float32
    return {"conv": {"x": torch.zeros((L, B, W - 1, di), dtype=f32,
                                      device=device),
                     "B": torch.zeros((L, B, W - 1, gn), dtype=f32,
                                      device=device),
                     "C": torch.zeros((L, B, W - 1, gn), dtype=f32,
                                      device=device)},
            "ssm": torch.zeros((L, B, H, P, N), dtype=f32, device=device),
            "len": torch.zeros((B,), dtype=torch.int32, device=device)}
