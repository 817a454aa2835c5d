"""The encoder-decoder family (``encdec``, the SeamlessM4T backbone) of
the port.

Translated from the reference's ``models/encdec.py``.  The speech
frontend is a stub there and here: the encoder takes precomputed frame
embeddings ``enc_frames`` (B, S_enc, D).  Encoder layers are non-causal
self-attention (RoPE) + a GELU MLP; decoder layers are causal
self-attention (RoPE), non-causal cross-attention over the encoder's
output (no RoPE) and a GELU MLP, each pre-normed and residual.  Prefill
calls the flash kernel once per encoder layer and twice per decoder
layer (self, cross with Sq != Skv); a decode step calls the decode
kernel twice per decoder layer (self over ``len + 1`` rows, cross over
all ``S_enc`` rows of the encoder's k/v).

The parameters keep the reference's tree: ``embed``, ``enc_layers``
(``attn``, ``mlp`` with ``wi``, ``wo``, ``ln1``, ``ln2``), ``dec_layers``
(``self``, ``cross``, ``mlp``, ``ln1``-``ln3``), ``enc_norm`` and
``final_norm``.  The cache is ``{"k", "v": (L, B, S, KV, dh), "ck",
"cv": (L, B, S_enc, KV, dh), "len": (B,) int32}``.

The frames keep their own dtype into the first layer, as the
reference's unscanned encoder (``scan_layers=False``) keeps them: the
normed input is cast to the model's dtype before the projections (the
reference's einsum promotes bf16 frames against f32 weights) and the
residual stream promotes as the reference's does.  (The reference's
scanned encoder refuses bf16 frames in an f32 model: its scan carry
changes dtype.)

``train_forward`` is the reference's: the decoder's chunked
cross-entropy (no aux loss), every encoder and decoder layer under
``maybe_remat`` as the reference's bodies are, its weights taken by
``common.layer_params`` (under the FSDP train step gathered over the
data-parallel axes inside the body, one layer at a time).

Under the rules of a mesh with a model axis (``launch.specs.rules_for``;
the reference's ``src/repro/parallel/sharding.py:124-146``) the family
runs with tensor parallelism in training, prefill and decode: the
encoder's and decoder's residuals are sequence-parallel in train and
prefill (``residual_seq -> model``), heads, ``mlp`` and the vocabulary
split over the model ranks, the cross cache ``ck`` / ``cv`` each rank's
``kv_seq`` block of the encoder's rows, as the self cache is of the
prompt's (:func:`encode`, :func:`_decoder`, :func:`decode_step`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (attention_decode, attention_fwd,
                                          attention_logical, decode_block,
                                          init_attention)
from repro_torch.models.common import (chunked_cross_entropy,
                                       default_positions, dtype_of,
                                       embed_tokens, embedding_logical,
                                       init_embedding, init_mlp,
                                       init_rmsnorm, layer_params,
                                       layer_slice, logits_from_hidden,
                                       maybe_remat, mlp,
                                       mlp_logical, rmsnorm, rmsnorm_logical,
                                       stacked_init, stacked_logical,
                                       whole_logits)
from repro_torch.parallel.sharding import (check_seq_split, gather_seq,
                                           kv_block, kv_offset, kv_split,
                                           scatter_seq, seq_row,
                                           take_seq_block)

#: the encoder (audio-context) length bound of the reference
ENC_MAX = 4096


def enc_len_for(seq_len: int) -> int:
    return min(seq_len, ENC_MAX)


def _check_family(cfg) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"models/encdec.py serves the 'encdec' family, not "
                         f"{cfg.family!r}")


# ----------------------------------------------------------------------
def _init_enc_layer(cfg, generator: torch.Generator, device) -> dict:
    return {"attn": init_attention(cfg, generator, device),
            "mlp": init_mlp(cfg, generator, device, swiglu=False),
            "ln1": init_rmsnorm(cfg.d_model, device),
            "ln2": init_rmsnorm(cfg.d_model, device)}


def _init_dec_layer(cfg, generator: torch.Generator, device) -> dict:
    return {"self": init_attention(cfg, generator, device),
            "cross": init_attention(cfg, generator, device),
            "mlp": init_mlp(cfg, generator, device, swiglu=False),
            "ln1": init_rmsnorm(cfg.d_model, device),
            "ln2": init_rmsnorm(cfg.d_model, device),
            "ln3": init_rmsnorm(cfg.d_model, device)}


def params_logical(cfg) -> dict:
    _check_family(cfg)
    attn, mlp_ = attention_logical(cfg), mlp_logical(swiglu=False)
    norm = rmsnorm_logical
    return {"embed": embedding_logical(cfg),
            "enc_layers": stacked_logical({"attn": attn, "mlp": mlp_,
                                           "ln1": norm(), "ln2": norm()}),
            "dec_layers": stacked_logical({"self": attn, "cross": attn,
                                           "mlp": mlp_, "ln1": norm(),
                                           "ln2": norm(), "ln3": norm()}),
            "enc_norm": norm(), "final_norm": norm()}


def cache_logical(cfg) -> dict:
    _check_family(cfg)
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"k": kv, "v": kv, "ck": kv, "cv": kv, "len": ("noshard",)}


def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Parameters on ``device`` (None: the CUDA card).  Draws in order:
    the embedding (tok, head), the encoder layers (attention, MLP), then
    the decoder layers (self, cross, MLP), each into stacked leaves."""
    _check_family(cfg)
    device = resolve_device(device)
    return {"embed": init_embedding(cfg, generator, device),
            "enc_layers": stacked_init(
                lambda: _init_enc_layer(cfg, generator, device),
                cfg.enc_layers),
            "dec_layers": stacked_init(
                lambda: _init_dec_layer(cfg, generator, device),
                cfg.num_layers),
            "enc_norm": init_rmsnorm(cfg.d_model, device),
            "final_norm": init_rmsnorm(cfg.d_model, device)}


# ----------------------------------------------------------------------
def _sublayer(cfg, ln, fn, h: torch.Tensor, S: Optional[int]):
    """``h + fn(rmsnorm(h))``, pre-normed and residual, in
    ``models.model._dec_layer``'s form under tensor parallelism: the
    normed input gathered along the sequence (``length`` ``S`` trims an
    uneven split's padding) and ``fn``'s row-parallel output summed back
    into this rank's block (``scatter_seq``; under decode rules the
    identity and an all-reduce).  ``fn`` returns (out, extra); returns
    (h, extra)."""
    out, extra = fn(gather_seq(rmsnorm(ln, h, cfg.norm_eps), length=S))
    return h + scatter_seq(out), extra


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frontend embeddings -> the
    encoder's normed output (B, S_enc, D).

    Under tensor parallelism (train and prefill rules) the frames, whole
    on every rank, enter the sequence-parallel residual as this rank's
    block (``take_seq_block``, padded past an uneven ``S_enc``); each
    layer's attention runs non-causal on the rank's heads and its GELU
    MLP on the rank's ``mlp`` block (:func:`_sublayer`); the output is
    gathered whole (its padding trimmed) before ``enc_norm``, so its
    gradient is reduce-scattered once, after every decoder layer's
    cross-attention has added its part."""
    B, S, _ = frames.shape
    dt = dtype_of(cfg)
    positions = default_positions(cfg, B, S, device=frames.device)

    def attn(p, x):
        return attention_fwd(p, cfg, x.to(dt), positions, causal=False)

    def body(i, h):
        lp = layer_params(params, "enc_layers", i)
        h, _ = _sublayer(cfg, lp["ln1"], lambda x: attn(lp["attn"], x), h, S)
        return _sublayer(cfg, lp["ln2"], lambda x: (
            mlp(lp["mlp"], x.to(dt), swiglu=False), None), h, S)[0]

    body = maybe_remat(cfg, body)
    h = take_seq_block(frames)
    for i in range(cfg.enc_layers):
        h = body(i, h)
    return rmsnorm(params["enc_norm"], gather_seq(h, length=S), cfg.norm_eps)


def _decoder(params, cfg, tokens: torch.Tensor, enc_out: torch.Tensor,
             cache: Optional[dict] = None) -> torch.Tensor:
    """The final-normed decoder states (B, S, D); each layer's self k/v
    go to rows [0, S) of ``cache["k"]`` / ``["v"]`` and its cross k/v to
    ``cache["ck"]`` / ``["cv"]`` when a cache is given, else each layer
    runs under ``maybe_remat``.

    Under tensor parallelism the states are this rank's block of the
    ``S`` positions (``seq_block``; the embedding's vocab-parallel rows
    reduce-scattered into it), each sublayer in :func:`_sublayer`'s form:
    the self-attention causal on the rank's heads, the cross-attention
    non-causal with q from the gathered normed residual on the rank's
    heads and k / v from the whole ``enc_out`` on the kv heads those
    read.  The cache is this rank's block of rows (``kv_block``) of each:
    the self rows of [0, S) that fall in it, and its ``S_enc / tp`` rows
    of the encoder's k / v."""
    B, S = tokens.shape
    h = scatter_seq(embed_tokens(params["embed"], cfg, tokens))
    positions = default_positions(cfg, B, S, device=h.device)
    enc_out = enc_out.to(dtype_of(cfg))
    self_kw, cross_kw = {}, {}
    if cache is not None:
        n = cache["k"].shape[2]
        lo = kv_offset(n)
        self_kw["kv_rows"] = (min(lo, S), min(lo + n, S))
        lo = kv_offset(cache["ck"].shape[2])
        cross_kw["kv_rows"] = (lo, lo + cache["ck"].shape[2])

    def layer(lp, h, enc_out):
        h, kv = _sublayer(cfg, lp["ln1"], lambda x: attention_fwd(
            lp["self"], cfg, x, positions, causal=True, **self_kw), h, S)
        h, ckv = _sublayer(cfg, lp["ln2"], lambda x: attention_fwd(
            lp["cross"], cfg, x, None, causal=False, x_kv=enc_out,
            use_rope=False, **cross_kw), h, S)
        h, _ = _sublayer(cfg, lp["ln3"], lambda x: (
            mlp(lp["mlp"], x, swiglu=False), None), h, S)
        return h, kv, ckv

    body = maybe_remat(cfg, lambda i, h, enc_out: layer(
        layer_params(params, "dec_layers", i), h, enc_out)[0])
    for i in range(cfg.num_layers):
        if cache is None:
            h = body(i, h, enc_out)
            continue
        h, (k, v), (ck, cv) = layer(layer_slice(params["dec_layers"], i), h,
                                    enc_out)
        cache["k"][i, :, :k.shape[1]], cache["v"][i, :, :v.shape[1]] = k, v
        cache["ck"][i], cache["cv"][i] = ck, cv
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)


def train_forward(params, cfg, batch):
    """batch: ``tokens``, ``labels`` (B, S) int, ``enc_frames`` (B,
    S_enc, D) and optional ``loss_mask``.  Returns (loss, metrics
    ``loss``, ``aux_loss`` (0), ``tokens``).  Under tensor parallelism S
    and S_enc must split over the model ranks (``ValueError``), and the
    loss is the vocab-parallel cross-entropy of the decoder's states
    gathered along the sequence."""
    _check_family(cfg)
    check_seq_split(batch["tokens"].shape[1])
    check_seq_split(batch["enc_frames"].shape[1], "encoder frames")
    enc_out = encode(params, cfg, batch["enc_frames"])
    h = gather_seq(_decoder(params, cfg, batch["tokens"], enc_out))
    loss, cnt = chunked_cross_entropy(
        lambda hc: logits_from_hidden(params["embed"], cfg, hc),
        h, batch["labels"], cfg, batch.get("loss_mask"))
    return loss, {"loss": loss, "aux_loss": torch.zeros_like(loss),
                  "tokens": cnt}


def prefill(params, cfg, batch, cache_len: Optional[int] = None):
    """batch: ``tokens`` (B, S) int and ``enc_frames`` (B, S_enc, D) on
    the parameters' device.  Returns the last position's logits (B,
    V_padded) f32 and the cache, the self rows padded to ``cache_len``.

    Under prefill rules with a model axis (``tokens`` and ``enc_frames``
    this rank's rows of the batch, whole along the sequence): the cache
    is this rank's block (:func:`init_cache`; ``ValueError`` where the
    cache length or S_enc does not split), the prompt may not split
    evenly (its last block is padded, as ``models.model``'s), and the
    logits are whole on every rank."""
    _check_family(cfg)
    B, S = batch["tokens"].shape
    frames = batch["enc_frames"]
    tok = params["embed"]["tok"]
    cache = init_cache(cfg, B, max(S, cache_len or 0), tok.dtype, tok.device,
                       enc_len=frames.shape[1])
    enc_out = encode(params, cfg, frames)
    h = _decoder(params, cfg, batch["tokens"], enc_out, cache)
    logits = whole_logits(params["embed"], cfg, seq_row(h, S - 1))
    cache["len"].fill_(S)
    return logits, cache


def decode_step(params, cfg, cache, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, V_padded) f32, cache).  The returned
    cache holds the same tensors, the self rows written in place, and
    ``len + 1``.

    Under decode rules with a model axis the residual is whole on every
    rank and the cache this rank's block of rows: the self-attention
    writes its row on the owner only and attends over the blocks
    (``attention.decode_block``, shared by the layers), the
    cross-attention over every row of the rank's block of the encoder's
    k / v, read only; each merged over the ranks by the log-sum-exp, the
    row-parallel outputs and the embedding's rows summed
    (``scatter_seq``, an all-reduce here), the logits whole."""
    _check_family(cfg)
    B = tokens.shape[0]
    h = scatter_seq(embed_tokens(params["embed"], cfg, tokens))
    pos = cache["len"]
    block = decode_block(pos, cache["k"].shape[2]) if kv_split() else None
    # without a split the cross-attention attends over cache_len + 1
    # rows: all S_enc of the encoder's (the reference passes S_enc, which
    # its mask reads as all rows as well)
    enc_last = torch.full((B,), cache["ck"].shape[2] - 1, dtype=torch.int32,
                          device=h.device)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["dec_layers"], i)
        h, _ = _sublayer(cfg, lp["ln1"], lambda x: attention_decode(
            lp["self"], cfg, x, pos, cache["k"][i], cache["v"][i],
            cache["len"], block=block)[:2], h, None)
        h, _ = _sublayer(cfg, lp["ln2"], lambda x: attention_decode(
            lp["cross"], cfg, x, pos, cache["ck"][i], cache["cv"][i],
            enc_last, update_cache=False, use_rope=False)[:2], h, None)
        h, _ = _sublayer(cfg, lp["ln3"], lambda x: (
            mlp(lp["mlp"], x, swiglu=False), None), h, None)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return (whole_logits(params["embed"], cfg, h),
            {**cache, "len": cache["len"] + 1})


def init_cache(cfg, B: int, S: int, dtype=torch.bfloat16, device=None,
               enc_len: Optional[int] = None):
    """The zeroed cache on ``device`` (None: the CUDA card); the cross
    rows number ``enc_len`` (default: ``enc_len_for(S)``).  Under rules
    that split ``kv_seq`` over a model axis this rank's block of each:
    ``S / tp`` self rows and ``enc_len / tp`` cross rows (``kv_block``:
    ``ValueError`` where either does not split)."""
    _check_family(cfg)
    device = resolve_device(device)
    L, KV, dh = cfg.num_layers, cfg.padded_kv, cfg.head_dim
    Se = kv_block(enc_len if enc_len is not None else enc_len_for(S))[1]
    S = kv_block(S)[1]

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"k": zeros(L, B, S, KV, dh), "v": zeros(L, B, S, KV, dh),
            "ck": zeros(L, B, Se, KV, dh), "cv": zeros(L, B, Se, KV, dh),
            "len": zeros(B, dt=torch.int32)}
