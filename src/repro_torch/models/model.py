"""Model assembly of the port: family dispatch, and the decoder-only
families (``dense`` / ``moe`` / ``vlm``, with GQA or MLA attention).

Translated from the reference's ``models/model.py``.  Public API:

  init_params(cfg, generator, device=None) -> params (nested dicts)
  train_forward(params, cfg, batch)        -> (loss, metrics)
  prefill(params, cfg, batch, cache_len=None) -> (last_logits (B, V), cache)
  decode_step(params, cfg, cache, tokens)  -> (logits (B, V), cache)
  init_cache(cfg, B, S, dtype=bf16, device=None) -> zeroed cache
  params_logical(cfg)                      -> the params' logical axes
  cache_logical(cfg)                       -> the cache's logical axes

The ``ssm`` (Mamba2) and ``hybrid`` (Zamba2) families go to
:mod:`repro_torch.models.hybrid` and ``encdec`` (SeamlessM4T) to
:mod:`repro_torch.models.encdec`, as in the reference.  The decoder-only
parameters keep the reference's leaf names and stacked shapes
(``embed.tok``, ``embed.head``, ``layers.attn.wq`` (L, D, H, dh), ...,
``layers.ln1.scale``, ``layers.ffn.wi``, ``final_norm.scale``; an ``moe``
layer's ``ffn`` holds ``router``, ``wi``, ``wg`` and ``wo`` stacked over
its experts; an MLA layer's ``attn`` holds ``wdq``, ``wuq``, ``wdkv``,
``wukv``, ``wo``, ``q_norm`` and ``kv_norm``), so a tree carried across
by :func:`repro_torch.interop.params_from_reference` runs here as it is.
The layers are a Python loop over the stacked leaves (the reference
scans them).  The GQA cache is ``{"k", "v": (L, B, S, KV, dh), "len": (B,)
int32}``, the MLA cache ``{"ckv": (L, B, S, kv_lora_rank), "kpe": (L, B,
S, qk_rope), "len"}``; prefill allocates it at its padded length and
fills the first S rows (the reference pads afterwards, ``_pad_seq``), and
a decode step writes its row of each layer's cache in place (the
reference threads the cache through its scan carry).

With ``kv_cache_dtype="int8"`` (GQA only, as in the reference),
``init_cache`` gives int8 ``k`` / ``v`` with f32 ``k_scale`` / ``v_scale``
(L, B, S, KV) and a decode step quantises its row.  Prefill still gives
the model-dtype cache without scales, as the reference's does; the
reference cannot decode from that (an ``IndexError`` on the missing
scales), and the port's ``decode_step`` raises ``ValueError`` there.

An ``moe`` layer's feed-forward is :func:`repro_torch.models.moe.moe_ffn`
(its expert products through the ``gmm`` kernel) where a dense layer's is
the SwiGLU MLP; prefill and decode drop its aux loss, as the reference's
do.

Under ``launch.specs.rules_for(cfg, mesh, "prefill" | "decode")`` with a
model axis (every family; the config resolved with ``tp``) ``prefill``,
``decode_step`` and ``init_cache`` serve with tensor parallelism: the
params are each rank's model blocks (``launch.specs.
serve_param_shardings``), the cache each rank's ``kv_seq`` block of rows
for every kv head (MLA: of both latent caches; ``encdec``: of the self
and the cross caches) and its rows of the batch (``launch.specs.
cache_shardings``; a Mamba2 cache its ``ssm_inner`` channels and heads),
the logits whole on every rank; shapes that do not split raise
``ValueError`` (:func:`check_tp`, ``parallel.sharding.kv_block``).

``train_forward`` is the reference's: the loss is the chunked
cross-entropy of the labels plus, for ``moe``, the layers' mean aux
loss; metrics ``loss``, ``aux_loss`` and ``tokens``.  Each layer runs
under ``maybe_remat`` (the config's ``remat``), so with ``"full"`` its
forward, flash and ``gmm`` kernels included, runs again in the backward
pass; it takes its weights by ``common.layer_params``, which under the
FSDP train step all-gathers them over the data-parallel axes inside the
body, for that layer alone (and again in the recompute).  The gradients come from autograd: through the kernels'
``autograd.Function``s (``FlashAttention``, ``GMM``), whose backward
kernels run on CUDA tensors and plain versions on CPU ones.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, ssm
from repro_torch.models.attention import (attention_decode, attention_fwd,
                                          attention_logical, check_lowered,
                                          decode_block, init_attention,
                                          init_mla, mla_decode, mla_fwd,
                                          mla_logical)
from repro_torch.models.common import (chunked_cross_entropy,
                                       default_positions, embed_tokens,
                                       embedding_logical, init_embedding,
                                       init_mlp, init_rmsnorm, layer_params,
                                       layer_slice, logits_from_hidden,
                                       maybe_remat, mlp,
                                       mlp_logical, rmsnorm, rmsnorm_logical,
                                       stacked_init, stacked_logical,
                                       whole_logits)
from repro_torch.models.moe import init_moe, moe_ffn, moe_logical
from repro_torch.parallel.sharding import (check_seq_split, dp_size,
                                           gather_seq, kv_block, kv_offset,
                                           kv_split, scatter_seq, seq_block,
                                           seq_row, tp_size)

#: the decoder-only families (``_dec_*``)
DEC_FAMILIES = ("dense", "moe", "vlm")


def check_tp(cfg, tp: int) -> None:
    """For a model axis of ``tp`` > 1, every family runs with tensor
    parallelism: ``ValueError`` where Mamba2's heads do not split
    (``ssm.check_tp``) or Zamba2's shared block's heads do not divide
    ``tp`` (``resolve`` pads ``num_heads``, never
    ``hybrid.shared_num_heads``).  The train step, prefill, decode and
    ``init_cache`` share this check; a sequence or a cache length that
    does not split is refused where it is read."""
    if tp == 1:
        return
    if cfg.family in ("ssm", "hybrid"):
        ssm.check_tp(cfg, tp)
    if cfg.family == "hybrid" and cfg.hybrid.shared_num_heads % tp:
        raise ValueError(
            f"{cfg.name}: the shared block's {cfg.hybrid.shared_num_heads} "
            f"heads do not split over {tp} model ranks (resolving the "
            f"config pads num_heads, not hybrid.shared_num_heads)")


def int8_kv(cfg) -> bool:
    """Whether ``cfg`` keeps an int8 KV cache: a GQA decoder-only model
    with ``kv_cache_dtype="int8"`` (the reference's MLA, Mamba2, Zamba2
    and encoder-decoder caches ignore the setting)."""
    return (cfg.family in DEC_FAMILIES and cfg.mla is None
            and cfg.kv_cache_dtype == "int8")


# ----------------------------------------------------------------------
# decoder-only layer
def _init_dec_layer(cfg, generator: torch.Generator, device) -> dict:
    init_attn = init_mla if cfg.mla is not None else init_attention
    init_ffn = init_moe if cfg.moe is not None else init_mlp
    return {"attn": init_attn(cfg, generator, device),
            "ln1": init_rmsnorm(cfg.d_model, device),
            "ln2": init_rmsnorm(cfg.d_model, device),
            "ffn": init_ffn(cfg, generator, device)}


def _dec_layer_logical(cfg) -> dict:
    return {"attn": mla_logical() if cfg.mla is not None
            else attention_logical(cfg),
            "ln1": rmsnorm_logical(), "ln2": rmsnorm_logical(),
            "ffn": moe_logical() if cfg.moe is not None else mlp_logical()}


def _ffn(lp, cfg, x: torch.Tensor):
    """The layer's feed-forward and its aux loss: the MoE layer (an f32
    scalar), or the SwiGLU MLP and None."""
    if cfg.moe is not None:
        return moe_ffn(lp["ffn"], cfg, x)
    return mlp(lp["ffn"], x), None


def _dec_layer(cfg, attn, lp, h: torch.Tensor, S: Optional[int] = None):
    """One decoder layer: (h, aux loss, the attention's cache rows);
    ``attn(p, x) -> (out, cache rows)`` is the layer's attention on its
    normed input (prefill's or the train step's full-sequence form, or a
    decode step's).

    Under tensor parallelism in train and prefill ``h`` is this rank's
    block of the ``S`` positions (the Megatron-SP residual, the
    reference's ``residual_seq``): each sublayer's normed input is
    all-gathered along the sequence for its column-parallel products, and
    its row-parallel output reduce-scattered back into the residual's
    blocks.  Under the decode rules the residual is whole on every rank:
    the gather is the identity and the outputs' partial sums are
    all-reduced (``parallel.sharding.scatter_seq``)."""
    eps = cfg.norm_eps
    a, kv = attn(lp["attn"], gather_seq(rmsnorm(lp["ln1"], h, eps), length=S))
    h = h + scatter_seq(a)
    f, aux = _ffn(lp, cfg, gather_seq(rmsnorm(lp["ln2"], h, eps), length=S))
    return h + scatter_seq(f), aux, kv


def _merge_vision(cfg, h: torch.Tensor, batch, S: int,
                  lo: int = 0) -> torch.Tensor:
    """The vision stub: the leading ``vision_embeds.shape[1]`` of the
    sequence's ``S`` positions take the given embeddings; ``h`` holds
    positions ``lo`` on (a tensor-parallel rank's block)."""
    ve = batch.get("vision_embeds")
    if ve is None or cfg.num_frontend_tokens == 0:
        return h
    n = ve.shape[1]
    if n > S:
        raise ValueError(f"{n} vision embeddings do not fit a sequence of "
                         f"{S} tokens")
    k = min(max(n - lo, 0), h.shape[1])
    if k == 0:
        return h
    return torch.cat([ve[:, lo:lo + k].to(h.dtype), h[:, k:, :]], dim=1)


def _dec_backbone(params, cfg, batch, cache: Optional[dict] = None):
    """(the final-normed hidden states (B, S, D), the layers' mean aux
    loss); each layer's k/v (or MLA latent and rotary key) go to rows
    [0, S) of ``cache`` when one is given, else each layer runs under
    ``maybe_remat``.  Under tensor parallelism the hidden states are this
    rank's block of ``ceil(S / tp)`` positions (``parallel.sharding.
    seq_block``): the embedding's partial rows (vocab-parallel) are
    reduce-scattered into it.  The train step's sequence must split
    evenly; prefill's may not (its last block is padded), and the cache
    is this rank's block of rows (``kv_block``), which takes the rows of
    [0, S) that fall in it."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cache is None:
        check_seq_split(S)
    h = scatter_seq(embed_tokens(params["embed"], cfg, tokens))
    if cfg.family == "vlm":
        h = _merge_vision(cfg, h, batch, S, seq_block(S)[0])
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, B, S, device=h.device)
    names = ("ckv", "kpe") if cfg.mla is not None else ("k", "v")
    attn_fwd = mla_fwd if cfg.mla is not None else attention_fwd
    kw = {}
    if cache is not None:
        n = cache[names[0]].shape[2]
        lo = kv_offset(n)
        kw["kv_rows"] = (min(lo, S), min(lo + n, S))

    def attn(p, x):
        return attn_fwd(p, cfg, x, positions, causal=cfg.causal, **kw)

    def body(i, hh):
        hh, aux, _ = _dec_layer(cfg, attn, layer_params(params, "layers", i),
                                hh, S)
        return hh, aux

    body = maybe_remat(cfg, body)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_layers):
        if cache is None:
            h, a = body(i, h)
        else:
            h, a, kv = _dec_layer(cfg, attn, layer_slice(params["layers"], i),
                                  h, S)
            for name, rows in zip(names, kv):
                cache[name][i, :, :rows.shape[1]] = rows
        if a is not None:
            aux = aux + a
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), \
        aux / cfg.num_layers


def _dec_train_forward(params, cfg, batch):
    h, aux = _dec_backbone(params, cfg, batch)
    h = gather_seq(h)
    loss, cnt = chunked_cross_entropy(
        lambda hc: logits_from_hidden(params["embed"], cfg, hc),
        h, batch["labels"], cfg, batch.get("loss_mask"))
    return loss + aux, {"loss": loss, "aux_loss": aux, "tokens": cnt}


def _dec_prefill(params, cfg, batch, cache_len: Optional[int] = None):
    """The last position's logits (B, V_padded) and the model-dtype cache
    of ``max(S, cache_len)`` rows, int8 config or not (the reference's
    prefill).

    Under prefill rules with a model axis (``tokens`` this rank's rows of
    the batch, whole along the sequence) the cache returned is this
    rank's block (``kv_block``) of the rows, for every kv head, and
    ``len`` its rows' lengths; the logits are the whole vocabulary's on
    every model rank: the last position's hidden state taken from the
    rank whose sequence block holds it, its vocabulary blocks
    all-gathered."""
    B, S = batch["tokens"].shape
    tok = params["embed"]["tok"]
    cache = _dec_init_cache(cfg, B, max(S, cache_len or 0), tok.dtype,
                            tok.device)
    h, _ = _dec_backbone(params, cfg, batch, cache)
    logits = whole_logits(params["embed"], cfg, seq_row(h, S - 1))
    cache["len"].fill_(S)
    return logits, cache


def _dec_decode(params, cfg, cache, tokens: torch.Tensor):
    """One token a row: (logits (B, V_padded), the cache with ``len +
    1``), each layer's row written in place.

    Under decode rules with a model axis the residual is whole on every
    rank (``residual_seq -> None``) and the cache this rank's block of
    rows: each layer attends over the blocks (``attention_decode``), its
    row-parallel outputs and the embedding's vocab-parallel rows summed
    over the model ranks (``scatter_seq``, an all-reduce here), and the
    logits are the whole vocabulary's on every rank."""
    int8 = int8_kv(cfg)
    if int8 and "k_scale" not in cache:
        raise ValueError(
            "an int8 KV cache decodes only from init_cache: this cache has "
            "no k_scale / v_scale (prefill keeps the model's dtype, and the "
            "reference's decode fails on it with an IndexError)")
    h = scatter_seq(embed_tokens(params["embed"], cfg, tokens))   # (B, 1, D)
    pos = cache["len"]
    block = (decode_block(pos, cache["ckv" if cfg.mla else "k"].shape[2])
             if kv_split() else None)
    for i in range(cfg.num_layers):
        if cfg.mla is not None:
            def attn(p, x):
                return mla_decode(p, cfg, x, pos, cache["ckv"][i],
                                  cache["kpe"][i], cache["len"],
                                  block)[0], None
        else:
            def attn(p, x):
                scales = ((cache["k_scale"][i], cache["v_scale"][i]) if int8
                          else None)
                return attention_decode(p, cfg, x, pos, cache["k"][i],
                                        cache["v"][i], cache["len"],
                                        scales=scales, block=block)[0], None
        h, _, _ = _dec_layer(cfg, attn, layer_slice(params["layers"], i), h)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return (whole_logits(params["embed"], cfg, h),
            {**cache, "len": cache["len"] + 1})


def _dec_init_params(cfg, generator: torch.Generator, device) -> dict:
    """Draws in order: the embedding (tok, head), then layer by layer
    (wq, wk, wv, wo or MLA's wdq, wuq, wdkv, wukv, wo; then the MLP's wi,
    wo, wg or the MoE layer's router, wi, wg, wo), each layer drawn in
    f32 on the generator's device and cast into its slot of the stacked
    leaves."""
    embed = init_embedding(cfg, generator, device)
    layers = stacked_init(lambda: _init_dec_layer(cfg, generator, device),
                          cfg.num_layers)
    return {"embed": embed, "layers": layers,
            "final_norm": init_rmsnorm(cfg.d_model, device)}


def _dec_params_logical(cfg) -> dict:
    return {"embed": embedding_logical(cfg),
            "layers": stacked_logical(_dec_layer_logical(cfg)),
            "final_norm": rmsnorm_logical()}


def _dec_cache_logical(cfg) -> dict:
    if cfg.mla is not None:
        return {"ckv": ("layers", "batch", "kv_seq", None),
                "kpe": ("layers", "batch", "kv_seq", None),
                "len": ("noshard",)}
    lg = {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
          "v": ("layers", "batch", "kv_seq", "kv_heads", None),
          "len": ("noshard",)}
    if cfg.kv_cache_dtype == "int8":
        lg["k_scale"] = ("layers", "batch", "kv_seq", "kv_heads")
        lg["v_scale"] = ("layers", "batch", "kv_seq", "kv_heads")
    return lg


def _dec_init_cache(cfg, B: int, S: int, dtype=torch.bfloat16, device=None,
                    int8: bool = False):
    """The zeroed cache of ``B`` rows (this rank's) and ``S`` positions;
    ``int8`` gives int8 rows and their f32 scales.  Under rules that split
    ``kv_seq`` over a model axis only this rank's block of the positions
    (``kv_block``: ``ValueError`` where ``S`` does not split)."""
    L = cfg.num_layers
    S = kv_block(S)[1]

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": zeros((L, B, S, m.kv_lora_rank), dtype),
                "kpe": zeros((L, B, S, m.qk_rope_head_dim), dtype),
                "len": zeros((B,), torch.int32)}
    shape = (L, B, S, cfg.padded_kv, cfg.head_dim)
    if int8:
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:-1], torch.float32),
                "v_scale": zeros(shape[:-1], torch.float32),
                "len": zeros((B,), torch.int32)}
    return {"k": zeros(shape, dtype), "v": zeros(shape, dtype),
            "len": zeros((B,), torch.int32)}


# ----------------------------------------------------------------------
# public dispatch
def _family(cfg):
    """The module serving ``cfg``'s family, None for the decoder-only
    families (this module)."""
    check_lowered(cfg)
    return {"ssm": hybrid, "hybrid": hybrid, "encdec": encdec}.get(cfg.family)


def _serving_family(cfg):
    """:func:`_family`, after :func:`check_tp` on the active rules' model
    axis."""
    check_tp(cfg, tp_size())
    return _family(cfg)


def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Random parameters for ``cfg`` on ``device`` (None: the CUDA card),
    drawn from ``generator`` on its own device one layer at a time, so no
    f32 copy of the whole model is ever held."""
    fam = _family(cfg)
    if fam is not None:
        return fam.init_params(cfg, generator, resolve_device(device))
    return _dec_init_params(cfg, generator, resolve_device(device))


def params_logical(cfg) -> dict:
    """The params' tree with each leaf replaced by its logical axis names
    (a tuple, ``"layers"`` in front of a stacked leaf's): the reference's
    ``params_logical``, which traces its init functions for the trees they
    return beside the params; the port writes them beside its own."""
    fam = _family(cfg)
    if fam is not None:
        return fam.params_logical(cfg)
    return _dec_params_logical(cfg)


def cache_logical(cfg) -> dict:
    """The cache's logical axis names, leaf by leaf (the reference's)."""
    fam = _family(cfg)
    if fam is not None:
        return fam.cache_logical(cfg)
    return _dec_cache_logical(cfg)


def train_forward(params, cfg, batch):
    """batch: ``tokens`` and ``labels`` (B, S) int, optional
    ``loss_mask`` (B, S), ``vision_embeds`` and ``positions``, and for
    ``encdec`` the encoder's ``enc_frames``, on the parameters' device; S
    a multiple of ``cfg.loss_chunk`` or shorter.  Returns (loss, metrics
    ``loss``, ``aux_loss``, ``tokens``), f32 scalars, the loss
    differentiable in the parameters."""
    fam = _family(cfg)
    if fam is not None:
        return fam.train_forward(params, cfg, batch)
    return _dec_train_forward(params, cfg, batch)


def prefill(params, cfg, batch, cache_len: Optional[int] = None):
    """batch: ``tokens`` (B, S) int, optional ``vision_embeds`` (B, n, D)
    and ``positions``, and for ``encdec`` the encoder's ``enc_frames``
    (B, S_enc, D), on the parameters' device.  Returns the last
    position's logits (B, V_padded) f32 and the cache, padded to
    ``cache_len`` rows (the ``ssm`` family's cache has no rows).

    Under ``launch.specs.rules_for(cfg, mesh, "prefill")`` with a model
    axis (``cfg`` resolved with ``tp``; ``params`` each rank's blocks,
    ``launch.specs.serve_param_shardings``; ``batch`` this rank's rows):
    the cache is this rank's block in ``launch.specs.cache_shardings``'
    layout and the logits are whole on every rank (:func:`_dec_prefill`,
    ``hybrid.prefill``, ``encdec.prefill``)."""
    fam = _serving_family(cfg)
    if fam is not None:
        return fam.prefill(params, cfg, batch, cache_len)
    return _dec_prefill(params, cfg, batch, cache_len)


def decode_step(params, cfg, cache, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, V_padded) f32, cache).  The returned
    cache holds the same state tensors, updated in place, and
    ``len + 1``.  Under the decode rules with a model axis the cache is
    this rank's block, as :func:`prefill` and :func:`init_cache` give it
    (:func:`_dec_decode`)."""
    fam = _serving_family(cfg)
    if fam is not None:
        return fam.decode_step(params, cfg, cache, tokens)
    return _dec_decode(params, cfg, cache, tokens)


def init_cache(cfg, B: int, S: int, dtype=torch.bfloat16, device=None):
    """The zeroed cache of ``B`` sequences and ``S`` positions.  Under
    rules with a model axis, this rank's block of it in ``launch.specs.
    cache_shardings``' layout: its rows of the batch (where ``B`` splits
    over the data-parallel ranks) and its block of the positions."""
    fam = _serving_family(cfg)
    dp = dp_size()
    B = B // dp if B % dp == 0 else B
    if fam is not None:
        return fam.init_cache(cfg, B, S, dtype, resolve_device(device))
    return _dec_init_cache(cfg, B, S, dtype, resolve_device(device),
                           int8=int8_kv(cfg))
