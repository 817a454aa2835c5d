"""The ``ssm`` (Mamba2) and ``hybrid`` (Zamba2) families of the port.

Translated from the reference's ``models/hybrid.py``: ``init_params``,
``prefill``, ``decode_step`` and ``init_cache`` for a stack of Mamba2
blocks (pre-norm, residual) between the embedding and the tied logits,
and Zamba2's shared block.

Zamba2 (``family == "hybrid"``): after every ``hybrid.shared_every``
Mamba2 blocks (a group), one *shared* transformer block (weights reused
by every group, per-group LoRA deltas on the q and FFN-in projections)
runs on concat(hidden, token embedding) at 2 d_model and its output,
projected back to d_model, is added to the stream.  Its attention calls
the flash kernel (causal, once a group) in prefill and the decode kernel
(once a group a step) in decode.

The parameters keep the reference's leaf names and stacked shapes:
``embed.tok``, ``final_norm.scale`` and, for ``ssm``, ``layers.ln.scale``,
``layers.mixer.in_z`` (L, D, d_inner), ...; for ``hybrid``, ``mamba``
stacked (G, per, ...), ``shared`` (``attn``, ``mlp`` with ``wi``, ``wo``,
``wg``, ``ln1``, ``ln2``, ``down``) and ``lora`` (``qa``, ``qb``, ``ia``,
``ib``) stacked (G, ...).  The reference starts ``qb`` and ``ib`` at
zeros, as does the port, so under init weights the LoRA path adds exactly
0.

The cache is ``{"conv": {"x", "B", "C": (L, B, W-1, C) f32}, "ssm":
(L, B, H, P, N) f32, "len": (B,) int32}`` (``hybrid``: (G, per, ...)
for the Mamba2 state, and the shared block's ``k``, ``v``: (G, B, S,
KV, dh)).  Prefill writes each layer's slice as the layer runs; a decode
step updates them in place (the reference threads them through its scan
carry).  The Mamba2 cache has no sequence axis, so the ``ssm`` family's
prefill ignores ``cache_len``, as in the reference.

``train_forward`` is the reference's (the chunked cross-entropy, no aux
loss; each ``ssm`` layer or ``hybrid`` group under ``maybe_remat``,
its weights taken by ``common.layer_params``: under the FSDP train step
each Mamba2 layer's and the group's LoRA gathered over the data-parallel
axes inside the body, one layer at a time; the shared block, outside
the stacks, is gathered once a step).
Under grad the Mamba2 layer's scan goes through ``kernels.ssd.SSD``: on
the card the SSD kernel forward and ``csrc/ssd_bwd.cu`` backward, on the
CPU their plain versions.

Under tensor parallelism (rules with a model axis; the config resolved
with ``tp``) each layer runs as ``model._dec_layer``'s sublayers do: in
train and prefill the residual is this rank's block of the sequence
(``residual_seq``), each Mamba2 layer's normed input is all-gathered
along it, the mixer runs on the rank's heads (``models.ssm``) and its
row-parallel output is reduce-scattered back; under the decode rules the
gather is the identity and the sum an all-reduce.  The shared block runs
on its local heads: ``wq`` and the LoRA's ``qb`` split over ``heads``,
the MLP's ``wi`` / ``wg`` and the LoRA's ``ib`` over ``mlp``, ``wk`` /
``wv`` replicated and read for the rank's q heads
(``attention.local_kv``), both ``wo`` row-parallel; concat(hidden,
embedding) stays in the residual's layout and ``down`` is replicated.  Its
decode attends over the rank's ``kv_seq`` block of the cache
(``attention._decode_block``: the decode kernel's log-sum-exp, merged by
``combine_over_model``).  The cache holds the rank's rows of the batch,
``ssm_inner`` channels and heads, and ``kv_seq`` block
(:func:`init_cache`); the logits are whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (_all_kv, _decode_block,
                                          _out_proj, _proj,
                                          attention_logical, decode_block,
                                          init_attention, local_kv)
from repro_torch.models.common import (apply_rope, chunked_cross_entropy,
                                       default_positions, dtype_of,
                                       embed_tokens, embedding_logical,
                                       init_embedding, init_mlp,
                                       init_rmsnorm, layer_params,
                                       layer_slice, logits_from_hidden,
                                       maybe_remat,
                                       mlp_logical, normal_init, rmsnorm,
                                       rmsnorm_logical, stacked_init,
                                       stacked_logical, whole_logits)
from repro_torch.models.ssm import (init_mamba2, mamba2_decode, mamba2_fwd,
                                    mamba2_logical)
from repro_torch.parallel.sharding import (check_seq_split, gather_seq,
                                           kv_block, kv_offset, scatter_seq,
                                           seq_row, tp_size)

_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"models/hybrid.py serves the 'ssm' and 'hybrid' "
                         f"families, not {cfg.family!r}")


# ----------------------------------------------------------------------
def _init_mamba_layer(cfg, generator: torch.Generator, device) -> dict:
    return {"ln": init_rmsnorm(cfg.d_model, device),
            "mixer": init_mamba2(cfg, generator, device)}


def _mamba_layer_fwd(cfg, lp, h: torch.Tensor, S: Optional[int] = None):
    """A Mamba2 layer on the residual ``h`` (under tensor parallelism this
    rank's block of the ``S`` positions): the normed input gathered along
    the sequence, the mixer's partial output summed back into the
    blocks."""
    y, states = mamba2_fwd(lp["mixer"], cfg, gather_seq(
        rmsnorm(lp["ln"], h, cfg.norm_eps), length=S))
    return h + scatter_seq(y), states


def _mamba_layer_decode(cfg, lp, h: torch.Tensor, conv_s: dict,
                        ssm_s: torch.Tensor):
    y, conv_s, ssm_s = mamba2_decode(
        lp["mixer"], cfg, rmsnorm(lp["ln"], h, cfg.norm_eps), conv_s, ssm_s)
    return h + scatter_seq(y), conv_s, ssm_s


def _layer_cache(cache: dict, *idx):
    """The conv tails and SSD state of layer ``idx`` (``i`` for ``ssm``,
    ``g, j`` for ``hybrid``): views into ``cache``."""
    return {k: v[idx] for k, v in cache["conv"].items()}, cache["ssm"][idx]


def _write_layer_cache(cache: dict, idx, states) -> None:
    tails, state = states
    conv, ssm = _layer_cache(cache, *idx)
    for name, t in zip(("x", "B", "C"), tails):
        conv[name].copy_(t)
    ssm.copy_(state)


# ----------------------------------------------------------------------
# Zamba2 shared block
def _init_shared_block(cfg, generator: torch.Generator, device) -> dict:
    """Draws in order: the attention (wq, wk, wv, wo at 2 d_model), the
    MLP (wi, wo, wg), then ``down``."""
    hb, D2 = cfg.hybrid, 2 * cfg.d_model
    attn = init_attention(cfg, generator, device, d_in=D2, d_out=D2,
                          num_heads=hb.shared_num_heads,
                          num_kv_heads=hb.shared_kv_heads,
                          head_dim=cfg.head_dim)
    mlp = init_mlp(cfg, generator, device, d_ff=hb.shared_d_ff, d_in=D2)
    return {"attn": attn, "mlp": mlp, "ln1": init_rmsnorm(D2, device),
            "ln2": init_rmsnorm(D2, device),
            "down": normal_init((D2, cfg.d_model), D2 ** -0.5,
                                dtype_of(cfg), generator, device)}


def _init_lora(cfg, generator: torch.Generator, device) -> dict:
    """Draws ``qa`` then ``ia``; ``qb`` and ``ib`` are zeros, as in the
    reference."""
    hb, D2, dt = cfg.hybrid, 2 * cfg.d_model, dtype_of(cfg)
    r, Hdh = hb.lora_rank, hb.shared_num_heads * cfg.head_dim
    qa = normal_init((D2, r), D2 ** -0.5, dt, generator, device)
    ia = normal_init((D2, r), D2 ** -0.5, dt, generator, device)
    return {"qa": qa, "qb": torch.zeros((r, Hdh), dtype=dt, device=qa.device),
            "ia": ia,
            "ib": torch.zeros((r, hb.shared_d_ff), dtype=dt,
                              device=qa.device)}


def _shared_q(sp, lp, x: torch.Tensor):
    """The shared block's q on this rank's heads, with the group's LoRA
    delta (``qb``: the rank's block of the heads' columns)."""
    q = _proj(x, sp["attn"]["wq"])
    return q + ((x @ lp["qa"]) @ lp["qb"]).reshape(q.shape)


def _shared_qkv(cfg, sp, lp, x: torch.Tensor, positions: torch.Tensor):
    """QKV of the shared block with the group's LoRA delta on q, rotated
    at ``positions`` (B, S): q on this rank's heads, k and v on the kv
    heads those read."""
    ap = local_kv(sp["attn"])
    q = _shared_q(sp, lp, x)
    k, v = _proj(x, ap["wk"]), _proj(x, ap["wv"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _shared_mlp(sp, lp, x: torch.Tensor) -> torch.Tensor:
    """The shared SwiGLU MLP with the group's LoRA delta on wi (under
    tensor parallelism the rank's ``mlp`` block: a partial sum)."""
    mp = sp["mlp"]
    h = x @ mp["wi"] + (x @ lp["ia"]) @ lp["ib"]
    return (F.silu(x @ mp["wg"]) * h) @ mp["wo"]


def _shared_block_tail(cfg, sp, lp, u: torch.Tensor, a: torch.Tensor,
                       S: Optional[int] = None) -> torch.Tensor:
    """The block after its attention: ``a`` the output projection's
    (partial) sum added into ``u``, the MLP, and the projection back to
    d_model (``u`` in the residual's layout)."""
    u = u + scatter_seq(a)
    x = gather_seq(rmsnorm(sp["ln2"], u, cfg.norm_eps), length=S)
    u = u + scatter_seq(_shared_mlp(sp, lp, x))
    return u @ sp["down"]


def _shared_block_fwd(cfg, sp, lp, h, emb, positions, S=None, kv_rows=None):
    """Prefill.  Returns (out (B, S, D), (k, v) (B, S, KV, dh));
    ``kv_rows = (lo, hi)`` gives instead the rows of positions [lo, hi)
    for every kv head (a prefill's block of the sequence-parallel
    cache)."""
    u = torch.cat([h, emb], dim=-1)
    x = gather_seq(rmsnorm(sp["ln1"], u, cfg.norm_eps), length=S)
    q, k, v = _shared_qkv(cfg, sp, lp, x, positions)
    att = flash_attention(q, k, v, causal=True)
    if kv_rows is not None:
        lo, hi = kv_rows
        ap = sp["attn"]
        if _all_kv(ap):
            k, v = k[:, lo:hi], v[:, lo:hi]
        else:
            k = apply_rope(_proj(x[:, lo:hi], ap["wk"]), positions[:, lo:hi],
                           cfg.rope_theta)
            v = _proj(x[:, lo:hi], ap["wv"])
    return _shared_block_tail(cfg, sp, lp, u, _out_proj(att, sp["attn"]["wo"]),
                              S), (k, v)


def _shared_block_decode(cfg, sp, lp, h, emb_t, pos, k_cache, v_cache,
                         block):
    """One decode step: writes row ``pos[b]`` of the group's ``k_cache``
    / ``v_cache`` (B, S, KV, dh) in place and attends over its ``pos +
    1`` rows.  Returns out (B, 1, D).  ``block`` is ``attention.
    decode_block``'s for this step: the caches are this rank's block of
    the sequence-parallel cache (the whole cache without a model axis),
    which ``attention._decode_block`` attends over."""
    u = torch.cat([h, emb_t], dim=-1)                          # (B,1,2D)
    x = rmsnorm(sp["ln1"], u, cfg.norm_eps)
    ap = sp["attn"]
    q = apply_rope(_shared_q(sp, lp, x), pos[:, None], cfg.rope_theta)
    k = apply_rope(_proj(x, ap["wk"]), pos[:, None], cfg.rope_theta)
    a = _decode_block(ap, q, k, _proj(x, ap["wv"]), k_cache, v_cache, block,
                      None)
    return _shared_block_tail(cfg, sp, lp, u, a)


def _n_groups(cfg) -> int:
    every = cfg.hybrid.shared_every
    if cfg.num_layers % every:
        raise ValueError(f"{cfg.num_layers} layers do not split into groups "
                         f"of {every}")
    return cfg.num_layers // every


# ----------------------------------------------------------------------
def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Parameters on ``device`` (None: the CUDA card).  Draws in order:
    the embedding, then layer by layer (each Mamba2 block as
    ``init_mamba2`` draws it; ``hybrid``: group by group) into stacked
    leaves, then for ``hybrid`` the shared block and each group's LoRA."""
    _check_family(cfg)
    device = resolve_device(device)
    p = {"embed": init_embedding(cfg, generator, device),
         "final_norm": init_rmsnorm(cfg.d_model, device)}

    def mamba_layer():
        return _init_mamba_layer(cfg, generator, device)

    if cfg.family == "ssm":
        p["layers"] = stacked_init(mamba_layer, cfg.num_layers)
        return p
    G, per = _n_groups(cfg), cfg.hybrid.shared_every
    p["mamba"] = stacked_init(lambda: stacked_init(mamba_layer, per), G)
    p["shared"] = _init_shared_block(cfg, generator, device)
    p["lora"] = stacked_init(lambda: _init_lora(cfg, generator, device), G)
    return p


def _backbone(params, cfg, batch, cache: Optional[dict] = None):
    """The final-normed hidden states (B, S, D); each layer's conv tails
    and final SSD state (and each group's shared k/v, rows [0, S)) go to
    ``cache`` when one is given, else each ``ssm`` layer or ``hybrid``
    group runs under ``maybe_remat``.  Under tensor parallelism the hidden
    states are this rank's block of ``ceil(S / tp)`` positions
    (``parallel.sharding.seq_block``; the train step's sequence must split
    evenly, prefill's last block is padded) and the shared k/v this
    rank's block of rows (``kv_block``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cache is None:
        check_seq_split(S)
    emb = scatter_seq(embed_tokens(params["embed"], cfg, tokens))
    h = emb
    if cfg.family == "ssm":
        body = maybe_remat(cfg, lambda i, hh: _mamba_layer_fwd(
            cfg, layer_params(params, "layers", i), hh, S)[0])
        for i in range(cfg.num_layers):
            if cache is None:
                h = body(i, h)
                continue
            h, states = _mamba_layer_fwd(cfg, layer_slice(params["layers"], i),
                                         h, S)
            _write_layer_cache(cache, (i,), states)
        return rmsnorm(params["final_norm"], h, cfg.norm_eps)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, B, S, device=h.device)
    kv_rows = None
    if cache is not None:
        n = cache["k"].shape[2]
        lo = kv_offset(n)
        kv_rows = (min(lo, S), min(lo + n, S))

    def group(g, hh):
        """One ``hybrid`` group: (h, each layer's states, the shared
        block's (k, v)); under the FSDP train step each Mamba2 layer and
        the group's LoRA are gathered on their own (``layer_params``)."""
        states = []
        for j in range(cfg.hybrid.shared_every):
            hh, st = _mamba_layer_fwd(
                cfg, layer_params(params, "mamba", (g, j)), hh, S)
            states.append(st)
        blk, kv = _shared_block_fwd(cfg, params["shared"],
                                    layer_params(params, "lora", g), hh, emb,
                                    positions, S, kv_rows)
        return hh + blk, states, kv

    body = maybe_remat(cfg, lambda g, hh: group(g, hh)[0])
    for g in range(_n_groups(cfg)):
        if cache is None:
            h = body(g, h)
            continue
        h, states, (k, v) = group(g, h)
        for j, st in enumerate(states):
            _write_layer_cache(cache, (g, j), st)
        cache["k"][g, :, :k.shape[1]] = k
        cache["v"][g, :, :v.shape[1]] = v
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)


def train_forward(params, cfg, batch):
    """batch: ``tokens``, ``labels`` (B, S) int and optional
    ``loss_mask`` on the parameters' device.  Returns (loss,
    metrics ``loss``, ``aux_loss`` (0), ``tokens``).  Under tensor
    parallelism the loss is the vocab-parallel cross-entropy of the
    hidden states gathered along the sequence."""
    _check_family(cfg)
    h = gather_seq(_backbone(params, cfg, batch))
    loss, cnt = chunked_cross_entropy(
        lambda hc: logits_from_hidden(params["embed"], cfg, hc),
        h, batch["labels"], cfg, batch.get("loss_mask"))
    return loss, {"loss": loss, "aux_loss": torch.zeros_like(loss),
                  "tokens": cnt}


def prefill(params, cfg, batch, cache_len: Optional[int] = None):
    """batch: ``tokens`` (B, S) int on the parameters' device.  Returns
    the last position's logits (B, V_padded) f32 and the cache (the
    shared block's rows padded to ``cache_len``).  Under tensor
    parallelism ``tokens`` are this rank's rows of the batch, the cache
    this rank's block (:func:`init_cache`) and the logits whole on every
    rank: the last position's hidden state from the rank whose sequence
    block holds it, its vocabulary blocks all-gathered."""
    _check_family(cfg)
    B, S = batch["tokens"].shape
    tok = params["embed"]["tok"]
    cache = init_cache(cfg, B, max(S, cache_len or 0), tok.dtype, tok.device)
    h = _backbone(params, cfg, batch, cache)
    logits = whole_logits(params["embed"], cfg, seq_row(h, S - 1))
    cache["len"].fill_(S)
    return logits, cache


def decode_step(params, cfg, cache, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, V_padded) f32, cache).  The returned
    cache holds the same state tensors, updated in place, and
    ``len + 1``.  Under the decode rules with a model axis the residual
    is whole on every rank, each row-parallel output and the embedding's
    vocab-parallel rows all-reduced, and the shared block attends over
    the rank's block of its cache."""
    _check_family(cfg)
    emb_t = scatter_seq(embed_tokens(params["embed"], cfg, tokens))
    h = emb_t                                                  # (B, 1, D)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            h, _, _ = _mamba_layer_decode(
                cfg, layer_slice(params["layers"], i), h,
                *_layer_cache(cache, i))
    else:
        pos = cache["len"]
        block = decode_block(pos, cache["k"].shape[2])
        for g in range(_n_groups(cfg)):
            mp = layer_slice(params["mamba"], g)
            for j in range(cfg.hybrid.shared_every):
                h, _, _ = _mamba_layer_decode(cfg, layer_slice(mp, j), h,
                                              *_layer_cache(cache, g, j))
            h = h + _shared_block_decode(
                cfg, params["shared"], layer_slice(params["lora"], g), h,
                emb_t, pos, cache["k"][g], cache["v"][g], block)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return (whole_logits(params["embed"], cfg, h),
            {**cache, "len": cache["len"] + 1})


def params_logical(cfg) -> dict:
    """The params' logical axes, as the reference's: a Zamba2 Mamba2
    leaf is stacked over groups and over the layers of a group, and both
    axes are named ``"layers"``."""
    _check_family(cfg)
    mamba = stacked_logical({"ln": rmsnorm_logical(),
                             "mixer": mamba2_logical()})
    lg = {"embed": embedding_logical(cfg), "final_norm": rmsnorm_logical()}
    if cfg.family == "ssm":
        lg["layers"] = mamba
        return lg
    lg["mamba"] = stacked_logical(mamba)
    lg["shared"] = {"attn": attention_logical(cfg), "mlp": mlp_logical(),
                    "ln1": rmsnorm_logical(), "ln2": rmsnorm_logical(),
                    "down": (None, "embed")}
    lg["lora"] = stacked_logical({"qa": (None, None), "qb": (None, "heads"),
                                  "ia": (None, None), "ib": (None, "mlp")})
    return lg


def cache_logical(cfg) -> dict:
    _check_family(cfg)
    if cfg.family == "ssm":
        return {"conv": {"x": ("layers", "batch", None, "ssm_inner"),
                         "B": ("layers", "batch", None, None),
                         "C": ("layers", "batch", None, None)},
                "ssm": ("layers", "batch", "ssm_inner", None, None),
                "len": ("noshard",)}
    return {"conv": {"x": ("layers", None, "batch", None, "ssm_inner"),
                     "B": ("layers", None, "batch", None, None),
                     "C": ("layers", None, "batch", None, None)},
            "ssm": ("layers", None, "batch", "ssm_inner", None, None),
            "k": ("layers", "batch", "kv_seq", "kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "kv_heads", None),
            "len": ("noshard",)}


def init_cache(cfg, B: int, S: int, dtype=torch.bfloat16, device=None):
    """The zeroed cache on ``device`` (None: the CUDA card).  The Mamba2
    state is kept in f32 whatever ``dtype``; ``S`` and ``dtype`` size
    only the shared block's k/v (``hybrid``), as in the reference.  Under
    rules with a model axis this rank's block (``launch.specs.
    cache_shardings``): ``B`` its rows (the caller's), the ``x`` conv
    tails its ``ssm_inner`` channels, the SSD state its heads, the shared
    k/v its ``kv_seq`` block of ``S`` (``kv_block``: ``ValueError`` where
    ``S`` does not split)."""
    _check_family(cfg)
    device = resolve_device(device)
    s = cfg.ssm
    D, W = cfg.d_model, s.d_conv
    tp = tp_size()
    di, gn = s.d_inner(D) // tp, s.n_groups * s.d_state
    H, P, N = s.n_heads(D) // tp, s.head_dim, s.d_state
    lead = ((cfg.num_layers,) if cfg.family == "ssm"
            else (_n_groups(cfg), cfg.hybrid.shared_every))

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    cache = {"conv": {"x": zeros(*lead, B, W - 1, di),
                      "B": zeros(*lead, B, W - 1, gn),
                      "C": zeros(*lead, B, W - 1, gn)},
             "ssm": zeros(*lead, B, H, P, N),
             "len": zeros(B, dt=torch.int32)}
    if cfg.family == "hybrid":
        kv = (lead[0], B, kv_block(S)[1], cfg.hybrid.shared_kv_heads,
              cfg.head_dim)
        cache["k"], cache["v"] = zeros(*kv, dt=dtype), zeros(*kv, dt=dtype)
    return cache
