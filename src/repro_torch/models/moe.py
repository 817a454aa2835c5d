"""Mixture-of-Experts feed-forward of the port: a top-k router with
per-group capacity, and the experts' products through the ``gmm`` kernel.

Translated from the reference's ``models/moe.py`` (``init_moe``,
``moe_ffn``), step by step:

- tokens form ``G`` dispatch groups, ``G`` doubled while a group holds
  more than 2048 tokens;
- an f32 router softmax and top-k, the gate values renormalised to sum
  to 1 (Qwen3);
- a per-group capacity ``cap = max(4, round_up(Sg·K/E·capacity_factor,
  4))``, taken slot-major: every token's top-1 assignment in the group
  comes before any top-2, and within a slot earlier tokens come first;
  assignments past ``cap`` are dropped (their FFN output is 0);
- the experts' input rounded to bf16 whatever the model's dtype (the
  reference's dispatch einsum is bf16), then cast to the weights' dtype;
- ``h = gmm(xe, wi)``, ``g = gmm(xe, wg)``, ``oe = gmm(silu(g) * h,
  wo)`` on the (E, G·cap, D) slot tensor;
- the combine with the gate values cast to ``oe``'s dtype, and the
  Switch load-balancing loss.

Where the reference builds one-hot (G, Sg, E, cap) dispatch and combine
tensors and contracts them, the port indexes: a slot is the exclusive
count of earlier assignments to the same expert in the flattened (k, s)
order, each slot gathers the row of the token assigned to it (a zero
row if none), and each token gathers its <= K expert rows and sums them
in f32.  The numbers are the same (each slot
holds one token, so the one-hot products are exact); the work is not.
Dropped assignments go to one spare slot past the end and are read back
with weight 0, so nothing waits for the host to count them.

The two gathers are ``index_select``s, whose backward is an
``index_add`` (on the card by atomics): advanced indexing's
sort-based backward, here and in the embedding, took 79 ms of a 430 ms
qwen3-moe train step (2 layers, B 4 x S 1024) on the H100.  Under grad the three products go through ``kernels.gmm.GMM`` (the
``gmm`` kernel's backward), and gradients reach the gate values (through
the combine) and the router's probabilities (through the gates and the
aux loss) as in the reference; the expert ids, the slot indices and the
one-hot counts are integers and carry none, as the reference's one-hot
dispatch carries none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.gmm import gmm
from repro_torch.models.common import dtype_of, normal_init
from repro_torch.parallel.sharding import (dp_gather_rows, dp_index, dp_size,
                                           dp_sum, replicated_term, tp_index)


def init_moe(cfg, generator: torch.Generator, device=None) -> dict:
    """Draws in order router (D, E) f32, wi, wg (E, D, F) and wo (E, F, D)
    in the model's dtype, at the reference's scales."""
    m = cfg.moe
    dt = dtype_of(cfg)
    D, Fd, E = cfg.d_model, cfg.d_ff, m.num_experts
    return {"router": normal_init((D, E), D ** -0.5, torch.float32,
                                  generator, device),
            "wi": normal_init((E, D, Fd), D ** -0.5, dt, generator, device),
            "wg": normal_init((E, D, Fd), D ** -0.5, dt, generator, device),
            "wo": normal_init((E, Fd, D), Fd ** -0.5, dt, generator,
                              device)}


def moe_logical() -> dict:
    return {"router": ("embed", None), "wi": ("experts", "embed", None),
            "wg": ("experts", "embed", None), "wo": ("experts", None, "embed")}


def dispatch_groups(T: int, num_groups: int) -> int:
    """The reference's group count: gcd(T, num_groups), doubled while a
    group holds more than 2048 tokens and T divides evenly."""
    G = math.gcd(T, max(1, num_groups))
    while T // G > 2048 and T % (2 * G) == 0:
        G *= 2
    return G


def capacity(Sg: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group, a multiple of 4 and at least 4."""
    cap = int(Sg * top_k / num_experts * capacity_factor)
    return max(4, (cap + 3) // 4 * 4)


def moe_ffn(p, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux_loss f32 scalar).

    Under sharding rules ``x`` holds this rank's rows of the global batch,
    and the groups are the global batch's: their count comes from the
    global token count, each rank holds ``G / dp`` whole groups (the
    reference's groups are contiguous runs of rows, split over the
    ``groups -> dp`` axes), and the aux loss returned is this rank's share
    of the global one: the top-1 fractions summed over the ranks, the
    router probabilities this rank's sum over the global count.  Where
    ``G`` does not split over the ranks (fewer groups than ranks), every
    rank gathers the global rows, routes them all and keeps its own rows'
    output, with ``1 / dp`` of the aux loss as its share.

    Under tensor parallelism (``experts -> model``) ``x`` is the whole
    sequence, the same on every model rank, and so are the routing, the
    capacity and the slots; this rank fills and runs only the slots of its
    own ``E / tp`` experts (the weights it holds), and ``y`` is its
    partial sum, which the caller reduce-scatters.  The aux loss, computed
    in full on every model rank, enters the backward once
    (``parallel.sharding.replicated_term``)."""
    B, S, D = x.shape
    dp = dp_size()
    G = dispatch_groups(B * S * dp, cfg.moe.num_groups)
    if G % dp:
        y, aux = _moe(p, cfg, dp_gather_rows(x), G, 1)
        return y.narrow(0, dp_index() * B, B), aux / dp
    return _moe(p, cfg, x, G // dp, dp)


def _moe(p, cfg, x: torch.Tensor, G: int, dp: int):
    """The layer on ``x``'s rows in ``G`` groups; ``dp`` data-parallel
    ranks hold the rest of the global batch's groups."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    El = p["wi"].shape[0]                    # this rank's experts
    e0 = tp_index() * El
    T = B * S
    Sg = T // G
    xg = x.reshape(G, Sg, D)

    probs = torch.softmax(xg.float() @ p["router"], dim=-1)   # (G, Sg, E)
    gate, ids = torch.topk(probs, K, dim=-1)                   # (G, Sg, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(Sg, K, E, m.capacity_factor)

    # slot-major order: j = k * Sg + s within each group; the one-hot is
    # laid out (G, E, K·Sg) so the count runs along the innermost axis (a
    # scan along an outer axis took 4.5 ms a layer at prefill on the H100)
    ids_ks = ids.transpose(1, 2).reshape(G, K * Sg)
    oh = torch.zeros((G, E, K * Sg), dtype=torch.int32, device=x.device)
    oh.scatter_(1, ids_ks.unsqueeze(1), 1)
    before = (oh.cumsum(-1, dtype=torch.int32) - oh).gather(
        1, ids_ks.unsqueeze(1)).squeeze(1)                     # (G, K·Sg)
    keep = before < cap
    g_idx = torch.arange(G, device=x.device).unsqueeze(1)
    n_slots = El * G * cap
    if El < E:                       # only this rank's experts' slots
        ids_ks = ids_ks - e0
        keep = keep & (ids_ks >= 0) & (ids_ks < El)
    row = torch.where(keep, (ids_ks * G + g_idx) * cap + before, n_slots)

    # dispatch: each slot's token (T, a zero row, for an empty slot; the
    # drops and the other ranks' experts all land in one spare slot past
    # the end), then the token rows, rounded to bf16 as the reference's
    # einsum does, gathered into the (El, G·cap, D) slot tensor
    tok = g_idx * Sg + torch.arange(K * Sg, device=x.device) % Sg
    slot_tok = torch.full((n_slots + 1,), T, dtype=torch.int64,
                          device=x.device)
    slot_tok.index_put_((row.reshape(-1),), tok.reshape(-1))
    xb = torch.cat([x.reshape(T, D).to(torch.bfloat16),
                    x.new_zeros((1, D), dtype=torch.bfloat16)])
    xe = xb.index_select(0, slot_tok[:n_slots]).view(El, G * cap, D) \
        .to(p["wi"].dtype)

    h = gmm(xe, p["wi"])
    g = gmm(xe, p["wg"])
    oe = gmm(F.silu(g) * h, p["wo"])                           # (El, G·cap, D)

    # combine: each token's kept rows, weighted by its gates in oe's dtype
    # and summed in f32 (a dropped assignment reads row 0 with weight 0)
    weight = torch.where(keep, gate.transpose(1, 2).reshape(G, K * Sg), 0.0)
    rows = oe.reshape(n_slots, D).index_select(
        0, torch.where(keep, row, 0).reshape(-1)).view(G, K * Sg, D).float()
    rows = rows * weight.to(oe.dtype).float().unsqueeze(-1)  # (G, K·Sg, D)
    y = rows.reshape(G, K, Sg, D).sum(1)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    if dp == 1:
        frac = F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))
        pm = probs.mean(dim=(0, 1))
    else:
        frac = dp_sum(F.one_hot(ids[..., 0], E).float().sum(dim=(0, 1))) \
            / (T * dp)
        pm = probs.sum(dim=(0, 1)) / (T * dp)
    aux = E * (frac * pm).sum() * m.router_aux_weight
    return y.reshape(B, S, D).to(x.dtype), replicated_term(aux)
