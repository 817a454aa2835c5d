"""Rank functions of the encoder-decoder tensor-parallel tests (gloo on the
CPU), ``tests/test_torch_tp_encdec.py``.

``torch.multiprocessing`` pickles its function by reference, so they live
in this importable module; each rank joins as ``tests/_torch_dist.py``'s
do, runs its cases and writes what the test reads into ``out_dir``.
Nothing here imports jax.  The reference's GSPMD step and wave are
REF_STEPS and REF_SERVE, run by ``tests/_torch_reference_tp_steps.py``
and ``tests/_torch_reference_tp_serve.py`` and held to the port's by
``_torch_dist.tp_against_reference`` and ``_torch_dist_serve.
tp_against_reference_serve``.
"""
import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist

import _torch_dist as D
import _torch_dist_serve as DS
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import rules_for, serve_param_shardings
from repro_torch.models import attention as A
from repro_torch.models import encdec
from repro_torch.models import model as M
from repro_torch.parallel.sharding import (axis_index, axis_rules,
                                           make_rules, place, scatter_seq,
                                           take_seq_block)
from repro_torch.testing import sharded_step_parity, tp_serve_parity
from repro_torch.training.train_step import state_shardings

ARCH = "seamless-m4t-medium"
#: the step cases (``_torch_dist._tp_cases``): ZeRO-1 and FSDP, one
#: microbatch, two steps of STEP_S tokens and STEP_ENC frames a row
STEP_CASES = [(ARCH, fsdp, 1, 2, D.STEP_S) for fsdp in (False, True)]
#: a wave's encoder frames (not a prompt's length: a swapped sequence
#: shows), its prompts (14 splits unevenly over 4 model ranks) and the
#: serving constants of ``tests/_torch_dist_serve.py``
SERVE_ENC = 8
SERVE_S = (14, 16)
#: the cases held against the reference's GSPMD step and wave; the
#: reference's scanned encoder refuses frames of another dtype than its
#: carry, so it runs unscanned (its f32 frames would scan, but the
#: unscanned path is the one its serving tests hold)
REF_MESH = (1, 4)
REF_CONFIG = {"scan_layers": False}
REF_STEPS = {f"{ARCH}-zero1-mb1": dict(
    arch=ARCH, mesh=REF_MESH, axes=("data", "model"), fsdp=False,
    microbatches=1, steps=2, S=D.STEP_S, config=REF_CONFIG)}
REF_SERVE = {ARCH: dict(mesh=REF_MESH, axes=("data", "model"))}


def case_name(S: int) -> str:
    return DS.case_name(ARCH, S)


def serve_batch(cfg, S: int, seed: int = 0) -> dict:
    """SERVE_B prompts of ``S`` tokens and SERVE_ENC normal f32 encoder
    frames (the engine's are zeros, which make the cross-attention
    vacuous)."""
    rng = np.random.default_rng(seed + 1)
    return {**DS.serve_batch(cfg, S, seed), "enc_frames": torch.as_tensor(
        rng.standard_normal((DS.SERVE_B, SERVE_ENC, cfg.d_model)),
        dtype=torch.float32)}


def tp_encdec_cases(rank, world, store, shape, axes, out_dir):
    """On a data x model mesh of ``shape``: the step cases
    (``_torch_dist._tp_cases``: the gradients and two steps against the
    single-device step, the flash kernel's shapes) and, for ZeRO-1, two
    steps on the single-device step's gradients
    (``testing.sharded_step_parity``); a wave of each prompt length in
    SERVE_S (``testing.tp_serve_parity``) with the decode kernel's
    shapes on the sequence-parallel cache; and on a (1, tp) mesh the
    pieces (:func:`_pieces`).  Writes ``rank<r>.json``."""
    D._join(rank, world, store)
    mesh = make_mesh(shape, axes, "cpu")
    dp, tp = math.prod(shape[:-1]), shape[-1]
    report = D._tp_cases(rank, mesh, STEP_CASES, out_dir)
    cfg = D.step_config(ARCH, dp, tp)
    tcfg = TrainConfig(microbatches=1, **D.STEP_TRAIN)
    rules = make_rules(mesh, mode="train", fsdp=False, zero1=True,
                       dp_axes=tuple(a for a in axes if a != "model"))
    report[f"{ARCH}-zero1-mb1"]["parity"] = sharded_step_parity(
        cfg, tcfg, rules, D.train_state(cfg, tcfg), D.step_batch(cfg))
    seen = DS._recording_decode()
    for S in SERVE_S:
        cfg = DS.serve_config(ARCH, dp, tp)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        seen.clear()
        rep = tp_serve_parity(cfg, mesh, params, serve_batch(cfg, S),
                              DS.SERVE_CACHE, DS.SERVE_STEPS)
        rep["decode"] = sorted([list(q), list(k)] for q, k in seen)
        report[case_name(S)] = rep
    if dp == 1:
        report["pieces"] = _pieces(mesh, tp)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _local_params(cfg, params, mesh, kind="prefill"):
    """This rank's serving blocks of ``params``."""
    return place(params, serve_param_shardings(cfg, rules_for(cfg, mesh,
                                                              kind)))


def _pieces(mesh, tp: int) -> dict:
    """On a (1, tp) mesh, each against its unsplit form (the largest
    difference over the unsplit value's largest): ``take_seq_block`` of
    whole frames (an uneven 3 tp - 1 positions, each block holding some)
    and its gradient, beside ``scatter_seq`` of the same frames (which
    sums tp copies); the cross
    cache's block rows from ``attention_fwd(x_kv=, kv_rows=)`` on the
    rank's heads, against the encoder's k / v rows; the read-only block
    decode of the cross-attention, summed over the ranks, against the
    whole cache, and the block left as it was; the encoder alone on an
    uneven 2 tp + 1 frames under prefill rules; and the refusals of
    encoder frames that do not split over the ranks (train, prefill)."""
    out = {}
    r = axis_index(mesh, ("model",))
    pre, dec = (rules_for(DS.serve_config(ARCH, 1, tp), mesh, k)
                for k in ("prefill", "decode"))
    g = torch.Generator().manual_seed(11)
    Se = 3 * tp - 1
    x = torch.randn((2, Se, 8), generator=g)
    blk = -(-Se // tp)
    want = torch.cat([x, x.new_zeros((2, blk * tp - Se, 8))], 1)[
        :, r * blk:(r + 1) * blk]
    cot = torch.randn((tp, 2, blk, 8), generator=g)
    xg = x.clone().requires_grad_()
    with axis_rules(pre):
        got = take_seq_block(xg)
        got.backward(cot[r])
        summed = scatter_seq(x.clone())
    out["take block"] = _rel(got, want)
    out["take block grad"] = _rel(xg.grad, cot.movedim(0, 1).reshape(
        2, blk * tp, 8)[:, :Se])
    out["scatter_seq on whole frames"] = [_rel(summed, want)]

    cfg = DS.serve_config(ARCH, 1, tp)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mine = _local_params(cfg, params, mesh)
    cross = {k: v[0] for k, v in params["dec_layers"]["cross"].items()}
    cross_mine = {k: v[0] for k, v in mine["dec_layers"]["cross"].items()}
    # more decoder positions than encoder rows, so keys taken from the
    # wrong sequence read rows that exist (and differ)
    S, Se = 5 * tp, 4 * tp
    h = torch.randn((2, S, cfg.d_model), generator=g)
    enc = torch.randn((2, Se, cfg.d_model), generator=g)
    n = Se // tp
    k_all, v_all = A._project_kv(cross, cfg, enc)
    with axis_rules(pre):
        _, (k, v) = A.attention_fwd(cross_mine, cfg, h, None, causal=False,
                                    x_kv=enc, use_rope=False,
                                    kv_rows=(r * n, (r + 1) * n))
    out["cross rows k"] = _rel(k, k_all[:, r * n:(r + 1) * n])
    out["cross rows v"] = _rel(v, v_all[:, r * n:(r + 1) * n])

    xd = torch.randn((2, 1, cfg.d_model), generator=g)
    ck = torch.randn((2, Se, cfg.padded_kv, cfg.head_dim), generator=g)
    cv = torch.randn((2, Se, cfg.padded_kv, cfg.head_dim), generator=g)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    last = torch.full((2,), Se - 1, dtype=torch.int32)
    whole = A.attention_decode(cross, cfg, xd, pos, ck, cv, last,
                               update_cache=False, use_rope=False)[0]
    ckb, cvb = (t[:, r * n:(r + 1) * n].clone() for t in (ck, cv))
    before = (ckb.clone(), cvb.clone())
    with axis_rules(dec):
        part = A.attention_decode(cross_mine, cfg, xd, pos, ckb, cvb, last,
                                  update_cache=False, use_rope=False)[0]
    dist.all_reduce(part)
    out["read-only decode"] = _rel(part, whole)
    out["read-only block kept"] = [bool(torch.equal(ckb, before[0])
                                        and torch.equal(cvb, before[1]))]

    frames = torch.randn((2, 2 * tp + 1, cfg.d_model), generator=g)
    with axis_rules(pre):
        got = encdec.encode(mine, cfg, frames)
    out["uneven encoder"] = _rel(got, encdec.encode(params, cfg, frames))

    refused = []
    scfg = D.step_config(ARCH, 1, tp)
    train = make_rules(mesh, mode="train", fsdp=False)
    sp = place(M.init_params(scfg, torch.Generator().manual_seed(0), "cpu"),
               state_shardings(scfg, train)["params"])
    batch = {**D.step_batch(scfg), "enc_frames": frames[:1].expand(
        D.STEP_B, -1, -1)}
    with axis_rules(train):
        try:
            M.train_forward(sp, scfg, batch)
            refused.append("train: no error")
        except ValueError as e:
            refused.append(f"train: {e}")
    sb = {**serve_batch(cfg, 14), "enc_frames": frames[:1].expand(
        DS.SERVE_B, -1, -1)}
    with axis_rules(pre):
        try:
            M.prefill(mine, cfg, sb, DS.SERVE_CACHE)
            refused.append("prefill: no error")
        except ValueError as e:
            refused.append(f"prefill: {e}")
    out["refused"] = refused
    return out
