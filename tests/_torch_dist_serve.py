"""Rank functions of the tensor-parallel serving tests (gloo on the CPU).

``torch.multiprocessing`` pickles its function by reference, so they live
in this importable module; each rank joins as ``tests/_torch_dist.py``'s
do, runs its waves and writes what the test reads into ``out_dir``.
Nothing here imports jax: the reference's params and its GSPMD waves come
from files the test and ``tests/_torch_reference_tp_serve.py`` write.
"""
import dataclasses
import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist import _join
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_reference
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import (batch_logical, cache_shardings,
                                      rules_for, serve_param_shardings,
                                      tree_arg_shardings)
from repro_torch.models import model as M
from repro_torch.parallel.sharding import (_axes, axis_index, axis_rules,
                                           combine_over_model, place)
from repro_torch.testing import seed_lora, serve_wave, tp_serve_parity
from repro_torch.tree import keystr, leaves_with_path, unflatten

#: a wave: SERVE_B prompts of each length in SERVE_S (14 splits unevenly
#: over 4 model ranks) into a cache of SERVE_CACHE rows, then SERVE_STEPS
#: greedy steps, so the new rows cross a kv_seq block at every mesh
SERVE_B, SERVE_CACHE, SERVE_STEPS = 4, 32, 8
SERVE_S = (14, 16)
ARCHS = ("deepseek-67b", "qwen1.5-32b", "qwen2-vl-7b", "qwen3-moe-30b-a3b")
#: MLA (its latent caches) and the Mamba2 families (conv tails and SSD
#: states on the rank's channels and heads; Zamba2's shared k / v), Zamba2
#: with its LoRA seeded nonzero
LATENT_SSM_ARCHS = ("minicpm3-4b", "mamba2-1.3b", "zamba2-2.7b")
#: an arch name with this suffix keeps an int8 cache and decodes from
#: ``init_cache``, fed the prompt a token a step (the reference's only
#: start for it)
INT8 = "+int8"
CASES = [(a, s) for a in ARCHS for s in SERVE_S] \
    + [(a, SERVE_S[0]) for a in LATENT_SSM_ARCHS] \
    + [("qwen2-vl-7b" + INT8, 14)]
#: the waves held against the reference's own GSPMD prefill and decode
REF_SERVE = {"deepseek-67b": dict(mesh=(2, 4), axes=("data", "model")),
             "qwen2-vl-7b": dict(mesh=(1, 8), axes=("data", "model")),
             **{a: dict(mesh=(1, 4), axes=("data", "model"))
                for a in LATENT_SSM_ARCHS}}
REF_S = 14
#: the prompt length of the wave under the serving FSDP rules
FSDP_S = 14
#: the family whose cross cache's rows (the encoder's frames) must split
#: over the model ranks too, and the frames and cache rows its refusals
#: take (2 tp + 1 and 8 tp + 1: neither splits)
REFUSED = ("seamless-m4t-medium",)
#: the reference helper's decode cache (``_torch_reference_sharding.py``)
LAYOUT_B, LAYOUT_S = 8, 64


def case_name(arch: str, S: int) -> str:
    return f"{arch}-S{S}"


def serve_config(arch: str, dp: int, tp: int):
    """The f32 smoke config of a wave, resolved for ``tp`` and ``dp``."""
    cfg = dataclasses.replace(get_config(arch.removesuffix(INT8),
                                         smoke=True), dtype="float32")
    if arch.endswith(INT8):
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg.resolve(tp=tp, dp=dp)


def serve_batch(cfg, S: int, seed: int = 0) -> dict:
    """SERVE_B prompts of ``S`` tokens; for ``vlm`` the vision stub's
    embeddings and M-RoPE positions (the vision tokens on a 2 x n/2 grid
    at time 0, the text after them)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (SERVE_B, S)), dtype=torch.int32)}
    if cfg.family == "vlm":
        n = cfg.num_frontend_tokens
        batch["vision_embeds"] = torch.as_tensor(
            0.02 * rng.standard_normal((SERVE_B, n, cfg.d_model)),
            dtype=torch.float32)
        pos = np.repeat(np.arange(S)[:, None], 3, axis=1)
        pos[:n] = np.stack([np.zeros(n), np.arange(n) // 2,
                            np.arange(n) % 2], axis=1)
        pos[n:] = np.arange(n, S)[:, None] - n + 2
        batch["positions"] = torch.as_tensor(
            np.broadcast_to(pos, (SERVE_B, S, 3)).copy(), dtype=torch.int32)
    return batch


def _mesh(shape, axes):
    return make_mesh(shape, axes, "cpu"), math.prod(
        n for a, n in zip(axes, shape) if a != "model"), \
        dict(zip(axes, shape)).get("model", 1)


def _recording_decode():
    """Wrap the models' decode kernel to record the (q, k) shapes of its
    calls on the sequence-parallel cache: under rules that split
    ``kv_seq`` (the single-device wave's calls, with ``return_lse`` too
    where a family's decode takes ``decode_block``'s path, are not)."""
    from repro_torch.models import attention as A
    from repro_torch.parallel.sharding import kv_split
    seen, decode = set(), A.decode_attention

    def rec(q, k, v, kv_len, **kw):
        if kv_split():
            seen.add((tuple(q.shape), tuple(k.shape)))
        return decode(q, k, v, kv_len, **kw)

    A.decode_attention = rec
    return seen


def tp_serve_cases(rank, world, store, shape, axes, cases, out_dir):
    """Each case's wave on the mesh against the single-device wave
    (``testing.tp_serve_parity``), the decode kernel's shapes on this
    rank, the cache layouts at LAYOUT_B x LAYOUT_S for every arch, and
    on a (1, tp) mesh the pieces (:func:`_pieces`); writes
    ``rank<r>.json``."""
    _join(rank, world, store)
    mesh, dp, tp = _mesh(shape, axes)
    seen = _recording_decode()
    report = {}
    for arch, S in cases:
        cfg = serve_config(arch, dp, tp)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if cfg.family == "hybrid":
            seed_lora(params, cfg)
        seen.clear()
        rep = tp_serve_parity(cfg, mesh, params, serve_batch(cfg, S),
                              SERVE_CACHE, SERVE_STEPS,
                              from_init=arch.endswith(INT8))
        rep["decode"] = sorted([list(q), list(k)] for q, k in seen)
        report[case_name(arch, S)] = rep
    layouts = {}
    for arch in ARCHS + LATENT_SSM_ARCHS:
        cfg = serve_config(arch, dp, tp)
        rules = rules_for(cfg, mesh, "decode")
        sh = cache_shardings(cfg, rules, LAYOUT_B, LAYOUT_S)
        with axis_rules(rules):
            local = M.init_cache(cfg, LAYOUT_B, LAYOUT_S, device="meta")
        whole = M.init_cache(cfg, LAYOUT_B, LAYOUT_S, device="meta")
        layouts[arch] = {}
        for (path, w), (_, s), (_, x) in zip(leaves_with_path(whole),
                                             leaves_with_path(sh),
                                             leaves_with_path(local)):
            layouts[arch][keystr(path)] = {
                "spec": [list(e) if isinstance(e, tuple) else e
                         for e in s.spec],
                "shape": list(s.shard_shape(w.shape)),
                "local": list(x.shape)}
    report["layouts"] = layouts
    report["fsdp"] = _fsdp_rules(mesh, dp, tp)
    if math.prod(shape[:-1]) == 1:
        report["pieces"] = _pieces(mesh, tp)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def _fsdp_rules(mesh, dp: int, tp: int) -> dict:
    """deepseek-67b's wave (FSDP_S) under the serving rules with FSDP on
    (``embed -> data``, which ``launch.specs.use_fsdp`` gives past 64 B
    parameters and no smoke config reaches) against its wave under the
    rules ``rules_for`` gives the smoke config: the rules' ``embed``
    entry of each, and whether the logits and tokens are equal bit for
    bit (``serve_param_shardings`` drops the data axes, so FSDP leaves
    the path as it is)."""
    from repro_torch.launch import specs as SP
    cfg = serve_config("deepseek-67b", dp, tp)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = serve_batch(cfg, FSDP_S)

    def wave():
        rules = rules_for(cfg, mesh, "prefill")
        b_sh = tree_arg_shardings(batch, batch_logical(cfg, "prefill"),
                                  rules)
        return rules.physical("embed"), serve_wave(
            place(params, serve_param_shardings(cfg, rules)), cfg,
            place(batch, b_sh), SERVE_CACHE, SERVE_STEPS, mesh=mesh,
            rows=SERVE_B)

    embed, base = wave()
    use_fsdp = SP.use_fsdp
    SP.use_fsdp = lambda cfg, kind: True
    try:
        embed_fsdp, got = wave()
    finally:
        SP.use_fsdp = use_fsdp
    return {"embed": [embed, embed_fsdp],
            "logits_equal": all(torch.equal(a, b) for a, b in zip(
                got["logits"], base["logits"])),
            "tokens_equal": torch.equal(got["tokens"], base["tokens"])}


def _pieces(mesh, tp: int) -> dict:
    """On a (1, tp) mesh: ``combine_over_model`` of each rank's block of a
    cache against one softmax over the whole cache (a row whose length
    leaves every block past the first empty); the refusal of an
    ``encdec`` model's encoder frames (its cross cache's rows) and cache
    length that do not split over the model axis, and of a Zamba2 shared
    block whose 3 heads do not split over it; a cache length that does
    not split over it."""
    from repro_torch.kernels.decode_attention import decode_attention
    out = {}
    g = torch.Generator().manual_seed(5)
    B, S, H, KV, D = 4, 8 * tp, 4, 2, 16
    q = torch.randn((B, 1, H, D), generator=g)
    k = torch.randn((B, S, KV, D), generator=g)
    v = torch.randn((B, S, KV, D), generator=g)
    kv_len = torch.tensor([3, 8, S // 2 + 1, S], dtype=torch.int32)
    want = decode_attention(q, k, v, kv_len)
    rules = rules_for(get_config("deepseek-67b", smoke=True), mesh,
                      "decode")
    r, n = axis_index(mesh, ("model",)), S // tp
    with axis_rules(rules):
        mine = (kv_len - r * n).clamp(0, n).to(torch.int32)
        o, lse = decode_attention(q, k[:, r * n:(r + 1) * n],
                                  v[:, r * n:(r + 1) * n], mine,
                                  return_lse=True)
        got = combine_over_model(o, lse)
    out["combine"] = float((got - want).abs().max() / want.abs().max())
    out["empty block lse"] = [bool(x) for x in torch.isinf(lse[:, 0])]
    refused = {}
    for arch in REFUSED:
        cfg = serve_config(arch, 1, tp)
        enc = place(M.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu"), serve_param_shardings(
            cfg, rules_for(cfg, mesh, "prefill")))
        frames = {**serve_batch(cfg, 14), "enc_frames": torch.ones(
            (SERVE_B, 2 * tp + 1, cfg.d_model))}
        got = []
        for kind, call in (
                ("prefill", lambda: M.prefill(enc, cfg, frames, 32)),
                ("init_cache", lambda: M.init_cache(cfg, 2, 8 * tp + 1,
                                                    device="cpu")),
                ("cache_shardings", lambda: cache_shardings(
                    cfg, rules_for(cfg, mesh, "decode"), 2, 32,
                    enc_len=2 * tp + 1))):
            with axis_rules(rules_for(cfg, mesh, kind.replace(
                    "init_cache", "decode"))):
                try:
                    call()
                    got.append(f"{kind}: no error")
                except ValueError as e:
                    got.append(f"{kind}: {e}")
        refused[arch] = got
    out["refused"] = refused
    cfg = get_config("zamba2-2.7b", smoke=True)
    cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
        cfg.hybrid, shared_num_heads=3, shared_kv_heads=3)).resolve(tp=tp)
    heads = []
    for kind, call in (
            ("prefill", lambda: M.prefill(None, cfg, {}, 32)),
            ("decode", lambda: M.decode_step(None, cfg, None, None)),
            ("init_cache", lambda: M.init_cache(cfg, 2, 32, device="cpu"))):
        with axis_rules(rules_for(cfg, mesh, kind.replace("init_cache",
                                                          "decode"))):
            try:
                call()
                heads.append(f"{kind}: no error")
            except ValueError as e:
                heads.append(f"{kind}: {e}")
    out["shared heads"] = heads
    cfg = serve_config("deepseek-67b", 1, tp)
    params = place(M.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"), serve_param_shardings(
        cfg, rules_for(cfg, mesh, "prefill")))
    uneven = []
    for kind, call in (
            ("init_cache", lambda: M.init_cache(cfg, 2, 8 * tp + 1,
                                                device="cpu")),
            ("prefill", lambda: M.prefill(params, cfg, serve_batch(cfg, 14),
                                          8 * tp + 1)),
            ("cache_shardings", lambda: cache_shardings(
                cfg, rules_for(cfg, mesh, "decode"), 2, 8 * tp + 1))):
        with axis_rules(rules_for(cfg, mesh, "prefill")):
            try:
                call()
                uneven.append(f"{kind}: no error")
            except ValueError as e:
                uneven.append(f"{kind}: {e}")
    out["uneven cache"] = uneven
    return out


# ----------------------------------------------------------------------
# against the reference's GSPMD prefill and decode
def reference_template(arch: str, table=None):
    """The port's params tree of a case of ``table`` (REF_SERVE by
    default) on the meta device: the key paths the reference's params
    were saved under."""
    c = (table or REF_SERVE)[arch]
    sizes = dict(zip(c["axes"], c["mesh"]))
    cfg = serve_config(arch, sizes["data"], sizes["model"])
    return cfg, M.init_params(cfg, torch.Generator(), "meta")


def tp_against_reference_serve(rank, world, store, ref_dir, out_dir,
                               archs=None, table=None):
    """Each wave of ``archs`` in ``table`` (REF_SERVE by default; their
    meshes hold ``world`` ranks; all of them by default) with the
    reference's params
    (``ref_dir/<arch>/params.npz``, carried across by
    ``interop.params_from_reference``) on the port's tensor-parallel path
    over the case's mesh; every rank writes its logits a step, its greedy
    tokens and its first row of the batch (``<arch>-rank<r>.npz``)."""
    _join(rank, world, store)
    table = table or REF_SERVE
    for arch in archs or table:
        c = table[arch]
        mesh = make_mesh(tuple(c["mesh"]), tuple(c["axes"]), "cpu")
        cfg, template = reference_template(arch, table)
        with np.load(os.path.join(ref_dir, arch, "params.npz")) as f:
            tree = unflatten(template, [f[keystr(p)]
                                        for p, _ in leaves_with_path(
                                            template)])
        params = params_from_reference(tree, "cpu")
        with np.load(os.path.join(ref_dir, arch, "batch.npz")) as f:
            batch = {k: torch.from_numpy(f[k].copy()) for k in f.files}
        rules = rules_for(cfg, mesh, "prefill")
        b_sh = tree_arg_shardings(batch, batch_logical(cfg, "prefill"),
                                  rules)
        wave = serve_wave(place(params, serve_param_shardings(cfg, rules)),
                          cfg, place(batch, b_sh), SERVE_CACHE, SERVE_STEPS,
                          mesh=mesh, rows=SERVE_B)
        dp_axes = _axes(b_sh["tokens"].spec[0])
        n = wave["tokens"].shape[0]
        np.savez(os.path.join(out_dir, f"{arch}-rank{rank}.npz"),
                 logits=torch.stack(wave["logits"]).numpy(),
                 tokens=wave["tokens"].numpy(),
                 row0=np.int64(axis_index(mesh, dp_axes) * n
                               if dp_axes else 0))
    dist.destroy_process_group()
