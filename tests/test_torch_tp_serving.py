"""Prefill and decode under tensor parallelism over ``model`` on gloo:
the sequence-parallel KV cache (``kv_seq -> model``) and the decode
kernel's log-sum-exp combine across the model ranks.

A wave (``testing.tp_serve_parity``) is a prefill and SERVE_STEPS greedy
decode steps under ``launch.specs.rules_for(cfg, mesh, "prefill" |
"decode")``, held against the single-device wave of the same resolved
config (never ``resolve(tp=1)``): deepseek-67b, qwen1.5-32b (MHA, qkv
bias), qwen2-vl-7b (M-RoPE, the vision stub; and with the int8 cache from
``init_cache``), qwen3-moe-30b-a3b, minicpm3-4b (MLA: the latent caches'
blocks, the latent combine), mamba2-1.3b (the conv tails and SSD states
on a rank's channels and heads) and zamba2-2.7b (those, and the shared
block's cache blocks; its LoRA seeded nonzero) at their f32 smoke
configs, on (1, 2), (2, 2) and (1, 4) data x model meshes, prompts of 14
tokens (an uneven split over 4 model ranks) and 16, a cache of 32 rows.
Logits and the gathered cache within 1e-5 of their largest value (MoE
1e-2: its layer rounds the dispatched tokens to bf16), greedy tokens
equal.  Waves are held against the reference's own GSPMD prefill and
decode on 8 host devices (``tests/_torch_reference_tp_serve.py``):
deepseek-67b on (2, 4), qwen2-vl-7b on (1, 8) with padded heads, and
minicpm3-4b, mamba2-1.3b and zamba2-2.7b on (1, 4), the reference's
params carried across by ``interop.params_from_reference``; logits
within 1e-4, tokens equal.  Then the pieces: ``combine_over_model``
against one softmax over the whole cache, the plain decode's ``lse``
against the reference's scores, each rank's cache block against the
reference's shard shapes, and the refusals.

The ranks run in ``torch.multiprocessing`` spawns, all at once
(``tests/_torch_dist_serve.py``), beside the reference's child process;
the tests read what they wrote.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_serve as DS
from repro_torch.kernels.decode_attention import decode_attention_plain
from test_torch_parallel import reference_layouts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
TOL = 1e-5
MOE_TOL = 1e-2
REF_TOL = 1e-4
#: the int8 cache: the TP path's sums (the row-parallel outputs'
#: all-reduce) differ from one device's in their last bits, and a row
#: whose element lies that close to a half step rounds one step apart;
#: at most this share of the elements may, and a step moves a logit by
#: ~1/127 of one key's weight
INT8_OFF = 1e-3
INT8_LOGIT_TOL = 1e-3


def _start(fn, nprocs, args):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def _reference_inputs(ref_dir) -> list:
    """The reference's params (``init_params(PRNGKey(0))`` of the resolved
    f32 smoke config) and the wave's batch of each REF_SERVE case, saved
    under ``ref_dir/<arch>``; returns the child's requests."""
    import jax
    from repro.configs.base import get_config
    from repro.models import model as JM
    reqs = []
    for arch, c in DS.REF_SERVE.items():
        sizes = dict(zip(c["axes"], c["mesh"]))
        d = os.path.join(ref_dir, arch)
        os.makedirs(d)
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32").resolve(
            tp=sizes["model"], dp=sizes["data"])
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        arrays = {"".join(f"[{getattr(p, 'key', p)!r}]" for p in path):
                  np.asarray(x) for path, x in flat}
        if cfg.family == "hybrid":
            # the LoRA's qb / ib start at zeros: seed them, as
            # testing.seed_lora does, so the wave reads them
            rng = np.random.default_rng(0)
            for k in ("['lora']['qb']", "['lora']['ib']"):
                arrays[k] = (rng.standard_normal(arrays[k].shape)
                             * cfg.hybrid.lora_rank ** -0.5).astype(
                    arrays[k].dtype)
        np.savez(os.path.join(d, "params.npz"), **arrays)
        tcfg = DS.serve_config(arch, sizes["data"], sizes["model"])
        np.savez(os.path.join(d, "batch.npz"), **{
            k: v.numpy() for k, v in DS.serve_batch(tcfg, DS.REF_S).items()})
        reqs.append({"arch": arch, "mesh": c["mesh"], "axes": c["axes"],
                     "cache_len": DS.SERVE_CACHE, "steps": DS.SERVE_STEPS,
                     "dir": d})
    return reqs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn at once, beside the reference's children:
    {"wave": {mesh: out_dir}, "ref": the reference's dir, "against":
    out_dir}."""
    out, ctxs = {"wave": {}}, []
    out["ref"] = tmp_path_factory.mktemp("tpserveref")
    reqs = _reference_inputs(str(out["ref"]))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    # two children at once, the earlier archs' waves and LATENT_SSM_ARCHS',
    # each reading its requests from a file and writing its log to one
    children = []
    for latent in (False, True):
        base = out["ref"] / f"child{int(latent)}"
        base.with_suffix(".json").write_text(json.dumps(
            [r for r in reqs if (r["arch"] in DS.LATENT_SSM_ARCHS) == latent]))
        with open(base.with_suffix(".json")) as fin, \
                open(base.with_suffix(".log"), "w") as flog:
            children.append((subprocess.Popen(
                [sys.executable, os.path.join(
                    ROOT, "tests", "_torch_reference_tp_serve.py")],
                stdin=fin, stdout=flog, stderr=subprocess.STDOUT, env=env,
                cwd=ROOT), base.with_suffix(".log")))
    for mesh, (shape, axes) in MESHES.items():
        d = tmp_path_factory.mktemp(f"tpserve{mesh}")
        n = int(np.prod(shape))
        ctxs.append(_start(DS.tp_serve_cases, n,
                           (n, str(d / "store"), shape, axes, DS.CASES,
                            str(d))))
        out["wave"][mesh] = d
    out["against"] = {}
    for n in (8, 4):
        d = tmp_path_factory.mktemp(f"tpserveagainst{n}")
        archs = [a for a, c in DS.REF_SERVE.items()
                 if int(np.prod(c["mesh"])) == n]
        ctxs.append(_start(DS.tp_against_reference_serve, n,
                           (n, str(d / "store"), str(out["ref"]), str(d),
                            archs)))
        out["against"][n] = d
    for child, log in children:
        assert child.wait(timeout=600) == 0, log.read_text()[-4000:]
    for ctx in ctxs:
        while not ctx.join():
            pass
    return out


def _reports(runs, mesh):
    return [json.loads((runs["wave"][mesh] / f"rank{r}.json").read_text())
            for r in range(int(np.prod(MESHES[mesh][0])))]


@pytest.mark.parametrize("arch,S", DS.CASES,
                         ids=[DS.case_name(a, s) for a, s in DS.CASES])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_wave_matches_single_device(runs, mesh, arch, S):
    """A prefill and eight greedy decode steps on the mesh equal the
    single-device wave of the same resolved config: every rank's logits
    (the whole vocabulary) and the gathered cache within TOL of their
    largest value, the greedy tokens and ``len`` equal.  An int8 cache's
    scales are held to TOL, its rows to one quantisation step on at most
    INT8_OFF of the elements, and its logits to INT8_LOGIT_TOL."""
    tol = MOE_TOL if "moe" in arch else TOL
    int8 = arch.endswith(DS.INT8)
    for rep in _reports(runs, mesh):
        got = rep[DS.case_name(arch, S)]
        assert got["tokens_equal"], got
        assert got["logits"] <= (INT8_LOGIT_TOL if int8 else tol), got
        assert got["cache"] <= tol, got
        # the int8 rows: rounding moves a row's element one step where a
        # last-bit difference of the row puts it across a half step
        assert got["int8_steps"] <= int(int8), got
        assert got["int8_off"] <= (INT8_OFF * np.prod(
            got["cache_shapes"]["k"]) * 2 if int8 else 0), got


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_rank_holds_its_cache_block(runs, mesh):
    """Each rank's cache is its block: its rows of the batch, SERVE_CACHE /
    tp positions, every kv head (and the int8 cache's scales alike; MLA's
    two latent caches alike); a Mamba2 cache its rows, its ``ssm_inner``
    channels of the ``x`` conv tail and its heads of the SSD state, the
    ``B`` / ``C`` tails whole; the decode kernel runs on the kv block
    with all H q heads."""
    (dp, tp), _ = MESHES[mesh]
    for rep in _reports(runs, mesh):
        for arch, S in DS.CASES:
            cfg = DS.serve_config(arch, dp, tp)
            got = rep[DS.case_name(arch, S)]
            want, decode = _cache_block(cfg, DS.SERVE_B // dp, tp)
            assert got["cache_shapes"] == want, (arch, got["cache_shapes"])
            assert got["decode"] == decode, (arch, got["decode"])


def _cache_block(cfg, B: int, tp: int):
    """A rank's cache leaves' shapes (by dotted path) for B rows of the
    batch at ``tp``, and the (q, k) shapes of its decode kernel calls
    with ``lse``: every q head over the rank's block of SERVE_CACHE / tp
    positions of every kv head (none for MLA, which attends in PyTorch
    ops, and for Mamba2)."""
    n = DS.SERVE_CACHE // tp
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": [cfg.num_layers, B, n, m.kv_lora_rank],
                "kpe": [cfg.num_layers, B, n, m.qk_rope_head_dim],
                "len": [B]}, []
    if cfg.ssm is not None:
        s = cfg.ssm
        lead = [cfg.num_layers] if cfg.family == "ssm" else [
            cfg.num_layers // cfg.hybrid.shared_every,
            cfg.hybrid.shared_every]
        di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
        want = {"conv.x": lead + [B, s.d_conv - 1, di // tp],
                "conv.B": lead + [B, s.d_conv - 1, gn],
                "conv.C": lead + [B, s.d_conv - 1, gn],
                "ssm": lead + [B, s.n_heads(cfg.d_model) // tp, s.head_dim,
                               s.d_state],
                "len": [B]}
        if cfg.family == "ssm":
            return want, []
        hb = cfg.hybrid
        rows = [lead[0], B, n, hb.shared_kv_heads, cfg.head_dim]
        want.update(k=rows, v=rows)
        return want, [[[B, 1, hb.shared_num_heads, cfg.head_dim],
                       rows[1:]]]
    rows = [cfg.num_layers, B, n, cfg.padded_kv]
    want = {"k": rows + [cfg.head_dim], "v": rows + [cfg.head_dim],
            "len": [B]}
    if cfg.kv_cache_dtype == "int8":
        want.update(k_scale=rows, v_scale=rows)
    return want, [[[B, 1, cfg.padded_heads, cfg.head_dim],
                   rows[1:] + [cfg.head_dim]]]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_wave_unchanged_under_serving_fsdp(runs, mesh):
    """Under serving rules with FSDP on (``embed -> data``, the
    reference's layout past 64 B parameters) the wave equals the one
    under the smoke config's own rules bit for bit, logits and tokens:
    the port's serving params drop the data axes (by design, ROADMAP
    Queue 3), so the rules' FSDP does not reach the path."""
    for rep in _reports(runs, mesh):
        got = rep["fsdp"]
        assert got["embed"] == [None, "data"], got
        assert got["logits_equal"] and got["tokens_equal"], got


@pytest.fixture(scope="module")
def ref_cache_layouts():
    reqs = [{"arch": a, "smoke": True, "dtype": "float32",
             "mesh": MESHES[m][0], "axes": MESHES[m][1], "fsdp": False,
             "what": "cache"} for m in MESHES
            for a in DS.ARCHS + DS.LATENT_SSM_ARCHS]
    got = reference_layouts(reqs)
    return {(tuple(r["mesh"]), r["arch"]): g for r, g in zip(reqs, got)}


#: each family's leaves that split over ``model`` (the others are whole)
ON_MODEL = {"deepseek-67b": ("['k']", "['v']"),
            "qwen1.5-32b": ("['k']", "['v']"),
            "qwen2-vl-7b": ("['k']", "['v']"),
            "qwen3-moe-30b-a3b": ("['k']", "['v']"),
            "minicpm3-4b": ("['ckv']", "['kpe']"),
            "mamba2-1.3b": ("['conv']['x']", "['ssm']"),
            "zamba2-2.7b": ("['conv']['x']", "['ssm']", "['k']", "['v']")}


@pytest.mark.parametrize("arch", DS.ARCHS + DS.LATENT_SSM_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_block_matches_reference_layout(runs, ref_cache_layouts,
                                              mesh, arch):
    """``launch.specs.cache_shardings`` at the reference helper's decode
    cache (B 8 x S 64): every leaf takes the reference's ``build_cell``
    spec and shard shape (k and v, MLA's latent caches, the Mamba2 ``x``
    conv tail and SSD state split over ``model``, the ``B`` / ``C`` tails
    whole), and ``init_cache`` under the decode rules allocates exactly
    that block on every rank; ``len`` splits like the rows (a rank holds
    its rows' lengths, the reference replicates them)."""
    want = ref_cache_layouts[(MESHES[mesh][0], arch)]
    for rep in _reports(runs, mesh):
        got = rep["layouts"][arch]
        assert set(got) == set(want)
        for leaf, w in want.items():
            g = got[leaf]
            assert g["shape"] == g["local"], (leaf, g)
            if leaf == "['len']":
                assert g["spec"] == [_batch_spec(got)], g
                continue
            assert {"spec": g["spec"], "shape": g["shape"]} == w, (leaf, g)
            assert ("model" in json.dumps(g["spec"])) == (
                leaf in ON_MODEL[arch]), (leaf, g)


def _batch_spec(layout: dict):
    """The spec entry of the cache rows' batch dim (the ``ssm`` state's
    or the kv cache's)."""
    leaf = next(k for k in ("['k']", "['ckv']", "['ssm']") if k in layout)
    dim = 2 if leaf == "['ssm']" and len(layout[leaf]["spec"]) == 6 else 1
    return layout[leaf]["spec"][dim]


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_combine_over_model_matches_whole_cache(runs, mesh):
    """Each rank's attention over its block of a cache and its
    log-sum-exp, merged by ``combine_over_model``, equal one softmax over
    the whole cache; a row of 3 valid positions leaves every block past
    the first empty (``lse = -inf``, weight 0)."""
    for r, rep in enumerate(_reports(runs, mesh)):
        p = rep["pieces"]
        assert p["combine"] <= 1e-6, p
        assert p["empty block lse"][0] == (r > 0), p


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_tp_serving_refuses_what_it_lacks(runs, mesh):
    """Under a model axis above 1, ``encdec`` (whose tensor parallelism
    ``tests/test_torch_tp_encdec.py`` holds) raises ValueError naming
    both sizes where its encoder frames, the cross cache's rows, do not
    split over the model ranks (prefill and ``cache_shardings``) or its
    cache length does not (``init_cache``); a Zamba2 shared block whose
    heads do not split over the model ranks ValueError naming them; a
    cache length that does not split over the model ranks raises
    ValueError naming both sizes (the reference would replicate the
    cache)."""
    tp = MESHES[mesh][0][1]
    for rep in _reports(runs, mesh):
        p = rep["pieces"]
        assert set(p["refused"]) == set(DS.REFUSED)
        for arch, msgs in p["refused"].items():
            assert [m.split(":")[0] for m in msgs] == [
                "prefill", "init_cache", "cache_shardings"], msgs
            for m, rows in zip(msgs, (2 * tp + 1, 8 * tp + 1, 2 * tp + 1)):
                assert f"{rows} rows does not split over {tp} model" in m, \
                    (arch, m)
        for m in p["uneven cache"]:
            assert f"{8 * tp + 1} rows" in m and str(tp) in m, m
        assert [m.split(":")[0] for m in p["shared heads"]] == [
            "prefill", "decode", "init_cache"], p["shared heads"]
        for m in p["shared heads"]:
            assert f"shared block's 3 heads do not split over {tp}" in m, m


@pytest.mark.parametrize("arch", list(DS.REF_SERVE))
def test_tp_wave_matches_reference_gspmd(runs, arch):
    """The port's wave on the mesh, from the reference's params, against
    the reference's own GSPMD prefill and decode steps on the same mesh
    (jitted under its prefill and decode rules with ``build_cell``'s
    shardings): every rank's logits within REF_TOL of the largest real
    logit and its greedy tokens equal."""
    c = DS.REF_SERVE[arch]
    with np.load(runs["ref"] / arch / "wave.npz") as f:
        want, want_tok = f["logits"], f["tokens"]
    V = DS.serve_config(arch, 1, 1).vocab_size
    assert want.shape[0] == DS.SERVE_STEPS + 1
    for r in range(int(np.prod(c["mesh"]))):
        with np.load(runs["against"][int(np.prod(c["mesh"]))]
                     / f"{arch}-rank{r}.npz") as f:
            got, tok, r0 = f["logits"], f["tokens"], int(f["row0"])
        n = got.shape[1]
        w = want[:, r0:r0 + n, :V]
        assert np.array_equal(tok, want_tok[r0:r0 + n]), (r, tok, want_tok)
        drift = float(np.abs(got[..., :V] - w).max() / np.abs(w).max())
        assert drift <= REF_TOL, (r, drift)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plain_lse_matches_reference_scores(dtype):
    """``decode_attention_plain(..., return_lse=True)``: ``out`` is the
    call without the flag bit for bit, and ``lse`` the log-sum-exp of
    ``repro.kernels.ref``'s masked scores over the valid positions (-inf
    where ``kv_len == 0``)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ref import NEG_INF
    g = torch.Generator().manual_seed(3)
    B, S, H, KV, D = 5, 40, 8, 2, 16
    q = torch.randn((B, 1, H, D), generator=g).to(dtype)
    k = torch.randn((B, S, KV, D), generator=g).to(dtype)
    v = torch.randn((B, S, KV, D), generator=g).to(dtype)
    kv_len = torch.tensor([0, 1, 17, 39, 40], dtype=torch.int32)
    out, lse = decode_attention_plain(q, k, v, kv_len, return_lse=True)
    assert torch.equal(out, decode_attention_plain(q, k, v, kv_len))
    qj, kj = (jnp.asarray(t.float().numpy()) for t in (q, k))
    s = jnp.einsum("bkgd,bskd->bkgs", qj.reshape(B, KV, H // KV, D),
                   kj) * (D ** -0.5)
    mask = jnp.arange(S)[None, :] < jnp.asarray(kv_len.numpy())[:, None]
    s = jnp.where(mask[:, None, None, :], s, NEG_INF)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H)
    assert torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    np.testing.assert_allclose(lse[1:].numpy(), want[1:], rtol=1e-6,
                               atol=1e-5)
