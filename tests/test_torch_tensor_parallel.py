"""Tensor parallelism over the ``model`` axis on gloo, against the
single-device step of the same resolved config and the reference's
layouts: the decoder-only families (deepseek-67b, qwen1.5-32b with MHA
and its qkv bias, qwen2-vl-7b with its loss mask, qwen3-moe-30b-a3b with
one dispatch group and with one a data-parallel rank) on (1, 2), (2, 2)
and (1, 4) data x model meshes and a (1, 2, 2) pod x data x model mesh,
ZeRO-1 and FSDP, one and two microbatches; MLA and the Mamba2 families
(minicpm3-4b, mamba2-1.3b, zamba2-2.7b with its LoRA seeded nonzero) on
(1, 2), (2, 2) and (1, 4), ZeRO-1 and FSDP; the reference's own
multi-device case (deepseek-67b resolved for tp 4, dp 2 on (2, 4), FSDP,
two microbatches, four steps); the step against the reference's own
GSPMD step on the same meshes (that case, qwen2-vl-7b at tp 8, whose
padded heads regroup the kv heads, and each of the three at (1, 4); the
reference runs in a child process with 8 host devices,
``tests/_torch_reference_tp_steps.py``); and the model-axis pieces one by
one (``tests/_torch_dist.py::tp_pieces``: the gated norm's sum over the
split ``d_inner``, Mamba2 on a rank's heads, MLA's latent combine; the
MoE aux loss alone on (1, 2) and (1, 4)).

The ranks run in ``torch.multiprocessing`` spawns, all at once
(``tests/_torch_dist.py``; a ``file://`` store under ``tmp_path``, one
thread a rank); the tests read what the ranks wrote.

Tolerances are ``tests/test_torch_distributed.py``'s: metrics, m and v
within 1e-5 of each leaf's largest value, master and params the same on
the elements whose gradient stayed above 1e-3 of the leaf's largest at
every step; the MoE arch 1e-2 (its layer rounds the dispatched tokens
and their cotangent to bf16, so last-bit differences upstream flip a
bf16 ulp here and there).  Each TP step is held against the
single-device step of the config resolved for that mesh (padding the
heads to a multiple of the model axis changes the GQA grouping), never
against ``resolve(tp=1)``.
"""
import json

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.models.attention import local_kv_heads
from repro_torch.parallel.sharding import AbstractMesh, make_rules
from repro_torch.training.train_step import make_train_step
from test_torch_parallel import reference_layouts

MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
ARCHS = ("deepseek-67b", "qwen1.5-32b", "qwen2-vl-7b", "qwen3-moe-30b-a3b")
STEP_ARCHS = ARCHS + ("qwen3-moe-30b-a3b" + _torch_dist.GROUPS,)
CASES = [(a, f, n, 2, _torch_dist.STEP_S) for a in STEP_ARCHS
         for f in (False, True) for n in (1, 2)]
#: MLA and the Mamba2 families, one microbatch, on LATENT_MESHES: two
#: steps, and two on the single-device step's gradients
#: (``testing.sharded_step_parity``)
LATENT_ARCHS = _torch_dist.LATENT_SSM_ARCHS
LATENT_MESHES = ("1x2", "2x2", "1x4")
LATENT_CASES = [(a, f, 1, 2, _torch_dist.STEP_S) for a in LATENT_ARCHS
                for f in (False, True)]
#: the reference's own case: (2, 4), deepseek-67b, FSDP, 2 microbatches
REF_MESH = ((2, 4), ("data", "model"))
REF_CASE = "deepseek-67b-fsdp-mb2"
REF_STEPS = _torch_dist.REF_STEPS
TOL = 1e-5
MOE_TOL = 1e-2
#: MLA and the Mamba2 families against the reference's GSPMD step
REF_TOL = 1e-4


def _name(arch, fsdp, nmb):
    return f"{arch}-{'fsdp' if fsdp else 'zero1'}-mb{nmb}"


def _start(fn, nprocs, args):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run every spawn at once, and the reference's steps beside them:
    {"step": {mesh: out_dir}, "ref": out_dir, "pieces": out_dir,
    "refsteps": the reference's dir, "against": out_dir}."""
    out, ctxs = {"step": {}}, []
    out["refsteps"] = tmp_path_factory.mktemp("tprefsteps")
    # two children at once: the eight-device cases, and the four-device
    # ones of LATENT_ARCHS
    by_ranks = {n: [k for k, c in REF_STEPS.items()
                    if int(np.prod(c["mesh"])) == n] for n in (8, 4)}
    children = {n: _torch_dist.start_reference_steps(str(out["refsteps"]),
                                                     names)
                for n, names in by_ranks.items()}
    for mesh, (shape, axes) in MESHES.items():
        d = tmp_path_factory.mktemp(f"tp{mesh}")
        n = int(np.prod(shape))
        cases = CASES + (LATENT_CASES if mesh in LATENT_MESHES else [])
        ctxs.append(_start(_torch_dist.tp_step_cases, n,
                           (n, str(d / "store"), shape, axes, cases,
                            str(d))))
        out["step"][mesh] = d
    d = tmp_path_factory.mktemp("tpref")
    ctxs.append(_start(_torch_dist.tp_reference_case, 8,
                       (8, str(d / "store"), str(d))))
    out["ref"] = d
    d = tmp_path_factory.mktemp("tppieces")
    ctxs.append(_start(_torch_dist.tp_pieces, 4,
                       (4, str(d / "store"), str(d))))
    out["pieces"] = d
    out["against"] = {}
    for n, (child, log) in children.items():
        assert child.wait(timeout=600) == 0, open(log).read()[-4000:]
        d = tmp_path_factory.mktemp(f"tpagainst{n}")
        ctxs.append(_start(_torch_dist.tp_against_reference, n,
                           (n, str(d / "store"), str(out["refsteps"]),
                            str(d), by_ranks[n])))
        out["against"][n] = d
    for ctx in ctxs:
        while not ctx.join():
            pass
    return out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_case(d, name, nranks, tol):
    """Each step on the mesh against the single-device step from the same
    state, and the gradients at the same params; every rank's metrics
    against rank 0's single-device metrics."""
    reports = [json.loads((d / f"rank{r}.json").read_text())[name]
               for r in range(nranks)]
    rep = reports[0]
    assert rep["grads"] and rep["drift"]
    for leaf, drift in rep["grads"].items():
        assert drift <= tol, ("gradient", leaf, drift)
    for i, step in enumerate(rep["drift"]):
        for kind, (drift, leaf) in step.items():
            assert drift <= tol, (i, kind, leaf, drift)
    for i, step in enumerate(rep["metrics"]):
        for key, (want, _) in step.items():
            mt = tol if key == "grad_norm" else TOL
            for r in reports:
                got = r["metrics"][i][key][1]
                assert abs(got - want) <= mt * max(abs(want), 1.0), \
                    (key, i, got, want)
    return reports


@pytest.mark.parametrize("nmb", [1, 2], ids=["mb1", "mb2"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_step_matches_single_device(runs, mesh, arch, fsdp, nmb):
    """Two steps on the mesh equal two single-device steps of the same
    resolved config on the global batch; every rank reports the same
    metrics."""
    _check_case(runs["step"][mesh], _name(arch, fsdp, nmb),
                int(np.prod(MESHES[mesh][0])),
                MOE_TOL if "moe" in arch else TOL)


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("arch", LATENT_ARCHS)
@pytest.mark.parametrize("mesh", LATENT_MESHES)
def test_tp_step_matches_single_device_mla_and_mamba2(runs, mesh, arch,
                                                      fsdp):
    """MLA (minicpm3-4b: ``wuq`` / ``wukv`` / ``wo`` on local heads, the
    latent replicated), mamba2-1.3b (``ssm_inner`` split, the SSD on the
    rank's heads, the gated norm's sum over the model ranks) and
    zamba2-2.7b (its Mamba2 layers so, and the shared block on local
    heads with its LoRA seeded nonzero), all three with tied embeddings
    under the vocabulary split, against the single-device step of the
    same resolved config: two steps on the mesh as
    :func:`test_tp_step_matches_single_device` holds them, but for the
    master and params of the leaves that start at zero (Mamba2's conv
    biases, whose m and v are held: AdamW's update of an element whose
    |g| is a few eps or whose m nearly cancels turns last-bit gradient
    differences into 1.1-1.5e-5 of such a master, zamba2-2.7b's
    ``conv_B_b`` and ``conv_x_b``; ROADMAP Queue 3 item 29); and two
    steps handed the
    single-device step's gradients (``testing.sharded_step_parity``)
    within STATE_TOL (master, m, v) and one ulp (params) of the
    single-device step, every microbatch the same rows, the mesh's
    forward loss within 1e-5."""
    from repro_torch.testing import STATE_TOL
    d = runs["step"][mesh]
    nranks = int(np.prod(MESHES[mesh][0]))
    reports = _check_case(d, _name(arch, fsdp, 1), nranks, TOL)
    assert len(reports[0]["drift"]) == 2
    exempt = sorted(reports[0].get("exempt", []))
    stack = "layers" if arch == "mamba2-1.3b" else "mamba"
    assert exempt == ([] if arch == "minicpm3-4b" else sorted(
        f"['{stack}']['mixer']['conv_{c}_b']" for c in "xBC")), exempt
    for r in reports:
        steps = r["parity"]
        assert len(steps) == 2 and steps[0]["params_equal"], steps
        for p in steps:
            assert p["batch_equal"] and p["loss_drift"] <= TOL, p
            for kind in ("master", "m", "v"):
                assert p["drift"][kind] <= STATE_TOL, (kind, p)
            assert p["drift"]["params"] <= 1.0, p


@pytest.mark.parametrize("mesh", LATENT_MESHES)
def test_tp_ssd_and_latent_attention_run_on_local_heads(runs, mesh):
    """A model rank's SSD kernel takes its H / tp Mamba2 heads (dt and A
    cut to them, B and C the one group), MLA's flash kernel its H / tp
    heads at D qk_nope + qk_rope and Dv v_head_dim, and Zamba2's its H /
    tp shared heads with the kv heads those read."""
    shape, _ = MESHES[mesh]
    tp, B, S = shape[-1], _torch_dist.STEP_B // shape[0], \
        _torch_dist.STEP_S
    for arch in LATENT_ARCHS:
        cfg = get_config(arch, smoke=True).resolve(tp=tp)
        rep = json.loads((runs["step"][mesh] / "rank0.json").read_text())[
            _name(arch, False, 1)]["kernels"]
        assert rep["gmm"] == [], rep
        if cfg.ssm is not None:
            s = cfg.ssm
            H = s.n_heads(cfg.d_model) // tp
            assert rep["ssd"] == [[[B, S, H, s.head_dim], [B, S, H], [H],
                                   [B, S, 1, s.d_state]]], (arch, rep)
        else:
            assert rep["ssd"] == [], rep
        if cfg.mla is not None:
            m, H = cfg.mla, cfg.padded_heads // tp
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            assert rep["flash"] == [[[B, S, H, qk], [B, S, H, qk],
                                     [B, S, H, m.v_head_dim]]], rep
        elif cfg.hybrid is not None:
            hb, dh = cfg.hybrid, cfg.head_dim
            H = hb.shared_num_heads // tp
            kv = local_kv_heads(H, hb.shared_kv_heads, tp, 0)
            KV = kv.stop - kv.start
            assert rep["flash"] == [[[B, S, H, dh], [B, S, KV, dh],
                                     [B, S, KV, dh]]], rep
        else:
            assert rep["flash"] == [], rep


def test_reference_case_four_steps(runs):
    """The reference's own case on a (2, 4) mesh: in f32 each of four
    steps equals the single-device step of the config resolved for tp 4,
    dp 2; in bf16 on a batch of ones, as the reference runs it, the total
    loss is finite and falls, the same on every rank."""
    reports = _check_case(runs["ref"], REF_CASE, 8, TOL)
    assert len(reports[0]["metrics"]) == 4
    bf16 = [json.loads((runs["ref"] / f"rank{r}.json").read_text())[
        "bf16_ones"] for r in range(8)]
    assert all(b == bf16[0] for b in bf16)
    assert all(np.isfinite(bf16[0])) and bf16[0][-1] < bf16[0][0], bf16[0]


@pytest.mark.parametrize("case", list(REF_STEPS))
def test_tp_step_matches_reference_gspmd_step(runs, case):
    """Each of the port's steps on the mesh, from the reference's state
    before the reference's own GSPMD step on that mesh (the config
    resolved for it, as ``build_cell`` resolves it), equals that step:
    every rank's metrics within 1e-5, and the state gathered after it
    (m, v; master and params on the elements whose gradient stayed above
    1e-3 of the leaf's largest at every step) within 1e-5 of each leaf's
    largest value; MLA and the Mamba2 families at (1, 4) within REF_TOL
    (the reference's compiled step sums in another order again).  The
    reference's loss falls over the steps."""
    c = REF_STEPS[case]
    tol = REF_TOL if c["arch"] in LATENT_ARCHS else TOL
    want = json.loads((runs["refsteps"] / case / "metrics.json").read_text())
    assert len(want) == c["steps"]
    n = int(np.prod(c["mesh"]))
    reports = [json.loads((runs["against"][n] / f"ref{r}.json")
                          .read_text())[case] for r in range(n)]
    assert len(reports[0]["drift"]) == c["steps"]
    for i, step in enumerate(reports[0]["drift"]):
        for kind, (drift, leaf) in step.items():
            assert drift <= tol, (i, kind, leaf, drift)
    for r in reports:
        for i, (got, w) in enumerate(zip(r["metrics"], want)):
            assert set(got) == set(w), (set(got), set(w))
            for key, v in w.items():
                assert abs(got[key] - v) <= tol * max(abs(v), 1.0), \
                    (i, key, got[key], v)
    assert want[-1]["total_loss"] < want[0]["total_loss"], want


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_moe_aux_loss_enters_the_backward_once(runs, mesh):
    """The MoE aux loss alone, its input gathered from each model rank's
    sequence block: the router's gradient summed over the model ranks and
    each rank's block of the input's gradient equal the unsplit layer's
    (each rank computes the aux loss in full, and ``replicated_term``
    scales its gradient by 1 / tp)."""
    for r in range(MESHES[mesh][0][-1]):
        got = json.loads((runs["step"][mesh] / f"rank{r}.json")
                         .read_text())["aux piece"]
        assert set(got) == {"router grad", "input grad"}
        for k, v in got.items():
            assert v <= 1e-6, (r, k, v)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_kernels_run_on_local_heads_and_experts(runs, mesh):
    """A model rank's flash attention takes its H / tp q heads and the kv
    heads those read, and its ``gmm`` its E / tp experts: no rank
    computes the whole layer."""
    shape, axes = MESHES[mesh]
    tp = shape[-1]
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True).resolve(tp=tp)
        rep = json.loads((runs["step"][mesh] / "rank0.json").read_text())[
            _name(arch, False, 1)]["kernels"]
        H = cfg.padded_heads // tp
        kv = local_kv_heads(H, cfg.padded_kv, tp, 0)
        KV = kv.stop - kv.start if isinstance(kv, slice) else H
        B = _torch_dist.STEP_B // int(np.prod(shape[:-1]))
        S = _torch_dist.STEP_S
        assert rep["flash"] == [[[B, S, H, cfg.head_dim],
                                 [B, S, KV, cfg.head_dim],
                                 [B, S, KV, cfg.head_dim]]], (arch, rep)
        if cfg.moe is not None:
            E = cfg.moe.num_experts // tp
            assert rep["gmm"] and all(x[0] == E and w[0] == E
                                      for x, w in rep["gmm"]), rep["gmm"]
        else:
            assert rep["gmm"] == []


@pytest.fixture(scope="module")
def ref_shapes():
    meshes = dict(MESHES, ref=REF_MESH)
    reqs = [{"arch": a, "smoke": True, "dtype": "float32",
             "mesh": meshes[m][0], "axes": meshes[m][1], "fsdp": f,
             "what": "state"} for m in meshes
            for a in ARCHS + (LATENT_ARCHS if m in LATENT_MESHES else ())
            for f in (False, True) if m != "ref" or (a, f) == (
                "deepseek-67b", True)]
    got = reference_layouts(reqs)
    return {(tuple(r["mesh"]), r["arch"], r["fsdp"]): g
            for r, g in zip(reqs, got)}


@pytest.mark.parametrize("mesh,arch,fsdp", [
    (m, a, f) for m in MESHES for a in ARCHS for f in (False, True)]
    + [("ref", "deepseek-67b", True)]
    + [(m, a, f) for m in LATENT_MESHES for a in LATENT_ARCHS
       for f in (False, True)])
def test_tp_rank_shards_have_reference_shapes(runs, ref_shapes, mesh, arch,
                                              fsdp):
    """Each rank's local leaves have the reference's ``arg_sharding``
    shard shapes at the mesh: heads, mlp, vocab, experts and
    ``ssm_inner`` split over ``model``, the kv projections, MLA's latent,
    Mamba2's B / C / dt projections, per-head vectors and norms whole."""
    if mesh == "ref":
        shape, d, nmb = REF_MESH[0], runs["ref"], 2
    else:
        shape, d, nmb = MESHES[mesh][0], runs["step"][mesh], 1
    want = ref_shapes[(tuple(shape), arch, fsdp)]
    on_model = 0
    for r in range(int(np.prod(shape))):
        got = json.loads((d / f"rank{r}.json").read_text())[
            _name(arch, fsdp, nmb)]["shapes"]
        assert got == {k: v["shape"] for k, v in want.items()}
        on_model += sum("model" in json.dumps(v["spec"])
                        for v in want.values())
    assert on_model > 0


@pytest.fixture(scope="module")
def pieces(runs):
    return [json.loads((runs["pieces"] / f"pieces{r}.json").read_text())
            for r in range(4)]


PIECES = ["sum_into", "reshard", "global_norm", "reduce_from_model", "gather_seq", "scatter_seq", "logits",
          "loss", "h grad", "head grad", "embedding rows", "gated norm",
          "mamba heads", "mamba decode", "mla combine"]


@pytest.mark.parametrize("piece", PIECES)
def test_model_axis_pieces_match_unsplit(pieces, piece):
    """Each piece on its ranks equals its unsplit form: ``sum_into`` of a
    dim split over (data, model) reduced over data, model or both (and
    over more axes than split a dim); ``reshard``; ``global_norm`` counts
    a model-split leaf's shards once each and a replicated leaf once; the
    collectives' forward and backward; the vocab-parallel logits, loss,
    gradients and embedding rows with labels in every rank's block and
    in the padded tail; the gated norm over a split ``d_inner`` (value
    and both gradients), Mamba2's prefill and decode on a rank's heads
    (one group and four) and MLA's latent decode on a rank's blocks of
    the caches, an empty block among them
    (``_torch_dist._latent_ssm_pieces``)."""
    n = 0
    for got in pieces:
        for k, v in got.items():
            if k.startswith(piece) and not isinstance(v, list):
                assert v <= 1e-6, (k, v)
                n += 1
    assert n > 0


@pytest.mark.parametrize("case", ["deepseek-67b fsdp=True",
                                  "deepseek-67b fsdp=False",
                                  "qwen3-moe-30b-a3b fsdp=True"])
def test_sharded_step_parity_with_a_model_axis(pieces, case):
    """``testing.sharded_step_parity`` on a (2, 2) data x model mesh: two
    steps handed the single-device step's gradients take every rank's
    rows bit for bit, and its blocks of the params at the first step
    (the clip's norm sums the shards in another order, so the second
    step's params may differ in a last bit), and come out within
    STATE_TOL (the params within one ulp) of the single-device step; the
    TP forward's loss within 1e-5."""
    from repro_torch.testing import STATE_TOL
    for got in pieces:
        steps = got[f"parity {case}"]
        assert steps[0]["params_equal"], steps
        for d in steps:
            assert d["batch_equal"], d
            assert d["loss_drift"] <= TOL, d
            for kind in ("master", "m", "v"):
                assert d["drift"][kind] <= STATE_TOL, (kind, d)
            assert d["drift"]["params"] <= 1.0, d


def test_uneven_sequence_is_refused(pieces):
    for got in pieces:
        msg = got["uneven sequence"]
        assert "6 tokens" in msg and "4 tensor-parallel ranks" in msg, msg


@pytest.mark.parametrize("H,KV,tp,want", [
    (4, 2, 2, [(0, 1), (1, 2)]),                 # each rank one kv head
    (4, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),  # two ranks share one
    (32, 4, 4, [(i, i + 1) for i in range(4)]),  # qwen3-moe at tp 4
    (96, 8, 8, [(i, i + 1) for i in range(8)]),  # mistral-large at tp 8
    (32, 8, 2, [(0, 4), (4, 8)]),
    (4, 4, 2, [(0, 2), (2, 4)]),                 # MHA
    (6, 2, 2, [(0, 1), (1, 2)]),
    (6, 2, 3, [(0, 1), [0, 1], (1, 2)]),         # rank 1 straddles
    (4, 2, 1, [(0, 2)])])
def test_local_kv_heads(H, KV, tp, want):
    """The kv heads a rank's q heads read: a slice where each serves the
    same number of them, one kv head a q head (an index) where they
    straddle two."""
    got = []
    for r in range(tp):
        kv = local_kv_heads(H // tp, KV, tp, r)
        got.append((kv.start, kv.stop) if isinstance(kv, slice)
                   else kv.tolist())
    assert got == want


def test_local_kv_heads_refuses_ungrouped_heads():
    with pytest.raises(ValueError, match="do not group"):
        local_kv_heads(3, 4, 2, 0)


@pytest.mark.parametrize("H,KV,tp,rank", [(6, 2, 3, 1), (6, 2, 3, 0),
                                           (4, 2, 4, 3), (32, 8, 2, 1)])
@pytest.mark.parametrize("bias", [False, True])
def test_project_qkv_reads_its_q_heads_kv_heads(monkeypatch, H, KV, tp, rank,
                                                bias):
    """On a rank's block of ``wq`` (and ``bq``), ``_project_qkv`` gives the
    full projection's q heads of that block and, for each local q head,
    the kv head the full layer's grouping gives it, as the flash kernel
    reads it (local kv head ``j // (H_local / KV_local)``); where a
    rank's q heads straddle two kv heads, one kv head a q head."""
    import dataclasses
    from repro_torch.models import attention as A
    cfg = dataclasses.replace(get_config("deepseek-67b", smoke=True),
                              dtype="float32", qkv_bias=bias)
    g = torch.Generator().manual_seed(0)
    D, dh = 8, 4
    p = {n: torch.randn(shape, generator=g) for n, shape in (
        ("wq", (D, H, dh)), ("wk", (D, KV, dh)), ("wv", (D, KV, dh)),
        ("bq", (H, dh)), ("bk", (KV, dh)), ("bv", (KV, dh)))}
    x = torch.randn((2, 5, D), generator=g)
    q, k, v = A._project_qkv(p, cfg, x)
    Hl = H // tp
    mine = {**p, "wq": p["wq"][:, rank * Hl:(rank + 1) * Hl],
            "bq": p["bq"][rank * Hl:(rank + 1) * Hl]}
    monkeypatch.setattr(A, "tp_size", lambda: tp)
    monkeypatch.setattr(A, "tp_index", lambda: rank)
    ql, kl, vl = A._project_qkv(mine, cfg, x)
    torch.testing.assert_close(ql, q[:, :, rank * Hl:(rank + 1) * Hl])
    Gl = Hl // kl.shape[2]
    for j in range(Hl):
        want = (rank * Hl + j) // (H // KV)
        torch.testing.assert_close(kl[:, :, j // Gl], k[:, :, want])
        torch.testing.assert_close(vl[:, :, j // Gl], v[:, :, want])


def test_config_not_resolved_for_tp_is_refused():
    """A config resolved for another model axis (heads that do not split
    over it) raises ValueError naming the leaves and the tp to resolve
    with, instead of running the layer replicated."""
    cfg = get_config("qwen2-vl-7b").resolve(tp=1)      # 28 heads
    rules = make_rules(AbstractMesh((1, 8), ("data", "model")),
                       mode="train", fsdp=False)
    with pytest.raises(ValueError, match=r"\['wq'\].*resolve the config "
                                         r"with tp=8"):
        make_train_step(cfg, TrainConfig(), rules)
    # resolved for tp 8, the heads pad to 32 and the step is made
    make_train_step(get_config("qwen2-vl-7b").resolve(tp=8), TrainConfig(),
                    rules)


@pytest.mark.parametrize("G,tp,ok", [(1, 2, True), (1, 8, True),
                                     (4, 2, True), (4, 4, True),
                                     (2, 4, False), (4, 8, False)])
def test_mamba2_groups_must_be_whole_on_a_rank(G, tp, ok):
    """With one group every rank's heads read it; with more, a rank's
    heads must cover whole groups (mamba2-1.3b's smoke config has 8
    heads), else ``ValueError`` naming the heads, the groups and tp."""
    import dataclasses
    from repro_torch.models import model as M
    cfg = get_config("mamba2-1.3b", smoke=True)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=G)).resolve(tp=tp)
    rules = make_rules(AbstractMesh((1, tp), ("data", "model")),
                       mode="train", fsdp=False)
    if ok:
        M.check_tp(cfg, tp)
        make_train_step(cfg, TrainConfig(), rules)
        return
    for call in (lambda: M.check_tp(cfg, tp),
                 lambda: make_train_step(cfg, TrainConfig(), rules)):
        with pytest.raises(ValueError, match=f"8 Mamba2 heads in {G} "
                                             f"groups over {tp} model"):
            call()


def test_zamba2_shared_heads_must_split():
    """zamba2-2.7b's smoke shared block has 4 heads: at tp 8 the step and
    ``models.model.check_tp`` (which prefill, decode and ``init_cache``
    call) raise ``ValueError`` naming them (``resolve`` pads
    ``num_heads``, never the shared block's); at tp 4 the step is made.
    The serving refusal on live ranks is ``test_torch_tp_serving``'s."""
    from repro_torch.models import model as M
    cfg = get_config("zamba2-2.7b", smoke=True).resolve(tp=8)
    assert cfg.hybrid.shared_num_heads == 4 and cfg.padded_heads == 8
    with pytest.raises(ValueError, match="shared block's 4 heads"):
        make_train_step(cfg, TrainConfig(), make_rules(
            AbstractMesh((1, 8), ("data", "model")), mode="train",
            fsdp=False))
    with pytest.raises(ValueError, match="shared block's 4 heads"):
        M.check_tp(cfg, 8)
    make_train_step(get_config("zamba2-2.7b", smoke=True).resolve(tp=4),
                    TrainConfig(), make_rules(AbstractMesh(
                        (1, 4), ("data", "model")), mode="train",
                        fsdp=False))
