"""Tensor parallelism over ``model`` for the encoder-decoder family
(seamless-m4t-medium's f32 smoke config, encoder frames seeded nonzero)
on gloo: the train step, prefill and decode against the single-device
path of the same resolved config, and against the reference's own GSPMD
step and wave.

On (1, 2), (2, 2) and (1, 4) data x model meshes: one microbatch's
gradients and two steps (ZeRO-1 and FSDP) within 1e-5 of each leaf's
largest value, as ``tests/test_torch_tensor_parallel.py`` holds the
other families (``_torch_dist._tp_cases``), and two steps on the
single-device step's gradients (``testing.sharded_step_parity``); a
wave (prefill and greedy decode steps, ``testing.tp_serve_parity``) of
prompts of 14 tokens (uneven over 4 model ranks) and 16 beside 8 encoder
frames (S_enc != S), logits and the gathered cache within 1e-5, tokens
equal.  The encoder runs non-causal on a rank's heads, the
cross-attention with q from the decoder and k / v from the whole encoder
output on the kv heads the rank's q heads read, the cross cache is each
rank's ``kv_seq`` block of the encoder's k / v, and decode attends over
it read only.  At (1, 4) the port's step and wave, from the reference's
state and params, against the reference's GSPMD step and wave
(``scan_layers=False``, f32 frames) within 1e-4, tokens equal.  Then
the pieces (``tests/_torch_dist_encdec.py::_pieces``) and the layouts
against the reference's.

The ranks run in ``torch.multiprocessing`` spawns, all at once, beside
the reference's two child processes with 8 host devices; the tests read
what they wrote.
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

import _torch_dist as D
import _torch_dist_encdec as E
import _torch_dist_serve as DS
from repro_torch.models.attention import local_kv_heads
from repro_torch.parallel.sharding import AbstractMesh
from test_torch_parallel import port_layouts, reference_layouts
from test_torch_tensor_parallel import _check_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
TOL = 1e-5
REF_TOL = 1e-4
#: the pieces on a (1, tp) mesh held to 1e-6 of their unsplit value (the
#: encoder alone on uneven frames sums in another order: TOL)
PIECES = ("take block", "take block grad", "cross rows k", "cross rows v",
          "read-only decode", "uneven encoder")


def _start(fn, nprocs, args):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def _reference_serve(ref_dir):
    """The reference's params (``init_params(PRNGKey(0))`` of the f32
    smoke config, unscanned, resolved for REF_MESH) and the wave's batch
    (prompts of DS.REF_S tokens, E.SERVE_ENC frames) saved under
    ``ref_dir/<arch>``; starts the reference's wave in a child process
    with 8 host devices and returns (it, its log's path)."""
    import jax
    from repro.configs.base import get_config
    from repro.models import model as JM
    cfg = dataclasses.replace(get_config(E.ARCH, smoke=True),
                              dtype="float32", **E.REF_CONFIG).resolve(
        tp=E.REF_MESH[1], dp=E.REF_MESH[0])
    flat = jax.tree_util.tree_flatten_with_path(
        JM.init_params(jax.random.PRNGKey(0), cfg))[0]
    d = ref_dir / E.ARCH
    d.mkdir()
    np.savez(d / "params.npz", **{
        "".join(f"[{getattr(p, 'key', p)!r}]" for p in path): np.asarray(x)
        for path, x in flat})
    tcfg = DS.serve_config(E.ARCH, *E.REF_MESH)
    np.savez(d / "batch.npz", **{
        k: v.numpy() for k, v in E.serve_batch(tcfg, DS.REF_S).items()})
    req = ref_dir / "request.json"
    req.write_text(json.dumps([{
        "arch": E.ARCH, "mesh": E.REF_MESH, "axes": ["data", "model"],
        "cache_len": DS.SERVE_CACHE, "steps": DS.SERVE_STEPS,
        "dir": str(d), "config": E.REF_CONFIG}]))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    log = ref_dir / "child.log"
    with open(req) as fin, open(log, "w") as flog:
        child = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_reference_tp_serve.py")],
            stdin=fin, stdout=flog, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT)
    return child, str(log)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn at once, beside the reference's children: {"mesh":
    {mesh: out_dir}, "refsteps", "refserve": the reference's dirs,
    "against", "against serve": out_dirs}."""
    out, ctxs = {"mesh": {}}, []
    out["refsteps"] = tmp_path_factory.mktemp("encrefsteps")
    out["refserve"] = tmp_path_factory.mktemp("encrefserve")
    children = [D.start_reference_steps(str(out["refsteps"]),
                                        table=E.REF_STEPS),
                _reference_serve(out["refserve"])]
    for mesh, (shape, axes) in MESHES.items():
        d = tmp_path_factory.mktemp(f"enc{mesh}")
        n = int(np.prod(shape))
        ctxs.append(_start(E.tp_encdec_cases, n,
                           (n, str(d / "store"), shape, axes, str(d))))
        out["mesh"][mesh] = d
    for child, log in children:
        assert child.wait(timeout=600) == 0, open(log).read()[-4000:]
    n = int(np.prod(E.REF_MESH))
    out["against"] = tmp_path_factory.mktemp("encagainst")
    ctxs.append(_start(D.tp_against_reference, n,
                       (n, str(out["against"] / "store"),
                        str(out["refsteps"]), str(out["against"]), None,
                        E.REF_STEPS)))
    out["against serve"] = tmp_path_factory.mktemp("encagainstserve")
    ctxs.append(_start(DS.tp_against_reference_serve, n,
                       (n, str(out["against serve"] / "store"),
                        str(out["refserve"]), str(out["against serve"]),
                        None, E.REF_SERVE)))
    for ctx in ctxs:
        while not ctx.join():
            pass
    return out


def _reports(runs, mesh):
    return [json.loads((runs["mesh"][mesh] / f"rank{r}.json").read_text())
            for r in range(int(np.prod(MESHES[mesh][0])))]


def _name(fsdp: bool) -> str:
    return f"{E.ARCH}-{'fsdp' if fsdp else 'zero1'}-mb1"


def test_no_leaf_starts_at_zero():
    """Without ``qkv_bias`` no parameter of the smoke config starts at
    zero, so the step cases hold every leaf's master and params (no
    leaf takes ``_tp_cases``' exemption, ROADMAP Queue 3 item 29)."""
    from repro_torch.models import model as M
    from repro_torch.tree import leaves_with_path
    cfg = D.step_config(E.ARCH, 1, 4)
    assert not cfg.qkv_bias
    zero = [p for p, x in leaves_with_path(M.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")) if not x.any()]
    assert zero == []


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_encdec_step_matches_single_device(runs, mesh, fsdp):
    """One microbatch's gradients on the mesh (each leaf summed over the
    ranks where it is replicated) and two steps, each from the
    single-device step's state, within 1e-5 of the single-device step of
    the same resolved config on the global batch, every rank's metrics
    too; with ZeRO-1, two steps handed the single-device step's
    gradients within STATE_TOL (master, m, v) and one ulp (params), the
    mesh's forward loss within 1e-5."""
    from repro_torch.testing import STATE_TOL
    reports = _check_case(runs["mesh"][mesh], _name(fsdp),
                          int(np.prod(MESHES[mesh][0])), TOL)
    assert len(reports[0]["drift"]) == 2
    assert "exempt" not in reports[0]
    if fsdp:
        return
    for r in reports:
        steps = r["parity"]
        assert len(steps) == 2 and steps[0]["params_equal"], steps
        for p in steps:
            assert p["batch_equal"] and p["loss_drift"] <= TOL, p
            for kind in ("master", "m", "v"):
                assert p["drift"][kind] <= STATE_TOL, (kind, p)
            assert p["drift"]["params"] <= 1.0, p


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_encdec_flash_runs_on_local_heads(runs, mesh):
    """A model rank's flash kernel takes its H / tp q heads and the kv
    heads those read: the encoder's self-attention over the STEP_ENC
    frames, the decoder's over the STEP_S tokens, and the
    cross-attention with q over the tokens and k / v over the frames
    (Sq != Skv)."""
    shape, _ = MESHES[mesh]
    tp = shape[-1]
    cfg = D.step_config(E.ARCH, 1, tp)
    B, S, Se = D.STEP_B // int(np.prod(shape[:-1])), D.STEP_S, D.STEP_ENC
    H, dh = cfg.padded_heads // tp, cfg.head_dim
    kv = local_kv_heads(H, cfg.padded_kv, tp, 0)
    KV = kv.stop - kv.start
    rep = json.loads((runs["mesh"][mesh] / "rank0.json").read_text())[
        _name(False)]["kernels"]
    want = sorted([[[B, s, H, dh], [B, t, KV, dh], [B, t, KV, dh]]
                   for s, t in ((Se, Se), (S, S), (S, Se))])
    assert rep["flash"] == want and rep["gmm"] == rep["ssd"] == [], rep


@pytest.mark.parametrize("S", E.SERVE_S)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_encdec_wave_matches_single_device(runs, mesh, S):
    """A prefill and eight greedy decode steps on the mesh equal the
    single-device wave of the same resolved config: every rank's logits
    and the gathered cache (the self and the cross caches) within 1e-5
    of their largest value, the greedy tokens and ``len`` equal.  Each
    rank holds its block of both caches (SERVE_CACHE / tp self rows,
    SERVE_ENC / tp cross rows, every kv head) and the decode kernel runs
    with all H q heads over each block."""
    (dp, tp), _ = MESHES[mesh]
    cfg = DS.serve_config(E.ARCH, dp, tp)
    B, L = DS.SERVE_B // dp, cfg.num_layers
    kv, dh = cfg.padded_kv, cfg.head_dim
    rows = {"k": DS.SERVE_CACHE // tp, "v": DS.SERVE_CACHE // tp,
            "ck": E.SERVE_ENC // tp, "cv": E.SERVE_ENC // tp}
    for rep in _reports(runs, mesh):
        got = rep[E.case_name(S)]
        assert got["tokens_equal"], got
        assert got["logits"] <= TOL and got["cache"] <= TOL, got
        assert got["cache_shapes"] == {
            **{k: [L, B, n, kv, dh] for k, n in rows.items()},
            "len": [B]}, got
        assert got["decode"] == sorted(
            [[B, 1, cfg.padded_heads, dh], [B, rows[k], kv, dh]]
            for k in ("k", "ck")), got["decode"]


def test_tp_encdec_step_matches_reference_gspmd(runs):
    """The port's step on REF_MESH, from the reference's state before
    each of its GSPMD steps on that mesh (unscanned, f32 frames), equals
    that step: every rank's metrics within 1e-4, and the state gathered
    after it (m, v; master and params where the gradient stayed above
    1e-3 of the leaf's largest) within 1e-4 of each leaf's largest value.
    The reference's loss falls over the steps."""
    case = next(iter(E.REF_STEPS))
    c = E.REF_STEPS[case]
    want = json.loads((runs["refsteps"] / case / "metrics.json").read_text())
    assert len(want) == c["steps"]
    n = int(np.prod(c["mesh"]))
    reports = [json.loads((runs["against"] / f"ref{r}.json").read_text())[
        case] for r in range(n)]
    assert len(reports[0]["drift"]) == c["steps"]
    for i, step in enumerate(reports[0]["drift"]):
        for kind, (drift, leaf) in step.items():
            assert drift <= REF_TOL, (i, kind, leaf, drift)
    for r in reports:
        for i, (got, w) in enumerate(zip(r["metrics"], want)):
            assert set(got) == set(w)
            for key, v in w.items():
                assert abs(got[key] - v) <= REF_TOL * max(abs(v), 1.0), \
                    (i, key, got[key], v)
    assert want[-1]["total_loss"] < want[0]["total_loss"], want


def test_tp_encdec_wave_matches_reference_gspmd(runs):
    """The port's wave on REF_MESH, from the reference's params, against
    the reference's own GSPMD prefill and decode (unscanned, f32 frames,
    the same batch): every rank's logits within 1e-4 of the largest real
    logit and its greedy tokens equal."""
    with np.load(runs["refserve"] / E.ARCH / "wave.npz") as f:
        want, want_tok = f["logits"], f["tokens"]
    V = DS.serve_config(E.ARCH, 1, 1).vocab_size
    assert want.shape[0] == DS.SERVE_STEPS + 1
    for r in range(int(np.prod(E.REF_MESH))):
        with np.load(runs["against serve"] / f"{E.ARCH}-rank{r}.npz") as f:
            got, tok, r0 = f["logits"], f["tokens"], int(f["row0"])
        n = got.shape[1]
        w = want[:, r0:r0 + n, :V]
        assert np.array_equal(tok, want_tok[r0:r0 + n]), (r, tok, want_tok)
        drift = float(np.abs(got[..., :V] - w).max() / np.abs(w).max())
        assert drift <= REF_TOL, (r, drift)


@pytest.mark.parametrize("piece", PIECES)
@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_tp_encdec_pieces_match_unsplit(runs, mesh, piece):
    """On each rank: ``take_seq_block`` of whole frames (3 tp - 1
    positions, the last block padded) is the rank's block and its
    gradient every rank's cotangent, all-gathered; the cross cache's
    block rows (``attention_fwd(x_kv=, kv_rows=)`` on the rank's heads)
    the encoder's k / v rows; the read-only block decode, summed over the
    ranks, the cross-attention over the whole cache; the encoder alone
    on uneven frames the single-device encoder (TOL)."""
    tol = TOL if piece == "uneven encoder" else 1e-6
    for rep in _reports(runs, mesh):
        assert rep["pieces"][piece] <= tol, (piece, rep["pieces"][piece])


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_tp_encdec_frames_enter_once_and_block_is_read_only(runs, mesh):
    """``scatter_seq`` of whole frames sums tp copies (tp - 1 of the block
    off), which ``take_seq_block`` avoids; the read-only decode leaves
    the rank's cross block as it was."""
    tp = MESHES[mesh][0][1]
    for rep in _reports(runs, mesh):
        p = rep["pieces"]
        assert abs(p["scatter_seq on whole frames"][0] - (tp - 1)) < 1e-6, p
        assert p["read-only block kept"] == [True], p


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_tp_encdec_refuses_frames_that_do_not_split(runs, mesh):
    """Encoder frames that do not split over the model ranks are refused
    with ValueError naming both sizes: the train step's (as an uneven
    sequence of tokens is) and prefill's (the cross cache's
    ``kv_block``); the encoder alone takes them
    (:func:`test_tp_encdec_pieces_match_unsplit`)."""
    tp = MESHES[mesh][0][1]
    n = 2 * tp + 1
    for rep in _reports(runs, mesh):
        train, prefill = rep["pieces"]["refused"]
        assert train == (f"train: a sequence of {n} encoder frames does "
                         f"not split over {tp} tensor-parallel ranks"), train
        assert prefill.startswith(f"prefill: a KV cache of {n} rows does "
                                  f"not split over {tp} model ranks"), prefill


@pytest.fixture(scope="module")
def ref_layouts():
    reqs = [{"arch": E.ARCH, "smoke": True, "dtype": "float32",
             "mesh": MESHES[m][0], "axes": MESHES[m][1], "fsdp": f,
             "what": w} for m in MESHES for w, f in (
                 ("state", False), ("state", True), ("cache", False))]
    return {(tuple(r["mesh"]), r["what"], r["fsdp"]): g
            for r, g in zip(reqs, reference_layouts(reqs))}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_encdec_layouts_match_reference(runs, ref_layouts, mesh):
    """Each rank's train-state leaves (ZeRO-1 and FSDP) have the
    reference's ``arg_sharding`` shard shapes at the mesh (heads, mlp and
    vocab split over ``model``, both stacks' kv projections and the norms
    whole), and ``launch.specs.cache_shardings`` (B 8 x S 64, the cross
    rows ``enc_len_for(64)``) gives the reference's decode cache spec
    and shard shape of every leaf: ``k``, ``v``, ``ck`` and ``cv`` split
    over ``model`` along ``kv_seq``; ``len`` splits like the rows."""
    shape, axes = MESHES[mesh]
    for fsdp in (False, True):
        want = ref_layouts[(shape, "state", fsdp)]
        got = json.loads((runs["mesh"][mesh] / "rank0.json").read_text())[
            _name(fsdp)]["shapes"]
        assert got == {k: v["shape"] for k, v in want.items()}
        assert any("model" in json.dumps(v["spec"]) for v in want.values())
    want = ref_layouts[(shape, "cache", False)]
    req = {"arch": E.ARCH, "smoke": True, "dtype": "float32", "mesh": shape,
           "axes": axes, "fsdp": False, "what": "cache"}
    assert port_layouts(req) == want
    from repro_torch.launch.specs import cache_shardings, rules_for
    cfg = DS.serve_config(E.ARCH, shape[0], shape[1])
    sh = cache_shardings(cfg, rules_for(cfg, AbstractMesh(shape, axes),
                                        "decode"), 8, 64)
    for leaf in ("k", "v", "ck", "cv"):
        spec = [list(e) if isinstance(e, tuple) else e for e in sh[leaf].spec]
        assert spec == want[f"['{leaf}']"]["spec"], (leaf, spec)
        assert "model" in json.dumps(spec), leaf
    sh = cache_shardings(cfg, rules_for(cfg, AbstractMesh(shape, axes),
                                        "decode"), 8, 64, enc_len=16)
    assert sh["ck"].shard_shape((cfg.num_layers, 8, 16, cfg.padded_kv,
                                 cfg.head_dim))[2] == 16 // shape[1]
