"""The port's multi-rank paths on gloo, against the single-device step and
the reference: the ZeRO-1 / FSDP train step on (2, 1) data x model and
(2, 2, 1) pod x data x model meshes, the int8 compressed all-reduce,
GPipe and an elastic restore onto another mesh.

The ranks run in ``torch.multiprocessing`` spawns grouped into four
(``tests/_torch_dist.py``; a ``file://`` store under ``tmp_path``, one
thread a rank); the two step spawns run at the same time.  The tests read
what the ranks wrote.

Tolerances: the sharded step against the unsharded one on the global
batch, two steps: metrics, m and v within 1e-5 of each leaf's largest
value; master and params the same on the elements whose gradient stayed
above 1e-3 of the leaf's largest at both steps, as
``tests/test_torch_train_step.py`` holds the step to the reference (Adam
moves an element by ~lr whatever its gradient, so where a gradient is ~0
the order of the sums decides the update).  The MoE arch is held to 1e-2
instead: its layer rounds the dispatched tokens and their cotangent to
bf16 (as the reference's does, ROADMAP Queue 3 item 11), so the last-bit
differences of the rank-local products upstream (a different row count
per product) flip a bf16 ulp here and there, as between the port and the
reference (``tests/_torch_train.py``).  On the smoke batch the first
moment of a leaf upstream of the MoE layer moved 4.1e-5 of its largest
after one step and 1.7e-3 after two, the grad norm 5.3e-5; the other
metrics stay within 1e-5, where they are held.  The
compressed all-reduce equals the reference's ``compressed_psum`` under
``jax.vmap(axis_name="pod")`` to 1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_dist
from repro.optim.compression import compressed_psum
from test_torch_parallel import reference_layouts

MESHES = {"2x1": ((2, 1), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
ARCHS = ("deepseek-67b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "qwen2-vl-7b")
#: the step cases: each arch, and the MoE arch with a dispatch group a
#: data-parallel rank
STEP_ARCHS = ARCHS + ("qwen3-moe-30b-a3b" + _torch_dist.GROUPS,)
CASES = [(a, f, n) for a in STEP_ARCHS for f in (False, True)
         for n in (1, 2)]
#: the MoE cases of the recompute check: one dispatch group across the
#: ranks (each rank gathers the rows) and one a rank
REMAT_ARCHS = ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b" + _torch_dist.GROUPS)
TOL = 1e-5
#: the MoE arch's leaves and metrics (see the module's docstring)
MOE_TOL = 1e-2


def _name(arch, fsdp, nmb):
    return f"{arch}-{'fsdp' if fsdp else 'zero1'}-mb{nmb}"


def _start(fn, nprocs, args):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def _wait(ctx):
    while not ctx.join():
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the four spawns: {mesh: out_dir}, the misc and remat out_dirs."""
    out, ctxs = {}, []
    for mesh, (shape, axes) in MESHES.items():
        d = tmp_path_factory.mktemp(f"step{mesh}")
        n = int(np.prod(shape))
        ctxs.append(_start(_torch_dist.step_cases, n,
                           (n, str(d / "store"), shape, axes, CASES,
                            str(d))))
        out[mesh] = d
    rng = np.random.default_rng(7)
    grads = (rng.standard_normal((4, 16, 32))
             * np.array([0.5, 1.0, 2.0, 4.0])[:, None, None]).astype(
                 np.float32)
    residuals = (0.01 * rng.standard_normal((4, 16, 32))).astype(np.float32)
    S, n_micro, mb, d = 4, 6, 2, 8
    ws = (0.3 * rng.standard_normal((S, d, d))).astype(np.float32)
    xs = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    md = tmp_path_factory.mktemp("misc")
    ctxs.append(_start(_torch_dist.misc, 8,
                       (8, str(md / "store"), str(md), grads, residuals,
                        (ws, xs))))
    rd = tmp_path_factory.mktemp("remat")
    ctxs.append(_start(_torch_dist.remat_backward, 2,
                       (2, str(rd / "store"), str(rd), REMAT_ARCHS)))
    for ctx in ctxs:
        _wait(ctx)
    return {"step": out, "misc": md, "remat": rd, "grads": grads,
            "residuals": residuals, "pipe": (ws, xs)}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("nmb", [1, 2], ids=["mb1", "mb2"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_unsharded(runs, mesh, arch, fsdp, nmb):
    """Two steps on the mesh equal two steps of the single-device step on
    the global batch (vlm with a loss mask that keeps a different share of
    each rank's rows); every rank reports the same metrics."""
    tol = MOE_TOL if "moe" in arch else TOL
    d = runs["step"][mesh]
    name = _name(arch, fsdp, nmb)
    z = np.load(d / f"{name}.npz")
    keys = [k[3:] for k in z.files if k.startswith("ref")]
    for k in keys:
        ref, got = z["ref" + k], z["got" + k]
        assert got.shape == ref.shape, k
        if "['master']" in k or k.startswith("['params']"):
            leaf = k.split("]", 2)[-1] if "['master']" in k else \
                k[len("['params']"):]
            keep = z["keep" + leaf]
            assert keep.any(), k
            ref, got = ref[keep], got[keep]
        assert _rel(got, ref) <= tol, (k, _rel(got, ref))
    ranks = [json.loads((d / f"rank{r}.json").read_text())[name]
             for r in range(int(np.prod(MESHES[mesh][0])))]
    for step in ranks[0]["metrics"]:
        for key, (want, got) in step.items():
            mt = tol if key == "grad_norm" else TOL
            assert abs(got - want) <= mt * max(abs(want), 1.0), (key, step)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_recompute_keeps_the_rules(runs, arch):
    """On two data-parallel ranks, the MoE layer's recompute under
    ``remat="full"`` run on another thread, outside the rules' context
    (where autograd runs a CUDA backward), gives the gradients of the
    backward inside the context without remat: the rules the forward ran
    under are bound to the recompute."""
    for r in range(2):
        got = json.loads((runs["remat"] / f"remat{r}.json").read_text())
        assert "error" not in got[arch], got[arch]
        assert got[arch]["drift"] <= TOL, got[arch]


@pytest.fixture(scope="module")
def ref_shapes():
    reqs = [{"arch": a, "smoke": True, "dtype": "float32",
             "mesh": MESHES[m][0], "axes": MESHES[m][1], "fsdp": f,
             "what": "state"} for m in MESHES for a in ARCHS
            for f in (False, True)]
    got = reference_layouts(reqs)
    return {(r["mesh"], r["arch"], r["fsdp"]): g for r, g in zip(reqs, got)}


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_rank_shards_have_reference_shapes(runs, ref_shapes, mesh, arch,
                                           fsdp):
    """Each rank's local leaves have the reference's ``arg_sharding``
    shard shapes (under FSDP the params' d_model dims halve; ZeRO-1
    splits master, m and v either way)."""
    want = ref_shapes[(MESHES[mesh][0], arch, fsdp)]
    d = runs["step"][mesh]
    split = 0
    for r in range(int(np.prod(MESHES[mesh][0]))):
        rep = json.loads((d / f"rank{r}.json").read_text())
        got = rep[_name(arch, fsdp, 1)]["shapes"]
        assert got == {k: v["shape"] for k, v in want.items()}
        split += sum(v["spec"] != [None] * len(v["spec"])
                     for v in want.values())
    assert split > 0


def test_compressed_allreduce_matches_reference_bounds(runs):
    """The reference test's bounds on a (4, 2) pod x data mesh: a
    pod-replicated gradient comes back within one scale, and so does the
    residual."""
    for r in range(8):
        got = json.loads((runs["misc"] / f"misc{r}.json").read_text())
        rep = got["replicated"]
        assert rep["err"] <= rep["scale"] + 1e-6, rep
        assert rep["res"] <= rep["scale"] + 1e-6, rep


def test_compressed_allreduce_matches_vmap_oracle(runs):
    """Unequal gradients and residuals on the four pods: each rank's mean
    and residual equal the reference's ``compressed_psum`` under
    ``jax.vmap(axis_name="pod")`` (which dequantises with the mean of the
    pods' scales)."""
    grads, res = runs["grads"], runs["residuals"]
    mean, new_res = jax.vmap(
        lambda g, r: compressed_psum({"w": g}, {"w": r}, "pod", 4),
        axis_name="pod")(jnp.asarray(grads), jnp.asarray(res))
    mean, new_res = np.asarray(mean["w"]), np.asarray(new_res["w"])
    for r in range(8):
        z = np.load(runs["misc"] / f"compressed{r}.npz")
        p = int(z["pod"])
        np.testing.assert_allclose(z["mean"], mean[p], rtol=0, atol=1e-6)
        np.testing.assert_allclose(z["res"], new_res[p], rtol=0, atol=1e-6)
    # the mean-scale dequantisation is far from the true mean here
    assert np.abs(mean[0] - grads.mean(0)).max() > 0.05


def test_pipeline_matches_sequential(runs):
    """GPipe at the reference test's S 4, n_micro 6, mb 2, d 8."""
    ws, xs = runs["pipe"]
    ref = xs
    for s in range(ws.shape[0]):
        ref = np.tanh(ref @ ws[s])
    for r in range(8):
        y = np.load(runs["misc"] / f"pipeline{r}.npy")
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)


def test_elastic_restore_onto_another_mesh(runs):
    """Saved from a (4, 2) data x model mesh, restored onto (2, 4) with
    ``("model", None)``: each rank's rows, exactly."""
    for r in range(8):
        got = json.loads((runs["misc"] / f"misc{r}.json").read_text())
        el = got["elastic"]
        assert el["shard1"] == [2, 4] and el["shard2"] == [2, 8], el
        assert el["exact"] and el["gathered"], el
