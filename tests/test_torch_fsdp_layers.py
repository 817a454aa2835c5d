"""The FSDP train step's layer-by-layer gather (``training.train_step.
make_train_step`` under ``make_rules(fsdp=True)``, ``parallel.sharding.
LayerGather``, ``models.common.layer_params``) on gloo and on the dry-run's
fake group.

- On (data 2) and (data 2, model 2) meshes, a family each (deepseek-67b
  dense, qwen3-moe-30b-a3b, qwen2-vl-7b with its loss mask, mamba2-1.3b,
  zamba2-2.7b with its LoRA seeded nonzero, seamless-m4t-medium), FSDP,
  two microbatches: two steps each held against the single-device step
  from the same state, and one microbatch's gradients, at
  ``tests/test_torch_tensor_parallel.py``'s tolerances (1e-5, the MoE
  arch 1e-2); and two steps on the single-device step's gradients
  (``testing.sharded_step_parity``) within STATE_TOL and one ulp.  The
  reference's own FSDP case against its GSPMD step (deepseek-67b on (2,
  4), ``tests/_torch_dist.py::REF_STEPS``) runs in
  ``tests/test_torch_tensor_parallel.py`` through the same step.
- On one rank, every family and bf16 under each remat policy: the FSDP
  step with its own backward equals the single-device step bit for bit.
- On rank 0 of a fake (data 2, model 2) group (``launch.dryrun_lib.
  fake_group``, ``launch.specs.build_cell`` / ``lower_cell``, FSDP
  set on the smoke configs, 4 layers, 4 microbatches): no all-gather
  over the data axis is larger than one layer's largest stacked leaf but
  the up-front gathers of the leaves outside the stacks (the embedding,
  Zamba2's shared block); the data axis's all-gathers number those plus
  forward and recompute x layers x split leaves a microbatch; and a
  dense layer's collective marginal by hand count.

The ranks run in spawns and one child process, all started at once by
the module's fixture (``tests/_torch_dist_fsdp.py``; a ``file://`` store
under ``tmp_path``, one thread a rank).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_dist_fsdp as F
from repro_torch.configs.base import get_config
from repro_torch.models.model import params_logical
from repro_torch.parallel.sharding import AbstractMesh, make_rules
from repro_torch.training.train_step import (layer_gathered,
                                             state_shardings)
from repro_torch.tree import leaves_with_path
from test_torch_tensor_parallel import MOE_TOL, TOL, _check_case

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"2x1": ((2, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _start(fn, nprocs, args):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo spawns of both meshes, the one-rank spawn and the fake
    group's child, at once: {"step": {mesh: out_dir}, "one": out_dir,
    "fake": its output}."""
    out, ctxs = {"step": {}}, []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    fake = tmp_path_factory.mktemp("fsdpfake") / "fake.json"
    child = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_dist_fsdp.py"),
         str(fake)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    for mesh, (shape, axes) in MESHES.items():
        d = tmp_path_factory.mktemp(f"fsdp{mesh}")
        n = int(np.prod(shape))
        ctxs.append(_start(F.gloo_cases, n, (n, str(d / "store"), shape,
                                             axes, str(d))))
        out["step"][mesh] = d
    d = tmp_path_factory.mktemp("fsdpone")
    ctxs.append(_start(F.one_rank, 1, (1, str(d / "store"), str(d))))
    out["one"] = d
    _, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-4000:]
    out["fake"] = json.loads(fake.read_text())
    for ctx in ctxs:
        while not ctx.join():
            pass
    return out


# ----------------------------------------------------------------------
# gloo
@pytest.mark.parametrize("arch", F.GLOO_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_step_matches_single_device(runs, mesh, arch):
    """Two FSDP steps on the mesh equal two single-device steps of the
    same resolved config on the global batch, and one microbatch's
    gradients equal the single-device ones (``_check_case``: master and
    params on the elements whose gradient stayed above 1e-3 of the
    leaf's largest, the leaves that start at zero apart for the Mamba2
    families); every rank reports the same metrics."""
    reports = _check_case(runs["step"][mesh], f"{arch}-fsdp-mb2",
                          int(np.prod(MESHES[mesh][0])),
                          MOE_TOL if "moe" in arch else TOL)
    assert len(reports[0]["drift"]) == 2


@pytest.mark.parametrize("arch", F.GLOO_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_step_on_the_single_device_gradients(runs, mesh, arch):
    """Handed the single-device step's gradients (the layer-gathered
    leaves' reduced layer by layer through ``LayerGather.reduce_stack``,
    the backward's reduction), two FSDP steps on the mesh take the same
    rows, the first on the same params (its layer-gathered leaves this
    rank's shards), and stay within STATE_TOL (master, m, v) and one ulp
    (params) of the single-device step on every rank."""
    from repro_torch.testing import STATE_TOL
    d = runs["step"][mesh]
    for r in range(int(np.prod(MESHES[mesh][0]))):
        rep = json.loads((d / f"rank{r}.json").read_text())
        steps = rep[f"{arch}-fsdp-mb2"]["parity"]
        assert len(steps) == 2 and steps[0]["params_equal"], steps
        for s in steps:
            assert s["batch_equal"], s
            for kind in ("master", "m", "v"):
                assert s["drift"][kind] <= STATE_TOL, (r, kind, s["drift"])
            assert s["drift"]["params"] <= 1.0, (r, s["drift"])


@pytest.mark.parametrize("case", [f"{a}-{r}-{t}" for a, r, t in F.ONE_RANK])
def test_one_rank_fsdp_step_is_the_single_device_step(runs, case):
    """On one rank the FSDP step, its layers gathered and their bf16 or
    f32 gradients cast and reduced into the f32 accumulator one layer at
    a time from its own backward, gives the single-device step's state
    and metrics bit for bit (remat full, dots and none)."""
    got = json.loads((runs["one"] / "one_rank.json").read_text())[case]
    assert got["layered"] > 0, got
    assert got["unequal"] == [] and got["metrics"], got


# ----------------------------------------------------------------------
# the layouts, without a process group
@pytest.mark.parametrize("arch", F.GLOO_ARCHS)
def test_layer_gathered_leaves_are_the_data_split_stacks(arch):
    """``layer_gathered`` holds exactly the stacked leaves (logical axes
    led by ``layers``) whose params' layout names the data axis under
    FSDP, each with its number of layer dims, and nothing under ZeRO-1;
    no leaf outside the stacks."""
    cfg = get_config(arch, smoke=True).resolve(tp=2, dp=2)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for fsdp in (False, True):
        rules = make_rules(mesh, mode="train", fsdp=fsdp)
        got = layer_gathered(cfg, rules)
        p_sh = dict(leaves_with_path(state_shardings(cfg, rules)["params"]))
        want = {}
        for path, axes in _logical_leaves(params_logical(cfg)):
            k = next((i for i, a in enumerate(axes) if a != "layers"),
                     len(axes))
            if fsdp and k and "data" in p_sh[path].axes():
                want[path] = k
        assert {p: e.k for p, e in got.items()} == want
        assert bool(want) == fsdp
        for p, e in got.items():
            assert "model" not in e.param.axes() + e.opt.axes(), p


def _logical_leaves(tree, path=()):
    if isinstance(tree, tuple):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _logical_leaves(tree[k], path + (k,))


# ----------------------------------------------------------------------
# the fake group
def _data_gathers(run) -> list:
    return [b for op, axis, b in run["calls"]
            if op == "all-gather" and axis == "data"]


@pytest.mark.parametrize("arch", F.ARCHS)
def test_no_weight_gather_is_larger_than_a_layer(runs, arch):
    """Over the data axis, the step's first all-gathers are the leaves
    outside the stacks, each once (the embedding; Zamba2's shared
    block); every later one is one layer's leaf, none larger than one
    layer's largest stacked leaf, which is gathered (its whole stack,
    which the step gathered before it gathered layer by layer, is
    ``LAYERS`` times that)."""
    run = runs["fake"][arch]
    ag = _data_gathers(run)
    whole = sorted(run["whole"].values())
    assert sorted(ag[:len(whole)]) == whole
    largest = max(b for b, _ in run["layered"].values())
    assert max(ag[len(whole):]) == largest


@pytest.mark.parametrize("arch", F.ARCHS)
def test_weight_gathers_per_microbatch(runs, arch):
    """The data axis's all-gathers: one a leaf outside the stacks a step,
    and, a microbatch, forward + recompute (remat full) x layers x
    layer-gathered leaves; a Zamba2 Mamba2 leaf counts its groups x
    layers."""
    run = runs["fake"][arch]
    n = run["microbatches"]
    per_mb = 2 * sum(k for _, k in run["layered"].values())
    assert len(_data_gathers(run)) == len(run["whole"]) + n * per_mb
    assert per_mb > 0


def test_collective_marginal_of_an_fsdp_dense_train_layer(runs):
    """One more layer of deepseek-67b's smoke config (D 64, 4 heads of 16
    over 2 kv heads, d_ff 128, bf16) under FSDP on (data 2, model 2), n
    = 4 microbatches of b = 16 / (4 x 2) = 2 rows of S = 64 tokens,
    adds, in result bytes (beside ``tests/test_torch_dryrun.py::
    test_collective_marginal_of_a_dense_train_layer``, its ZeRO-1 form):

    - per microbatch, the layer's sequence-parallel collectives, as under
      ZeRO-1: all-gathers of (b, S, D) bf16 = 16384 B, two in the
      forward, two in the recompute, two in the backward: 6;
      reduce-scatters of (b, S / 2, D) = 8192 B: 5 (the recompute stops
      before the MLP's output projection);
    - per microbatch, the layer's weights all-gathered over data in bf16,
      whole over data and the rank's model block, in the forward and
      again in the recompute: wq (D, 2 local heads, 16), wk and wv (D, 2
      kv heads, 16), wo (2, 16, D) 4096 B each, wi, wg (D, 64) and wo
      (64, D) 8192 B each: 7 gathers of 40960 B, twice;
    - per microbatch, each of those weights' f32 gradient reduce-scattered
      over data into the optimizer's layout from the backward, one layer
      at a time: 4 x 4096 / 2 x 2 + 3 x 8192 / 2 x 2 = 40960 B in 7; wk
      and wv (replicated over model) then all-reduced over model, 4096 B
      each in 2; the two norm scales (64 f32, outside the gather) summed
      over data and model with their stacks, 256 B each, no new
      collective;
    - per step, nothing from the optimizer: under FSDP the params keep
      the master's layout (ZeRO-1 gathers each weight, 40960 B).

    All-gathers +4 x (6 + 14) = 80 for 4 x (6 x 16384 + 2 x 40960) =
    720896 B (ZeRO-1: 24 for 434176); reduce-scatters +4 x (5 + 7) = 48
    for 4 x (5 x 8192 + 40960) = 327680 B (ZeRO-1: 20, the same bytes);
    all-reduces +4 x 2 = 8 for 4 x 8704 = 34816 B (ZeRO-1: 0, the same
    bytes)."""
    a = runs["fake"]["deepseek-67b L1"]["collectives"]
    b = runs["fake"]["deepseek-67b L2"]["collectives"]
    ops = ("all-gather", "reduce-scatter", "all-reduce")
    assert {op: b["_counts"].get(op, 0) - a["_counts"].get(op, 0)
            for op in ops} == {"all-gather": 80, "reduce-scatter": 48,
                               "all-reduce": 8}
    assert {op: b.get(op, 0) - a.get(op, 0) for op in ops} == {
        "all-gather": 4 * (6 * 16384 + 2 * 40960),
        "reduce-scatter": 4 * (5 * 8192 + 40960),
        "all-reduce": 4 * 8704}
