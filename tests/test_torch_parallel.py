"""The port's logical-axis layer against the reference, in one process:
the params' and caches' logical trees, the rules, the specs, the argument
shardings of the train state, the decode cache and each cell's inputs on
(2, 4), (4, 2) and (2, 2, 4) meshes, the int8 quantiser, the config
additions, and the train step's refusals.

The reference's argument shardings need a real mesh, so they are computed
once in a child process with 16 forced host devices
(``tests/_torch_reference_sharding.py``); the port's come from its own
functions on an ``AbstractMesh`` (no process group).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.models import model as JM
from repro.optim import compression as JC
from repro.parallel import sharding as JS
from repro_torch.configs import base as TB
from repro_torch.launch import specs as TSPEC
from repro_torch.models import model as TM
from repro_torch.optim import compression as TC
from repro_torch.parallel import sharding as TS
from repro_torch.training.train_step import (make_train_step,
                                             state_shardings)
from repro_torch.tree import keystr, leaves_with_path

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = TB.available_archs()
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}
#: the layouts held per (mesh, arch): the train state without and with
#: FSDP, the decode cache, and the inputs of each shape cell
WHATS = ("state", "state-fsdp", "cache", "train_4k", "prefill_32k",
         "decode_32k")
MODES = ("train", "prefill", "decode")


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return tuple(tree)


def _variants(arch):
    """(label, config changes): the arch as it is, and with the int8 KV
    cache where the family keeps one."""
    out = [("", {})]
    if TB.get_config(arch).family in ("dense", "moe", "vlm"):
        out.append(("int8", {"kv_cache_dtype": "int8"}))
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_trees_match_reference(arch, smoke):
    """``params_logical`` / ``cache_logical``: the reference's keys and
    tuples, ``"layers"`` in front of stacked leaves (MLA's and the int8
    cache's included)."""
    for _, changes in _variants(arch):
        jc = dataclasses.replace(JB.get_config(arch, smoke=smoke),
                                 **changes).resolve(tp=1)
        tc = dataclasses.replace(TB.get_config(arch, smoke=smoke),
                                 **changes).resolve(tp=1)
        assert TM.params_logical(tc) == _norm(JM.params_logical(jc))
        assert TM.cache_logical(tc) == _norm(JM.cache_logical(jc))


def test_logical_trees_cover_every_leaf():
    """Every leaf of the params and of the cache has a tuple of its rank."""
    for arch in ARCHS:
        for _, changes in _variants(arch):
            cfg = dataclasses.replace(TB.get_config(arch, smoke=True),
                                      **changes).resolve(tp=1)
            params = TM.init_params(cfg, torch.Generator(), "meta")
            cache = TM.init_cache(cfg, 2, 16, device="meta")
            for tree, lg in ((params, TM.params_logical(cfg)),
                             (cache, TM.cache_logical(cfg))):
                TS.map_logical(lambda axes, x: None if len(axes) == x.ndim
                               else pytest.fail(f"{arch}: {axes} "
                                                f"{tuple(x.shape)}"),
                               lg, tree)


def _all_logical():
    """Every logical-axis tuple of the params, caches and inputs."""
    out = set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            out.add(tuple(t))
    for arch in ARCHS:
        cfg = TB.get_config(arch, smoke=True).resolve(tp=1)
        walk(TM.params_logical(cfg))
        walk(TM.cache_logical(cfg))
        for kind in MODES:
            walk(TSPEC.batch_logical(cfg, kind))
    # the optimizer's swap and the activations' names
    out |= {("opt_embed", "mlp"), ("batch", "residual_seq", None),
            ("groups", None, None), ("experts", "groups", None, None),
            ("batch", "act_seq", "vocab"), ("batch", "batch"),
            ("embed", "embed", "opt_embed")}
    return sorted(out, key=repr)


@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")],
                         ids=["data", "pod-data"])
@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "nozero1"])
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "nofsdp"])
@pytest.mark.parametrize("mode", MODES)
def test_rules_and_pspecs_match_reference(mode, fsdp, zero1, dp_axes):
    """``make_rules``' dict and ``logical_to_pspec`` of every logical
    tuple the framework uses (a mesh axis named twice kept once)."""
    jr = JS.make_rules(None, mode=mode, fsdp=fsdp, zero1=zero1,
                       dp_axes=dp_axes)
    tr = TS.make_rules(None, mode=mode, fsdp=fsdp, zero1=zero1,
                       dp_axes=dp_axes)
    assert tr.rules == jr.rules
    for axes in _all_logical():
        assert TS.logical_to_pspec(axes, tr) == \
            tuple(JS.logical_to_pspec(axes, jr)), axes
    assert TS.logical_to_pspec(("batch", None)) == ()   # no rules active
    with TS.axis_rules(tr):
        assert TS.current_rules() is tr
        assert TS.logical_to_pspec(("batch", None)) == \
            tuple(JS.logical_to_pspec(("batch", None), jr))
    assert TS.current_rules() is None


def _request(arch, mesh, what):
    shape, axes = MESHES[mesh]
    return {"arch": arch, "smoke": False, "dtype": None, "mesh": shape,
            "axes": axes, "fsdp": what == "state-fsdp",
            "what": "state" if what.startswith("state") else what}


def reference_layouts(requests):
    """The reference's layouts of ``requests`` (a child process)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_reference_sharding.py")],
        input=json.dumps(requests), capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout)


@pytest.fixture(scope="module")
def ref_layouts():
    keys = [(m, a, w) for m in MESHES for a in ARCHS for w in WHATS]
    got = reference_layouts([_request(a, m, w) for m, a, w in keys])
    return dict(zip(keys, got))


def port_layouts(req) -> dict:
    """The port's layouts of a request, as the reference helper's."""
    shape, axes = req["mesh"], req["axes"]
    mesh = TS.AbstractMesh(shape, axes)
    sizes = dict(zip(axes, shape))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    cfg = TB.get_config(req["arch"], smoke=req["smoke"])
    if req.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=req["dtype"])
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    cfg = cfg.resolve(tp=sizes.get("model", 1), dp=dp)
    what = req["what"]
    if what == "state":
        rules = TS.make_rules(mesh, mode="train", fsdp=req["fsdp"],
                              zero1=True, dp_axes=dp_axes)
        shardings = state_shardings(cfg, rules)
        tree = {"params": TM.init_params(cfg, torch.Generator(), "meta")}
        tree["opt"] = {"master": tree["params"], "m": tree["params"],
                       "v": tree["params"],
                       "step": torch.empty((), device="meta")}
    elif what == "cache":
        rules = TS.make_rules(mesh, mode="decode", fsdp=req["fsdp"],
                              dp_axes=dp_axes)
        tree = TM.init_cache(cfg, 8, 64, device="meta")
        shardings = TSPEC.tree_arg_shardings(tree, TM.cache_logical(cfg),
                                             rules)
    else:
        cell = TB.SHAPES[what]
        rules = TSPEC.rules_for(cfg, mesh, cell.kind)
        tree = TSPEC.input_specs(cfg, cell)
        shardings = TSPEC.tree_arg_shardings(
            tree, TSPEC.batch_logical(cfg, cell.kind), rules)
    out = {}
    for (path, x), (_, s) in zip(leaves_with_path(tree),
                                 leaves_with_path(shardings)):
        out[keystr(path)] = {
            "spec": [list(e) if isinstance(e, tuple) else e for e in s.spec],
            "shape": list(s.shard_shape(x.shape))}
    return out


@pytest.mark.parametrize("what", WHATS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_arg_shardings_match_reference(ref_layouts, mesh, arch, what):
    """``arg_sharding`` / ``tree_arg_shardings`` (and the train step's
    ``state_shardings``): every leaf's spec and shard shape equal the
    reference's at full width (a mesh axis dropped where it does not
    divide)."""
    want = ref_layouts[(mesh, arch, what)]
    got = port_layouts(_request(arch, mesh, what))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """``input_specs``: meta tensors of the reference's shapes and
    dtypes for every cell."""
    import jax
    jc = JB.get_config(arch).resolve(tp=1)
    tc = TB.get_config(arch).resolve(tp=1)
    from repro.launch import specs as JSPEC
    for name in TB.SHAPES:
        want = JSPEC.input_specs(jc, JB.SHAPES[name])
        got = TSPEC.input_specs(tc, TB.SHAPES[name])
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[1] == \
                jax.numpy.dtype(want[k].dtype).name
        assert TSPEC.use_fsdp(tc, "train") == JSPEC.use_fsdp(jc, "train")
        assert TSPEC.use_fsdp(tc, "decode") == JSPEC.use_fsdp(jc, "decode")


def test_config_additions_match_reference():
    """``MeshConfig``, ``ShapeSpec`` / ``SHAPES``, ``RunConfig`` and
    ``supported_shapes``, field for field."""
    assert {k: dataclasses.astuple(v) for k, v in TB.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JB.SHAPES.items()}
    for kw in ({}, {"pods": 2}, {"data": 4, "model": 2}):
        t, j = TB.MeshConfig(**kw), JB.MeshConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("axis_names", "shape", "dp_axes", "dp", "chips"):
            assert getattr(t, prop) == getattr(j, prop)
    assert [f.name for f in dataclasses.fields(TB.RunConfig)] == \
        [f.name for f in dataclasses.fields(JB.RunConfig)]
    run = TB.RunConfig(model=TB.get_config("mamba2-1.3b"))
    assert run.mesh == TB.MeshConfig() and run.train == TB.TrainConfig()
    for arch in ARCHS:
        assert [s.name for s in TB.supported_shapes(TB.get_config(arch))] \
            == [s.name for s in JB.supported_shapes(JB.get_config(arch))]


def test_shard_checks_rank_only_under_rules():
    x = torch.zeros(2, 3)
    assert TS.shard(x, "batch") is x             # no rules: no check
    rules = TS.make_rules(TS.AbstractMesh((2, 1), ("data", "model")),
                          mode="train", fsdp=False)
    with TS.axis_rules(rules):
        assert TS.shard(x, "batch", None) is x
        with pytest.raises(AssertionError):
            TS.shard(x, "batch")


REFUSAL_MESHES = {"1x2": ((1, 2), ("data", "model")),
                  "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def refusal_layouts():
    """The reference's train-state layouts of the smoke configs that a
    model axis above 1 once refused, on REFUSAL_MESHES (a child
    process)."""
    keys = [(m, a) for m in REFUSAL_MESHES
            for a in ("minicpm3-4b", "mamba2-1.3b", "zamba2-2.7b",
                      "seamless-m4t-medium")]
    got = reference_layouts([
        {"arch": a, "smoke": True, "dtype": None,
         "mesh": REFUSAL_MESHES[m][0], "axes": REFUSAL_MESHES[m][1],
         "fsdp": False, "what": "state"} for m, a in keys])
    return dict(zip(keys, got))


@pytest.mark.parametrize("arch,what", [
    ("minicpm3-4b", "MLA"), ("mamba2-1.3b", "'ssm' family"),
    ("zamba2-2.7b", "'hybrid' family"),
    ("seamless-m4t-medium", "'encdec' family")])
@pytest.mark.parametrize("shape,axes", [((1, 2), ("data", "model")),
                                        ((2, 2, 4), ("pod", "data",
                                                     "model"))])
def test_model_axis_above_one_is_refused(refusal_layouts, shape, axes, arch,
                                         what):
    """Tensor parallelism covers every family, and no model axis is
    refused by family any more: the step of MLA (minicpm3-4b), the
    ``ssm`` family (mamba2-1.3b), the ``hybrid`` family (zamba2-2.7b) and
    the ``encdec`` family (seamless-m4t-medium) is made under a model
    axis, its state in the reference's layouts (every leaf's spec and
    shard shape)."""
    cfg = TB.get_config(arch, smoke=True).resolve(tp=shape[-1])
    mesh = TS.AbstractMesh(shape, axes)
    rules = TS.make_rules(mesh, mode="train", fsdp=False,
                          dp_axes=tuple(a for a in axes if a != "model"))
    TM.check_tp(cfg, shape[-1])
    make_train_step(cfg, TB.TrainConfig(), rules)
    name = "1x2" if shape == (1, 2) else "2x2x4"
    assert port_layouts({"arch": arch, "smoke": True, "dtype": None,
                         "mesh": shape, "axes": axes, "fsdp": False,
                         "what": "state"}) == refusal_layouts[(name, arch)]


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            make_production_mesh(multi_pod=multi, device="cpu")


@pytest.mark.parametrize("case", ["normal", "wide", "tiny", "zeros"])
def test_quantize_matches_reference(case):
    """``quantize`` / ``dequantize`` bit for bit (round half to even)."""
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal((16, 32)),
         "wide": rng.standard_normal((8, 8)) * np.logspace(-6, 3, 8),
         "tiny": rng.standard_normal(64) * 1e-14,
         "zeros": np.zeros(10)}[case].astype(np.float32)
    jq, js = JC.quantize(jnp.asarray(x))
    tq, ts = TC.quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TC.dequantize(tq, ts).numpy(),
                                  np.asarray(JC.dequantize(jq, js)))
