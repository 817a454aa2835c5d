"""Processes of ``tests/test_torch_fsdp_layers.py``: the gloo ranks'
functions (spawned; ``torch.multiprocessing`` pickles them by reference)
and the fake group's process (a fake process group must not share a
process with another group).  Nothing here imports jax.

:func:`gloo_cases` and :func:`one_rank` run the FSDP step on gloo.

``python tests/_torch_dist_fsdp.py OUT``: rank 0 of a fake four-rank
group on a (data 2, model 2) mesh runs one FSDP train step of each arch
of :data:`ARCHS` (its smoke config, bf16, :data:`LAYERS` layers, a
TRAIN_TINY batch of 16 x 64 tokens in 4 microbatches) through
``launch.specs.build_cell`` / ``lower_cell``, and deepseek-67b's at depth
1 and 2 for the marginal, with FSDP set (``build_cell(fsdp=True)``: by
``specs.use_fsdp`` the smoke configs, far below 8 B parameters, are
ZeRO-1).  It writes, a run, every
collective's op, group (``data`` or ``model``) and result bytes in call
order, the counts' ``collective_bytes``, and the layouts the test needs:
each layer-gathered leaf's one-layer bytes as the forward takes it and
its number of layers, and each other data-split leaf's bytes.
"""
import dataclasses
import json
import math
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch import specs
from repro_torch.launch.counts import COLLECTIVES, collective_bytes
from repro_torch.tree import keystr, leaves_with_path

MESH = ((2, 2), ("data", "model"))
TRAIN_TINY = ShapeSpec("train_tiny", "train", 64, 16)
#: a family each: dense, moe (a dispatch group a data-parallel rank, so
#: no activation rows are gathered over the data axis), vlm, ssm, hybrid
#: (two groups of two Mamba2 layers) and encdec
ARCHS = ("deepseek-67b", "qwen3-moe-30b-a3b", "qwen2-vl-7b", "mamba2-1.3b",
         "zamba2-2.7b", "seamless-m4t-medium")
LAYERS = 4


#: the gloo step cases: a family each, FSDP, two microbatches, two steps
GLOO_ARCHS = ("deepseek-67b", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
              "mamba2-1.3b", "zamba2-2.7b", "seamless-m4t-medium")
#: the one-rank cases: (arch, remat, dtype) of the step with its real
#: backward against the single-device step, bit for bit
ONE_RANK = tuple((a, "full", "float32") for a in GLOO_ARCHS) + (
    ("deepseek-67b", "full", "bfloat16"), ("deepseek-67b", "dots", "bfloat16"),
    ("deepseek-67b", "none", "bfloat16"),
    ("qwen3-moe-30b-a3b", "full", "bfloat16"),
    ("zamba2-2.7b", "dots", "float32"))


def gloo_cases(rank, world, store, shape, axes, out_dir):
    """``_torch_dist._tp_cases`` of GLOO_ARCHS with FSDP (two steps on
    the mesh, each against the single-device step from the same state,
    and one microbatch's gradients), and two steps of each on the
    single-device step's gradients (``testing.sharded_step_parity``);
    every rank writes its report (``rank<r>.json``)."""
    import os
    import torch.distributed as dist
    from _torch_dist import (STEP_S, STEP_TRAIN, _join, _tp_cases,
                             step_batch, step_config, train_state)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import sharded_step_parity
    _join(rank, world, store)
    mesh = make_mesh(shape, axes, "cpu")
    sizes = dict(zip(axes, shape))
    report = _tp_cases(rank, mesh, [(a, True, 2, 2, STEP_S)
                                    for a in GLOO_ARCHS], out_dir)
    for arch in GLOO_ARCHS:
        cfg = step_config(arch, sizes["data"], sizes["model"])
        tcfg = TrainConfig(microbatches=2, **STEP_TRAIN)
        rules = make_rules(mesh, mode="train", fsdp=True)
        report[f"{arch}-fsdp-mb2"]["parity"] = sharded_step_parity(
            cfg, tcfg, rules, train_state(cfg, tcfg), step_batch(cfg))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def one_rank(rank, world, store, out_dir):
    """On a one-rank (data 1, model 1) gloo mesh, for each ONE_RANK case:
    two FSDP steps with their own backward (the layers gathered and their
    gradients reduced layer by layer) beside two single-device steps from
    the same state; writes whether every state leaf and every metric is
    equal bit for bit, and the leaves that are not."""
    import os
    import torch.distributed as dist
    from _torch_dist import STEP_TRAIN, _join, step_batch, step_config, \
        train_state
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import gather, make_rules
    from repro_torch.training.train_step import (layer_gathered,
                                                 make_train_step,
                                                 state_shardings)
    from repro_torch.tree import leaves
    _join(rank, world, store)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    rules = make_rules(mesh, mode="train", fsdp=True)
    out = {}
    for arch, remat, dtype in ONE_RANK:
        cfg = dataclasses.replace(step_config(arch, 1, 1), remat=remat,
                                  dtype=dtype)
        tcfg = TrainConfig(microbatches=2, **STEP_TRAIN)
        plain, sharded = train_state(cfg, tcfg), train_state(cfg, tcfg,
                                                             rules)
        batch = step_batch(cfg)
        p_step = make_train_step(cfg, tcfg)
        s_step = make_train_step(cfg, tcfg, rules)
        metrics = True
        for _ in range(2):
            plain, m0 = p_step(plain, batch)
            sharded, m1 = s_step(sharded, batch)
            metrics &= all(torch.equal(m0[k], m1[k]) for k in m0)
        whole = gather(sharded, state_shardings(cfg, rules))
        bad = [keystr(p) for (p, x), y in zip(leaves_with_path(plain),
                                              leaves(whole))
               if not torch.equal(x, y)]
        out[f"{arch}-{remat}-{dtype}"] = {
            "layered": len(layer_gathered(cfg, rules)), "metrics": metrics,
            "unequal": bad}
    with open(os.path.join(out_dir, "one_rank.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def config(arch: str):
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_groups=0))
    return cfg


class Recorder(TorchDispatchMode):
    """Every collective a run calls: (op, axis of its group, result
    bytes)."""

    def __init__(self, groups: dict):
        super().__init__()
        self.groups = groups
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d" and func._opname in COLLECTIVES:
            import torch.distributed as dist
            pg = next(dist.ProcessGroup.unbox(a) for a in args
                      if isinstance(a, torch.ScriptObject))
            res = args[0]
            res = res if isinstance(res, torch.Tensor) else res[0]
            res = res if isinstance(res, torch.Tensor) else res[0]
            self.calls.append([COLLECTIVES[func._opname],
                               self.groups.get(pg.group_name, "other"),
                               res.numel() * res.element_size()])
        return out


def layouts(cell) -> dict:
    """{"layered": {leaf: [one layer's bytes, layers]}, "whole": {leaf:
    bytes}}: the forward's layout of each layer-gathered leaf (a model
    block whole over data) and of every other leaf a data axis splits."""
    from repro_torch.training.train_step import (layer_gathered,
                                                 state_shardings)
    rules, cfg = cell.rules, cell.cfg
    layered = layer_gathered(cfg, rules)
    p_sh = dict(leaves_with_path(state_shardings(cfg, rules)["params"]))
    out = {"layered": {}, "whole": {}}
    for path, x in leaves_with_path(cell.args[0]["params"]):
        s = p_sh[path]
        block = list(x.shape)
        for d, ax in enumerate(s.parts(x.ndim)):
            if "data" in ax:
                block[d] *= 2
        nbytes = math.prod(block) * x.element_size()
        if path in layered:
            k = layered[path].k
            n = math.prod(block[:k])
            out["layered"][keystr(path)] = [nbytes // n, n]
        elif "data" in s.axes():
            out["whole"][keystr(path)] = nbytes
    return out


def run(mesh, groups, arch, layers: int) -> dict:
    cell = specs.build_cell(arch, TRAIN_TINY, mesh, cfg=config(arch),
                            overrides={"num_layers": layers,
                                       **({"enc_layers": layers}
                                          if arch.startswith("seamless")
                                          else {})},
                            tcfg_overrides={"microbatches": 4},
                            device="cpu", fsdp=True)
    rec = Recorder(groups)
    with rec:
        ran = specs.lower_cell(cell)()
    return {"calls": rec.calls, "collectives": collective_bytes(ran),
            "microbatches": cell.tcfg.microbatches, **layouts(cell)}


def main(out: str) -> None:
    from repro_torch.launch.dryrun_lib import fake_group
    torch.set_num_threads(1)
    res = {}
    with fake_group(*MESH, rank=0, device="cpu") as mesh:
        groups = {mesh.get_group(a).group_name: a for a in MESH[1]}
        for arch in ARCHS:
            res[arch] = run(mesh, groups, arch, LAYERS)
        for n in (1, 2):
            res[f"deepseek-67b L{n}"] = run(mesh, groups, "deepseek-67b", n)
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
