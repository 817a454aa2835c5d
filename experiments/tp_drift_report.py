#!/usr/bin/env python3
"""How far the tensor-parallel train step lands from the single-device
step, on gloo on the CPU.

For each ``("data", "model")`` / ``("pod", "data", "model")`` mesh of
``tests/test_torch_tensor_parallel.py`` and each of its archs (f32 smoke
configs resolved for the mesh, ZeRO-1, one and two microbatches), ranks
spawned on the CPU print three drifts against the single-device step of
the same resolved config, each the largest over the leaves of the
difference over the leaf's largest value:

- ``grads``: one microbatch's gradients at the same params;
- ``step``: each of two steps from the same state (m and v over every
  element, master and params over the elements whose gradient stayed
  above 1e-3 of the leaf's largest), what the tests hold;
- ``chained``: two steps of each, each from its own previous state, held
  as ``tests/test_torch_distributed.py`` holds the data-parallel step.

MLA and the Mamba2 families (``_torch_dist.LATENT_SSM_ARCHS``, one
microbatch, on the (1, 2), (2, 2) and (1, 4) meshes) print ``step`` as
their tests hold it (without the master and params of the leaves that
start at zero) and, for each step, those leaves' master and params
drift.

Then, for the cases of ``tests/_torch_dist.py::REF_STEPS``, each step of
the port's from the reference's state against the reference's own GSPMD
step on the same mesh (run in a child process with 8 host devices): the
state's drift as above and the metrics' largest relative difference.

Run from the repository root (~2.5 min, one thread a rank)::

    PYTHONPATH=src python3 experiments/tp_drift_report.py
"""
import json
import math
import os
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import _torch_dist as D  # noqa: E402

MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
ARCHS = ("deepseek-67b", "qwen1.5-32b", "qwen2-vl-7b", "qwen3-moe-30b-a3b",
         "qwen3-moe-30b-a3b" + D.GROUPS)
CASES = [(a, False, n, 2, D.STEP_S) for a in ARCHS for n in (1, 2)]
LATENT_MESHES = ("1x2", "2x2", "1x4")
LATENT_CASES = [(a, False, 1, 2, D.STEP_S) for a in D.LATENT_SSM_ARCHS]


def _chained(rank, mesh, arch, nmb) -> dict:
    """Two steps on the mesh and (rank 0) two of the single-device step,
    each chained from its own state: their drift after the second."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.parallel.sharding import gather, make_rules
    from repro_torch.training.train_step import (make_train_state,
                                                 make_train_step,
                                                 state_shardings)
    axes = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(axes, mesh.shape))
    dp_axes = tuple(a for a in axes if a != "model")
    cfg = D.step_config(arch, math.prod(sizes[a] for a in dp_axes),
                        sizes["model"])
    tcfg = TrainConfig(microbatches=nmb, **D.STEP_TRAIN)
    rules = make_rules(mesh, mode="train", fsdp=False, dp_axes=dp_axes)
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             "cpu", rules=rules)
    batch = D.step_batch(cfg)
    step = make_train_step(cfg, tcfg, rules)
    ref = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                           "cpu")
    plain, keep = make_train_step(cfg, tcfg), None
    for _ in range(2):
        state, _ = step(state, batch)
        if rank == 0:
            big = [x.abs() > 1e-3 * x.abs().max()
                   for x in D._step_grads(cfg, ref, batch, nmb)]
            keep = big if keep is None else [a & b for a, b in
                                             zip(keep, big)]
            ref, _ = plain(ref, batch)
    whole = gather(state, state_shardings(cfg, rules))
    return D._state_drift(whole, ref, keep) if rank == 0 else {}


def _rank(rank, world, store, mesh_name, shape, axes, out_dir):
    from repro_torch.launch.mesh import make_mesh
    D._join(rank, world, store)
    mesh = make_mesh(shape, axes, "cpu")
    latent = LATENT_CASES if mesh_name in LATENT_MESHES else []
    report = D._tp_cases(rank, mesh, CASES + latent, out_dir)
    for arch, _, nmb, _, _ in CASES:
        report[f"{arch}-zero1-mb{nmb}"]["chained"] = _chained(
            rank, mesh, arch, nmb)
    if rank == 0:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f)
    D.dist.destroy_process_group()


def _worst(drift: dict) -> str:
    kind, (value, leaf) = max(drift.items(), key=lambda kv: kv[1][0])
    return f"{value:.2e} ({kind} {leaf})"


def main() -> int:
    base = tempfile.mkdtemp(prefix="tp_drift_")
    ref_dir = os.path.join(base, "reference")
    os.makedirs(ref_dir)
    # the eight-device cases of the reference's steps
    names = [k for k, c in D.REF_STEPS.items()
             if int(np.prod(c["mesh"])) == 8]
    child, log = D.start_reference_steps(ref_dir, names)
    ctxs, dirs = [], {}
    for name, (shape, axes) in MESHES.items():
        d = os.path.join(base, name)
        os.makedirs(d)
        n = int(np.prod(shape))
        ctxs.append(mp.start_processes(
            _rank, args=(n, os.path.join(d, "store"), name, shape, axes,
                         d),
            nprocs=n, join=False, start_method="spawn"))
        dirs[name] = d
    if child.wait(timeout=600):
        with open(log) as f:
            print(f.read()[-4000:], file=sys.stderr)
        return 1
    against = os.path.join(base, "against")
    os.makedirs(against)
    ctxs.append(mp.start_processes(
        D.tp_against_reference,
        args=(8, os.path.join(against, "store"), ref_dir, against, names),
        nprocs=8, join=False, start_method="spawn"))
    for ctx in ctxs:
        while not ctx.join():
            pass
    print("mesh   case                                   grads     "
          "step (worst of two, from the same state)      chained")
    for name, d in dirs.items():
        with open(os.path.join(d, "report.json")) as f:
            report = json.load(f)
        for case, rep in report.items():
            grads = max(rep["grads"].values())
            step = max(rep["drift"], key=lambda s: max(v[0] for v in
                                                       s.values()))
            chained = _worst(rep["chained"]) if "chained" in rep else ""
            print(f"{name:6s} {case:38s} {grads:.2e}  {_worst(step):44s} "
                  f"{chained}")
            for i, drift in enumerate(rep.get("exempt_drift", [])):
                print(f"{'':45s} step {i}, the leaves that start at zero: "
                      f"{_worst(drift)}")
    print("\nagainst the reference's GSPMD step, each step from its state")
    with open(os.path.join(against, "ref0.json")) as f:
        report = json.load(f)
    for case, rep in report.items():
        with open(os.path.join(ref_dir, case, "metrics.json")) as f:
            want = json.load(f)
        for i, (drift, got, w) in enumerate(zip(rep["drift"],
                                                rep["metrics"], want)):
            metrics = max(abs(got[k] - v) / max(abs(v), 1e-30)
                          for k, v in w.items())
            print(f"{case:24s} step {i}  state {_worst(drift):44s} "
                  f"metrics {metrics:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
