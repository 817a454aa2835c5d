"""Rank functions of the port's multi-process tests (gloo on the CPU).

``torch.multiprocessing.spawn`` pickles its function by reference, so the
functions live in this importable module.  Every rank joins through a
``file://`` store (no TCP port: the suite runs several workers at once)
with one thread, does its part and writes what the test reads into
``out_dir``; the assertions are the test's.  Nothing here imports jax.
"""
import dataclasses
import json
import math
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim.compression import make_compressed_allreduce
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import (Sharding, axis_index,
                                           axis_rules, gather, make_rules)
from repro_torch.training.train_step import (make_train_state,
                                             make_train_step,
                                             state_shardings, value_and_grad)
from repro_torch.tree import keystr, leaves, leaves_with_path, unflatten

#: the global batch of the step cases: 8 rows (one a rank and microbatch
#: on four data-parallel ranks with two microbatches) of 16 tokens
STEP_B, STEP_S = 8, 16
STEP_TRAIN = dict(learning_rate=1e-3, warmup_steps=1)
#: an arch name with this suffix takes one MoE dispatch group a
#: data-parallel rank (``num_groups=0``, resolved to dp): each rank routes
#: its own groups, where the smoke config's one group spans the ranks
GROUPS = "+groups"


def step_config(arch: str, dp: int):
    """The f32 smoke config of a step case, resolved for ``dp``."""
    cfg = get_config(arch.removesuffix(GROUPS), smoke=True)
    if arch.endswith(GROUPS):
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, num_groups=0))
    return dataclasses.replace(cfg, dtype="float32").resolve(tp=1, dp=dp)


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def step_batch(cfg, seed: int = 0) -> dict:
    """The global batch: tokens and labels, for ``vlm`` vision embeds and
    a loss mask that keeps a different share of each row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (STEP_B, STEP_S + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
             "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.as_tensor(
            0.02 * rng.standard_normal(
                (STEP_B, cfg.num_frontend_tokens, cfg.d_model)),
            dtype=torch.float32)
        keep = np.linspace(0.1, 0.9, STEP_B)[:, None]
        batch["loss_mask"] = torch.as_tensor(
            rng.random((STEP_B, STEP_S)) < keep, dtype=torch.float32)
    return batch


def step_cases(rank, world, store, shape, axes, cases, out_dir):
    """For each (arch, fsdp, microbatches): two steps of the sharded step
    on the mesh and of the unsharded one on the global batch from the
    same state.  Rank 0 writes both whole states and, per parameter leaf,
    the elements whose global-batch gradient stayed above 1e-3 of the
    leaf's largest at both steps (``<case>.npz``); every rank writes its
    metrics and its leaves' local shapes."""
    _join(rank, world, store)
    mesh = make_mesh(shape, axes, "cpu")
    dp_axes = tuple(a for a in axes if a != "model")
    dp = math.prod(n for a, n in zip(axes, shape) if a != "model")
    report = {}
    for arch, fsdp, nmb in cases:
        name = f"{arch}-{'fsdp' if fsdp else 'zero1'}-mb{nmb}"
        cfg = step_config(arch, dp)
        tcfg = TrainConfig(microbatches=nmb, **STEP_TRAIN)
        rules = make_rules(mesh, mode="train", fsdp=fsdp, zero1=True,
                           dp_axes=dp_axes)
        ref = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                               "cpu")
        state = make_train_state(cfg, tcfg,
                                 torch.Generator().manual_seed(0), "cpu",
                                 rules=rules)
        shapes = {keystr(p): list(x.shape)
                  for p, x in leaves_with_path(state)}
        batch = step_batch(cfg)
        plain, sharded = make_train_step(cfg, tcfg), \
            make_train_step(cfg, tcfg, rules)
        metrics, keep = [], None
        for _ in range(2):
            g = [x.abs() for x in leaves(
                value_and_grad(cfg, ref["params"], batch)[2])]
            big = [x > 1e-3 * x.max() for x in g]
            keep = big if keep is None else [a & b for a, b in zip(keep, big)]
            ref, m0 = plain(ref, batch)
            state, m1 = sharded(state, batch)
            metrics.append({k: [float(m0[k]), float(m1[k])] for k in m0})
        whole = gather(state, state_shardings(cfg, rules))
        if rank == 0:
            arrays = {}
            for tag, tree in (("ref", ref), ("got", whole)):
                for p, x in leaves_with_path(tree):
                    arrays[f"{tag}{keystr(p)}"] = x.numpy()
            for (p, _), k in zip(leaves_with_path(ref["params"]), keep):
                arrays[f"keep{keystr(p)}"] = k.numpy()
            np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
        report[name] = {"shapes": shapes, "metrics": metrics}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def misc(rank, world, store, out_dir, grads, residuals, pipe):
    """Eight ranks: the compressed all-reduce on a (4, 2) pod x data mesh
    (a pod-replicated gradient, then ``grads[p]`` / ``residuals[p]`` on
    pod p), GPipe over a (4, 2) stage x rep mesh, and an elastic save on
    a (4, 2) data x model mesh restored onto (2, 4) with ``("model",
    None)``."""
    _join(rank, world, store)
    out = {}
    # compressed all-reduce
    mesh = make_mesh((4, 2), ("pod", "data"), "cpu")
    fn = make_compressed_allreduce(mesh, axis_name="pod")
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.standard_normal((16, 32)),
                              dtype=torch.float32)}
    mean, res = fn(g, {"w": torch.zeros(16, 32)})
    out["replicated"] = {
        "err": float((mean["w"] - g["w"]).abs().max()),
        "scale": float(g["w"].abs().max()) / 127.0,
        "res": float(res["w"].abs().max())}
    p = axis_index(mesh, ("pod",))
    # a transposed view, as autograd hands some gradients over
    g_t = torch.as_tensor(np.ascontiguousarray(grads[p].T)).t()
    assert not g_t.is_contiguous()
    mean, res = fn({"w": g_t}, {"w": torch.as_tensor(residuals[p])})
    np.savez(os.path.join(out_dir, f"compressed{rank}.npz"), pod=p,
             mean=mean["w"].numpy(), res=res["w"].numpy())
    # GPipe
    ws, xs = pipe
    stage_mesh = make_mesh((4, 2), ("stage", "rep"), "cpu")
    y = pipeline_apply(stage_mesh, lambda w, h: torch.tanh(h @ w),
                       torch.as_tensor(ws), torch.as_tensor(xs))
    np.save(os.path.join(out_dir, f"pipeline{rank}.npy"), y.numpy())
    # elastic: save under one mesh, restore under another
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = make_mesh((4, 2), ("data", "model"), "cpu")
    s1 = Sharding(mesh1, ("data", "model"))
    w1 = s1.local(w)
    full = s1.gather(w1)
    ck_dir = os.path.join(out_dir, "elastic")
    if rank == 0:
        Checkpointer(ck_dir, use_async=False).save(5, {"w": full},
                                                   blocking=True)
    dist.barrier()
    mesh2 = make_mesh((2, 4), ("data", "model"), "cpu")
    s2 = Sharding(mesh2, ("model", None))
    r = Checkpointer(ck_dir, use_async=False).restore(
        {"w": torch.empty(8, 8, device="meta")}, device="cpu",
        shardings={"w": s2})
    m = axis_index(mesh2, ("model",))
    out["elastic"] = {
        "shard1": list(w1.shape), "shard2": list(r["w"].shape),
        "exact": bool(torch.equal(r["w"], w[2 * m:2 * m + 2])),
        "gathered": bool(torch.equal(s2.gather(r["w"]), w))}
    with open(os.path.join(out_dir, f"misc{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def remat_backward(rank, world, store, out_dir, archs):
    """Two data-parallel ranks, for each arch: the gradients of this
    rank's rows of the global batch with ``remat="full"``, the forward
    under the rules and the backward (and with it the recompute) on a
    thread of its own after the rules' context is left, as autograd runs
    a CUDA backward; against ``remat="none"`` with the backward on this
    thread inside the context.  Writes the largest difference over each
    leaf's largest value, or the error the backward raised."""
    _join(rank, world, store)
    rules = make_rules(make_mesh((2, 1), ("data", "model"), "cpu"),
                       mode="train", fsdp=False)
    out = {}
    for arch in archs:
        base = step_config(arch, world)
        per = STEP_B // world
        mb = {k: v.narrow(0, rank * per, per)
              for k, v in step_batch(base).items()}
        grads = {}
        for remat in ("none", "full"):
            cfg = dataclasses.replace(base, remat=remat)
            params = M.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            xs = [p.detach().requires_grad_() for p in leaves(params)]
            res = {}

            def backward(loss):
                try:
                    res["g"] = torch.autograd.grad(loss, xs,
                                                   allow_unused=True)
                except Exception as e:  # reported, not raised
                    res["error"] = f"{type(e).__name__}: {e}"[:300]

            with axis_rules(rules), torch.enable_grad():
                loss, _ = M.train_forward(unflatten(params, xs), cfg, mb)
                if remat == "none":
                    backward(loss)
            if remat == "full":
                t = threading.Thread(target=backward, args=(loss,))
                t.start()
                t.join()
            grads[remat] = res
        if "error" in grads["none"] or "error" in grads["full"]:
            out[arch] = {"error": grads["full"].get(
                "error", grads["none"].get("error"))}
            continue
        worst = 0.0
        for a, b in zip(grads["full"]["g"], grads["none"]["g"]):
            if b is None:
                assert a is None
                continue
            worst = max(worst, float((a - b).abs().max()
                                     / b.abs().max().clamp_min(1e-30)))
        out[arch] = {"drift": worst}
    with open(os.path.join(out_dir, f"remat{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
