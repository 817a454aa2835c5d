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
import subprocess
import sys
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
                                           axis_rules, axis_size, gather,
                                           make_rules)
from repro_torch.training.train_step import (make_train_state,
                                             make_train_step,
                                             state_shardings, value_and_grad)
from repro_torch.tree import (keystr, leaves, leaves_with_path, tree_map,
                              unflatten)

#: the global batch of the step cases: 8 rows (one a rank and microbatch
#: on four data-parallel ranks with two microbatches) of 16 tokens; an
#: ``encdec`` batch's STEP_ENC encoder frames (not STEP_S, which would hide
#: a swapped sequence)
STEP_B, STEP_S, STEP_ENC = 8, 16, 8
STEP_TRAIN = dict(learning_rate=1e-3, warmup_steps=1)
#: an arch name with this suffix takes one MoE dispatch group a
#: data-parallel rank (``num_groups=0``, resolved to dp): each rank routes
#: its own groups, where the smoke config's one group spans the ranks
GROUPS = "+groups"
#: MLA and the Mamba2 families (the local heads of ``wuq`` / ``wukv``, the
#: ``ssm_inner`` channels and heads, Zamba2's shared block)
LATENT_SSM_ARCHS = ("minicpm3-4b", "mamba2-1.3b", "zamba2-2.7b")


def step_config(arch: str, dp: int, tp: int = 1):
    """The f32 smoke config of a step case, resolved for ``tp`` and
    ``dp``."""
    cfg = get_config(arch.removesuffix(GROUPS), smoke=True)
    if arch.endswith(GROUPS):
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, num_groups=0))
    return dataclasses.replace(cfg, dtype="float32").resolve(tp=tp, dp=dp)


def train_state(cfg, tcfg, rules=None) -> dict:
    """``make_train_state`` from seed 0 on the CPU, Zamba2's LoRA ``qb`` /
    ``ib`` seeded nonzero in the params and the master
    (``testing.seed_lora``: at init they add exactly 0), then this
    rank's shards under ``rules``."""
    from repro_torch.parallel.sharding import place
    from repro_torch.testing import seed_lora
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             "cpu")
    if cfg.family == "hybrid":
        seed_lora(state["params"], cfg)
        for name in ("qb", "ib"):
            state["opt"]["master"]["lora"][name].copy_(
                state["params"]["lora"][name])
    return state if rules is None else place(state,
                                             state_shardings(cfg, rules))


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def step_batch(cfg, seed: int = 0, S: int = STEP_S) -> dict:
    """The global batch of STEP_B rows of ``S`` tokens: tokens and
    labels, for ``vlm`` vision embeds and a loss mask that keeps a
    different share of each row, for ``encdec`` STEP_ENC normal f32
    encoder frames (nonzero: zero frames make the cross-attention's
    gradients vacuous)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (STEP_B, S + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
             "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.as_tensor(
            0.02 * rng.standard_normal(
                (STEP_B, cfg.num_frontend_tokens, cfg.d_model)),
            dtype=torch.float32)
        keep = np.linspace(0.1, 0.9, STEP_B)[:, None]
        batch["loss_mask"] = torch.as_tensor(
            rng.random((STEP_B, S)) < keep, dtype=torch.float32)
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.as_tensor(
            rng.standard_normal((STEP_B, STEP_ENC, cfg.d_model)),
            dtype=torch.float32)
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


# ----------------------------------------------------------------------
# tensor parallelism over the model axis
def _record_kernel_shapes() -> dict:
    """Wrap the models' flash attention, ``gmm`` and SSD to record the
    shapes each is called with on this rank: {"flash": {(q, k, v)},
    "gmm": {(x, w)}, "ssd": {(x, dt, A, B)}}."""
    from repro_torch.models import attention as A, hybrid, moe, ssm
    seen = {"flash": set(), "gmm": set(), "ssd": set(), "on": False}
    flash, gmm, ssd = A.flash_attention, moe.gmm, ssm.ssd

    def rec_flash(q, k, v, **kw):
        if seen["on"]:
            seen["flash"].add((tuple(q.shape), tuple(k.shape),
                               tuple(v.shape)))
        return flash(q, k, v, **kw)

    def rec_gmm(x, w):
        if seen["on"]:
            seen["gmm"].add((tuple(x.shape), tuple(w.shape)))
        return gmm(x, w)

    def rec_ssd(x, dt, A_, Bm, Cm, **kw):
        if seen["on"]:
            seen["ssd"].add(tuple(tuple(t.shape) for t in (x, dt, A_, Bm)))
        return ssd(x, dt, A_, Bm, Cm, **kw)

    A.flash_attention = hybrid.flash_attention = rec_flash
    moe.gmm, ssm.ssd = rec_gmm, rec_ssd
    return seen


def _recording(seen: dict, fn):
    """``fn`` with the shapes recorded only while it runs."""
    def run(*args):
        seen["on"] = True
        try:
            return fn(*args)
        finally:
            seen["on"] = False
    return run


def tp_step_cases(rank, world, store, shape, axes, cases, out_dir):
    """``_tp_cases`` on a mesh of ``shape`` named ``axes``; every rank
    writes its report (``rank<r>.json``)."""
    _join(rank, world, store)
    mesh = make_mesh(shape, axes, "cpu")
    report = _tp_cases(rank, mesh, cases, out_dir)
    if math.prod(shape[:-1]) == 1:
        report["aux piece"] = _aux_piece(mesh)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def _aux_piece(mesh) -> dict:
    """On a (1, tp) data x model mesh: the MoE layer's aux loss alone, its
    input gathered from each model rank's block of the sequence
    (``gather_seq``), against the unsplit layer's.  Returns the largest
    differences, over the unsplit gradient's largest, of the router's
    gradient summed over the model ranks (a replicated leaf's, as the
    step sums it) and of this rank's block of the input's gradient.
    Every model rank computes the aux loss in full, so each must enter
    the backward at 1 / tp (``parallel.sharding.replicated_term``); at 1
    the sums would count it tp times."""
    from repro_torch.models.moe import init_moe, moe_ffn
    from repro_torch.parallel.sharding import gather_seq
    tp = mesh.shape[-1]
    rules = make_rules(mesh, mode="train", fsdp=False)
    cfg = step_config("qwen3-moe-30b-a3b", 1, tp)
    p = init_moe(cfg, torch.Generator().manual_seed(3), "cpu")
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    r = axis_index(mesh, ("model",))
    El, Sl = cfg.moe.num_experts // tp, x.shape[1] // tp
    grads = {}
    for split in (False, True):
        q = {k: (v if k == "router" or not split
                 else v[r * El:(r + 1) * El]).clone().requires_grad_()
             for k, v in p.items()}
        xb = (x[:, r * Sl:(r + 1) * Sl] if split else x).clone() \
            .requires_grad_()
        with axis_rules(rules if split else None):
            aux = moe_ffn(q, cfg, gather_seq(xb))[1]
        aux.backward()
        grads[split] = (q["router"].grad, xb.grad)
    (rw, xw), (rg, xg) = grads[False], grads[True]
    dist.all_reduce(rg)
    return {"router grad": _rel(rg, rw),
            "input grad": _rel(xg, xw[:, r * Sl:(r + 1) * Sl])}


def _tp_cases(rank, mesh, cases, out_dir) -> dict:
    """For each (arch, fsdp, microbatches, steps, S): ``steps`` steps of
    the step on ``mesh`` (``step_batch`` of S tokens a row), its config
    resolved for the mesh's model and data-parallel sizes.  Before the
    first step, rank 0 holds the gradients of one microbatch on the mesh
    against the single-device ones at the same params; before each step
    it gathers the state and runs the single-device step of that config
    on the global batch from it, and holds the step on the mesh to it
    (:func:`_state_drift`; master and params on the elements whose
    gradient, the step's, stayed above 1e-3 of the leaf's largest at
    every step so far).  Returns, a case: the gradients' and each
    step's drift (rank 0), every rank's metrics (rank 0's beside the
    single-device step's), its leaves' local shapes and the shapes its
    flash attention, ``gmm`` and SSD calls took (in the gradients' pass
    and the steps').  For LATENT_SSM_ARCHS the master and params of
    the leaves that start at zero (Mamba2's conv biases) are left out of
    ``drift``: such a master is nothing but the sum of AdamW's updates
    m / (sqrt(v) + eps), which turn TP's last-bit gradient differences
    into up to 1.5e-5 of its largest where an element's |g| is a few
    eps or its m nearly cancels (ROADMAP Queue 3 item 29).  Their report
    adds ``exempt``, those leaves' names, ``exempt_drift``, each step's
    master and params drift over them alone (their m and v stay in
    ``drift``), and
    ``parity``: ``testing.sharded_step_parity``'s two steps of the step
    on the mesh handed the single-device step's gradients, from the same
    first state."""
    seen = _record_kernel_shapes()
    axes = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(axes, mesh.shape))
    dp_axes = tuple(a for a in axes if a != "model")
    dp = math.prod(sizes[a] for a in dp_axes)
    report = {}
    for arch, fsdp, nmb, steps, S in cases:
        name = f"{arch}-{'fsdp' if fsdp else 'zero1'}-mb{nmb}"
        cfg = step_config(arch, dp, sizes["model"])
        tcfg = TrainConfig(microbatches=nmb, **STEP_TRAIN)
        rules = make_rules(mesh, mode="train", fsdp=fsdp, zero1=True,
                           dp_axes=dp_axes)
        sh = state_shardings(cfg, rules)
        state = train_state(cfg, tcfg, rules)
        shapes = {keystr(p): list(x.shape)
                  for p, x in leaves_with_path(state)}
        batch = step_batch(cfg, S=S)
        sharded = _recording(seen, make_train_step(cfg, tcfg, rules))
        plain = make_train_step(cfg, tcfg)
        for k in ("flash", "gmm", "ssd"):
            seen[k].clear()
        rep = {"shapes": shapes, "metrics": [], "drift": []}
        rep["grads"] = _grad_drift(cfg, rules, state, sh, batch, rank, seen)
        for _ in range(steps):
            # a copy: a leaf no rank splits is gathered as itself, and
            # both steps write their state in place
            whole = tree_map(torch.clone, gather(state, sh))
            state, m1 = sharded(state, batch)
            row = {k: [None, float(v)] for k, v in m1.items()}
            after = gather(state, sh)
            if rank == 0:
                big = [x.abs() > 1e-3 * x.abs().max()
                       for x in _step_grads(cfg, whole, batch, nmb)]
                if not rep["drift"]:
                    zero = [arch in LATENT_SSM_ARCHS and not x.any()
                            for x in leaves(whole["opt"]["master"])]
                keep = big if not rep["drift"] else [
                    a & b for a, b in zip(keep, big)]
                ref, m0 = plain(whole, batch)
                for k in row:
                    row[k][0] = float(m0[k])
                rep["drift"].append(_state_drift(
                    after, ref, [k & (not z) for k, z in zip(keep, zero)]))
                if any(zero):
                    rep["exempt"] = [keystr(p) for (p, _), z in zip(
                        leaves_with_path(ref["params"]), zero) if z]
                    rep.setdefault("exempt_drift", []).append({
                        kind: _state_drift(after, ref, [
                            k & z for k, z in zip(keep, zero)])[kind]
                        for kind in ("master", "params")})
            rep["metrics"].append(row)
        rep["kernels"] = {k: sorted(seen[k]) for k in ("flash", "gmm",
                                                        "ssd")}
        if arch in LATENT_SSM_ARCHS:
            from repro_torch.testing import sharded_step_parity
            rep["parity"] = sharded_step_parity(
                cfg, tcfg, rules, train_state(cfg, tcfg), batch)
        report[name] = rep
    return report


def _grad_drift(cfg, rules, state, sh, batch, rank, seen=None):
    """Rank 0: the largest difference of one microbatch's gradient on the
    mesh (this rank's rows; each leaf summed over the data-parallel ranks
    and, replicated over ``model``, over it, or gathered over it) from
    the single-device gradient of the global batch at the same params,
    over the leaf's largest: {leaf: drift}.  With ``seen`` the mesh's
    pass records its kernels' shapes (:func:`_record_kernel_shapes`)."""
    from repro_torch.parallel.sharding import MODEL, axis_group
    p_sh = sh["params"]
    params = gather(state["params"], p_sh)
    dp_axes = rules.batch_axes
    per = STEP_B // axis_size(rules.mesh, dp_axes)
    r = axis_index(rules.mesh, dp_axes)
    mb = {k: v.narrow(0, r * per, per) for k, v in batch.items()}
    mine = tree_map(lambda x, s: s.without(dp_axes).local(x), params, p_sh)
    with axis_rules(rules):
        g = (value_and_grad if seen is None
             else _recording(seen, value_and_grad))(cfg, mine, mb)[2]
    want = value_and_grad(cfg, params, batch)[2]
    out = {}
    for (p, x), s, w in zip(leaves_with_path(g), leaves(p_sh),
                            leaves(want)):
        if MODEL in s.axes():
            x = s.without(dp_axes).gather(x)
            dist.all_reduce(x, group=axis_group(rules.mesh, dp_axes))
        else:
            dist.all_reduce(x)
        out[keystr(p)] = _rel(x, w)
    return out if rank == 0 else {}


def _state_drift(got: dict, want: dict, keep: list) -> dict:
    """Per kind, the largest difference of ``got``'s train state from
    ``want``'s over each leaf's largest value, with the leaf: ``m`` and
    ``v`` over every element, ``master`` and ``params`` over the
    elements in ``keep`` (each leaf's)."""
    out = {}
    for kind in ("m", "v", "master", "params"):
        a = got["params"] if kind == "params" else got["opt"][kind]
        b = want["params"] if kind == "params" else want["opt"][kind]
        worst = (0.0, "")
        for (p, x), y, k in zip(leaves_with_path(a), leaves(b), keep):
            if kind in ("master", "params"):
                x, y = x[k], y[k]
            if x.numel():
                worst = max(worst, (_rel(x.float(), y.float()), keystr(p)))
        out[kind] = worst
    return out


def _step_grads(cfg, state, batch, n: int):
    """The gradient the single-device step takes: the mean of its ``n``
    microbatches' (a loss mask weighs each microbatch's mean by its own
    count, so this is not the whole batch's gradient)."""
    B = next(iter(batch.values())).shape[0]
    acc = None
    for i in range(n):
        mb = {k: v.narrow(0, i * (B // n), B // n) for k, v in batch.items()}
        g = value_and_grad(cfg, state["params"], mb)[2]
        acc = g if acc is None else [a + b for a, b in zip(leaves(acc),
                                                           leaves(g))]
    return [a / n for a in leaves(acc)]


def tp_reference_case(rank, world, store, out_dir):
    """Eight ranks, the reference's own multi-device case
    (``tests/test_distributed.py::test_sharded_train_step_runs``):
    deepseek-67b's smoke config resolved for tp 4, dp 2 on a (2, 4) data
    x model mesh, FSDP, 2 microbatches, 8 x 32 tokens, four steps; in f32
    on ``step_batch`` beside the single-device step (``_tp_cases``), and
    as the reference runs it, bf16 on a batch of ones with the default
    TrainConfig (its total loss a step)."""
    _join(rank, world, store)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    report = _tp_cases(rank, mesh, [("deepseek-67b", True, 2, 4, 32)],
                       out_dir)
    cfg = get_config("deepseek-67b", smoke=True).resolve(tp=4, dp=2)
    tcfg = TrainConfig(microbatches=2)
    rules = make_rules(mesh, mode="train", fsdp=True, dp_axes=("data",))
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             "cpu", rules=rules)
    step = make_train_step(cfg, tcfg, rules)
    ones = torch.ones((8, 32), dtype=torch.int32)
    losses = []
    for _ in range(4):
        state, m = step(state, {"tokens": ones, "labels": ones})
        losses.append(float(m["total_loss"]))
    report["bf16_ones"] = losses
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


#: the cases held against the reference's GSPMD step: the reference's own
#: (2, 4) case (``tests/test_distributed.py``), and a padded-head config
#: (qwen2-vl-7b's 4 q / 2 kv smoke heads pad to 8 at tp 8: a group of 4,
#: not 2) with ZeRO-1
REF_STEPS = {
    "deepseek-67b-fsdp-mb2": dict(arch="deepseek-67b", mesh=(2, 4),
                                  axes=("data", "model"), fsdp=True,
                                  microbatches=2, steps=4, S=32),
    "qwen2-vl-7b-zero1-mb1": dict(arch="qwen2-vl-7b", mesh=(1, 8),
                                  axes=("data", "model"), fsdp=False,
                                  microbatches=1, steps=2, S=16),
    **{f"{a}-zero1-mb1": dict(arch=a, mesh=(1, 4), axes=("data", "model"),
                              fsdp=False, microbatches=1, steps=2, S=16)
       for a in LATENT_SSM_ARCHS}}


def start_reference_steps(ref_dir: str, names=None, table=None):
    """Start the reference's steps of the cases ``names`` of ``table``
    (REF_STEPS by default; all its cases by default) in a child process
    with 8 host devices (``tests/_torch_reference_tp_steps.py``), each
    case writing into ``ref_dir/<name>``, where its batch
    (``step_batch``) is written first; a case's ``config`` entry changes
    the reference's config (``scan_layers``).  The child reads its
    requests from a file and writes its output to another.  Returns (the
    process, its log's path)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    table = table or REF_STEPS
    names = names or list(table)
    reqs = []
    for name in names:
        c = table[name]
        out = os.path.join(ref_dir, name)
        os.makedirs(out)
        sizes = dict(zip(c["axes"], c["mesh"]))
        cfg = step_config(c["arch"], sizes["data"], sizes["model"])
        np.savez(os.path.join(out, "batch.npz"), **{
            k: v.numpy() for k, v in step_batch(cfg, S=c["S"]).items()})
        reqs.append({"arch": c["arch"], "mesh": c["mesh"], "axes": c["axes"],
                     "fsdp": c["fsdp"], "steps": c["steps"],
                     "train": dict(STEP_TRAIN,
                                   microbatches=c["microbatches"]),
                     "config": c.get("config", {}),
                     "batch": os.path.join(out, "batch.npz"), "out": out})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    base = os.path.join(ref_dir, "_".join(names))
    with open(base + ".json", "w") as f:
        json.dump(reqs, f)
    with open(base + ".json") as fin, open(base + ".log", "w") as flog:
        p = subprocess.Popen(
            [sys.executable, os.path.join(root, "tests",
                                          "_torch_reference_tp_steps.py")],
            stdin=fin, stdout=flog, stderr=subprocess.STDOUT, env=env,
            cwd=root)
    return p, base + ".log"


def tp_against_reference(rank, world, store, ref_dir, out_dir,
                         cases=None, table=None):
    """Eight ranks: the port's step with a model axis against the
    reference's GSPMD step for each case of REF_STEPS
    (:func:`start_reference_steps` wrote the reference's states before
    and after each of its steps into ``ref_dir/<name>``).  Every step starts from the reference's state before it (carried
    across whole, each rank taking its shards) on ``step_batch``, the
    batch the reference took; rank 0 gathers the state after it and holds
    it to the reference's (:func:`_state_drift`, master and params on the
    elements whose gradient, the port's single-device step's, stayed
    above 1e-3 of the leaf's largest at every step so far).  Every rank
    writes its metrics a step (``ref<r>.json``), rank 0 the drifts.
    ``cases`` names the cases of ``table`` (REF_STEPS by default; their
    meshes of ``world`` ranks; all of them by default)."""
    _join(rank, world, store)
    table = table or REF_STEPS
    report = {}
    for name in cases or table:
        case = table[name]
        ref = os.path.join(ref_dir, name)
        shape, axes = tuple(case["mesh"]), tuple(case["axes"])
        mesh = make_mesh(shape, axes, "cpu")
        dp_axes = tuple(a for a in axes if a != "model")
        dp = math.prod(n for a, n in zip(axes, shape) if a != "model")
        cfg = step_config(case["arch"], dp, dict(zip(axes, shape))["model"])
        nmb = case["microbatches"]
        tcfg = TrainConfig(microbatches=nmb, **STEP_TRAIN)
        rules = make_rules(mesh, mode="train", fsdp=case["fsdp"], zero1=True,
                           dp_axes=dp_axes)
        sh = state_shardings(cfg, rules)
        template = make_train_state(cfg, tcfg,
                                    torch.Generator().manual_seed(0), "cpu")

        def load(k):
            with np.load(os.path.join(ref, f"state{k}.npz")) as f:
                return unflatten(template, [
                    torch.from_numpy(f[keystr(p)].copy())
                    for p, _ in leaves_with_path(template)])

        batch = step_batch(cfg, S=case["S"])
        step = make_train_step(cfg, tcfg, rules)
        rep = {"metrics": [], "drift": []}
        keep = None
        for k in range(case["steps"]):
            whole = load(k)
            state = tree_map(lambda x, s: s.local(x).clone(), whole, sh)
            state, m = step(state, batch)
            rep["metrics"].append({n: float(v) for n, v in m.items()})
            after = gather(state, sh)
            if rank == 0:
                big = [x.abs() > 1e-3 * x.abs().max()
                       for x in _step_grads(cfg, whole, batch, nmb)]
                keep = big if keep is None else [
                    a & b for a, b in zip(keep, big)]
                rep["drift"].append(_state_drift(after, load(k + 1), keep))
        report[name] = rep
    with open(os.path.join(out_dir, f"ref{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _everyone(x: torch.Tensor) -> list:
    """Every rank's ``x``, in rank order."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x.contiguous())
    return out


def tp_pieces(rank, world, store, out_dir):
    """Four ranks: the model-axis pieces against their unsplit forms.

    On a (2, 2) data x model mesh: ``Sharding.sum_into`` with a dim split
    over more axes than it reduces, ``Sharding.reshard``, the
    differentiable collectives forward and backward, and ``global_norm``
    over model-split, data-split and replicated leaves, and
    ``testing.sharded_step_parity`` (the step on the single-device step's
    gradients) at two smoke configs.  On a (1, 4)
    mesh: the vocab-parallel embedding, logits and cross-entropy (a
    vocabulary of 500 padded to 512, labels in every rank's block and in
    the padded tail) with their gradients, and the refusal of a sequence
    that does not split over the model ranks.  Writes each check's
    largest relative difference (or the error message) to
    ``pieces<r>.json``."""
    from repro_torch.models import common as C
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel import sharding as TS
    _join(rank, world, store)
    out = {}
    g = torch.Generator().manual_seed(100 + rank)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.randn((8, 6), generator=g)
    every = torch.stack(_everyone(x))                         # (4, 8, 6)
    d, m = axis_index(mesh, ("data",)), axis_index(mesh, ("model",))
    for spec, red in (((("data", "model"),), ("data",)),
                      ((("data", "model"),), ("model",)),
                      ((("data", "model"),), ("data", "model")),
                      (("data", "model"), ("model",)),
                      ((None, "model"), ("data", "model"))):
        sh = Sharding(mesh, spec)
        # the sum over the ranks that differ from this one only in `red`
        peers = [r for r in range(4)
                 if all(("data", "model")[i] in red or (r // 2, r % 2)[i]
                        == (d, m)[i] for i in range(2))]
        want = sh.local(every[peers].sum(0))
        out[f"sum_into {spec} over {red}"] = _rel(sh.sum_into(x, red), want)
    same = every[0]                               # rank 0's, on every rank
    for src, dst in (((("data", "model"),), ("data",)),
                     (("data", None), (None, "model")),
                     ((None, "model"), ("data", "model"))):
        a, b = Sharding(mesh, src), Sharding(mesh, dst)
        out[f"reshard {src} -> {dst}"] = float(
            (a.reshard(a.local(same), b) - b.local(same)).abs().max())
    tree = {"split": torch.randn((4, 6), generator=torch.Generator()
                                 .manual_seed(1)),
            "rep": torch.randn((5,), generator=torch.Generator()
                               .manual_seed(2)),
            "both": torch.randn((8, 2), generator=torch.Generator()
                                .manual_seed(3))}
    shs = {"split": Sharding(mesh, (None, "model")),
           "rep": Sharding(mesh, ()),
           "both": Sharding(mesh, (("data", "model"),))}
    local = {k: shs[k].local(v) for k, v in tree.items()}
    out["global_norm"] = _rel(global_norm(local, shs), global_norm(tree))
    rules = make_rules(mesh, mode="train", fsdp=False)
    w = float(m + 1)                   # a different weight a model rank
    with axis_rules(rules):
        a = torch.full((3,), w, requires_grad=True)
        y = TS.reduce_from_model(a)
        y.sum().backward()
        out["reduce_from_model"] = float((y - 3.0).abs().max())
        out["reduce_from_model grad"] = float((a.grad - 1.0).abs().max())
        a = (torch.arange(4.0) + 10 * m).reshape(1, 2, 2).requires_grad_()
        y = TS.gather_seq(a)
        want = torch.cat([torch.arange(4.0), torch.arange(4.0) + 10]) \
            .reshape(1, 4, 2)
        out["gather_seq"] = float((y - want).abs().max())
        (y * w).sum().backward()
        out["gather_seq grad"] = float((a.grad - 3.0).abs().max())
        a = torch.full((1, 4, 2), w, requires_grad=True)
        y = TS.scatter_seq(a)
        out["scatter_seq"] = float((y - 3.0).abs().max())
        (y * (torch.arange(4.0).reshape(1, 2, 2) + 4 * m)).sum().backward()
        out["scatter_seq grad"] = float(
            (a.grad - torch.arange(8.0).reshape(1, 4, 2)).abs().max())

    # the step on the single-device step's gradients (the optimizer's
    # layouts and collectives with a model axis), two steps each
    from repro_torch.testing import sharded_step_parity
    for arch, fsdp in (("deepseek-67b", True), ("deepseek-67b", False),
                       ("qwen3-moe-30b-a3b", True)):
        cfg = step_config(arch, 2, 2)
        tcfg = TrainConfig(microbatches=2, **STEP_TRAIN)
        state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
        out[f"parity {arch} fsdp={fsdp}"] = sharded_step_parity(
            cfg, tcfg, make_rules(mesh, mode="train", fsdp=fsdp), state,
            step_batch(cfg))

    # the vocabulary pieces on four model ranks
    mesh4 = make_mesh((1, 4), ("data", "model"), "cpu")
    rules4 = make_rules(mesh4, mode="train", fsdp=False)
    cfg = dataclasses.replace(get_config("deepseek-67b", smoke=True),
                              dtype="float32", vocab_size=500,
                              loss_chunk=4).resolve(tp=4)
    V, D = cfg.padded_vocab, cfg.d_model
    gen = torch.Generator().manual_seed(7)
    full = {"tok": torch.randn((V, D), generator=gen),
            "head": torch.randn((V, D), generator=gen) * D ** -0.5}
    h0 = torch.randn((2, 8, D), generator=gen)
    r = axis_index(mesh4, ("model",))
    blk = slice(r * V // 4, (r + 1) * V // 4)
    tokens = torch.tensor([[0, 127, 128, 255, 256, 383, 384, 499]] * 2)
    for case, labels in (
            ("every rank's block", tokens.flip(1)),
            ("padded tail", torch.tensor([[3, 200, 300, 499, 500, 505, 511,
                                           400]] * 2))):
        mask = torch.tensor([[1.0] * 7 + [0.0], [1.0] * 8])
        res = {}
        for split in (False, True):
            p = {k: (v[blk] if split else v).clone().requires_grad_()
                 for k, v in full.items()}
            h = h0.clone().requires_grad_()
            with axis_rules(rules4 if split else None):
                logits = C.logits_from_hidden(p, cfg, h)
                loss, cnt = C.chunked_cross_entropy(
                    lambda hc: C.logits_from_hidden(p, cfg, hc), h, labels,
                    cfg, mask)
                rows = C.embed_tokens(p, cfg, tokens)
            loss.backward()
            res[split] = (logits.detach(), loss.detach(), h.grad,
                          p["head"].grad, rows.detach())
        (lw, sw, hw, gw, rw), (lg, sg, hg, gg, rg) = res[False], res[True]
        dist.all_reduce(hg)
        dist.all_reduce(rg)
        out[f"logits, {case}"] = _rel(lg, lw[..., blk])
        out[f"loss, {case}"] = _rel(sg, sw)
        out[f"h grad, {case}"] = _rel(hg, hw)
        out[f"head grad, {case}"] = _rel(gg, gw[blk])
        out[f"embedding rows, {case}"] = float((rg - rw).abs().max())
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with axis_rules(rules4):
        try:
            M.train_forward(params, cfg, {
                "tokens": torch.zeros((2, 6), dtype=torch.int32),
                "labels": torch.zeros((2, 6), dtype=torch.int32)})
            out["uneven sequence"] = "no error"
        except ValueError as e:
            out["uneven sequence"] = str(e)
    out.update(_latent_ssm_pieces(mesh4, rules4))
    with open(os.path.join(out_dir, f"pieces{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _latent_ssm_pieces(mesh, rules) -> dict:
    """On a (1, tp) data x model mesh, MLA's and Mamba2's model-axis pieces
    against their unsplit forms (the largest difference over the unsplit
    value's largest):

    - ``gated norm``: ``ssm.gated_rmsnorm`` on this rank's block of the
      ``d_inner`` channels, its value and the gradients of its input and
      scale (a loss weighing each channel differently), against the
      unsplit norm: the rank's mean of squares goes through
      ``sum_over_model``, whose backward sums the ranks' cotangents;
    - ``mamba heads``: ``mamba2_fwd`` / ``mamba2_decode`` on the rank's
      blocks of ``in_z``, ``in_x``, ``conv_x_*``, ``norm`` and
      ``out_proj`` (the per-head ``dt_bias``, ``A_log`` and ``Dskip``
      drawn apart per head and cut by the layer itself): the output's
      partial sums summed, the SSD state and the ``x`` conv tail equal
      the unsplit layer's at the rank's heads and channels, with one
      group and with four (a rank's heads reading their own group);
    - ``mla combine``: ``mla_decode`` on the rank's block of both latent
      caches and its heads, the partial outputs summed, against the
      whole-cache decode, rows whose new position leaves later blocks
      empty among them; the blocks' written rows against the whole
      cache's."""
    from repro_torch.models.attention import decode_block, init_mla, \
        mla_decode
    from repro_torch.models.ssm import (gated_rmsnorm, init_mamba2,
                                        mamba2_decode, mamba2_fwd)
    from repro_torch.parallel.sharding import reduce_from_model
    out = {}
    tp, r = mesh.shape[-1], axis_index(mesh, ("model",))
    g = torch.Generator().manual_seed(11)
    d = 16 * tp
    x = torch.randn((2, 5, d), generator=g)
    scale = 1 + 0.3 * torch.randn((d,), generator=g)
    w = torch.randn((2, 5, d), generator=g)
    blk = slice(r * d // tp, (r + 1) * d // tp)
    res = {}
    for split in (False, True):
        xs = (x[..., blk] if split else x).clone().requires_grad_()
        ss = (scale[blk] if split else scale).clone().requires_grad_()
        with axis_rules(rules if split else None):
            y = gated_rmsnorm(ss, xs, 1e-6, d)
            (y * (w[..., blk] if split else w)).sum().backward()
        res[split] = (y.detach(), xs.grad, ss.grad)
    (yw, xw, sw), (yg, xg, sg) = res[False], res[True]
    out["gated norm"] = _rel(yg, yw[..., blk])
    out["gated norm grad x"] = _rel(xg, xw[..., blk])
    out["gated norm grad scale"] = _rel(sg, sw[blk])

    for G in (1, 4):
        cfg = step_config("mamba2-1.3b", 1, tp)
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=G))
        p = init_mamba2(cfg, torch.Generator().manual_seed(12), "cpu")
        H = cfg.ssm.n_heads(cfg.d_model)
        p["Dskip"] = torch.randn((H,), generator=g)
        p["norm"] = 1 + 0.3 * torch.randn(p["norm"].shape, generator=g)
        di = p["in_x"].shape[1]
        cb = slice(r * di // tp, (r + 1) * di // tp)
        hb = slice(r * H // tp, (r + 1) * H // tp)
        mine = dict(p)
        for k in ("in_z", "in_x", "conv_x_w"):
            mine[k] = p[k][:, cb]
        for k in ("conv_x_b", "norm"):
            mine[k] = p[k][cb]
        mine["out_proj"] = p["out_proj"][cb]
        xin = torch.randn((2, 32, cfg.d_model), generator=g)
        y, ((tx, tb, tc), st) = mamba2_fwd(p, cfg, xin)
        with axis_rules(rules):
            yl, ((lx, lb, lc), sl) = mamba2_fwd(mine, cfg, xin)
            yl = reduce_from_model(yl)
        tag = f"mamba heads G{G}"
        out[f"{tag} y"] = _rel(yl, y)
        out[f"{tag} state"] = _rel(sl, st[:, hb])
        out[f"{tag} conv tails"] = max(_rel(lx, tx[..., cb]), _rel(lb, tb),
                                       _rel(lc, tc))
        xt = torch.randn((2, 1, cfg.d_model), generator=g)
        conv = {"x": tx.clone(), "B": tb.clone(), "C": tc.clone()}
        yd, conv, sd = mamba2_decode(p, cfg, xt, conv, st.clone())
        lconv = {"x": lx.clone(), "B": lb.clone(), "C": lc.clone()}
        with axis_rules(make_rules(mesh, mode="decode", fsdp=False)):
            ydl, lconv, sdl = mamba2_decode(mine, cfg, xt, lconv, sl.clone())
            ydl = reduce_from_model(ydl)
        out[f"mamba decode G{G} y"] = _rel(ydl, yd)
        out[f"mamba decode G{G} state"] = _rel(sdl, sd[:, hb])
        out[f"mamba decode G{G} conv x"] = _rel(lconv["x"],
                                                 conv["x"][..., cb])

    cfg = step_config("minicpm3-4b", 1, tp)
    m = cfg.mla
    p = init_mla(cfg, torch.Generator().manual_seed(13), "cpu")
    H = cfg.padded_heads
    hb = slice(r * H // tp, (r + 1) * H // tp)
    mine = {**p, "wuq": p["wuq"][:, hb], "wukv": p["wukv"][:, hb],
            "wo": p["wo"][hb]}
    B, n = 4, 8
    S = n * tp
    xt = torch.randn((B, 1, cfg.d_model), generator=g)
    ckv = torch.randn((B, S, m.kv_lora_rank), generator=g)
    kpe = torch.randn((B, S, m.qk_rope_head_dim), generator=g)
    # row 0's new row lands in the first block and leaves the rest empty;
    # row 1's opens the second block; the last row fills the cache
    lens = torch.tensor([2, n, S // 2 + 1, S - 1], dtype=torch.int32)
    want, wc, wk = mla_decode(p, cfg, xt, lens, ckv.clone(), kpe.clone(),
                              lens)
    with axis_rules(make_rules(mesh, mode="decode", fsdp=False)):
        block = decode_block(lens, n)
        got, gc, gk = mla_decode(mine, cfg, xt, lens,
                                 ckv[:, r * n:(r + 1) * n].clone(),
                                 kpe[:, r * n:(r + 1) * n].clone(), lens,
                                 block=block)
        got = reduce_from_model(got)
    out["mla combine"] = _rel(got, want)
    out["mla combine cache"] = max(
        float((gc - wc[:, r * n:(r + 1) * n]).abs().max()),
        float((gk - wk[:, r * n:(r + 1) * n]).abs().max()))
    return out
