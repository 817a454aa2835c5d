#!/usr/bin/env python3
"""Whether the one-rank tensor-parallel train step stays bit for bit
with the single-device step when repeated, on one card.

``chip_smoke.py`` phase 12g's train check, alone and ``--repeats`` times
in one process: the arch at full width and ``--layers`` layers, bf16,
remat full, B 4 x S 1024, on a one-rank NCCL (1, 1) data x model group;
each repeat a new seeded state (Zamba2's LoRA seeded nonzero; an
encoder-decoder's ``--layers`` encoder layers too and 1024 nonzero
encoder frames) and ``testing.sharded_step_parity`` (the TP step handed
the single-device step's gradients).  Both steps' optimizer inputs are
recorded: each repeat prints whether the states are bit for bit, the
drift, both steps' gradient norms, the gradient leaves that differ
between them, the single-device step's leaves that are not contiguous,
and the leaves whose f32 sum of squares differs between the two steps
when each is summed in its own memory order (``layout sums differ``)
and in row-major order (``row-major sums differ``, what
``optim.adamw.leaf_square_sums`` adds)::

    python3 experiments/tp_step_repeat_probe.py [--arch A] [--layers N] \\
        [--repeats K]

Needs a CUDA card.
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import seed_lora, sharded_step_parity
    from repro_torch.training import train_step as TS
    from repro_torch.tree import keystr, leaves, leaves_with_path
    dev = torch.device("cuda")
    store = os.path.join(ROOT, "build", f"nccl_probe{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        rules = make_rules(mesh, mode="train", fsdp=False)
        cfg = dataclasses.replace(
            get_config(args.arch), num_layers=args.layers, dtype="bfloat16",
            remat="full").resolve(tp=1, dp=1)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, enc_layers=args.layers)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=100)
        it = make_batch_iterator(SyntheticLMData(cfg.vocab_size, seed=0),
                                 4, 1024, seed=2, device=dev)
        batch = next(it)
        it.close()
        if cfg.family == "encdec":
            batch["enc_frames"] = torch.randn(
                (4, 1024, cfg.d_model), generator=torch.Generator(
                    dev).manual_seed(100), device=dev).to(torch.bfloat16)
        calls = []
        update = TS.adamw_update

        def recorded(params, grads, opt, tcfg, **kw):
            # each leaf in f32 with its own strides
            g = [x.detach().to(torch.float32).clone() for x in leaves(grads)]
            out = update(params, grads, opt, tcfg, **kw)
            calls.append(([keystr(p) for p, _ in leaves_with_path(grads)],
                          g, out[2]["grad_norm"].clone()))
            return out

        TS.adamw_update = recorded
        for k in range(args.repeats):
            state = TS.make_train_state(
                cfg, tcfg, torch.Generator(dev).manual_seed(0), dev)
            if cfg.family == "hybrid":
                seed_lora(state["params"], cfg)
                for n in ("qb", "ib"):
                    state["opt"]["master"]["lora"][n].copy_(
                        state["params"]["lora"][n])
            calls.clear()
            d = sharded_step_parity(cfg, tcfg, rules, state, batch,
                                    steps=1)[0]
            torch.cuda.synchronize()
            (names, g0, n0), (_, g1, n1) = calls
            differ = [n for n, a, b in zip(names, g0, g1)
                      if not torch.equal(a, b)]
            strided = [n for n, a in zip(names, g0) if not a.is_contiguous()]
            layout = [n for n, a, b in zip(names, g0, g1) if not torch.equal(
                a.square().sum(), b.square().sum())]
            row_major = [n for n, a, b in zip(names, g0, g1)
                         if not torch.equal(a.contiguous().square().sum(),
                                            b.contiguous().square().sum())]
            print(f"repeat {k}: state bit for bit {d['exact']}, drift "
                  f"{d['drift']}; grad norm single {n0.item()!r}, TP "
                  f"{n1.item()!r}; gradient leaves that differ: {differ}; "
                  f"not contiguous (single): {strided}; layout sums "
                  f"differ: {layout}; row-major sums differ: {row_major}",
                  flush=True)
            del state
            calls.clear()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
