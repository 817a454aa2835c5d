"""Training launcher of the port: mesh + sharded train step + data
pipeline + fault tolerance (auto-resume, async checkpoints, SIGTERM
preemption).

Translated from the reference's ``launch/train.py``.  On one card
(``--mesh 1x1``, the default) the step is the single-device one; with
``data x model > 1`` ranks the process group comes from the environment
``torchrun`` sets (NCCL on cards, one a rank; gloo with ``--device cpu``),
and the step is the ZeRO-1 / FSDP one of ``training.train_step`` under
``launch.specs.rules_for``'s rules.  A ``model`` axis above 1 is tensor
parallelism, for every family (the config is resolved for it); a
sequence, or an ``encdec`` model's 16 encoder frames, that does not split
over it is refused.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --smoke --steps 50 --mesh 1x1
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch mamba2-1.3b --smoke --steps 50 --mesh 2x1 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch deepseek-67b --smoke --steps 50 --mesh 2x2 --device cpu

Every rank draws the same batches (``SyntheticLMData``, seed 0, the
iterator seeded by the start step as the reference's is, so a resumed run
draws other batches than an uninterrupted one) and the step takes its own
rows.  Checkpoints hold whole leaves: under a mesh every rank gathers the
state and rank 0 writes it, and a restore cuts each rank's shards (any
mesh restores any checkpoint, see ``launch.elastic``).  The step writes
the state in place, so SIGTERM does not save from inside the handler, as
the reference's does: the handler asks, and the loop saves the last whole
step and exits 0 (under a mesh the ranks agree on it after each step).
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import AxisRules, gather
from repro_torch.training.train_step import (make_train_state,
                                             make_train_step,
                                             state_shardings)


def parse_mesh(text: str) -> tuple:
    """``"DxM"`` -> (data, model)."""
    dp, tp = (int(x) for x in text.split("x"))
    return dp, tp


def init_mesh(dp: int, tp: int, device: DeviceLike = None,
              init_method: str = "env://"):
    """(mesh or None, this rank's device) for a ``dp x tp`` run: None and
    ``device`` for one rank; otherwise the process group is initialised
    (if it is not yet) from ``RANK`` / ``WORLD_SIZE`` and ``init_method``
    (``env://``: torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``), NCCL with
    card ``LOCAL_RANK`` on CUDA, gloo on the CPU, and a ``("data",
    "model")`` mesh laid over it."""
    dev = resolve_device(device)
    if dp * tp == 1:
        return None, dev
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return make_mesh((dp, tp), ("data", "model"), dev), dev


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _extras(cfg, batch: int) -> dict:
    """The reference launcher's stand-ins: zero vision embeds (vlm) and
    16 zero encoder frames (encdec), bf16 on the device (cast by
    :func:`run`: numpy has no bf16)."""
    import numpy as np
    out = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = np.zeros(
            (batch, cfg.num_frontend_tokens, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        out["enc_frames"] = np.zeros((batch, 16, cfg.d_model), np.float32)
    return out


def run(cfg, tcfg, *, batch: int, seq: int, ckpt_dir: str,
        ckpt_every: int = 25, steps: Optional[int] = None,
        rules: Optional[AxisRules] = None, device: DeviceLike = None,
        log_every: int = 10,
        on_restore: Optional[Callable[[int, dict], None]] = None,
        out: Callable[[str], None] = print) -> dict:
    """Train ``cfg`` to ``steps`` (default ``tcfg.total_steps``), resuming
    from the latest checkpoint in ``ckpt_dir`` and saving every
    ``ckpt_every`` steps (asynchronously).  ``on_restore(step, state)``
    sees a restored state before the first step.  Returns ``{"start",
    "step", "state", "metrics", "preempted"}`` (the state in this rank's
    layout)."""
    steps = tcfg.total_steps if steps is None else steps
    dev = resolve_device(device)
    say = out if _rank() == 0 else (lambda _: None)
    step_fn = make_train_step(cfg, tcfg, rules)
    shardings = state_shardings(cfg, rules) if rules is not None else None
    ck = Checkpointer(ckpt_dir, keep=2)
    start = ck.latest_step() or 0
    if start:
        template = make_train_state(cfg, tcfg, torch.Generator(), "meta")
        state = ck.restore(template, device=dev, shardings=shardings)
        say(f"[train] resumed at step {start}")
        if on_restore is not None:
            on_restore(start, state)
    else:
        state = make_train_state(
            cfg, tcfg, torch.Generator(dev).manual_seed(tcfg.seed), dev,
            rules=rules)

    def save(step: int, blocking: bool = False):
        whole = gather(state, shardings) if shardings is not None else state
        if _rank() == 0:
            ck.save(step, whole, blocking=blocking)

    asked = []
    previous = signal.signal(signal.SIGTERM,
                             lambda signum, frame: asked.append(signum))

    def preempted() -> bool:
        if rules is None:
            return bool(asked)
        import torch.distributed as dist
        flag = torch.tensor([float(bool(asked))], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    stand_ins = _extras(cfg, batch)

    data = SyntheticLMData(cfg.vocab_size, seed=0)
    it = make_batch_iterator(data, batch, seq, seed=start, device=dev,
                             extras=stand_ins)
    metrics, stopped = None, False
    try:
        t0 = time.time()
        for i in range(start, steps):
            b = next(it)
            for k in stand_ins:
                b[k] = b[k].to(torch.bfloat16)
            state, metrics = step_fn(state, b)
            if (i + 1) % log_every == 0:
                say(f"[train] step {i + 1} loss="
                    f"{float(metrics['loss']):.3f} "
                    f"({(time.time() - t0) / log_every:.2f}s/step)")
                t0 = time.time()
            if preempted():
                s = int(state["opt"]["step"])
                save(s, blocking=True)
                say(f"[train] preempted -> checkpointed step {s}")
                stopped = True
                break
            if (i + 1) % ckpt_every == 0:
                save(i + 1)
        ck.wait()
    finally:
        it.close()
        signal.signal(signal.SIGTERM, previous)
    if metrics is not None and not stopped:
        say(f"[train] done at step {steps}, "
            f"loss={float(metrics['loss']):.3f}")
    return {"start": start, "step": int(state["opt"]["step"]),
            "state": state, "metrics": metrics, "preempted": stopped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1", help="data x model, e.g. 2x4")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dist-init", default="env://",
                    help="torch.distributed init method of a multi-rank "
                         "run (torchrun: env://; or a file:// URL)")
    args = ap.parse_args(argv)

    dp, tp = parse_mesh(args.mesh)
    cfg = get_config(args.arch, smoke=args.smoke).resolve(tp=tp, dp=dp)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10,
                       total_steps=args.steps,
                       microbatches=args.microbatches)
    mesh, dev = init_mesh(dp, tp, args.device, args.dist_init)
    rules = None
    if mesh is not None:
        from repro_torch.launch.specs import rules_for
        rules = rules_for(cfg, mesh, "train")
    run(cfg, tcfg, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, rules=rules, device=dev)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
