"""Elastic restart: restore a checkpoint onto a DIFFERENT mesh.

Translated from the reference's ``launch/elastic.py``.  Node failures /
resizes change the rank count; checkpoints are stored unsharded (whole
leaves), so restoring under a new mesh is each rank cutting its shards
of the new layout (``Checkpointer.restore(shardings=)``).  A ``model``
axis above 1 is a layout only here (the train step refuses it).

  PYTHONPATH=src python -m repro_torch.launch.elastic --arch mamba2-1.3b \\
      --smoke --ckpt-dir /tmp/repro_torch_launch_train --mesh 1x1
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.elastic \\
      --arch mamba2-1.3b --smoke --ckpt-dir ... --mesh 2x1 --device cpu

Where the reference restores the whole state and re-places the params,
each rank here restores its shards of the whole train state (params in
their layout, master / m / v in the optimizer's).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.launch.train import init_mesh, parse_mesh
from repro_torch.tree import leaves
from repro_torch.training.train_step import make_train_state, state_shardings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--mesh", default="2x4", help="new data x model mesh")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dist-init", default="env://",
                    help="torch.distributed init method of a multi-rank "
                         "run (torchrun: env://; or a file:// URL)")
    args = ap.parse_args(argv)

    dp, tp = parse_mesh(args.mesh)
    cfg = get_config(args.arch, smoke=args.smoke).resolve(tp=tp, dp=dp)
    mesh, dev = init_mesh(dp, tp, args.device, args.dist_init)
    rules = None
    if mesh is not None:
        from repro_torch.launch.specs import rules_for
        rules = rules_for(cfg, mesh, "train")
    ck = Checkpointer(args.ckpt_dir, use_async=False)
    step = ck.latest_step()
    template = make_train_state(cfg, TrainConfig(), torch.Generator(),
                                "meta")
    state = ck.restore(template, device=dev, shardings=state_shardings(
        cfg, rules) if rules is not None else None)
    n = sum(x.numel() for x in leaves(template["params"]))
    local = sum(x.numel() for x in leaves(state["params"]))
    rank = 0
    if mesh is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
    if rank == 0:
        print(f"[elastic] restored step {step} of {cfg.name} onto mesh "
              f"{dp}x{tp}; params resharded ({n} elements)")
    print(f"[elastic] rank {rank}: {local} of the {n} param elements")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
