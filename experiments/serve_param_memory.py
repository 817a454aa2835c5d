#!/usr/bin/env python3
"""The serving weights a rank holds under tensor parallelism, with and
without the reference's serving FSDP.

For each arch that ``launch.specs.use_fsdp`` puts under FSDP in serving
(more than 64 B parameters), on the production mesh (16, 16) data x
model and its config resolved for it, the bytes of one rank's blocks of
the params in the config's dtype, counted from meta tensors (no memory,
no devices):

- ``port``: ``launch.specs.serve_param_shardings``, the layout the
  port's prefill and decode take (heads, mlp, vocab and experts split
  over ``model``, the data axis dropped: a rank holds its model block of
  every leaf whole);
- ``reference``: each leaf's ``arg_sharding`` by ``params_logical``
  under the same rules, ``embed -> data`` kept: the reference's
  ``build_cell`` layout, which gathers the weights inside its step.

Run from the repository root (a few seconds, on the CPU)::

    PYTHONPATH=src python3 experiments/serve_param_memory.py
"""
import math

import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.specs import (rules_for, serve_param_shardings,
                                      tree_arg_shardings, use_fsdp)
from repro_torch.models import model as M
from repro_torch.parallel.sharding import AbstractMesh
from repro_torch.tree import leaves_with_path

ARCHS = ("deepseek-67b", "mistral-large-123b", "qwen3-moe-235b-a22b")
MESH = (16, 16)


def rank_bytes(shapes, shardings) -> int:
    """The bytes of one rank's blocks of the ``shapes`` tree's leaves."""
    sh = dict(leaves_with_path(shardings))
    return sum(math.prod(sh[p].shard_shape(x.shape)) * x.element_size()
               for p, x in leaves_with_path(shapes))


def main() -> None:
    mesh = AbstractMesh(MESH, ("data", "model"))
    for arch in ARCHS:
        cfg = get_config(arch).resolve(tp=MESH[1], dp=MESH[0])
        rules = rules_for(cfg, mesh, "decode")
        shapes = M.init_params(cfg, torch.Generator(), "meta")
        port = rank_bytes(shapes, serve_param_shardings(cfg, rules))
        ref = rank_bytes(shapes, tree_arg_shardings(
            shapes, M.params_logical(cfg), rules))
        total = sum(x.numel() * x.element_size()
                    for _, x in leaves_with_path(shapes))
        print(f"{arch}: {cfg.param_count() / 1e9:.1f} B params, "
              f"{cfg.dtype}, {total / 1e9:.2f} GB in all; fsdp "
              f"{use_fsdp(cfg, 'decode')}; a rank of {MESH} data x model "
              f"holds {port / 1e9:.3f} GB (port) against "
              f"{ref / 1e9:.3f} GB (reference, embed -> data)")


if __name__ == "__main__":
    main()
