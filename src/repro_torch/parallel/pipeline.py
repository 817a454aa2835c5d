"""GPipe-style pipeline parallelism over ``torch.distributed``.

Translated from the reference's ``parallel/pipeline.py`` (a
``collective_permute`` ring in ``shard_map``).  Layers are grouped into S
stages, one stage a rank along the mesh's ``stage`` axis, and each rank
holds its own stage's parameters.  Microbatches stream through: at step t
stage s runs microbatch t - s, then sends its output to stage s + 1 (the
ring's last stage sends to stage 0, which ignores it), over
``batch_isend_irecv``.  Total steps n_micro + S - 1 (bubble (S-1)/steps).
The last stage writes the finished microbatches, every other stage holds
zeros, and the outputs are summed over the stage group, as the
reference's ``psum`` reconciles them.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import tree_map


def pipeline_apply(mesh, stage_fn: Callable, params_stacked,
                   x_micro: torch.Tensor, axis_name: str = "stage"):
    """Run x through S pipeline stages.

    stage_fn(stage_params, h) -> h  (one stage's computation)
    params_stacked: this rank's stage's parameters, leaves with a leading
      dim of 1 (its slice of the stacked S stages) or of S (the full
      stack, of which it takes its own)
    x_micro: (n_micro, mb, ...) microbatched input, the same on every rank
    Returns the (n_micro, mb, ...) outputs of the LAST stage, on every rank.
    """
    import torch.distributed as dist
    from repro_torch.parallel.sharding import (axis_group, axis_index,
                                               mesh_axes)
    S = mesh_axes(mesh)[axis_name]
    group = axis_group(mesh, (axis_name,))
    idx = axis_index(mesh, (axis_name,))
    n_micro = x_micro.shape[0]
    params = tree_map(lambda p: p[0] if p.shape[0] == 1 else p[idx],
                      params_stacked)
    nxt = dist.get_global_rank(group, (idx + 1) % S)
    prv = dist.get_global_rank(group, (idx - 1) % S)
    buf = torch.zeros_like(x_micro[0])        # current activation
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + S - 1):
        # stage 0 loads a fresh microbatch (zeros past the last one);
        # the others take the shifted buffer
        if idx == 0:
            h_in = x_micro[t] if t < n_micro else torch.zeros_like(buf)
        else:
            h_in = buf
        h_out = stage_fn(params, h_in)
        mb_out = t - (S - 1)                  # the last stage's finished mb
        if idx == S - 1 and 0 <= mb_out < n_micro:
            outs[mb_out] = h_out
        if S == 1:
            buf = h_out
            continue
        recv = torch.empty_like(h_out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, h_out.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
        buf = recv
    dist.all_reduce(outs, group=group)
    return outs
