"""Int8 error-feedback gradient compression for the cross-pod all-reduce.

Translated from the reference's ``optim/compression.py``.  Cross-pod
links are far slower than in-pod ones, so the pod-axis gradient
all-reduce is the multi-pod bottleneck.  Compress: quantize the local
gradient to int8 with a per-tensor scale, sum the payload over the pod
axis (exact in int32), dequantize, and keep the quantization residual
locally (error feedback) so the bias cancels over steps (1-bit-Adam /
EF-SGD family).

The arithmetic is the reference's, rounding for rounding: the int32 sum
is dequantized with the *mean* of the ranks' scales, not with each
rank's own, so with unequal scales the result is not the mean of the
dequantized gradients (ROADMAP Queue 3 records the hazard).  Where the
reference runs ``psum`` inside ``shard_map``, each rank here holds its
own gradients and the sums are ``torch.distributed.all_reduce`` over the
axis's process group.  No train step calls it, in the reference as here:
``TrainConfig.grad_compression`` is read by nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import leaves, unflatten


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads, residuals, group, axis_size: int):
    """Error-feedback int8 sum over the ranks of ``group``.

    grads/residuals: local f32 trees.  Returns (mean_grads,
    new_residuals)."""
    import torch.distributed as dist

    def one(g, r):
        g = g + r                                  # error feedback
        q, scale = quantize(g)
        total = q.to(torch.int32, memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=group)
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        # each rank quantized with its own scale; use the mean scale for
        # the dequantized sum (scales are summed so every rank agrees)
        mean_scale = scale_sum / axis_size
        out = total.to(torch.float32) * mean_scale / axis_size
        new_r = g - dequantize(q, scale)           # local residual
        return out, new_r

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def make_compressed_allreduce(mesh, axis_name: str = "pod"):
    """Returns fn(grads, residuals) -> (mean, residuals) running the
    error-feedback int8 reduction over the mesh's ``axis_name``; the
    other mesh axes are untouched."""
    from repro_torch.parallel.sharding import axis_group, mesh_axes
    size = mesh_axes(mesh)[axis_name]

    def apply(grads, residuals):
        return compressed_psum(grads, residuals,
                               axis_group(mesh, (axis_name,)), size)

    return apply
