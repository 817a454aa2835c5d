"""Grouped (expert-batched) matrix product: the CUDA kernel's wrapper and
its plain version.

``out[e] = x[e] @ w[e]``: x (E, C, D), w (E, D, F) -> (E, C, F) in x's
dtype, accumulated in f32.  x and w are both bf16 or both f32.

Replaces the Pallas kernel ``src/repro/kernels/moe_gmm.py::gmm``.  The
reference's MoE layer computes the same product with its
``"egcd,edf->egcf"`` einsums; the port's (``models/moe.py::moe_ffn``)
calls this wrapper three times per layer on the (E, G·cap, D) slot
tensor.

Two CUDA kernels (``csrc/gmm.cu``), chosen by :func:`_variant`: bf16
goes through the tensor cores (``wgmma``: persistent CTAs, a ring of
TMA-loaded stages, f32 accumulators; for C <= 16 the operands swap so
that the weights stream as wgmma's 64-row side), f32 through f32 FMAs.
At qwen3-moe-30b-a3b's prefill shape (E = 128, C = 624, D = 2048,
F = 768, bf16) a call is 251 GFLOP and 853 MB, ~0.254 ms at either of
the H100's peaks; at the decode shape (C = 4) the 403 MB of weights bound
it at ~0.120 ms.  Any C >= 1 is taken (the kernels mask the ragged
edge); D and F must be multiples of 16.

Tolerance against the plain version: 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_kernels.py`` holds the Pallas kernel (the f32 sums run in
another order; bf16 outputs round once, from f32).

:func:`gmm` runs the plain version only for tensors that lie on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

__all__ = ["gmm", "gmm_plain"]

_ENTRY = {"fma": "gmm_f32", "wgmma": "gmm_bf16"}
_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm takes x (E, C, D) and w (E, D, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gmm: x and w must both be float32 or both "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"gmm: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm: x and w must be contiguous")
    D, F = w.shape[1], w.shape[2]
    if D % 16 or F % 16 or D == 0 or F == 0:
        raise ValueError(f"gmm: D = {D} and F = {F} must be positive "
                         f"multiples of 16")
    if max(x.shape) > _INT_MAX or F > _INT_MAX:
        raise ValueError(f"gmm: sizes out of range: {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")


def gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, ``ref.gmm_ref``'s math: an f32
    batched product of the up-cast inputs, cast to x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def _variant(dtype: torch.dtype, C: int, D: int, F: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` (tensor cores) for bf16,
    ``"fma"`` for f32, whose 2e-5 tolerance TF32 tiles would break.  C, D
    and F do not change the choice: the wgmma kernel takes every shape
    :func:`_check` lets through (inside it, C <= 16 swaps the operands)."""
    del C, D, F
    return "wgmma" if dtype == torch.bfloat16 else "fma"


@functools.lru_cache(maxsize=None)
def _entry(variant: str):
    fn = getattr(load("gmm"), _ENTRY[variant])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D), w (E, D, F) -> (E, C, F) in x's dtype.

    CPU tensors take :func:`gmm_plain` (counted in ``gmm.plain_calls``);
    CUDA tensors launch the kernel that :func:`_variant` picks on the
    current stream (counted in ``gmm.launches`` and in ``wgmma_launches``
    or ``fma_launches``)."""
    _check(x, w)
    if x.device.type == "cpu":
        gmm.plain_calls += 1
        return gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm runs on CUDA or CPU tensors, got {x.device}")
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if E == 0 or C == 0:
        return out
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gmm: x and w must start on a 16-byte boundary")
    variant = _variant(x.dtype, C, D, F)
    fn = _entry(variant)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
                stream)
    if rc != 0:
        raise RuntimeError(f"gmm {variant} kernel launch failed: CUDA error "
                           f"{rc}")
    gmm.launches += 1
    if variant == "wgmma":
        gmm.wgmma_launches += 1
    else:
        gmm.fma_launches += 1
    return out


gmm.launches = 0
gmm.wgmma_launches = 0
gmm.fma_launches = 0
gmm.plain_calls = 0
