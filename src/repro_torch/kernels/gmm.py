"""Grouped (expert-batched) matrix product, forward and backward: the CUDA
kernels' wrappers, their plain versions and the autograd function that
joins them.

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
F = 768, bf16) a call is 251 GFLOP and 852 MB, ~0.254 ms at either of
the H100's peaks; at the decode shape (C = 4) the 403 MB of weights bound
it at ~0.120 ms.  Any C >= 1 is taken (the kernels mask the ragged
edge); D and F must be multiples of 16.

Tolerance against the plain version: 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_kernels.py`` holds the Pallas kernel (the f32 sums run in
another order; bf16 outputs round once, from f32).

:func:`gmm` runs the plain version only for tensors that lie on the CPU;
for a CUDA tensor it launches the kernel or raises.

Training: when grad is enabled and x or w requires it, :func:`gmm` goes
through :class:`GMM`, whose backward is :func:`gmm_bwd`: ``dx[e] =
dy[e] w[e]^T`` and ``dw[e] = x[e]^T dy[e]``, on a CUDA tensor by the
kernels of ``csrc/gmm_bwd.cu`` that :func:`_bwd_variant` picks (bf16:
``wgmma``, persistent CTAs on a TMA ring, dx computed transposed so that
w streams once; f32: FMA tiles; two launches a call, counted once in
``gmm_bwd.launches`` and in ``wgmma_launches`` or ``fma_launches``), on
a CPU tensor by :func:`gmm_bwd_plain`.  The backward takes the
forward's operands as they are, so its only extra condition
(:func:`_check_bwd`) is dy's shape and dtype: the contraction of dw runs
over C, which the kernels mask at any length.  The CPU versions also
take float64, for ``torch.autograd.gradcheck``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.work import counting, record, uncounted

__all__ = ["GMM", "gmm", "gmm_bwd", "gmm_bwd_plain", "gmm_plain", "work"]

_ENTRY = {"fma": "gmm_f32", "wgmma": "gmm_bf16"}
_BWD_ENTRY = {"fma": "gmm_bwd_f32", "wgmma": "gmm_bwd_bf16",
              "mma": "gmm_bwd_bf16_mma"}
_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm takes x (E, C, D) and w (E, D, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    cpu_f64 = x.dtype == torch.float64 and x.device.type == "cpu"
    if (x.dtype not in _DTYPES and not cpu_f64) or w.dtype != x.dtype:
        raise TypeError(f"gmm: x and w must both be float32 or both "
                        f"bfloat16 (or float64 on the CPU), got {x.dtype} "
                        f"and {w.dtype}")
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


def work(x, w, backward: bool = False) -> tuple:
    """(bytes, operations) of one call on x (E, C, D) and w (E, D, F)
    (anything with ``shape`` and ``dtype``): forward x and w read and the
    (E, C, F) output written, one product; ``backward`` x, w and dy read
    and dx, dw written, two products."""
    E, C, D = x.shape
    F = w.shape[2]
    e = x.dtype.itemsize
    nx, nw, ny = E * C * D, E * D * F, E * C * F
    ops = 2 * E * C * D * F
    if backward:
        return e * (2 * nx + 2 * nw + ny), 2 * ops
    return e * (nx + nw + ny), ops


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t up-cast for the sums: f32, or f64 for f64 inputs (gradcheck)."""
    return t if t.dtype == torch.float64 else t.float()


def gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, ``ref.gmm_ref``'s math: an f32
    batched product of the up-cast inputs, cast to x's dtype."""
    return torch.bmm(_acc(x), _acc(w)).to(x.dtype)


def gmm_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """The backward in plain PyTorch: (dx, dw) = (dy w^T, x^T dy) per
    expert, f32 products of the up-cast inputs, in x's and w's dtypes."""
    dyf = _acc(dy)
    return (torch.bmm(dyf, _acc(w).transpose(1, 2)).to(x.dtype),
            torch.bmm(_acc(x).transpose(1, 2), dyf).to(w.dtype))


def _check_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> None:
    """The backward's conditions beyond the forward's :func:`_check`: dy
    (E, C, F) on x's device, in x's dtype."""
    _check(x, w)
    E, C, _ = x.shape
    if tuple(dy.shape) != (E, C, w.shape[2]):
        raise ValueError(f"gmm_bwd: dy {tuple(dy.shape)} does not fit x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)}")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"gmm_bwd: dy is {dy.dtype} on {dy.device}, x is "
                        f"{x.dtype} on {x.device}")


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
    or ``fma_launches``).  Under grad, when x or w requires it, through
    :class:`GMM`."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GMM.apply(x, w)
    return _gmm_forward(x, w)


def _gmm_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    if counting():
        record("gmm", *work(x, w))
    if x.device.type == "cpu":
        gmm.plain_calls += 1
        with uncounted():
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


def _bwd_variant(dtype: torch.dtype, C: int, D: int, F: int, ptrs) -> str:
    """The backward kernel a CUDA call takes: ``"wgmma"`` (tensor cores,
    TMA) for bf16, whose base addresses ``ptrs`` (x, w, dy) must be
    16-byte aligned (TMA's condition; else ValueError, as the forward);
    ``"fma"`` for f32, whose 2e-5 tolerance TF32 tiles would break.  C,
    D and F do not change the choice: the kernels take every shape
    :func:`_check_bwd` lets through.  ``"mma"``, the earlier bf16 kernel
    on mma.sync, is never chosen here."""
    del C, D, F
    if dtype != torch.bfloat16:
        return "fma"
    if any(p % 16 for p in ptrs):
        raise ValueError("gmm_bwd: bf16 x, w and dy must start on a "
                         "16-byte boundary")
    return "wgmma"


@functools.lru_cache(maxsize=None)
def _bwd_entry(variant: str):
    fn = getattr(load("gmm_bwd"), _BWD_ENTRY[variant])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx (E, C, D), dw (E, D, F)) of :func:`gmm` at (x, w) for the
    cotangent ``dy`` (E, C, F), in x's and w's dtype.

    CPU tensors take :func:`gmm_bwd_plain` (counted in
    ``gmm_bwd.plain_calls``); CUDA tensors launch the kernels that
    :func:`_bwd_variant` picks on the current stream, once for dx and
    once for dw (counted once a call in ``gmm_bwd.launches`` and in
    ``wgmma_launches`` or ``fma_launches``)."""
    dy = dy.contiguous()
    _check_bwd(x, w, dy)
    if counting():
        record("gmm_bwd", *work(x, w, backward=True))
    if x.device.type == "cpu":
        gmm_bwd.plain_calls += 1
        with uncounted():
            return gmm_bwd_plain(x, w, dy)
    E, C, D = x.shape
    F = w.shape[2]
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    if E == 0:
        return dx, dw
    if C == 0:
        return dx, dw.zero_()
    variant = _bwd_variant(x.dtype, C, D, F,
                           (x.data_ptr(), w.data_ptr(), dy.data_ptr()))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _bwd_entry(variant)(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                                 dx.data_ptr(), dw.data_ptr(), E, C, D, F,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"gmm_bwd {variant} kernel launch failed: CUDA "
                           f"error {rc}")
    gmm_bwd.launches += 1
    if variant == "wgmma":
        gmm_bwd.wgmma_launches += 1
    elif variant == "fma":
        gmm_bwd.fma_launches += 1
    return dx, dw


class GMM(torch.autograd.Function):
    """:func:`gmm` with its backward :func:`gmm_bwd`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gmm_forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return gmm_bwd(x, w, dy)


gmm.launches = 0
gmm.wgmma_launches = 0
gmm.fma_launches = 0
gmm.plain_calls = 0
gmm_bwd.launches = 0
gmm_bwd.wgmma_launches = 0
gmm_bwd.fma_launches = 0
gmm_bwd.plain_calls = 0
