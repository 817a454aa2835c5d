"""Flash attention (forward): the CUDA kernel's wrapper and its plain
version.

``out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // G] / sqrt(D)) v[b, j,
h // G]`` over the keys ``j < Skv`` (and ``j <= i`` when ``causal``), with
``G = H // KV`` query heads per kv head.  Shapes are the reference's:
q (B, Sq, H, D), k (B, Skv, KV, D), v (B, Skv, KV, Dv) -> (B, Sq, H, Dv)
in q's dtype.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py::
flash_attention``.  The model's prefill (``models/attention.py::
attention_fwd``) calls it once per layer on the GQA k/v as they are.

The causal mask aligns the query and key positions at 0, as the Pallas
kernel and the reference's ``blockwise_attention`` do, while
``ref.attention_ref`` aligns them bottom-right.  The three agree only when
``Sq == Skv``, the only case the model has, so ``causal`` with
``Sq != Skv`` is refused.

The kernel (``csrc/flash_attention.cu``) is bound by operations: ~60 GFLOP
per call at the serving path's shape (B=8, S=1024, H=28, KV=4, D=128,
bf16, causal), ~0.061 ms at 989 TFLOP/s.  One CTA per (batch, kv head, 64
(query, head) rows) loads each K/V tile into shared memory once for all G
heads, keeps (m, l, acc) in f32 registers, skips the tiles above the
diagonal and masks ragged edges.  Like the Pallas kernel it computes in
f32 throughout (the reference model's XLA path casts P to the value dtype
before P.V, so at bf16 the two differ slightly).

Tolerance against the plain version: 2e-5 in f32 and 2e-2 in bf16 (the
order of the sums differs; bf16 rounds the output), as
``tests/test_kernels.py`` holds the Pallas kernel.

:func:`flash_attention` runs the plain version only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

__all__ = ["flash_attention", "flash_attention_plain"]

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65535


def check_attention_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> None:
    """Checks shared by the two attention wrappers: rank, batch and
    sequence agreement, GQA grouping, head dims, dtype, device and a
    contiguous head dim."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be 4-d (B, S, heads, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    _, S, KV, Dk = k.shape
    if k.shape[0] != B or v.shape[0] != B or v.shape[1] != S \
            or v.shape[2] != KV:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if KV < 1 or H % KV:
        raise ValueError(f"{name}: {H} query heads are not a multiple of "
                         f"{KV} kv heads")
    if Dk != D:
        raise ValueError(f"{name}: q head dim {D} != k head dim {Dk}")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= v.shape[3] <= MAX_HEAD_DIM):
        raise ValueError(f"{name}: head dims {D}, {v.shape[3]} must lie in "
                         f"[1, {MAX_HEAD_DIM}]")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must all be float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if any(t.stride(3) != 1 and t.shape[3] > 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim of q, k, v must be "
                         f"contiguous")
    if B * KV > _MAX_GRID_Y:
        raise ValueError(f"{name}: B * KV = {B * KV} exceeds {_MAX_GRID_Y}")


def strides_arg(*tensors_and_dims):
    """A ctypes array of the element strides ``t.stride(d)`` for each
    ``(t, dims)`` pair, in order."""
    vals = [t.stride(d) for t, dims in tensors_and_dims for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch: full f32 scores with GQA by
    reshape, as ``ref.attention_ref``, with the causal mask aligned at 0."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(load("flash_attention"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Skv, KV, D), v (B, Skv, KV, Dv) ->
    (B, Sq, H, Dv) in q's dtype.

    CPU tensors take :func:`flash_attention_plain` (counted in
    ``flash_attention.plain_calls``); CUDA tensors launch the kernel on
    the current stream (counted in ``flash_attention.launches``)."""
    check_attention_inputs("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if causal and Sq != Skv:
        raise ValueError(f"causal flash_attention aligns query and key "
                         f"positions at 0 and needs Sq == Skv, got {Sq} "
                         f"and {Skv}")
    if Skv == 0 and Sq > 0:
        raise ValueError("flash_attention needs at least one key")
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, causal)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 1, 2)))
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Skv, H, KV, D, Dv, int(causal), strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.plain_calls = 0
