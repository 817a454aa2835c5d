"""Flash-decoding: the CUDA kernel's wrapper and its plain version.

One query token per batch row against a KV cache with a per-row valid
length: ``out[b, 0, h] = softmax_{j < kv_len[b]}(q[b, 0, h] . k[b, j,
h // G] / sqrt(D)) v[b, j, h // G]``.  Shapes are the reference's:
q (B, 1, H, D), k (B, S, KV, D), v (B, S, KV, Dv), kv_len (B,) int32 ->
(B, 1, H, Dv) in q's dtype.

Replaces the Pallas kernel ``src/repro/kernels/decode_attention.py::
decode_attention``.  The model's decode step (``models/attention.py::
attention_decode``) calls it once per layer with ``kv_len = len + 1``.

The kernel (``csrc/decode_attention.cu``) is bound by bytes: K and V up to
``kv_len`` are read once, ~16.7 MB per call at the serving path's shape
(B=8, KV=4, D=128, bf16, kv_len ~1018 of S=2048), ~5.0 us at 3.35 TB/s.
Pass 1 splits the cache into chunks of 64 positions, one CTA per (chunk,
batch, kv head) for all G heads, and a chunk at or beyond ``kv_len[b]``
reads nothing; pass 2 combines the chunks' (m, l, acc) partials.  Scores,
probabilities and sums are f32 throughout, as in the Pallas kernel.

``kv_len`` is clamped to [0, S].  Every length from 1 to S is supported; a
row with ``kv_len == 0`` has no keys and its output is not specified (the
reference averages V uniformly there, the kernel writes zeros); the model
never produces one.

Tolerance against the plain version: 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_kernels.py`` holds the Pallas kernel.

:func:`decode_attention` runs the plain version only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention import (check_attention_inputs,
                                                 strides_arg)

__all__ = ["decode_attention", "decode_attention_plain"]

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, ``ref.decode_attention_ref``'s
    math: full f32 scores, positions at or beyond ``kv_len`` masked."""
    B, _, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (D ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(load("decode_attention"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _chunk() -> int:
    fn = load("decode_attention").decode_attention_chunk
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D), k (B, S, KV, D), v (B, S, KV, Dv), kv_len (B,)
    int32 -> (B, 1, H, Dv) in q's dtype.

    CPU tensors take :func:`decode_attention_plain` (counted in
    ``decode_attention.plain_calls``); CUDA tensors launch the kernel's
    two passes on the current stream (counted once in
    ``decode_attention.launches``)."""
    check_attention_inputs("decode_attention", q, k, v)
    B, Sq, H, D = q.shape
    S, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if Sq != 1:
        raise ValueError(f"decode_attention takes one query token per row, "
                         f"got q {tuple(q.shape)}")
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError(f"kv_len must be ({B},) int32, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    if kv_len.device != q.device:
        raise ValueError(f"kv_len on {kv_len.device}, q on {q.device}")
    if q.device.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_plain(q, k, v, kv_len)
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    kv_len = kv_len.contiguous()
    G, n_splits = H // KV, -(-S // _chunk())
    part_ml = torch.empty((B * KV, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B * KV, n_splits, G, Dv), dtype=torch.float32,
                           device=q.device)
    strides = strides_arg((q, (0, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 2)))
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                B, S, H, KV, D, Dv, n_splits, strides, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0
