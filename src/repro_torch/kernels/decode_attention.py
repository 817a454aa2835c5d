"""Flash-decoding: the CUDA kernel's wrapper and its plain version.

One query token per batch row against a KV cache with a per-row valid
length: ``out[b, 0, h] = softmax_{j < kv_len[b]}(q[b, 0, h] . k[b, j,
h // G] / sqrt(D)) v[b, j, h // G]``.  Shapes are the reference's:
q (B, 1, H, D), k (B, S, KV, D), v (B, S, KV, Dv), kv_len (B,) int32 ->
(B, 1, H, Dv) in q's dtype.

With ``return_lse=True`` it also returns ``lse`` (B, H) f32, each row's
log-sum-exp ``log sum_{j < kv_len} exp(q . k_j / sqrt(D))`` (-inf where
``kv_len == 0``), which the last CTA of each (batch, kv head) writes
beside the output; ``out`` is the same bits either way.

Replaces the Pallas kernel ``src/repro/kernels/decode_attention.py::
decode_attention``.  The model's decode step (``models/attention.py::
attention_decode``) calls it once per layer with ``kv_len = len + 1``;
under tensor parallelism each model rank calls it on its own block of the
cache's rows with ``return_lse=True``, and
``parallel.sharding.combine_over_model`` merges the ranks' outputs by
their ``lse``.

The kernels (``csrc/decode_attention.cu``) are bound by bytes: K and V
up to ``kv_len`` are read once, ~16.7 MB per call at the serving path's
shape (B=8, KV=4, D=128, bf16, kv_len ~1018 of S=2048), ~5.0 us at
3.35 TB/s.  One launch per call: each (batch, kv head) gets
:func:`_splits` CTAs, each of which reads its row's ``kv_len`` on the
card and takes an even share of the valid positions for all G heads;
the last CTA of each (batch, kv head) to finish combines the partials
in split order, found by a ticket counter it resets itself (the
counters live in :func:`_tickets`, once per device).  bf16 inputs
that :func:`_variant` allows go through ``mma.sync`` tensor-core tiles
(K and V stay bf16 in shared memory), the rest through f32 FMAs.
Scores, probabilities and sums are f32 throughout, as in the Pallas
kernel.

``kv_len`` is clamped to [0, S].  Every length from 1 to S is supported; a
row with ``kv_len == 0`` has no keys and the kernels write zeros there
(the reference averages V uniformly; the model never produces one).
Calls on one device share the ticket counters, so two calls must not run
at once on two streams.

Tolerance against the plain version: 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_kernels.py`` holds the Pallas kernel.

:func:`decode_attention` runs the plain version only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention import (check_attention_inputs,
                                                 strides_arg)
from repro_torch.kernels.work import counting, record, uncounted

__all__ = ["decode_attention", "decode_attention_plain", "work"]

_ENTRY = {("fma", torch.float32): "decode_attention_f32",
          ("fma", torch.bfloat16): "decode_attention_bf16",
          ("mma", torch.bfloat16): "decode_attention_bf16_mma"}
#: cache positions of a kernel tile: a split gets at least one
TILE = 64
#: CTAs of the mma kernel that fit on one SM at once (~96 KB of shared
#: memory each at D = 128)
CTAS_PER_SM = 2
#: the most query heads per kv head that the mma kernel's 16-row tiles take
MAX_MMA_GROUP = 16


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, *, return_lse: bool = False):
    """The same function in plain PyTorch, ``ref.decode_attention_ref``'s
    math: full f32 scores, positions at or beyond ``kv_len`` masked (a row
    with ``kv_len == 0`` averages V uniformly, as the reference's does).
    With ``return_lse`` also the scores' log-sum-exp (B, H) f32 over the
    valid positions, -inf where ``kv_len == 0``."""
    B, _, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (D ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = o.reshape(B, 1, H, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, H)
    return out, torch.where(kv_len[:, None] > 0, lse, -torch.inf)


def work(q, k, v, used: int, lse: bool = False) -> tuple:
    """(bytes, operations) of one call on q (B, 1, H, D), k (B, S, KV, D),
    v (B, S, KV, Dv) (anything with ``shape`` and ``dtype``) whose rows
    hold ``used`` valid cache positions in all (the sum of ``kv_len``
    clamped to [0, S]: the work depends on the data): q read, K and V read
    up to each row's length, ``kv_len`` read, the output written (and the
    (B, H) f32 log-sum-exp with ``lse``); q . k and p . v over the valid
    positions of every head."""
    B, _, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    e = q.dtype.itemsize
    nbytes = e * (math.prod(q.shape) + used * KV * (D + Dv) + B * H * Dv) \
        + 4 * B + (4 * B * H if lse else 0)
    return nbytes, 2 * H * used * (D + Dv)


def _splits(B: int, KV: int, S: int, n_sm: int) -> int:
    """CTAs per (batch, kv head): as many as keep all B * KV * n_split
    CTAs resident at once, CTAS_PER_SM an SM (a second wave of a few CTAs
    costs more than the finer split gains; ``chip_smoke.py`` times other
    split counts beside this one), at least 1 and at most one per tile of
    the cache.  A function of the shapes and the card alone, never of
    ``kv_len``, which lives on the card (reading it here would wait for
    the device)."""
    return max(1, min(CTAS_PER_SM * n_sm // (B * KV), -(-S // TILE)))


def _variant(dtype: torch.dtype, D: int, Dv: int, G: int, strides,
             ptrs) -> str:
    """The kernel a CUDA call takes: ``"mma"`` (tensor cores) for bf16 with
    D and Dv multiples of 16, at most MAX_MMA_GROUP query heads per kv
    head (G), ``strides`` (q's batch and head, k's and v's batch, position
    and head element strides) multiples of 8 and base addresses ``ptrs``
    16-byte aligned; else ``"fma"``."""
    if dtype != torch.bfloat16 or D % 16 or Dv % 16 or G > MAX_MMA_GROUP:
        return "fma"
    if any(s % 8 for s in strides) or any(p % 16 for p in ptrs):
        return "fma"
    return "mma"


@functools.lru_cache(maxsize=None)
def _entry(variant: str, dtype: torch.dtype):
    fn = getattr(load("decode_attention"), _ENTRY[variant, dtype])
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` ticket counters on ``device``, zero between calls:
    allocated zeroed on first use (and when more are needed), then kept,
    since each call's last CTAs set theirs back to zero."""
    t = _TICKETS.get(device.index)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: call it once outside CUDA "
                               "graph capture first, to allocate its "
                               "ticket counters")
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device.index] = t
    return t


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, return_lse: bool = False):
    """q (B, 1, H, D), k (B, S, KV, D), v (B, S, KV, Dv), kv_len (B,)
    int32 -> (B, 1, H, Dv) in q's dtype; with ``return_lse`` (out, lse),
    lse (B, H) f32 each row's log-sum-exp of its scaled scores (-inf
    where ``kv_len == 0``), written by the same launch.

    CPU tensors take :func:`decode_attention_plain` (counted in
    ``decode_attention.plain_calls``); CUDA tensors launch the kernel that
    :func:`_variant` picks, once, on the current stream (counted in
    ``decode_attention.launches`` and in ``mma_launches`` or
    ``fma_launches``)."""
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
    if counting():
        with uncounted():
            used = int(kv_len.clamp(0, S).sum())
        record("decode_attention", *work(q, k, v, used, return_lse))
    if q.device.type == "cpu":
        decode_attention.plain_calls += 1
        with uncounted():
            return decode_attention_plain(q, k, v, kv_len,
                                          return_lse=return_lse)
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or S == 0:
        out.zero_()
        return (out, lse.fill_(-torch.inf)) if return_lse else out
    kv_len = kv_len.contiguous()
    G = H // KV
    n_split = _splits(B, KV, S, _sm_count(q.device.index))
    part_ml = torch.empty((B * KV, n_split, G, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B * KV, n_split, G, Dv), dtype=torch.float32,
                           device=q.device)
    tickets = _tickets(q.device, B * KV)
    strides = strides_arg((q, (0, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 2)))
    variant = _variant(q.dtype, D, Dv, G, strides[:8],
                       (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    fn = _entry(variant, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                part_ml.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(), B, S,
                H, KV, D, Dv, n_split, strides, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention {variant} kernel launch "
                           f"failed: CUDA error {rc}")
    decode_attention.launches += 1
    if variant == "mma":
        decode_attention.mma_launches += 1
    else:
        decode_attention.fma_launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
decode_attention.mma_launches = 0
decode_attention.fma_launches = 0
decode_attention.plain_calls = 0
