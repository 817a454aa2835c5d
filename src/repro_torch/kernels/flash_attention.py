"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd function that joins them.

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

Both kernels live in ``csrc/flash_attention.cu`` and are bound by
operations: 57.6 GFLOP per call at the serving path's shape (B=8, S=1002,
H=28, KV=4, D=128, bf16, causal), 0.058 ms at 989 TFLOP/s.  A CTA takes
one (batch, kv head) and a block of the flattened (query position, head
in group) rows, so each K/V tile it loads serves all G heads; it keeps
(m, l, acc) in f32 registers, skips the tiles above the diagonal and
masks ragged edges.  :func:`_variant` picks the kernel, by rules that
depend only on dtype, widths, strides and alignment:

* ``"tc"``, the tensor-core kernel: bf16 with D and Dv multiples of 16, G
  at most 128, and 16-byte aligned rows (base pointers and the batch,
  position and head strides of q, k, v positive multiples of 8 elements).
  Persistent, one CTA per SM; an item is all G heads of as many positions
  as fit 64 rows per consumer warpgroup (three, or two at D > 128);
  ``wgmma`` products in bf16 with f32 accumulation; Q, K and V in and O
  out by TMA; the softmax of one tile overlapping the previous tile's
  P.V.  Like the Pallas kernel (which casts P to ``v.dtype`` before P.V)
  it rounds P to bf16 before P.V.
* ``"fma"``, the FMA kernel: every f32 input and the other bf16 inputs.
  64 rows a CTA, f32 FMA products from shared memory, P in f32.

Tolerance against the plain version: 2e-5 in f32 and 2e-2 in bf16 (the
order of the sums differs; bf16 rounds the output and, in the tensor-core
kernel, P), as ``tests/test_kernels.py`` holds the Pallas kernel.

:func:`flash_attention` runs the plain version only for tensors that lie
on the CPU (counted in ``flash_attention.plain_calls``); for a CUDA tensor
it launches the chosen kernel or raises.  ``flash_attention.launches``
counts every launch, ``tc_launches`` and ``fma_launches`` each variant's.

Training: when grad is enabled and q, k or v requires it,
:func:`flash_attention` goes through :class:`FlashAttention`, whose
forward asks either kernel for the (B, H, Sq) f32 log-sum-exp of each
row's scaled scores as well (written only when asked, so serving is
unchanged) and saves q, k, v, the output and the log-sum-exp.  Its
backward is :func:`flash_attention_bwd`: on a CUDA tensor the kernels
of ``csrc/flash_attention_bwd.cu`` (a delta pass and one dq / dk / dv
pass, counted once a call in ``flash_attention_bwd.launches``, and in
``tc_launches`` or ``fma_launches``), on a CPU tensor
:func:`flash_attention_bwd_plain`.  :func:`_bwd_variant` sends bf16 with
D and Dv multiples of 16 and 16-byte rows to the tensor-core kernel
(``flash_bwd_tc``: ldmatrix fragments, dq by one bulk reduction a row);
f32 and the other inputs take the FMA kernel (``flash_bwd``).  Under
``torch.utils.checkpoint`` the forward runs again in the backward pass,
log-sum-exp and all.  The CPU versions also take float64, for
``torch.autograd.gradcheck``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.work import counting, record, uncounted

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain", "work"]

_ENTRY = {("fma", torch.float32): "flash_attention_f32",
          ("fma", torch.bfloat16): "flash_attention_bf16",
          ("tc", torch.bfloat16): "flash_attention_bf16_tc"}
_DTYPES = (torch.float32, torch.bfloat16)
_BWD_ENTRY = {("fma", torch.float32): "flash_attention_bwd_f32",
              ("fma", torch.bfloat16): "flash_attention_bwd_bf16",
              ("tc", torch.bfloat16): "flash_attention_bwd_bf16_tc"}
MAX_HEAD_DIM = 256
#: the tensor-core kernel's items hold every head of a kv head's group
#: for at least one position: 128 rows at D > 128
MAX_TC_GROUP = 128
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
    cpu_f64 = q.dtype == torch.float64 and q.device.type == "cpu"
    if (q.dtype not in _DTYPES and not cpu_f64) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must all be float32 or bfloat16 "
                        f"(or float64 on the CPU), got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
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


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 sums, f64 for f64 inputs (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """The scaled scores (B, KV, G, Sq, Skv), masked to -1e30 above the
    diagonal (aligned at 0) when ``causal``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    qg = q.reshape(B, Sq, KV, H // KV, D).to(acc)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(acc)) * (D ** -0.5)
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, return_lse: bool = False):
    """The same function in plain PyTorch: full f32 scores with GQA by
    reshape, as ``ref.attention_ref``, with the causal mask aligned at 0.
    With ``return_lse`` also the (B, H, Sq) f32 log-sum-exp of each row's
    scaled scores."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(s.dtype))
    o = o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor,
                              causal: bool = True):
    """The backward pass in plain PyTorch, the kernel's math: P from the
    saved log-sum-exp, ``delta = rowsum(do o)``, ``dS = P (dP - delta)``;
    dk and dv summed over each kv head's G query heads.  Returns (dq, dk,
    dv) in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    s = _scores(q, k, causal)
    acc = s.dtype
    p = torch.exp(s - lse.to(acc).reshape(B, KV, G, Sq, 1))
    dog = do.reshape(B, Sq, KV, G, Dv).to(acc)
    delta = (dog * o.reshape(B, Sq, KV, G, Dv).to(acc)).sum(-1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.to(acc))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    qg = q.reshape(B, Sq, KV, G, D).to(acc)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(acc)) * (D ** -0.5)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * (D ** -0.5)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _variant(dtype: torch.dtype, D: int, Dv: int, G: int, strides,
             ptrs) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for bf16 with
    D and Dv multiples of 16, at most MAX_TC_GROUP query heads per kv head
    (G), ``strides`` (the batch, position and head element strides of q,
    k and v) positive multiples of 8 and base addresses ``ptrs`` 16-byte
    aligned; else ``"fma"``."""
    if dtype != torch.bfloat16 or D % 16 or Dv % 16 or G > MAX_TC_GROUP:
        return "fma"
    if any(s <= 0 or s % 8 for s in strides) or any(p % 16 for p in ptrs):
        return "fma"
    return "tc"


@functools.lru_cache(maxsize=None)
def _entry(variant: str, dtype: torch.dtype):
    fn = getattr(load("flash_attention"), _ENTRY[variant, dtype])
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bwd_variant(dtype: torch.dtype, D: int, Dv: int, strides,
                 ptrs) -> str:
    """The backward kernel a CUDA call takes: ``"tc"`` (tensor cores) for
    bf16 with D and Dv multiples of 16, ``strides`` (the batch, position
    and head element strides of q, k, v and do) positive multiples of 8
    and base addresses ``ptrs`` (q, k, v, do) 16-byte aligned; else
    ``"fma"``."""
    if dtype != torch.bfloat16 or D % 16 or Dv % 16:
        return "fma"
    if any(s <= 0 or s % 8 for s in strides) or any(p % 16 for p in ptrs):
        return "fma"
    return "tc"


def work(q, k, v, causal: bool, backward: bool = False,
         lse: bool = False) -> tuple:
    """(bytes, operations) of one call on q (B, Sq, H, D), k (B, Skv, KV,
    D), v (B, Skv, KV, Dv) (anything with ``shape`` and ``dtype``): each
    input read and each output written once, the products over the
    (query, key) pairs the mask keeps (causal: Sq = Skv).  Forward: q, k,
    v read, the output written (and the (B, H, Sq) f32 log-sum-exp with
    ``lse``); S = QK^T and PV.  ``backward``: q, k, v, the output and its
    cotangent and the log-sum-exp read, dq, dk, dv written; S again, dV,
    dP, dQ and dK."""
    B, Sq, H, D = q.shape
    Skv, Dv = k.shape[1], v.shape[3]
    pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Skv)
    e = q.dtype.itemsize
    n = math.prod(q.shape) + math.prod(k.shape) + math.prod(v.shape) \
        + B * Sq * H * Dv
    if backward:
        return e * 2 * n + 4 * B * H * Sq, 2 * pairs * (3 * D + 2 * Dv)
    return e * n + (4 * B * H * Sq if lse else 0), 2 * pairs * (D + Dv)


@functools.lru_cache(maxsize=None)
def _bwd_entry(variant: str, dtype: torch.dtype):
    fn = getattr(load("flash_attention_bwd"), _BWD_ENTRY[variant, dtype])
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Skv, KV, D), v (B, Skv, KV, Dv) ->
    (B, Sq, H, Dv) in q's dtype.

    CPU tensors take :func:`flash_attention_plain` (counted in
    ``flash_attention.plain_calls``); CUDA tensors launch the kernel that
    :func:`_variant` picks on the current stream (counted in
    ``flash_attention.launches`` and in ``tc_launches`` or
    ``fma_launches``).  Under grad, when q, k or v requires it, through
    :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _flash_forward(q, k, v, causal, False)[0]


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, with_lse: bool):
    """(out, lse or None): the forward of :func:`flash_attention`, the
    (B, H, Sq) f32 log-sum-exp too when ``with_lse``."""
    check_attention_inputs("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if causal and Sq != Skv:
        raise ValueError(f"causal flash_attention aligns query and key "
                         f"positions at 0 and needs Sq == Skv, got {Sq} "
                         f"and {Skv}")
    if Skv == 0 and Sq > 0:
        raise ValueError("flash_attention needs at least one key")
    if counting():
        record("flash_attention", *work(q, k, v, causal, lse=with_lse))
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        with uncounted():
            if with_lse:
                return flash_attention_plain(q, k, v, causal,
                                             return_lse=True)
            return flash_attention_plain(q, k, v, causal), None
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    strides = strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 1, 2)))
    variant = _variant(q.dtype, D, Dv, H // KV, strides[:9],
                       (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    fn = _entry(variant, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KV,
                D, Dv, int(causal), strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention.launches += 1
    if variant == "tc":
        flash_attention.tc_launches += 1
    else:
        flash_attention.fma_launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v) with output
    ``o`` and log-sum-exp ``lse`` (B, H, Sq) f32, for the cotangent
    ``do`` (B, Sq, H, Dv), each in its input's dtype.

    CPU tensors take :func:`flash_attention_bwd_plain` (counted in
    ``flash_attention_bwd.plain_calls``); CUDA tensors launch the kernels
    that :func:`_bwd_variant` picks on the current stream (counted once a
    call, two kernels, in ``flash_attention_bwd.launches`` and in
    ``tc_launches`` or ``fma_launches``)."""
    check_attention_inputs("flash_attention_bwd", q, k, v)
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(o.shape) != (B, Sq, H, Dv) or tuple(do.shape) != tuple(o.shape) \
            or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)} and v {tuple(v.shape)}")
    if causal and Sq != Skv:
        raise ValueError(f"causal flash_attention_bwd needs Sq == Skv, got "
                         f"{Sq} and {Skv}")
    if counting():
        record("flash_attention_bwd", *work(q, k, v, causal, backward=True))
    if q.device.type == "cpu":
        flash_attention_bwd.plain_calls += 1
        with uncounted():
            return flash_attention_bwd_plain(q, k, v, o, do.to(q.dtype), lse,
                                             causal)
    # the kernel reads rows with a contiguous head dim, in q's dtype
    o, do = (t.to(q.dtype) if t.stride(3) == 1 or t.shape[3] == 1
             else t.to(q.dtype).contiguous() for t in (o, do))
    lse = lse.float().contiguous()
    dk = torch.empty((B, Skv, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Skv, KV, Dv), dtype=q.dtype, device=q.device)
    if Sq == 0 or Skv == 0 or B == 0:
        return q.new_zeros((B, Sq, H, D)), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (o, (0, 1, 2)), (do, (0, 1, 2)))
    G = H // KV
    variant = _bwd_variant(q.dtype, D, Dv, strides[:9] + strides[12:],
                           (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr()))
    # f32 sums of dq: the tensor-core kernel's in its (batch, kv head,
    # position, head in group) row order
    dq = torch.zeros((B, KV, Sq, G, D) if variant == "tc" else
                     (B, Sq, H, D), dtype=torch.float32, device=q.device)
    fn = _bwd_entry(variant, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H,
                KV, D, Dv, int(causal), strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd {variant} kernel launch "
                           f"failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    if variant == "tc":
        flash_attention_bwd.tc_launches += 1
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        out.view(B, Sq, KV, G, D).copy_(dq.transpose(1, 2))
        return out, dk, dv
    flash_attention_bwd.fma_launches += 1
    return dq.to(q.dtype), dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its backward: the forward keeps the
    log-sum-exp, the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _flash_forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, ctx.causal)
        return dq, dk, dv, None


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.fma_launches = 0
flash_attention.plain_calls = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0
flash_attention_bwd.fma_launches = 0
flash_attention_bwd.plain_calls = 0
