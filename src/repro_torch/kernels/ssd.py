"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and its plain
version.

For each (batch, head), with ``xd = x * dt`` and ``dA = dt * A``, walking
chunks of ``Q = min(chunk, L)`` positions in order with a carried (P, N)
state::

    cum   = cumsum(dA)
    y     = ((C B^T) o L) xd + (C state^T) o exp(cum),
            L[q, k] = exp(cum_q - cum_k) for q >= k, else 0
    state = state * exp(cum_Q) + (xd o exp(cum_Q - cum))^T B

Head ``h`` reads group ``h // (H // G)`` of B and C.  Shapes are the
reference's: x (B, L, H, P), dt (B, L, H), A (H,), Bm / Cm (B, L, G, N) ->
y (B, L, H, P) f32 and the final state (B, H, P, N) f32.  x, Bm and Cm
may be f32 or bf16 (one dtype for the three), dt and A are taken in f32;
sums, decays and the carried state are f32.

Replaces the Pallas kernel ``src/repro/kernels/ssd.py::ssd``, the twin of
the reference model's XLA ``ssd_chunked``.  The Mamba2 prefill
(``models/ssm.py::mamba2_fwd``) calls it once per layer.

Two CUDA kernels (``csrc/ssd.cu``), chosen by :func:`_variant`: bf16
with P and N multiples of 8 (P <= 64, N <= 128), a chunk of at most 256
positions and 16-byte aligned rows goes through the tensor cores
(``mma.sync`` with bf16 operands and f32 accumulators; the score, state
and ``x * w`` operands as bf16 hi + lo pairs), everything else through
f32 FMAs (P <= 64, N <= 128).  In both, one CTA walks a (batch, head)'s
chunks in order with the state on chip.  At the serving path's shape
(B=8, L=1024, H=64, P=64, N=128, Q=256, bf16) a call moves ~224 MB
(f32 y is 134 MB of it) and computes ~26 GFLOP with C B^T counted once
per (batch, group, chunk): bound by bytes at ~0.067 ms.

The decay is selected on the causal triangle before the exp, in the
kernels and in the plain version: ``cum_q - cum_k`` above the diagonal is
large and positive, and ``exp(seg) * mask`` would give ``inf * 0 = NaN``.

Tolerance against the plain version: 2e-4 in f32 and 4e-2 with bf16 x, B
and C (``tests/test_kernels.py``'s for the Pallas kernel; the prefix sums
and products run in another order, and the tensor-core kernel's hi + lo
pairs keep ~16 bits of each rounded operand).

:func:`ssd` runs the plain version only for tensors that lie on the CPU;
for a CUDA tensor it launches one of the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention import strides_arg

__all__ = ["ssd", "ssd_plain"]

_ENTRY = {("fma", torch.float32): "ssd_f32",
          ("fma", torch.bfloat16): "ssd_bf16",
          ("tc", torch.bfloat16): "ssd_bf16_tc"}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 64
MAX_STATE_DIM = 128
MAX_TC_CHUNK = 256   # the tensor-core kernel holds a chunk in shared memory


def _check_inputs(x, dt, A, Bm, Cm, chunk: int) -> int:
    """Shapes, dtypes, devices and layout of :func:`ssd`'s inputs; returns
    the chunk length ``Q``."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd: x (B, L, H, P), dt (B, L, H), A (H,), Bm and "
                         f"Cm (B, L, G, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (Bsz, L):
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)} do not "
                         f"agree")
    if G < 1 or H % G:
        raise ValueError(f"ssd: {H} heads are not a multiple of {G} groups")
    if L < 1 or chunk < 1:
        raise ValueError(f"ssd needs L >= 1 and chunk >= 1, got L={L}, "
                         f"chunk={chunk}")
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd: length {L} is not a multiple of the chunk "
                         f"{Q}")
    if not (1 <= P <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE_DIM):
        raise ValueError(f"ssd takes head dims up to {MAX_HEAD_DIM} and state "
                         f"dims up to {MAX_STATE_DIM}, got P={P}, N={N}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd: x, Bm, Cm must all be float32 or bfloat16, "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not (dt.is_floating_point() and A.is_floating_point()):
        raise TypeError(f"ssd: dt and A must be floating, got {dt.dtype}, "
                        f"{A.dtype}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd: x, dt, A, Bm, Cm must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd runs on CUDA or CPU tensors, got {x.device}")
    if any(t.stride(3) != 1 and t.shape[3] > 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd: the last dim of x, Bm, Cm must be contiguous")
    return Q


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256):
    """The same function in plain PyTorch: the chunked algebra of the
    reference's ``ssd_chunked``, a Python loop over chunks, f32
    throughout."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    nc = L // Q
    dt = dt.float()
    xd = (x.float() * dt[..., None]).reshape(Bsz, nc, Q, H, P)
    dA = (dt * A.float()).reshape(Bsz, nc, Q, H)
    Bh = Bm.float().repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)
    Ch = Cm.float().repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)
    upper = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xq, Bq, Cq = xd[:, c], Bh[:, c], Ch[:, c]
        cum = dA[:, c].cumsum(dim=1)                           # (B, Q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B, Q, K, H)
        # select on the triangle before the exp: exp(-inf) = 0, no inf
        Lmat = seg.masked_fill(upper[None, :, :, None], float("-inf")).exp()
        scores = torch.einsum("bqhn,bkhn->bqkh", Cq, Bq) * Lmat
        y = torch.einsum("bqkh,bkhp->bqhp", scores, xq)
        y = y + torch.einsum("bqhn,bhpn->bqhp", Cq, state) \
            * cum.exp()[..., None]
        tot = cum[:, -1, :]                                    # (B, H)
        decay_out = (tot[:, None, :] - cum).exp()              # (B, Q, H)
        state = state * tot.exp()[..., None, None] + torch.einsum(
            "bqhn,bqhp->bhpn", Bq, xq * decay_out[..., None])
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(Bsz, L, H, P), state


def _variant(dtype: torch.dtype, L: int, Q: int, P: int, N: int,
             strides=(), ptrs=()) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for bf16 with
    P and N multiples of 8, a chunk ``Q`` of at most MAX_TC_CHUNK
    positions, ``strides`` (x's, B's and C's batch, position and head
    element strides) multiples of 8 and base addresses ``ptrs`` 16-byte
    aligned; else ``"fma"``, whose f32 products hold f32 inputs to 2e-4.
    L does not change the choice: the tensor-core kernel takes the prefix
    sums of any number of chunks, a window at a time."""
    del L
    if dtype != torch.bfloat16 or P % 8 or N % 8 or Q > MAX_TC_CHUNK:
        return "fma"
    if any(s % 8 for s in strides) or any(p % 16 for p in ptrs):
        return "fma"
    return "tc"


@functools.lru_cache(maxsize=None)
def _entry(variant: str, dtype: torch.dtype):
    fn = getattr(load("ssd"), _ENTRY[variant, dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 256):
    """x (B, L, H, P), dt (B, L, H), A (H,), Bm / Cm (B, L, G, N) ->
    (y (B, L, H, P) f32, final state (B, H, P, N) f32).  ``L`` must be a
    multiple of ``min(chunk, L)`` (``ValueError`` otherwise).

    CPU tensors take :func:`ssd_plain` (counted in ``ssd.plain_calls``);
    CUDA tensors launch the kernel that :func:`_variant` picks on the
    current stream (counted in ``ssd.launches`` and in ``tc_launches`` or
    ``fma_launches``)."""
    Q = _check_inputs(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        ssd.plain_calls += 1
        return ssd_plain(x, dt, A, Bm, Cm, chunk)
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    strides = strides_arg((x, (0, 1, 2)), (dt, (0, 1, 2)), (Bm, (0, 1, 2)),
                          (Cm, (0, 1, 2)))
    variant = _variant(x.dtype, L, Q, P, N,
                       [t.stride(d) for t in (x, Bm, Cm) for d in (0, 1, 2)],
                       [t.data_ptr() for t in (x, Bm, Cm)])
    fn = _entry(variant, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, L, H, G,
                P, N, Q, strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd {variant} kernel launch failed: CUDA error "
                           f"{rc}")
    ssd.launches += 1
    if variant == "tc":
        ssd.tc_launches += 1
    else:
        ssd.fma_launches += 1
    return y, state


ssd.launches = 0
ssd.tc_launches = 0
ssd.fma_launches = 0
ssd.plain_calls = 0
