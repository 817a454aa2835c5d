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

Training: when grad is enabled and x, dt, A, Bm or Cm requires it,
:func:`ssd` goes through :class:`SSD`, whose forward asks the kernel for
each chunk's incoming state (B, nc, H, P, N) f32 as well (written only
when asked, so serving is unchanged) and whose backward is
:func:`ssd_bwd`: on a CUDA tensor the kernels of ``csrc/ssd_bwd.cu``
(counted once a call in ``ssd_bwd.launches``, and in ``tc_launches`` or
``fma_launches``), on a CPU tensor :func:`ssd_bwd_plain`
(``ssd_bwd.plain_calls``).  :func:`_bwd_variant` sends bf16 with P and N
multiples of 8, a chunk of at most 256 and 16-byte rows to the
tensor-core path (four kernels on an f32 scratch of
:func:`bwd_scratch_floats` elements: each chunk's own state-cotangent
term, the carry across chunks, the chunk-local products on ``mma.sync``
with bf16 hi + lo pairs for the f32 operands, the reverse cumsum); f32
and the other inputs take the FMA kernel (one CTA a (batch, head)
walking the chunks in reverse).  dB and dC are summed over each group's
heads by f32 atomics in both.  The backward walks the chunks in reverse
with the state's cotangent carried, and selects every decay on the
causal triangle before the exp, as the forward does: the reference's
``jnp.where(causal, exp(seg), 0)`` gives NaN gradients once a chunk's
decay passes ~88 (ROADMAP Queue 3), the port's stay finite.  The plain
versions also take float64.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention import _acc_dtype, strides_arg
from repro_torch.kernels.work import counting, record, uncounted

__all__ = ["SSD", "ssd", "ssd_bwd", "ssd_bwd_plain", "ssd_plain", "work"]

_ENTRY = {("fma", torch.float32): "ssd_f32",
          ("fma", torch.bfloat16): "ssd_bf16",
          ("tc", torch.bfloat16): "ssd_bf16_tc"}
_BWD_ENTRY = {("fma", torch.float32): "ssd_bwd_f32",
              ("fma", torch.bfloat16): "ssd_bwd_bf16",
              ("tc", torch.bfloat16): "ssd_bwd_bf16_tc"}
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
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256,
              return_states: bool = False):
    """The same function in plain PyTorch: the chunked algebra of the
    reference's ``ssd_chunked``, a Python loop over chunks, f32
    throughout (f64 for f64 inputs).  With ``return_states`` also each
    chunk's incoming state (B, nc, H, P, N), the first one zeros."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    nc = L // Q
    acc = _acc_dtype(x)
    dt = dt.to(acc)
    xd = (x.to(acc) * dt[..., None]).reshape(Bsz, nc, Q, H, P)
    dA = (dt * A.to(acc)).reshape(Bsz, nc, Q, H)
    Bh = Bm.to(acc).repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)
    Ch = Cm.to(acc).repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)
    upper = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((Bsz, H, P, N), dtype=acc, device=x.device)
    ys, states = [], []
    for c in range(nc):
        states.append(state)
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
    y = torch.stack(ys, dim=1).reshape(Bsz, L, H, P)
    if return_states:
        return y, state, torch.stack(states, dim=1)
    return y, state


def ssd_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, states: torch.Tensor,
                  dy: torch.Tensor, dstate=None, chunk: int = 256):
    """The backward pass in plain PyTorch, the kernel's math: the chunks
    in reverse order with the cotangent ``dS`` (B, H, P, N) of the state
    leaving the chunk carried from one to the next (``dstate`` at the
    end, zeros without one); ``states`` (B, nc, H, P, N) are the chunks'
    incoming states (:func:`ssd_plain`'s ``return_states``).  Per chunk,
    with ``L[q, k] = exp(cum_q - cum_k)`` selected on the causal triangle
    before the exp, ``CB = C B^T`` and ``DX = dy xd^T``::

        dC_q  = sum_k (DX o L)_qk B_k + exp(cum_q) dy_q S_in
        dB_k  = sum_q (DX o L)_qk C_q + exp(tot - cum_k) dS^T xd_k
        dxd_k = sum_q (CB o L)_qk dy_q + exp(tot - cum_k) dS B_k
        dcum  = rowsum(M) - colsum(M) + exp(cum) (dy S_in C)
                - exp(tot - cum) (xd^T dS B),  M = CB o DX o L
        dcum[Q - 1] += exp(tot) <dS, S_in> + sum_k exp(tot - cum_k)
                       (xd_k^T dS B_k)
        dS   <- exp(tot) dS + sum_q exp(cum_q) dy_q C_q^T

    then ``d(dA)`` is the reverse cumsum of ``dcum``, ``dx = dxd dt``,
    ``ddt = dxd . x + d(dA) A`` and ``dA_h = sum d(dA) dt``.  dB and dC
    are summed over each group's heads.  Returns (dx, ddt, dA, dBm, dCm)
    in the dtypes of x, dt, A, Bm and Cm, f32 sums (f64 for f64
    inputs)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    nc = L // Q
    acc = _acc_dtype(x)
    xs = x.to(acc).reshape(Bsz, nc, Q, H, P)
    dts = dt.to(acc).reshape(Bsz, nc, Q, H)
    Af = A.to(acc)
    Bh = Bm.to(acc).repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)
    Ch = Cm.to(acc).repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)
    dys = dy.to(acc).reshape(Bsz, nc, Q, H, P)
    states = states.to(acc)
    dS = torch.zeros((Bsz, H, P, N), dtype=acc, device=x.device) \
        if dstate is None else dstate.to(acc)
    upper = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dxs, ddts, dBs, dCs = [None] * nc, [None] * nc, [None] * nc, [None] * nc
    dA = torch.zeros((H,), dtype=acc, device=x.device)
    for c in reversed(range(nc)):
        xq, dtq, Bq, Cq, dyq = xs[:, c], dts[:, c], Bh[:, c], Ch[:, c], \
            dys[:, c]
        S_in = states[:, c]
        xd = xq * dtq[..., None]
        cum = (dtq * Af).cumsum(dim=1)                         # (B, Q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B, Q, K, H)
        Lm = seg.masked_fill(upper[None, :, :, None], float("-inf")).exp()
        CB = torch.einsum("bqhn,bkhn->bqkh", Cq, Bq)
        DX = torch.einsum("bqhp,bkhp->bqkh", dyq, xd)
        T1, T2 = DX * Lm, CB * Lm
        M = CB * T1
        e_in = cum.exp()                                       # (B, Q, H)
        tot = cum[:, -1, :]                                    # (B, H)
        w = (tot[:, None, :] - cum).exp()                      # (B, Q, H)
        dyS = torch.einsum("bqhp,bhpn->bqhn", dyq, S_in)
        dSB = torch.einsum("bhpn,bkhn->bkhp", dS, Bq)
        dC = torch.einsum("bqkh,bkhn->bqhn", T1, Bq) + e_in[..., None] * dyS
        dB = torch.einsum("bqkh,bqhn->bkhn", T1, Cq) + w[..., None] \
            * torch.einsum("bkhp,bhpn->bkhn", xd, dS)
        dxd = torch.einsum("bqkh,bqhp->bkhp", T2, dyq) + w[..., None] * dSB
        W = w * (xd * dSB).sum(-1)                             # (B, K, H)
        dcum = M.sum(2) - M.sum(1) + e_in * (dyS * Cq).sum(-1) - W
        dtot = tot.exp() * (dS * S_in).sum((-1, -2)) + W.sum(1)
        dcum = torch.cat([dcum[:, :-1], dcum[:, -1:] + dtot[:, None]], 1)
        da = dcum.flip(1).cumsum(1).flip(1)                    # d(dA)
        dxs[c] = dxd * dtq[..., None]
        ddts[c] = (dxd * xq).sum(-1) + da * Af
        dA = dA + (da * dtq).sum((0, 1))
        dBs[c], dCs[c] = dB, dC
        dS = tot.exp()[..., None, None] * dS + torch.einsum(
            "bqh,bqhp,bqhn->bhpn", e_in, dyq, Cq)

    def grouped(parts):
        return torch.stack(parts, 1).reshape(Bsz, L, G, rep, N).sum(3)

    return (torch.stack(dxs, 1).reshape(Bsz, L, H, P).to(x.dtype),
            torch.stack(ddts, 1).reshape(Bsz, L, H).to(dt.dtype),
            dA.to(A.dtype), grouped(dBs).to(Bm.dtype),
            grouped(dCs).to(Cm.dtype))


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
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bwd_variant(dtype: torch.dtype, P: int, N: int, Q: int, strides=(),
                 ptrs=()) -> str:
    """The backward kernels a CUDA call takes: ``"tc"`` (tensor cores) for
    bf16 with P and N multiples of 8 (P <= 64, N <= 128), a chunk ``Q`` of
    at most MAX_TC_CHUNK positions, ``strides`` (x's, B's and C's batch,
    position and head element strides) multiples of 8 and base addresses
    ``ptrs`` (x, B, C) 16-byte aligned; else ``"fma"``."""
    if dtype != torch.bfloat16 or P % 8 or N % 8 or Q > MAX_TC_CHUNK:
        return "fma"
    if any(s % 8 for s in strides) or any(p % 16 for p in ptrs):
        return "fma"
    return "tc"


def bwd_scratch_floats(Bsz: int, L: int, H: int, P: int, N: int,
                       Q: int) -> int:
    """f32 elements of the tensor-core backward's scratch: bf16 hi + lo
    planes of dy (B, L, H, P) and of the states and their cotangents at
    the chunk boundaries (B, nc, H, P, N); then f32 the chunks' own
    cotangent terms (B, nc, H, P, N), ``<dS, S_in>`` (B, nc, H) and two
    (B, L, H) rows (dcum - W and W), the last three each rounded up to a
    multiple of 4 (16-byte aligned parts)."""
    nc = L // Q
    X, Y = Bsz * nc * H * P * N, Bsz * L * H * P

    def r4(n):
        return -(-n // 4) * 4
    return Y + 3 * X + r4(Bsz * nc * H) + 2 * r4(Bsz * L * H)


@functools.lru_cache(maxsize=None)
def _bwd_entry(variant: str, dtype: torch.dtype):
    fn = getattr(load("ssd_bwd"), _BWD_ENTRY[variant, dtype])
    if variant == "tc":  # the f32 scratch and its length after dC
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def work(x, Bm, chunk: int, backward: bool = False, states: bool = False,
         final: bool = False) -> tuple:
    """(bytes, operations) of one call on x (B, L, H, P) and Bm / Cm (B, L,
    G, N) (anything with ``shape`` and ``dtype``; dt (B, L, H) and A (H,)
    read as f32) at chunk ``chunk``.  Forward: x, dt, A, B, C read once,
    y (f32) and the final state written once (and each chunk's incoming
    f32 state with ``states``); the causal half of C B^T once per (batch,
    group, chunk), and per (batch, head, chunk) the causal half of S xd,
    the incoming-state term and the state update.  ``backward``: x, dt,
    A, B, C, the chunks' f32 states and the f32 dy (and dstate with
    ``final``) read once, dx, ddt, dA, dB, dC written once; C B^T and dC,
    dB from the group's heads' summed tiles once per (batch, group,
    chunk) over the causal half, and per (batch, head, chunk) dy xd^T and
    dxd over the causal half and the four (Q, P, N) state terms."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    nc = -(-L // Q)
    half = Q * (Q + 1) // 2
    xb = x.dtype.itemsize
    bb = Bm.dtype.itemsize
    nx, ndt, nb, ns = B * L * H * P, B * L * H, B * L * G * N, B * H * P * N
    if backward:
        nbytes = (2 * xb * nx + 2 * 4 * ndt + 2 * 4 * H + 4 * bb * nb
                  + 4 * B * nc * H * P * N + 4 * nx + (4 * ns if final
                                                       else 0))
        return nbytes, (B * G * nc * 3 * half * 2 * N
                        + B * H * nc * (2 * half * 2 * P + 4 * 2 * Q * P * N))
    nbytes = (xb * nx + 4 * (ndt + H) + 2 * bb * nb + 4 * (nx + ns)
              + (4 * B * nc * H * P * N if states else 0))
    return nbytes, (B * G * nc * half * 2 * N
                    + B * H * nc * (half * 2 * P + 4 * Q * N * P))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 256):
    """x (B, L, H, P), dt (B, L, H), A (H,), Bm / Cm (B, L, G, N) ->
    (y (B, L, H, P) f32, final state (B, H, P, N) f32).  ``L`` must be a
    multiple of ``min(chunk, L)`` (``ValueError`` otherwise).

    CPU tensors take :func:`ssd_plain` (counted in ``ssd.plain_calls``);
    CUDA tensors launch the kernel that :func:`_variant` picks on the
    current stream (counted in ``ssd.launches`` and in ``tc_launches`` or
    ``fma_launches``).  Under grad, when x, dt, A, Bm or Cm requires it,
    through :class:`SSD`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SSD.apply(x, dt, A, Bm, Cm, chunk)
    return _ssd_forward(x, dt, A, Bm, Cm, chunk, False)[:2]


def _ssd_forward(x, dt, A, Bm, Cm, chunk: int, with_states: bool):
    """(y, final state, states or None): the forward of :func:`ssd`, each
    chunk's incoming state (B, nc, H, P, N) f32 too when
    ``with_states``."""
    Q = _check_inputs(x, dt, A, Bm, Cm, chunk)
    if counting():
        record("ssd", *work(x, Bm, Q, states=with_states))
    if x.device.type == "cpu":
        ssd.plain_calls += 1
        with uncounted():
            if with_states:
                return ssd_plain(x, dt, A, Bm, Cm, chunk, return_states=True)
            return (*ssd_plain(x, dt, A, Bm, Cm, chunk), None)
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, L // Q, H, P, N), dtype=torch.float32,
                         device=x.device) if with_states else None
    strides = strides_arg((x, (0, 1, 2)), (dt, (0, 1, 2)), (Bm, (0, 1, 2)),
                          (Cm, (0, 1, 2)))
    variant = _variant(x.dtype, L, Q, P, N,
                       [t.stride(d) for t in (x, Bm, Cm) for d in (0, 1, 2)],
                       [t.data_ptr() for t in (x, Bm, Cm)])
    fn = _entry(variant, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                None if states is None else states.data_ptr(), Bsz, L, H, G,
                P, N, Q, strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd {variant} kernel launch failed: CUDA error "
                           f"{rc}")
    ssd.launches += 1
    if variant == "tc":
        ssd.tc_launches += 1
    else:
        ssd.fma_launches += 1
    return y, state, states


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, states: torch.Tensor,
            dy: torch.Tensor, dstate=None, chunk: int = 256):
    """(dx, ddt, dA, dBm, dCm) of :func:`ssd` at (x, dt, A, Bm, Cm) for the
    cotangents ``dy`` (B, L, H, P) of y and ``dstate`` (B, H, P, N) of
    the final state (None: zeros), given each chunk's incoming state
    ``states`` (B, nc, H, P, N) from the forward; each gradient in its
    input's dtype (dt and A f32 on the card).

    CPU tensors take :func:`ssd_bwd_plain` (counted in
    ``ssd_bwd.plain_calls``); CUDA tensors launch the kernels that
    :func:`_bwd_variant` picks on the current stream (counted once a
    call in ``ssd_bwd.launches`` and in ``tc_launches`` or
    ``fma_launches``)."""
    Q = _check_inputs(x, dt, A, Bm, Cm, chunk)
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dy.shape) != (Bsz, L, H, P) \
            or tuple(states.shape) != (Bsz, L // Q, H, P, N) \
            or (dstate is not None
                and tuple(dstate.shape) != (Bsz, H, P, N)):
        raise ValueError(
            f"ssd_bwd: dy {tuple(dy.shape)}, states {tuple(states.shape)} "
            f"and dstate {None if dstate is None else tuple(dstate.shape)} "
            f"do not fit x {tuple(x.shape)} and Bm {tuple(Bm.shape)} at "
            f"chunk {Q}")
    if any(t is not None and t.device != x.device
           for t in (dy, states, dstate)):
        raise ValueError("ssd_bwd: dy, states and dstate must lie on x's "
                         "device")
    if counting():
        record("ssd_bwd", *work(x, Bm, Q, backward=True,
                                final=dstate is not None))
    if x.device.type == "cpu":
        ssd_bwd.plain_calls += 1
        with uncounted():
            return ssd_bwd_plain(x, dt, A, Bm, Cm, states, dy, dstate,
                                 chunk)
    dt = dt.float()
    A = A.float().contiguous()
    variant = _bwd_variant(x.dtype, P, N, Q,
                           [t.stride(d) for t in (x, Bm, Cm)
                            for d in (0, 1, 2)],
                           [t.data_ptr() for t in (x, Bm, Cm)])
    dy = dy.float()
    if variant == "tc":  # 16-byte rows for the tensor-core kernels
        dy = dy.contiguous()
        if dy.data_ptr() % 16:
            dy = dy.clone()
    elif dy.stride(3) != 1 and P > 1:
        dy = dy.contiguous()
    states = states.float().contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    dx = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, L, H), dtype=torch.float32, device=x.device)
    dA = torch.zeros((H,), dtype=torch.float32, device=x.device)
    # f32 sums over each group's heads, by atomics
    dB = torch.zeros((Bsz, L, G, N), dtype=torch.float32, device=x.device)
    dC = torch.zeros((Bsz, L, G, N), dtype=torch.float32, device=x.device)
    strides = strides_arg((x, (0, 1, 2)), (dt, (0, 1, 2)), (Bm, (0, 1, 2)),
                          (Cm, (0, 1, 2)), (dy, (0, 1, 2)))
    fn = _bwd_entry(variant, x.dtype)
    scratch = ()
    if variant == "tc":
        n = bwd_scratch_floats(Bsz, L, H, P, N, Q)
        buf = torch.empty((n,), dtype=torch.float32, device=x.device)
        scratch = (buf.data_ptr(), n)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), states.data_ptr(), dy.data_ptr(),
                None if dstate is None else dstate.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), *scratch, Bsz, L, H, G, P, N, Q, strides,
                stream)
    if rc != 0:
        raise RuntimeError(f"ssd_bwd {variant} kernel launch failed: CUDA "
                           f"error {rc}")
    ssd_bwd.launches += 1
    if variant == "tc":
        ssd_bwd.tc_launches += 1
    else:
        ssd_bwd.fma_launches += 1
    return dx, ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype)


class SSD(torch.autograd.Function):
    """:func:`ssd` with its backward: the forward keeps each chunk's
    incoming state, the backward is :func:`ssd_bwd`.  A cotangent that
    autograd does not give (the final state unused) is zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        y, state, states = _ssd_forward(x, dt, A, Bm, Cm, chunk, True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, dA, dB, dC = ssd_bwd(x, dt, A, Bm, Cm, states, dy, dstate,
                                      ctx.chunk)
        return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, None


ssd.launches = 0
ssd.tc_launches = 0
ssd.fma_launches = 0
ssd.plain_calls = 0
ssd_bwd.launches = 0
ssd_bwd.tc_launches = 0
ssd_bwd.fma_launches = 0
ssd_bwd.plain_calls = 0
