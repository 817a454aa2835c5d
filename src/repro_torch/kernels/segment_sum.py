"""Per-row segment sum: the CUDA kernel's wrapper and its plain version.

``out[t, b] = sum_r values[t, r] * (seg_ids[t, r] == b)``; ids outside
``[0, n_segments)`` add nothing.

Replaces the Pallas kernel ``src/repro/kernels/segment_sum.py::
segment_sum``.  The simulation core calls it from ``recount`` to rebuild
the per-(node, app) busy counts of every trial from its (T, R) busy
mask; each trial has its own placement, so the ids differ per row.
Predictor training calls it for histograms: a tree's split search sums
the counts and residuals of d binned columns as (2d, n) f64 rows into
n_bins bins (``core/zoo.py``), and MIC counts each grid's joint bins of
m metrics as (m, n) f32 ones (``core/correlate.py``).

The kernel (``csrc/segment_sum.cu``) is bound by bytes: each row's
histogram lives in shared memory; every thread loads its share of the
row with 16-byte loads into registers before it adds any of it with a
shared-memory atomic, and the row is written with 16-byte stores.  At
the core's shape (T=256, R=1000, B=1250, f64) it moves about 5.6 MB,
about 1.7 us at the H100's 3.35 TB/s.  Rows whose length is not a
multiple of 4 or whose base is not 16-byte aligned take scalar loads.

Tolerance: sums of 0/1 masks (the core's only use) are exact.  For
general values the atomics add in an order that changes from run to run,
so the result differs from a sequential sum by rounding: within 1e-12
relative in f64 and 1e-5 in f32 at the shapes above.

:func:`segment_sum` runs the plain version only for tensors that lie on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.work import counting, record, uncounted

__all__ = ["segment_sum", "segment_sum_plain", "launch_floor", "work"]

_ENTRY = {torch.float64: "segment_sum_f64", torch.float32: "segment_sum_f32"}
_INT_MAX = 2 ** 31 - 1


def _check(values: torch.Tensor, seg_ids: torch.Tensor,
           n_segments: int) -> None:
    if values.ndim != 2 or values.shape != seg_ids.shape:
        raise ValueError(f"values {tuple(values.shape)} / seg_ids "
                         f"{tuple(seg_ids.shape)} must be matching (T, R)")
    if values.dtype not in _ENTRY:
        raise TypeError(f"values must be float32 or float64, got "
                        f"{values.dtype}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"seg_ids must be int32, got {seg_ids.dtype}")
    if values.device != seg_ids.device:
        raise ValueError(f"values on {values.device}, seg_ids on "
                         f"{seg_ids.device}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("values and seg_ids must be contiguous")
    if not 0 <= n_segments <= _INT_MAX or max(values.shape) > _INT_MAX:
        raise ValueError(f"sizes out of range: {tuple(values.shape)}, "
                         f"n_segments={n_segments}")


def work(values, seg_ids, n_segments: int) -> tuple:
    """(bytes, operations) of one call on (T, R) ``values`` and ``seg_ids``
    (anything with ``shape`` and ``dtype``) into ``n_segments`` buckets:
    values and ids read once, the (T, B) sums written once, one add a
    value."""
    T, R = values.shape
    e = values.dtype.itemsize
    i = seg_ids.dtype.itemsize
    return T * R * (e + i) + T * n_segments * e, T * R


def segment_sum_plain(values: torch.Tensor, seg_ids: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    """The same function in plain PyTorch: a ``scatter_add_`` whose
    out-of-range ids land in one spare column that is cut off."""
    T = values.shape[0]
    ok = (seg_ids >= 0) & (seg_ids < n_segments)
    idx = torch.where(ok, seg_ids, n_segments).long()
    out = torch.zeros((T, n_segments + 1), dtype=values.dtype,
                      device=values.device)
    out.scatter_add_(1, idx, values)
    return out[:, :n_segments].contiguous()


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry ``name``: (values, ids[, out]) pointers, then T, R, B
    and the stream."""
    fn = getattr(load("segment_sum"), name)
    n_ptr = 2 if name == "segment_sum_noop" else 3
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Per-row bucket sums: (T, R) values + (T, R) int32 ids -> (T, B).

    CPU tensors take :func:`segment_sum_plain` (counted in
    ``segment_sum.plain_calls``); CUDA tensors launch the kernel on the
    current stream (counted in ``segment_sum.launches``)."""
    _check(values, seg_ids, n_segments)
    if counting():
        record("segment_sum", *work(values, seg_ids, n_segments))
    if values.device.type == "cpu":
        segment_sum.plain_calls += 1
        with uncounted():
            return segment_sum_plain(values, seg_ids, n_segments)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum runs on CUDA or CPU tensors, got "
                         f"{values.device}")
    T, R = values.shape
    out = torch.empty((T, n_segments), dtype=values.dtype,
                      device=values.device)
    if T == 0 or n_segments == 0:
        return out
    fn = _entry(_ENTRY[values.dtype])
    with torch.cuda.device(values.device):
        rc = fn(values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(),
                T, R, n_segments, _stream(values))
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{rc}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
segment_sum.plain_calls = 0


def launch_floor(values: torch.Tensor, seg_ids: torch.Tensor,
                 n_segments: int) -> None:
    """Launch an empty kernel with the grid, block and shared memory the
    segment sum would take on these inputs: the floor that launching
    alone puts under its time.  Not counted in ``launches``."""
    _check(values, seg_ids, n_segments)
    T, R = values.shape
    with torch.cuda.device(values.device):
        rc = _entry("segment_sum_noop")(
            values.data_ptr(), seg_ids.data_ptr(), T, R, n_segments,
            _stream(values))
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
