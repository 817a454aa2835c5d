#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, with no result line):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build every kernel under ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, all at once) into the git-ignored ``build/``
   directory;
3. hold each kernel against its plain PyTorch version on the card (the
   main paths' shapes, the sweeps of ``tests/test_kernels.py``, ragged
   lengths and edge cases; for flash attention, flash-decoding, SSD and
   ``gmm``, which of each one's two kernels, tensor-core or FMA, each call
   took) and time kernel, plain version and a one-call library yardstick
   (for SSD, the FMA kernel on f32 beside the tensor-core one on bf16);
4. the simulation path: ``run_scenario`` at full width (250 nodes, 200
   replicas per app, 1000 requests, 8 seeds x 32 trials) on baseline,
   stale-predictions, churn, cold-start and drift-fallback (the
   closed-loop fleet under drift) with the four default policies and the
   oracle, counting kernel launches; then profiled full-width passes cut
   to 100 requests (device busy share, largest kernels and host ops,
   the host's waits on the device), outside the launch count;
5. the serving path: ``ServingEngine`` with qwen2-vl-7b at full width
   (28 layers, bf16, random weights from a seeded generator), 3 waves of
   8 requests (prompts of 256-1024 tokens, 32 new tokens each), counting
   the attention kernels' launches (every flash call on the tensor-core
   kernel); then a profiled prefill and decode step outside the count;
5b. the Mamba2 serving path: ``ServingEngine`` with mamba2-1.3b at full
   width (48 layers, bf16, random weights), the same 3 waves with each
   wave's longest prompt lengthened to the next multiple of the SSD
   chunk (256), counting the SSD kernel's launches (every one on the
   tensor cores); then a profiled prefill and decode step outside the
   count;
5c. the MoE serving path: ``ServingEngine`` with qwen3-moe-30b-a3b at
   full width (48 layers, 128 experts top-8, bf16, random weights, ~61
   GB), the waves of phase 5, counting the grouped-matmul kernel's
   launches (three per layer and step) beside the attention kernels';
   then a profiled prefill and decode step outside the count;
6. CUDA against the CPU: the campaign at a mid shape (summary stats
   within 1e-5 relative; a closed-loop cell that misses is shown its
   flipped pick and held to 1e-2) and the three serving paths at their
   smoke configs in f32 (logits within 1e-4 relative, identical tokens);
7. a ``kernels`` JSON line, the card's line, then the result line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the
#: FP64 / FP32 rates outside the tensor cores and the dense bf16 rate
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"torch.float64": 34e12, "torch.float32": 67e12,
              "torch.bfloat16": 989e12}

LARGE = dict(n_nodes=250, n_replicas_per_app=200, n_requests=1000)
LARGE_SEEDS, LARGE_TRIALS = tuple(range(8)), 32
MID = dict(n_nodes=60, n_replicas_per_app=50, n_requests=200)
MID_SEEDS, MID_TRIALS = tuple(range(4)), 16
MAIN_SCENARIOS = ("baseline", "stale-predictions", "churn", "cold-start",
                  "drift-fallback")
KERNEL_SCENARIOS = ("stale-predictions", "churn")
PARITY_SCENARIOS = ("stale-predictions", "churn", "cold-start",
                    "drift-fallback")
PARITY_RTOL = 1e-5

#: the serving path: qwen2-vl-7b at full width, 3 waves of 8 requests
ARCH = "qwen2-vl-7b"
SERVE = dict(max_batch=8, max_seq=2048)
WAVES, NEW_TOKENS, PROMPT_LEN = 3, 32, (256, 1024)
ATTN_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
SERVE_PARITY_RTOL = 1e-4

#: the Mamba2 serving path: mamba2-1.3b at full width, the same waves
MAMBA_ARCH = "mamba2-1.3b"
SSD_TOL = {"torch.float32": 2e-4, "torch.bfloat16": 4e-2}

#: the MoE serving path: qwen3-moe-30b-a3b at full width, the same waves
MOE_ARCH = "qwen3-moe-30b-a3b"
GMM_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}


def wave_prompts(vocab: int):
    """The serving waves' prompts, seeded: WAVES x max_batch token
    arrays of lengths drawn in PROMPT_LEN."""
    import numpy as np
    rng = np.random.default_rng(0)
    n = WAVES * SERVE["max_batch"]
    lens = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=n)
    prompts = [rng.integers(0, vocab, size=int(m)).astype(np.int32)
               for m in lens]
    B = SERVE["max_batch"]
    return [prompts[w * B:(w + 1) * B] for w in range(WAVES)]


def mamba_waves(vocab: int, chunk: int):
    """The serving waves' prompts with each wave's longest prompt
    lengthened to the next multiple of ``chunk`` by seeded tokens: the
    reference's Mamba2 prefill takes a padded length longer than the
    chunk only as a multiple of it."""
    import numpy as np
    rng = np.random.default_rng(1)
    waves = []
    for prompts in wave_prompts(vocab):
        i = max(range(len(prompts)), key=lambda j: len(prompts[j]))
        n = len(prompts[i])
        extra = rng.integers(0, vocab, size=-n % chunk).astype(np.int32)
        waves.append([np.concatenate([extra, p]) if j == i else p
                      for j, p in enumerate(prompts)])
    return waves


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A ptxas entry name without its namespace and parameters, e.g.
    ``flash_fwd_tc<128, 4, 2, 3>`` (``c++filt`` where it is installed)."""
    import shutil
    if shutil.which("c++filt") is None:
        return mangled
    out = subprocess.run(["c++filt", mangled], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = out.replace("(anonymous namespace)::", "").split("(")[0]
    return out.removeprefix("void ").split("::")[-1] or mangled


def _median_event_ms(run, inner: int, repeats: int) -> float:
    import torch
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def call_ms(fn, repeats: int = 11, inner: int = 50) -> float:
    """Time of one eager call, host work included: median over
    ``repeats`` of the mean of ``inner`` back-to-back calls, by CUDA
    events, after a warm-up."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _median_event_ms(run, inner, repeats)


def device_ms(fn, repeats: int = 11, inner: int = 50) -> float:
    """Device time of one call: ``inner`` calls captured into one CUDA
    graph, replayed ``repeats`` times, median of the mean by CUDA
    events.  Replaying takes the host out of the measurement."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, inner, repeats)


def check_segment_sum(dev) -> dict:
    """Hold the segment-sum kernel against its plain version; time it at
    the main path's shape.  Returns its ``kernels`` entry (launches are
    filled in from the main-path run)."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_sum import (launch_floor, segment_sum,
                                                 segment_sum_plain)

    rng = np.random.default_rng(0)

    def unaligned_copy(x):
        """A copy of ``x`` whose base is 8 bytes past 16-byte alignment."""
        off = 8 // x.element_size()
        y = torch.empty(x.numel() + off, dtype=x.dtype, device=dev)[off:]
        return y.view(x.shape).copy_(x)

    def case(T, R, B, dtype, lo=0, hi=None, mask=False, unaligned=False):
        ids = rng.integers(lo, B if hi is None else hi, size=(T, R))
        vals = (rng.random((T, R)) < 0.5).astype(float) if mask \
            else rng.standard_normal((T, R))
        v = torch.as_tensor(vals, dtype=dtype, device=dev)
        i = torch.as_tensor(ids.astype(np.int32), device=dev)
        if unaligned:
            v, i = unaligned_copy(v), unaligned_copy(i)
            assert v.data_ptr() % 16 == 8 and i.data_ptr() % 16 == 8
        got = segment_sum(v, i, B)
        torch.cuda.synchronize()
        want = segment_sum_plain(v, i, B)
        return v, i, got, want

    # the main path's shape: (T, R) = (256, 1000), B = N·A = 1250, keyed
    # by node·A + app like simcore's recount, on a 0/1 f64 busy mask
    T, R, N, A = 256, 1000, LARGE["n_nodes"], 5
    B = N * A
    node_of = rng.integers(0, N, size=(T, R))
    na_key = (node_of * A + np.repeat(np.arange(A), R // A)[None, :])
    busy = torch.as_tensor((rng.random((T, R)) < 0.5).astype(float),
                           device=dev)
    ids = torch.as_tensor(na_key.astype(np.int32), device=dev)
    got = segment_sum(busy, ids, B)
    want = segment_sum_plain(busy, ids, B)
    path_err = float((got - want).abs().max())
    assert path_err == 0.0, f"0/1 mask not exact: {path_err}"
    print(f"segment_sum path shape ({T},{R})->{B} f64 0/1 mask: "
          f"max_abs_err {path_err}")

    # each load and store path of the kernel: 16-byte loads (the path
    # shape), scalar loads (R % 4 != 0, an unaligned base), a scalar
    # head / tail of the stores (odd B), bin tiles (B past 48 KB of
    # histograms), more than one pass of loads a thread, f32
    checks = [
        ((256, 1000, 1250, torch.float64), dict(), 1e-12),
        ((256, 1000, 1250, torch.float32), dict(), 1e-5),
        ((256, 1001, 1250, torch.float64), dict(), 1e-12),
        ((256, 1001, 1250, torch.float64), dict(mask=True), 0.0),
        ((256, 1000, 1251, torch.float64), dict(), 1e-12),
        ((256, 1000, 1251, torch.float32), dict(mask=True), 0.0),
        ((4, 1000, 6145, torch.float64), dict(), 1e-12),   # 2 bin tiles
        ((4, 1000, 6145, torch.float64), dict(mask=True), 0.0),
        ((4, 5000, 10000, torch.float64), dict(), 1e-12),  # 3 bin tiles
        ((4, 5000, 20000, torch.float32), dict(), 1e-5),   # 3 bin tiles
        ((3, 8000, 1250, torch.float64), dict(), 1e-12),   # 2 load passes
        ((37, 1000, 999, torch.float64), dict(unaligned=True), 1e-12),
        ((37, 1000, 999, torch.float32), dict(unaligned=True, mask=True),
         0.0),
    ]
    for shape in ((1, 1, 1), (3, 50, 20), (8, 128, 128), (16, 300, 60)):
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            checks.append((shape + (dtype,), dict(), tol))
            checks.append((shape + (dtype,), dict(mask=True), 0.0))
            checks.append((shape + (dtype,),
                           dict(lo=-5, hi=shape[2] + 5), tol))
    for (t, r, b, dtype), kw, tol in checks:
        _, _, g, w = case(t, r, b, dtype, **kw)
        err = float((g - w).abs().max()) if g.numel() else 0.0
        scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
        assert err <= tol * scale, \
            f"segment_sum ({t},{r},{b}) {dtype} {kw}: err {err} > {tol}"
        print(f"segment_sum ({t},{r})->{b} {str(dtype)[6:]} {kw or ''}: "
              f"max_abs_err {err:.3e} (tol {tol} x {scale:.3g})")

    ids64 = ids.long()
    timed = {
        "kernel": lambda: segment_sum(busy, ids, B),
        "plain": lambda: segment_sum_plain(busy, ids, B),
        "library": lambda: torch.zeros((T, B), dtype=busy.dtype,
                                       device=dev).scatter_add_(1, ids64,
                                                                busy)}
    # the launch floor: an empty kernel with the same grid, block and
    # shared memory, timed by the same graph replay
    timed["launch floor"] = lambda: launch_floor(busy, ids, B)
    dev_ms = {k: device_ms(f) for k, f in timed.items()}
    eager_ms = {k: call_ms(timed[k]) for k in ("kernel", "plain", "library")}
    print("segment_sum device time per call (CUDA graph replay): "
          + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in dev_ms.items()))
    print("segment_sum eager call time, host included: "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in eager_ms.items()))
    ms, plain_ms, library_ms = (dev_ms[k]
                                for k in ("kernel", "plain", "library"))
    nbytes = T * R * (busy.element_size() + ids.element_size()) \
        + T * B * busy.element_size()
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = T * R / PEAK_OPS_S[str(busy.dtype)] * 1e3
    return {"name": "segment_sum", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
            "replaces": "src/repro/kernels/segment_sum.py:58",
            "launches": 0, "max_abs_err": path_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "launch_floor_ms": dev_ms["launch floor"]}


def _randn(shape, dtype, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _attn_err(got, want, dtype) -> float:
    """Fail unless ``got`` is within the dtype's tolerance of ``want``;
    returns the largest absolute difference."""
    import torch
    tol = ATTN_TOL[str(dtype)]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return float((got.float() - want.float()).abs().max())


def _bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _timed(name: str, timed: dict, inner: int) -> dict:
    dev_ms = {k: device_ms(f, repeats=7, inner=inner)
              for k, f in timed.items()}
    print(f"{name} device time per call (CUDA graph replay): "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in dev_ms.items()))
    return dev_ms


def check_flash(dev, S: int) -> dict:
    """Hold the flash-attention kernels against their plain version (the
    serving paths' prefill shapes at padded length ``S``, the sweep of
    tests/test_kernels.py, ragged lengths, head dims 256 and 40, q, k, v
    as views of one fused tensor), asserting which kernel each call took;
    time them at the path shape.  Returns the ``kernels`` entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    def counts():
        return flash_attention.tc_launches, flash_attention.fma_launches

    def checked(q, k, v, causal, variant, label):
        before = counts()
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == ((1, 0) if variant == "tc" else (0, 1)), \
            f"flash {label}: took {moved} (tc, fma) launches, not {variant}"
        err = _attn_err(got, flash_attention_plain(q, k, v, causal),
                        q.dtype)
        print(f"flash {label} {str(q.dtype)[6:]} causal={causal} "
              f"[{variant}]: max_abs_err {err:.3e} "
              f"(tol {ATTN_TOL[str(q.dtype)]})")
        return err

    def case(B, Sq, H, KV, D, dtype, causal, seed=0):
        q = _randn((B, Sq, H, D), dtype, dev, seed)
        k = _randn((B, Sq, KV, D), dtype, dev, seed + 1)
        v = _randn((B, Sq, KV, D), dtype, dev, seed + 2)
        variant = "tc" if dtype == torch.bfloat16 and D % 16 == 0 \
            and H // KV <= 128 else "fma"
        err = checked(q, k, v, causal, variant, f"({B},{Sq},{H}/{KV},{D})")
        return q, k, v, err

    B, H, KV, D = SERVE["max_batch"], 28, 4, 128
    q, k, v, path_err = case(B, S, H, KV, D, torch.bfloat16, True)
    for shape in ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 128, 8, 1, 16),
                  (1, 777, 28, 4, 128), (2, 1000, 8, 2, 64),
                  (1, 300, 4, 2, 256), (3, 100, 6, 3, 16),
                  (B, 910, 32, 4, 128), (2, 200, 6, 2, 40)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                case(*shape, dtype, causal, seed=3)
    # q, k, v as views of one fused (B, S, H + 2 KV, D) tensor: aligned
    # rows take the tensor cores; one element off, the FMA kernel
    n = 2 * 300 * (H + 2 * KV) * D
    for off, variant in ((0, "tc"), (1, "fma")):
        qkv = _randn((n + off,), torch.bfloat16, dev, 5)[off:].view(
            2, 300, H + 2 * KV, D)
        for causal in (True, False):
            checked(qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:],
                    causal, variant, f"fused qkv views, offset {off}")

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed = {
        "kernel": lambda: flash_attention(q, k, v, causal=True),
        "plain": lambda: flash_attention_plain(q, k, v, True),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}
    lib = timed["library"]().transpose(1, 2)
    print(f"flash library (SDPA) vs kernel at the path shape: max_abs_diff "
          f"{float((lib.float() - flash_attention(q, k, v).float()).abs().max()):.3e}")
    dev_ms = _timed("flash_attention", timed, inner=10)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ops = 2 * B * H * (S * (S + 1) // 2) * (D + D)
    bound_ms, bound_by = _bound(nbytes, ops, q.dtype)
    print(f"flash at the path shape ({B},{S},{H}/{KV},{D}) bf16 causal "
          f"[tc]: {ops / 1e9:.2f} GFLOP, {ops / dev_ms['kernel'] / 1e9:.1f} "
          f"TFLOP/s, {bound_ms / dev_ms['kernel'] * 100:.1f} % of the "
          f"{bound_ms * 1e3:.2f} us bound ({bound_by}); SDPA "
          f"{ops / dev_ms['library'] / 1e9:.1f} TFLOP/s, kernel / SDPA "
          f"{dev_ms['kernel'] / dev_ms['library']:.3f}")
    # the FMA kernel on the same values, q one element off its 16-byte
    # alignment: the kernel this path took before the tensor-core one
    qf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(
        q.shape).copy_(q)
    checked(qf, k, v, True, "fma", f"({B},{S},{H}/{KV},{D}), q misaligned")
    fma_ms = device_ms(lambda: flash_attention(qf, k, v, causal=True),
                       repeats=5, inner=3)
    print(f"flash FMA kernel at the path shape: {fma_ms * 1e3:.2f} us, "
          f"{ops / fma_ms / 1e9:.1f} TFLOP/s; the tensor-core kernel is "
          f"{fma_ms / dev_ms['kernel']:.1f}x faster")
    del qf
    # the MoE path's shape (32 heads over 4, G = 8) at its first wave's
    # padded length, kernel against SDPA
    Sm, Hm = 910, 32
    qm = _randn((B, Sm, Hm, D), torch.bfloat16, dev, 11)
    km, vm = (_randn((B, Sm, KV, D), torch.bfloat16, dev, 12 + i)
              for i in range(2))
    qmt, kmt, vmt = (t.transpose(1, 2) for t in (qm, km, vm))
    moe_ms = _timed("flash_attention (8,910,32/4,128)", {
        "kernel": lambda: flash_attention(qm, km, vm, causal=True),
        "library": lambda: F.scaled_dot_product_attention(
            qmt, kmt, vmt, is_causal=True, enable_gqa=True)}, inner=10)
    ops_m = 2 * B * Hm * (Sm * (Sm + 1) // 2) * (D + D)
    print(f"flash at (8,910,32/4,128) bf16 causal [tc]: "
          f"{ops_m / moe_ms['kernel'] / 1e9:.1f} TFLOP/s, SDPA "
          f"{ops_m / moe_ms['library'] / 1e9:.1f} TFLOP/s")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "variant": "tc",
            "launches": 0, "max_abs_err": path_err, "ms": dev_ms["kernel"],
            "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": dev_ms["library"]}


def check_decode(dev, plen: int) -> dict:
    """Hold the flash-decoding kernel against its plain version (the
    serving path's decode shape, mid-wave at kv_len = plen + 16 of a
    max_seq cache, the sweep of tests/test_kernels.py, every kv_len from
    1 to S, ragged S, head dim 256); time it at the path shape.  Returns
    its ``kernels`` entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)

    def counts():
        return (decode_attention.launches, decode_attention.mma_launches,
                decode_attention.fma_launches)

    def case(B, S, H, KV, D, dtype, lens, seed=0):
        q = _randn((B, 1, H, D), dtype, dev, seed)
        k = _randn((B, S, KV, D), dtype, dev, seed + 1)
        v = _randn((B, S, KV, D), dtype, dev, seed + 2)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        variant = "mma" if dtype == torch.bfloat16 and D % 16 == 0 \
            and H // KV <= 16 else "fma"
        before = counts()
        got = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == (1, int(variant == "mma"), int(variant == "fma")), \
            f"decode took {moved} (all, mma, fma) launches, not one {variant}"
        live = lens > 0
        assert torch.count_nonzero(got[~live]) == 0, "kv_len 0 not zeros"
        err = _attn_err(got[live], decode_attention_plain(
            q[live], k[live], v[live], lens[live]), dtype)
        print(f"decode ({B},{S},{H}/{KV},{D}) {str(dtype)[6:]} kv_len "
              f"{int(lens.min())}..{int(lens.max())} [{variant}]: "
              f"max_abs_err {err:.3e} (tol {ATTN_TOL[str(dtype)]})")
        return q, k, v, lens, err

    B, S, H, KV, D = SERVE["max_batch"], SERVE["max_seq"], 28, 4, 128
    kv = plen + NEW_TOKENS // 2
    q, k, v, lens, path_err = case(B, S, H, KV, D, torch.bfloat16, [kv] * B)
    for (b, s, h, g, d) in ((2, 128, 4, 4, 32), (1, 256, 8, 2, 64),
                            (3, 64, 8, 1, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            sweep = [min((i + 1) * (s // 2), s) for i in range(b)]
            case(b, s, h, g, d, dtype, sweep, seed=5)
            case(b, s, h, g, d, dtype, [1] * b, seed=5)
            case(b, s, h, g, d, dtype, [s] * b, seed=5)
    for dtype in (torch.float32, torch.bfloat16):
        case(100, 100, 4, 2, 32, dtype, list(range(1, 101)), seed=7)
        case(4, 777, 28, 4, 128, dtype, [1, 64, 65, 777], seed=7)
        case(2, 300, 8, 1, 256, dtype, [299, 300], seed=7)
        # every kv_len from 1 to S at the path's heads, one row each
        case(300, 300, H, KV, D, dtype, list(range(1, 301)), seed=9)
        # one (batch, kv head) pair: ~2 x 132 splits, so lengths below
        # the split count leave most splits empty; kv_len 0 gives zeros
        case(18, 4096, 7, 1, D, dtype, list(range(18)), seed=9)
        case(3, 256, H, KV, D, dtype, [0, 256, 0], seed=9)
    # two CUDA-graph replays give the same bits (each call's last CTAs
    # reset their ticket counters)
    ragged = torch.tensor([kv, 1, 7, 64, 65, S, 500, 999], dtype=torch.int32,
                          device=dev)
    eager = decode_attention(q, k, v, ragged)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = decode_attention(q, k, v, ragged)
    outs = []
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        outs.append(replayed.clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], eager), \
        "decode: CUDA-graph replays differ"
    print("decode: two CUDA-graph replays and the eager call bit-identical")

    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed = {
        "kernel": lambda: decode_attention(q, k, v, lens),
        "plain": lambda: decode_attention_plain(q, k, v, lens),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)}
    lib = timed["library"]().transpose(1, 2)
    print(f"decode library (SDPA) vs kernel at the path shape: "
          f"max_abs_diff {float((lib.float() - decode_attention(q, k, v, lens).float()).abs().max()):.3e}")
    dev_ms = _timed("decode_attention", timed, inner=50)
    # the split rule (every CTA resident at once, two an SM) against
    # other split counts at the path shape, by swapping the rule
    from repro_torch.kernels import decode_attention as decode_mod
    rule = decode_mod._splits
    picked = rule(B, KV, S, torch.cuda.get_device_properties(0)
                  .multi_processor_count)
    swept = {}
    try:
        for n in sorted({4, 6, picked, picked + 1, 12, 16}):
            decode_mod._splits = lambda *_, n=n: n
            swept[n] = device_ms(lambda: decode_attention(q, k, v, lens),
                                 repeats=7, inner=50)
    finally:
        decode_mod._splits = rule
    print(f"decode split sweep at the path shape (the rule picks {picked}): "
          + ", ".join(f"{n}: {t * 1e3:.2f} us" for n, t in swept.items()))
    # one call is one kernel on the device (the combine is folded in)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
    ran = {e.key: e.count for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and not e.key.startswith("Mem")}
    assert sum(ran.values()) == 1, f"decode ran {ran}, not one kernel"
    print(f"decode: one call ran one kernel on the device: {ran}")
    used = int(lens.sum())
    nbytes = (2 * (q.numel() * 2 + used * KV * (D + D))
              + 4 * lens.numel())
    ops = 2 * H * used * (D + D)
    bound_ms, bound_by = _bound(nbytes, ops, q.dtype)
    print(f"decode at the path shape ({B},{S},{H}/{KV},{D}) bf16 kv_len "
          f"{kv} [mma]: {nbytes / dev_ms['kernel'] / 1e6:.1f} GB/s, "
          f"{bound_ms / dev_ms['kernel'] * 100:.1f} % of the "
          f"{bound_ms * 1e3:.2f} us bound ({bound_by}); kernel / SDPA "
          f"{dev_ms['kernel'] / dev_ms['library']:.3f}")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:65",
            "variant": "mma", "launches": 0, "max_abs_err": path_err,
            "ms": dev_ms["kernel"],
            "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": dev_ms["library"]}


def check_ssd(dev, L: int) -> dict:
    """Hold the SSD kernels against their plain version (the Mamba2 path's
    prefill shape at padded length ``L``, the sweep of
    tests/test_kernels.py, one partial chunk, G = 2, a chunk that is no
    multiple of 64, zamba2-2.7b's N = 64, and the strong decay A = -16,
    dt = 0.1, where exp of the upper triangle overflows), asserting which
    kernel each call took; time the tensor-core kernel on the path's bf16
    inputs and the FMA kernel on the same values in f32.  Returns the
    ``kernels`` entry (launches are filled in from the main-path run)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd import ssd, ssd_plain

    def counts():
        return ssd.launches, ssd.tc_launches, ssd.fma_launches

    def checked(args, chunk, variant, label):
        before = counts()
        y, state = ssd(*args, chunk=chunk)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == (1, int(variant == "tc"), int(variant == "fma")), \
            f"ssd {label}: took {moved} (all, tc, fma) launches, not {variant}"
        assert bool(torch.isfinite(y).all() & torch.isfinite(state).all()), \
            f"ssd {label}: not finite"
        want_y, want_state = ssd_plain(*args, chunk)
        tol = SSD_TOL[str(args[0].dtype)]
        torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
        torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
        err = max(float((y - want_y).abs().max()),
                  float((state - want_state).abs().max()))
        print(f"ssd {label} {str(args[0].dtype)[6:]} [{variant}]: finite, "
              f"max_abs_err {err:.3e} (tol {tol})")
        return err

    def case(B, L, H, P, G, N, chunk, dtype, strong=False, seed=0):
        x = _randn((B, L, H, P), dtype, dev, seed)
        Bm = _randn((B, L, G, N), dtype, dev, seed + 1)
        Cm = _randn((B, L, G, N), dtype, dev, seed + 2)
        if strong:
            dt = torch.full((B, L, H), 0.1, device=dev)
            A = torch.full((H,), -16.0, device=dev)
        else:
            dt = F.softplus(_randn((B, L, H), torch.float32, dev, seed + 3))
            A = -_randn((H,), torch.float32, dev, seed + 4).exp()
        # the tensor cores take bf16 with P, N multiples of 8, chunks <= 256
        variant = "tc" if dtype == torch.bfloat16 and P % 8 == 0 \
            and N % 8 == 0 and min(chunk, L) <= 256 else "fma"
        args = (x, dt, A, Bm, Cm)
        label = (f"({B},{L},{H},{P}) G={G} N={N} chunk {chunk}"
                 f"{' A=-16 dt=0.1' if strong else ''}")
        return args, checked(args, chunk, variant, label)

    s = get_config(MAMBA_ARCH).ssm
    d_model = get_config(MAMBA_ARCH).d_model
    B, H, P, G, N, Q = (SERVE["max_batch"], s.n_heads(d_model), s.head_dim,
                        s.n_groups, s.d_state, s.chunk_size)
    args, path_err = case(B, L, H, P, G, N, Q, torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((1, 64, 2, 8, 1, 4, 16), (2, 128, 4, 16, 2, 8, 32),
                      (1, 256, 8, 32, 1, 16, 64),     # tests/test_kernels.py
                      (2, 40, 4, 16, 1, 16, 256),     # L < chunk
                      (2, 512, 8, 64, 2, 128, 256),   # G = 2
                      (2, 200, 4, 64, 2, 128, 100),   # chunk not 64k
                      (2, 512, 8, 64, 1, 64, 256),    # zamba2-2.7b's P, N
                      (1, 64, 8, 16, 1, 16, 32)):     # the smoke configs'
            case(*shape, dtype, seed=5)
        case(1, 512, 8, 64, 1, 128, 256, dtype, strong=True, seed=6)
    case(B, 200, H, P, G, N, Q, torch.bfloat16, seed=7)   # one partial chunk
    # the FMA kernel on the path's bf16 values, x one element off its
    # 16-byte alignment: what the rounding of the tensor-core kernel costs
    x, dt, A, Bm, Cm = args
    xm = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(
        x.shape).copy_(x)
    fma_err = checked((xm, dt, A, Bm, Cm), Q, "fma",
                      f"({B},{L},{H},{P}) G={G} N={N}, x misaligned")
    del xm
    f32_args = (x.float(), dt, A, Bm.float(), Cm.float())
    f32_err = checked(f32_args, Q, "fma", f"({B},{L},{H},{P}) G={G} N={N}")

    timed = {"kernel": lambda: ssd(*args, chunk=Q),
             "plain": lambda: ssd_plain(*args, chunk=Q)}
    dev_ms = _timed("ssd", timed, inner=10)
    fma_ms = device_ms(lambda: ssd(*f32_args, chunk=Q), repeats=5, inner=3)
    nc = L // Q

    def nbytes(t):
        return (x.numel() * t.element_size() + 4 * (dt.numel() + A.numel())
                + 2 * Bm.numel() * t.element_size()
                + 4 * (x.numel() + B * H * P * N))
    # the causal half of C B^T once per (batch, group, chunk); per (batch,
    # head, chunk) the causal half of S xd, the incoming-state term and the
    # state update
    ops = (B * G * nc * Q * (Q + 1) // 2 * 2 * N
           + B * H * nc * (Q * (Q + 1) // 2 * 2 * P + 4 * Q * N * P))
    bound_ms, bound_by = _bound(nbytes(x), ops, x.dtype)
    fma_bound, fma_by = _bound(nbytes(f32_args[0]), ops, torch.float32)
    ms = dev_ms["kernel"]
    print(f"ssd at the path shape ({B},{L},{H},{P}) G={G} N={N} chunk {Q} "
          f"bf16 [tc]: {ms * 1e3:.2f} us, {ops / 1e9:.2f} GFLOP counted "
          f"({ops / ms / 1e9:.1f} TFLOP/s), {nbytes(x) / 1e6:.1f} MB "
          f"({nbytes(x) / ms / 1e6:.1f} GB/s), {bound_ms / ms * 100:.1f} % "
          f"of the {bound_ms * 1e3:.2f} us bound ({bound_by}); max_abs_err "
          f"{path_err:.3e}, the FMA kernel's on the same bf16 inputs "
          f"{fma_err:.3e}")
    print(f"ssd FMA kernel at the path shape in f32: {fma_ms * 1e3:.2f} us, "
          f"{fma_bound / fma_ms * 100:.1f} % of its {fma_bound * 1e3:.2f} us "
          f"bound ({fma_by}), max_abs_err {f32_err:.3e}; the tensor-core "
          f"kernel is {fma_ms / ms:.1f}x faster")
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:78",
            "variant": "tc", "launches": 0, "tc_launches": 0,
            "fma_launches": 0, "max_abs_err": path_err, "ms": ms,
            "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "fma": {"dtype": "float32", "ms": fma_ms, "bound_ms": fma_bound,
                    "bound_by": fma_by, "max_abs_err": f32_err,
                    "max_abs_err_bf16_inputs": fma_err}}


def moe_path_rows(cfg, plens) -> tuple:
    """The grouped matmul's C (= G * cap) at each wave's prefill (B =
    max_batch tokens of each padded length) and at a decode step (B
    tokens), from the MoE layer's own group and capacity rules."""
    from repro_torch.models.moe import capacity, dispatch_groups
    m, B = cfg.moe, SERVE["max_batch"]

    def rows(T):
        G = dispatch_groups(T, m.num_groups)
        return G * capacity(T // G, m.top_k, m.num_experts,
                            m.capacity_factor)
    return [rows(B * n) for n in plens], rows(B)


def check_gmm(dev, prefill_cs, decode_c: int) -> dict:
    """Hold the grouped-matmul kernel against its plain version (the MoE
    path's prefill and decode shapes in both orientations, wi/wg (D -> F)
    and wo (F -> D), bf16; the sweep of tests/test_kernels.py and ragged
    C = 1, 5, 100 in f32 and bf16); time kernel, plain version and
    ``torch.bmm`` at the largest prefill C and at the decode C.  Returns
    its ``kernels`` entry (the prefill shape's numbers)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gmm import gmm, gmm_plain

    def counts():
        return gmm.launches, gmm.wgmma_launches, gmm.fma_launches

    def case(E, C, D, F, dtype, seed=0, scale=1.0):
        x = _randn((E, C, D), dtype, dev, seed)
        w = (_randn((E, D, F), torch.float32, dev, seed + 1) * scale) \
            .to(dtype)
        variant = "wgmma" if dtype == torch.bfloat16 else "fma"
        before = counts()
        got = gmm(x, w)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == (1, int(variant == "wgmma"), int(variant == "fma")), \
            f"gmm took {moved} (all, wgmma, fma) launches, not {variant}"
        want = gmm_plain(x, w)
        tol = GMM_TOL[str(dtype)]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        err = float((got.float() - want.float()).abs().max())
        print(f"gmm ({E},{C},{D})x({D},{F}) {str(dtype)[6:]} [{variant}]: "
              f"max_abs_err {err:.3e} (rtol = atol = {tol})")
        return x, w, err

    cfg = get_config(MOE_ARCH)
    E, D, Fd = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    big = max(prefill_cs)
    path = {}
    for C in sorted(set(prefill_cs)) + [decode_c]:
        for d, f in ((D, Fd), (Fd, D)):
            # the weights at the model's scale (d^-1/2), outputs O(1)
            path[C, d] = case(E, C, d, f, torch.bfloat16, seed=C,
                              scale=d ** -0.5)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 64, 32, 48), (4, 128, 64, 64), (1, 32, 16, 128),
                      (3, 1, 32, 48), (2, 5, 64, 16), (4, 100, 48, 80)):
            case(*shape, dtype, seed=3)
    # row counts on both sides of the decode operand swap (C <= 16) and of
    # the 128-row tile edge, at both widths, one expert and all of them
    for e in (1, E):
        for d, f in ((D, Fd), (Fd, D)):
            for C in (1, 4, 5, 100, 112, 128, 576, 608, 624, 625):
                case(e, C, d, f, torch.bfloat16, seed=7, scale=d ** -0.5)

    entries = {}
    for C in (big, decode_c):
        x, w, _ = path[C, D]
        timed = {"kernel": lambda: gmm(x, w),
                 "plain": lambda: gmm_plain(x, w),
                 "library": lambda: torch.bmm(x, w)}
        lib = float((timed["library"]().float() - gmm(x, w).float())
                    .abs().max())
        print(f"gmm library (torch.bmm) vs kernel at C = {C}: max_abs_diff "
              f"{lib:.3e}")
        dev_ms = _timed(f"gmm C={C}", timed, inner=10)
        nbytes = 2 * (x.numel() + w.numel() + E * C * Fd)
        ops = 2 * E * C * D * Fd
        bound_ms, bound_by = _bound(nbytes, ops, x.dtype)
        print(f"gmm C={C}: bound {bound_ms * 1e3:.2f} us ({bound_by}), "
              f"{ops / dev_ms['kernel'] / 1e9:.1f} TFLOP/s, "
              f"{nbytes / dev_ms['kernel'] / 1e6:.1f} GB/s")
        entries[C] = dict(ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=dev_ms["library"])
        print(f"gmm C={C}: kernel / torch.bmm "
              f"{dev_ms['kernel'] / dev_ms['library']:.3f}")
    return {"name": "gmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:49",
            "variant": "wgmma", "launches": 0,
            "max_abs_err": path[big, D][2], **entries[big],
            "decode": {"C": decode_c, "max_abs_err": path[decode_c, D][2],
                       **entries[decode_c]}}


def sync_cost_us(dev) -> float:
    """Cost of one expiry-round host sync: ``bool(mask.any())`` on a
    (256, 1000) bool mask, CUDA launch and device-to-host copy included."""
    import torch
    mask = torch.zeros((256, 1000), dtype=torch.bool, device=dev)
    for _ in range(20):
        bool(mask.any())
    n = 500
    t0 = time.perf_counter()
    for _ in range(n):
        bool(mask.any())
    return (time.perf_counter() - t0) / n * 1e6


def profile_pass(scenario: str, policy: str, n_requests: int) -> None:
    """One full-width pass of ``policy`` on ``scenario``, cut to
    ``n_requests`` requests, under torch.profiler: kernel launches per
    step, the device's busy share of the request loop (kernel time only:
    the setup's host-to-device copies are left out), and the largest
    kernels and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.campaign import run_scenario
    kw = dict(LARGE, n_requests=n_requests)
    run_scenario(scenario, policies=(policy,), include_oracle=False,
                 seeds=LARGE_SEEDS[:1], n_trials=8, **kw)      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_scenario(scenario, policies=(policy,),
                           include_oracle=False, seeds=LARGE_SEEDS,
                           n_trials=LARGE_TRIALS, **kw)
    loop_s = res[policy].loop_s
    events = prof.key_averages()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    kernels = [e for e in on_device if not e.key.startswith("Mem")]
    kern_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"profile {scenario}/{policy} ({n_requests} requests, full "
          f"width, profiler on): loop {loop_s:.3f} s, "
          f"{launches / n_requests:.0f} kernel launches/step, kernels "
          f"busy {kern_us / 1e6:.4f} s = {kern_us / 1e6 / loop_s * 100:.1f}"
          f" % of the loop")
    # every wait of the host on the device goes through the runtime
    # API, a library's own included: the core's count of its syncs is
    # held against the profiler's
    syncs = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize"))
    print(f"profile {scenario}/{policy}: {syncs} host waits on the device "
          f"in the pass (set-up copies and results included), "
          f"{res[policy].host_syncs} counted by the core's expiry rounds, "
          f"{res[policy].n_fallback} fallback routings")
    if kern_us == 0:
        print("profile: no device time recorded (not measured)")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
              f"{e.count:7d} x  {e.key[:80]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.2f} ms  "
              f"{e.count:7d} x  {e.key[:80]}")


def _kernel_wrappers() -> dict:
    """name -> wrapper of every kernel of the port, each with its
    ``launches`` count."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.ssd import ssd
    return {"segment_sum": segment_sum, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd": ssd, "gmm": gmm}


#: wrapper -> its counters by variant, beside ``launches``
VARIANT_COUNTERS = {"flash_attention": ("tc", "fma"),
                    "decode_attention": ("mma", "fma"),
                    "ssd": ("tc", "fma"),
                    "gmm": ("wgmma", "fma")}


def counts(kernels) -> dict:
    """Each wrapper's ``launches``, and its launches by variant as
    ``<name>.<variant>`` (e.g. ``flash_attention.tc``)."""
    out = {n: k.launches for n, k in kernels.items()}
    for n, variants in VARIANT_COUNTERS.items():
        for v in variants:
            out[f"{n}.{v}"] = getattr(kernels[n], f"{v}_launches")
    return out


def reset_counts(kernels) -> None:
    for n, k in kernels.items():
        k.launches = 0
        for v in VARIANT_COUNTERS.get(n, ()):
            setattr(k, f"{v}_launches", 0)


def _batch(cfg, prompts, dev) -> dict:
    """The engine's left-padded wave batch (with the zero vision stub of
    a ``vlm``)."""
    import numpy as np
    import torch
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (len(prompts), cfg.num_frontend_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    return batch


def serve_full_width(dev, arch: str, waves, per_wave) -> dict:
    """A serving path at full width: ``arch``'s weights from the port's
    own ``init_params`` with a seeded generator on the card, ``waves`` of
    requests through ``ServingEngine``.  Checks tokens and logits, and
    that each wave launched each kernel of ``per_wave`` (name -> launches
    per wave, from the config) that many times and no other kernel.
    Returns the launch counts, the engine and the first wave's prompts."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(arch).resolve(tp=1)
    expect = per_wave(cfg)
    L, V = cfg.num_layers, cfg.vocab_size
    held = torch.cuda.memory_allocated()
    assert held < 1e9, f"{held / 1e9:.2f} GB still held before {arch}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve {cfg.name}: {L} layers, {n_params} parameters "
          f"({cfg.param_count()} by param_count), init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    eng = ServingEngine(cfg, params, device=dev, **SERVE)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    spent = {}

    def checked(name, fn):
        """``fn`` timed to its end on the card (the engine waits for its
        tokens right after anyway), its logits checked on the card."""
        def run(*args):
            nonlocal finite
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            finite = finite & torch.isfinite(logits[:, :V]).all()
            return logits, cache
        return run

    eng._prefill = checked("prefill", eng._prefill)
    eng._decode = checked("decode", eng._decode)
    kernels = _kernel_wrappers()
    reset_counts(kernels)
    for w, prompts in enumerate(waves):
        before = counts(kernels)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=w * len(prompts) + i, tokens=p,
                               max_new_tokens=NEW_TOKENS))
        spent.clear()
        t0 = time.perf_counter()
        done = eng.step_wave()
        wall = time.perf_counter() - t0
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        for n, count in got.items():
            assert count == expect.get(n, 0), \
                f"wave {w}: {count} {n} launches, not {expect.get(n, 0)}"
        out = np.stack([r.output for r in done])
        assert out.shape == (len(prompts), NEW_TOKENS), out.shape
        assert ((out >= 0) & (out < V)).all(), "token outside the vocab"
        plen = max(len(p) for p in prompts)
        print(f"wave {w}: padded prompt {plen}, prefill "
              f"{spent['prefill'] * 1e3:.1f} ms, decode "
              f"{spent['decode'] / (NEW_TOKENS - 1) * 1e3:.2f} ms/step, "
              f"{out.size / wall:.1f} tokens/s, wall {wall:.3f} s, launches "
              + " ".join(f"{n} {c}" for n, c in got.items() if c))
        print(f"  rtt s: " + " ".join(f"{r.rtt:.3f}" for r in done))
    assert bool(finite), "a logit is not finite"
    launches = counts(kernels)
    print(f"{cfg.name} serving path launches: {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"launches": launches, "engine": eng, "prompts": waves[0]}


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _profiled(label: str, fn):
    """Run ``fn`` once unprofiled and once under torch.profiler, each to
    its end on the card; print the wall times, the kernels and launch
    calls, the device's busy share of the profiled run, and the largest
    kernels.  Returns ``fn``'s last result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        step = time.perf_counter() - t0
    events = prof.key_averages()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    kernels = [e for e in on_device if not e.key.startswith("Mem")]
    kern_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    print(f"profile {label}: {unprofiled * 1e3:.2f} ms unprofiled, "
          f"{step * 1e3:.2f} ms profiled; {n_kernels} kernels on the device, "
          f"{launches} launch calls; kernels busy {kern_us / 1e3:.2f} ms = "
          f"{kern_us / 1e6 / step * 100:.1f} % of the profiled run")
    if kern_us == 0:
        print("profile: no device time recorded (not measured)")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d} x  {e.key[:90]}")
    return out


def profile_serving(eng, prompts) -> None:
    """A prefill of the first wave's prompts and then the second decode
    step after it, at full width, each under torch.profiler after an
    unprofiled run of the same call (see :func:`_profiled`)."""
    from repro_torch.models import model
    cfg = eng.cfg
    batch = _batch(cfg, prompts, eng.device)
    plen = batch["tokens"].shape[1]
    logits, cache = _profiled(
        f"{cfg.name} prefill (B={len(prompts)}, padded prompt {plen})",
        lambda: model.prefill(eng.params, cfg, batch, cache_len=eng.max_seq))
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    logits, cache = model.decode_step(eng.params, cfg, cache, tok)
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    # both runs of the step write the same cache row (attention) or update
    # the state in place (Mamba2); the step's work is the same
    _profiled(f"{cfg.name} decode step (B={len(prompts)}, prompt {plen})",
              lambda: model.decode_step(eng.params, cfg, cache, tok))


def serving_parity(dev, arch: str, S: int, lengths, max_seq: int) -> None:
    """A serving path on CUDA and on the CPU at ``arch``'s smoke config in
    f32: prefill of ``S`` tokens and 4 decode steps' logits within
    SERVE_PARITY_RTOL of the largest value, identical greedy tokens, and
    an engine wave (prompts of ``lengths``) with identical outputs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(4, S)).astype(np.int32)
    runs = {}
    for name in ("cuda", "cpu"):
        p = _to(params, name)
        batch = {"tokens": torch.as_tensor(toks, device=name)}
        logits, cache = model.prefill(p, cfg, batch, cache_len=S + 8)
        seq = [logits.cpu()]
        for _ in range(4):
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(p, cfg, cache, tok)
            seq.append(logits.cpu())
        runs[name] = seq
    worst = 0.0
    for a, b in zip(runs["cuda"], runs["cpu"]):
        V = cfg.vocab_size
        rel = float((a[:, :V] - b[:, :V]).abs().max() / b[:, :V].abs().max())
        worst = max(worst, rel)
        assert rel <= SERVE_PARITY_RTOL, f"logits differ by {rel}"
        assert torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1))
    outs = {}
    for name in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, device=name, max_batch=len(lengths),
                            max_seq=max_seq)
        for i, n in enumerate(lengths):
            eng.submit(Request(rid=i, tokens=toks[i, :n],
                               max_new_tokens=6))
        outs[name] = [r.output for r in eng.step_wave()]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)
    print(f"serving parity cuda vs cpu ({cfg.name}, f32): worst logit "
          f"drift {worst:.3e} of the largest (limit {SERVE_PARITY_RTOL}), "
          f"greedy tokens identical")


def finite_stats(res, stats) -> None:
    import numpy as np
    for pol, r in res.items():
        for k in stats:
            v = np.asarray(r.per_seed[k], float)
            assert np.isfinite(v).all(), f"{r.scenario}/{pol}/{k}: {v}"
        if r.inefficiency_pct is not None:
            assert np.isfinite(r.inefficiency_pct), f"{r.scenario}/{pol}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.core.campaign import SUMMARY_STATS, run_scenario
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.segment_sum import segment_sum

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind} x{count}")

    # phase 2: build every kernel
    t0 = time.perf_counter()
    libs = kbuild.build()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        entry = ""
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line or "C75" in line:
                print(f"  {name} {entry}: {line.strip()}")
            # ptxas's C7512 / C7518 remarks: the wgmmas were serialised
            assert not ("C7512" in line or "C7518" in line), \
                f"{name} {entry}: wgmma serialised: {line.strip()}"
            # the gmm and SSD tensor-core kernels hold their accumulators
            # in registers: a spill would put them in local memory
            if (name == "gmm" or "ssd_tc" in entry) \
                    and "spill stores" in line:
                assert line.split("bytes spill stores")[0].split(",")[-1] \
                    .strip() == "0", f"{name} {entry} spills: {line.strip()}"

    # phase 3: kernels against their plain versions, timed, at the main
    # paths' shapes (the serving waves' padded prompt lengths)
    from repro_torch.configs.base import get_config
    plens = [max(len(p) for p in w)
             for w in wave_prompts(get_config(ARCH).vocab_size)]
    mamba = get_config(MAMBA_ARCH)
    waves_ssm = mamba_waves(mamba.vocab_size, mamba.ssm.chunk_size)
    ssm_len = max(len(p) for w in waves_ssm for p in w)
    moe_prefill_cs, moe_decode_c = moe_path_rows(get_config(MOE_ARCH),
                                                 plens)
    print(f"gmm path rows: prefill C {moe_prefill_cs} (padded prompts "
          f"{plens}), decode C {moe_decode_c}")
    kernels = [check_segment_sum(dev), check_flash(dev, max(plens)),
               check_decode(dev, max(plens)), check_ssd(dev, ssm_len),
               check_gmm(dev, moe_prefill_cs, moe_decode_c)]
    for k in kernels:
        lib = "no library call" if k["library_ms"] is None \
            else f"{k['library_ms'] * 1e3:.2f} us library"
        print(f"{k['name']}: {k['ms'] * 1e3:.2f} us kernel, "
              f"{k['plain_ms'] * 1e3:.2f} us plain, {lib}, "
              f"bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']})")
    sync_us = sync_cost_us(dev)
    print(f"host sync (bool(mask.any()) on (256, 1000)): {sync_us:.1f} us")

    # phase 4: the simulation path at full width
    wrappers = _kernel_wrappers()
    reset_counts(wrappers)
    per_scen = {}
    torch.cuda.reset_peak_memory_stats()
    for scen in MAIN_SCENARIOS:
        before = segment_sum.launches
        t0 = time.perf_counter()
        res = run_scenario(scen, seeds=LARGE_SEEDS, n_trials=LARGE_TRIALS,
                           **LARGE)
        total = time.perf_counter() - t0
        per_scen[scen] = segment_sum.launches - before
        finite_stats(res, SUMMARY_STATS)
        J = LARGE["n_requests"]
        print(f"{scen}: {total:.1f} s total (build + 5 passes), "
              f"segment_sum launches {per_scen[scen]}")
        for pol, r in res.items():
            ineff = "" if r.inefficiency_pct is None \
                else f" ineff {r.inefficiency_pct:.2f}%"
            fb = f" fallback {r.n_fallback}" if r.n_fallback else ""
            print(f"  {scen}/{pol}: wall {r.wall_s:.2f} s, loop "
                  f"{r.loop_s:.2f} s = {r.loop_s / J * 1e6:.0f} us/step, "
                  f"host syncs {r.host_syncs} (~{r.host_syncs * sync_us / 1e6:.2f} s), "
                  f"mean_rtt {r.stat('mean_rtt'):.4f} p99_rtt "
                  f"{r.stat('p99_rtt'):.4f}{ineff}{fb}")
        if scen == "baseline":
            pa, rr = res["perf_aware"].stat("mean_rtt"), \
                res["round_robin"].stat("mean_rtt")
            assert pa < rr, f"baseline perf_aware {pa} >= round_robin {rr}"
    main_launches = segment_sum.launches
    for scen in KERNEL_SCENARIOS:
        assert per_scen[scen] > 0, f"segment_sum never launched on {scen}"
    assert all(k.launches == 0 for n, k in wrappers.items()
               if n != "segment_sum"), "the simulation launched a model kernel"
    kernels[0]["launches"] = main_launches
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")

    # where the loop's time goes (not part of the main-path count)
    profile_pass("stale-predictions", "perf_aware", 100)
    profile_pass("stale-predictions", "least_conn", 100)
    profile_pass("drift-fallback", "perf_aware", 100)

    # phase 5: the serving path at full width (each wave: the flash
    # kernel once per layer, the decode kernel once per layer and step)
    served = serve_full_width(
        dev, ARCH, wave_prompts(get_config(ARCH).vocab_size),
        lambda cfg: {"flash_attention": cfg.num_layers,
                     "flash_attention.tc": cfg.num_layers,
                     "decode_attention": cfg.num_layers * (NEW_TOKENS - 1),
                     "decode_attention.mma":
                         cfg.num_layers * (NEW_TOKENS - 1)})
    for k in kernels[1:3]:
        k["launches"] = served["launches"][k["name"]]
        assert k["launches"] > 0, f"{k['name']} never launched"
    profile_serving(served["engine"], served["prompts"])
    del served
    torch.cuda.empty_cache()

    # phase 5b: the Mamba2 serving path at full width (each wave: the SSD
    # kernel once per layer, in prefill, every call on the tensor cores)
    served = serve_full_width(dev, MAMBA_ARCH, waves_ssm,
                              lambda cfg: {"ssd": cfg.num_layers,
                                           "ssd.tc": cfg.num_layers})
    kernels[3].update(launches=served["launches"]["ssd"],
                      tc_launches=served["launches"]["ssd.tc"],
                      fma_launches=served["launches"]["ssd.fma"])
    assert kernels[3]["launches"] > 0, "ssd never launched"
    assert kernels[3]["tc_launches"] == kernels[3]["launches"], \
        "an ssd call of the Mamba2 waves missed the tensor cores"
    profile_serving(served["engine"], served["prompts"])
    del served
    torch.cuda.empty_cache()

    # phase 5c: the MoE serving path at full width (each wave: three
    # grouped matmuls per layer in prefill and in each decode step, and
    # the attention kernels as in phase 5)
    served = serve_full_width(
        dev, MOE_ARCH, wave_prompts(get_config(MOE_ARCH).vocab_size),
        lambda cfg: {"gmm": 3 * cfg.num_layers * NEW_TOKENS,
                     "gmm.wgmma": 3 * cfg.num_layers * NEW_TOKENS,
                     "flash_attention": cfg.num_layers,
                     "flash_attention.tc": cfg.num_layers,
                     "decode_attention": cfg.num_layers * (NEW_TOKENS - 1),
                     "decode_attention.mma":
                         cfg.num_layers * (NEW_TOKENS - 1)})
    kernels[4]["launches"] = served["launches"]["gmm"]
    assert kernels[4]["launches"] > 0, "gmm never launched"
    profile_serving(served["engine"], served["prompts"])
    del served
    torch.cuda.empty_cache()

    # phase 6: CUDA against the CPU: the campaign at the mid shape
    worst = 0.0
    for scen in PARITY_SCENARIOS:
        kw = dict(seeds=MID_SEEDS, n_trials=MID_TRIALS, **MID)
        t0 = time.perf_counter()
        on_gpu = run_scenario(scen, device="cuda", **kw)
        t1 = time.perf_counter()
        on_cpu = run_scenario(scen, device="cpu", **kw)
        t2 = time.perf_counter()
        for pol in on_cpu:
            a, b = on_gpu[pol], on_cpu[pol]
            assert a.n_hedged == b.n_hedged, f"{scen}/{pol} n_hedged"
            assert a.n_fallback == b.n_fallback, f"{scen}/{pol} n_fallback"
            for k in SUMMARY_STATS + ("hedged", "fallback"):
                x = np.asarray(a.per_seed[k], float)
                y = np.asarray(b.per_seed[k], float)
                np.testing.assert_allclose(x, y, rtol=PARITY_RTOL, atol=1e-7,
                                           err_msg=f"{scen}/{pol}/{k}")
                d = np.abs(x - y) / np.maximum(np.abs(y), 1e-9)
                worst = max(worst, float(d.max()))
            if b.inefficiency_pct is not None:
                np.testing.assert_allclose(
                    a.inefficiency_pct, b.inefficiency_pct,
                    rtol=PARITY_RTOL, atol=1e-7,
                    err_msg=f"{scen}/{pol}/inefficiency_pct")
        print(f"parity {scen} (mid shape): cuda {t1 - t0:.1f} s, cpu "
              f"{t2 - t1:.1f} s")
    print(f"parity cuda vs cpu: worst relative drift {worst:.3e} "
          f"(limit {PARITY_RTOL})")
    serving_parity(dev, ARCH, S=24, lengths=(9, 13, 17, 21), max_seq=32)
    serving_parity(dev, MAMBA_ARCH, S=64, lengths=(9, 40, 64, 17),
                   max_seq=96)
    serving_parity(dev, MOE_ARCH, S=24, lengths=(9, 13, 17, 21), max_seq=32)

    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s, "
          f"the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
