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
   lengths and edge cases) and time kernel, plain version and a one-call
   library yardstick;
4. the simulation path: ``run_scenario`` at full width (250 nodes, 200
   replicas per app, 1000 requests, 8 seeds x 32 trials) on baseline,
   stale-predictions and churn with the four default policies and the
   oracle, counting kernel launches; then a profiled full-width pass
   cut to 100 requests (device busy share, largest kernels and host
   ops), outside the launch count;
5. the serving path: ``ServingEngine`` with qwen2-vl-7b at full width
   (28 layers, bf16, random weights from a seeded generator), 3 waves of
   8 requests (prompts of 256-1024 tokens, 32 new tokens each), counting
   the attention kernels' launches; then a profiled decode step outside
   the count;
6. CUDA against the CPU: the campaign at a mid shape (summary stats
   within 1e-5 relative) and the serving path at qwen2-vl-7b's smoke
   config in f32 (logits within 1e-4 relative, identical tokens);
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
MAIN_SCENARIOS = ("baseline", "stale-predictions", "churn")
KERNEL_SCENARIOS = ("stale-predictions", "churn")
PARITY_SCENARIOS = ("stale-predictions", "churn")
PARITY_RTOL = 1e-5

#: the serving path: qwen2-vl-7b at full width, 3 waves of 8 requests
ARCH = "qwen2-vl-7b"
SERVE = dict(max_batch=8, max_seq=2048)
WAVES, NEW_TOKENS, PROMPT_LEN = 3, 32, (256, 1024)
ATTN_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
SERVE_PARITY_RTOL = 1e-4


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    from repro_torch.kernels.segment_sum import (segment_sum,
                                                 segment_sum_plain)

    rng = np.random.default_rng(0)

    def case(T, R, B, dtype, lo=0, hi=None, mask=False):
        ids = rng.integers(lo, B if hi is None else hi, size=(T, R))
        vals = (rng.random((T, R)) < 0.5).astype(float) if mask \
            else rng.standard_normal((T, R))
        v = torch.as_tensor(vals, dtype=dtype, device=dev)
        i = torch.as_tensor(ids.astype(np.int32), device=dev)
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

    checks = [
        ((256, 1000, 1250, torch.float64), dict(), 1e-12),
        ((256, 1000, 1250, torch.float32), dict(), 1e-5),
        ((4, 5000, 10000, torch.float64), dict(), 1e-12),  # 2 bin tiles
        ((4, 5000, 20000, torch.float32), dict(), 1e-5),   # 2 bin tiles
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
    dev_ms = {k: device_ms(f) for k, f in timed.items()}
    eager_ms = {k: call_ms(f) for k, f in timed.items()}
    print("segment_sum device time per call (CUDA graph replay): "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in dev_ms.items()))
    print("segment_sum eager call time, host included: "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in eager_ms.items()))
    ms, plain_ms, library_ms = (dev_ms[k] for k in timed)
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
            "library_ms": library_ms}


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
    """Hold the flash-attention kernel against its plain version (the
    serving path's prefill shape at padded length ``S``, the sweep of
    tests/test_kernels.py, ragged lengths, head dim 256); time it at the
    path shape.  Returns its ``kernels`` entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    def case(B, Sq, H, KV, D, dtype, causal, seed=0):
        q = _randn((B, Sq, H, D), dtype, dev, seed)
        k = _randn((B, Sq, KV, D), dtype, dev, seed + 1)
        v = _randn((B, Sq, KV, D), dtype, dev, seed + 2)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = _attn_err(got, flash_attention_plain(q, k, v, causal), dtype)
        print(f"flash ({B},{Sq},{H}/{KV},{D}) {str(dtype)[6:]} causal="
              f"{causal}: max_abs_err {err:.3e} "
              f"(tol {ATTN_TOL[str(dtype)]})")
        return q, k, v, err

    B, H, KV, D = SERVE["max_batch"], 28, 4, 128
    q, k, v, path_err = case(B, S, H, KV, D, torch.bfloat16, True)
    for shape in ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 128, 8, 1, 16),
                  (1, 777, 28, 4, 128), (2, 1000, 8, 2, 64),
                  (1, 300, 4, 2, 256), (3, 100, 6, 3, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                case(*shape, dtype, causal, seed=3)

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
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
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

    def case(B, S, H, KV, D, dtype, lens, seed=0):
        q = _randn((B, 1, H, D), dtype, dev, seed)
        k = _randn((B, S, KV, D), dtype, dev, seed + 1)
        v = _randn((B, S, KV, D), dtype, dev, seed + 2)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        err = _attn_err(got, decode_attention_plain(q, k, v, lens), dtype)
        print(f"decode ({B},{S},{H}/{KV},{D}) {str(dtype)[6:]} kv_len "
              f"{int(lens.min())}..{int(lens.max())}: max_abs_err "
              f"{err:.3e} (tol {ATTN_TOL[str(dtype)]})")
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
    used = int(lens.sum())
    nbytes = (2 * (q.numel() * 2 + used * KV * (D + D))
              + 4 * lens.numel())
    ops = 2 * H * used * (D + D)
    bound_ms, bound_by = _bound(nbytes, ops, q.dtype)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:65",
            "launches": 0, "max_abs_err": path_err, "ms": dev_ms["kernel"],
            "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": dev_ms["library"]}


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
    if kern_us == 0:
        print("profile: no device time recorded (not measured)")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
              f"{e.count:7d} x  {e.key[:80]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.2f} ms  "
              f"{e.count:7d} x  {e.key[:80]}")


def serve_full_width(dev) -> dict:
    """The serving path: qwen2-vl-7b at full width, weights from the
    port's own ``init_params`` with a seeded generator on the card, 3
    waves of 8 requests through ``ServingEngine``.  Checks tokens and
    logits, and that each wave launched the flash kernel once per layer
    and the decode kernel once per layer and decode step.  Returns the
    launch counts, the engine and the first wave's prompts."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(ARCH).resolve(tp=1)
    L, V = cfg.num_layers, cfg.vocab_size
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
    waves = wave_prompts(V)
    flash_attention.launches = decode_attention.launches = 0
    for w, prompts in enumerate(waves):
        before = (flash_attention.launches, decode_attention.launches)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=w * len(prompts) + i, tokens=p,
                               max_new_tokens=NEW_TOKENS))
        spent.clear()
        t0 = time.perf_counter()
        done = eng.step_wave()
        wall = time.perf_counter() - t0
        n_flash = flash_attention.launches - before[0]
        n_decode = decode_attention.launches - before[1]
        assert n_flash == L, f"wave {w}: {n_flash} flash launches, not {L}"
        assert n_decode == L * (NEW_TOKENS - 1), \
            f"wave {w}: {n_decode} decode launches"
        out = np.stack([r.output for r in done])
        assert out.shape == (len(prompts), NEW_TOKENS), out.shape
        assert ((out >= 0) & (out < V)).all(), "token outside the vocab"
        plen = max(len(p) for p in prompts)
        print(f"wave {w}: padded prompt {plen}, prefill "
              f"{spent['prefill'] * 1e3:.1f} ms, decode "
              f"{spent['decode'] / (NEW_TOKENS - 1) * 1e3:.2f} ms/step, "
              f"{out.size / wall:.1f} tokens/s, wall {wall:.3f} s, "
              f"launches flash {n_flash} decode {n_decode}")
        print(f"  rtt s: " + " ".join(f"{r.rtt:.3f}" for r in done))
    assert bool(finite), "a logit is not finite"
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    print(f"serving path launches: {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
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


def profile_decode(eng, prompts) -> None:
    """One decode step at full width under torch.profiler (a prefill of
    the first wave's prompts and one warm-up step first): kernel
    launches per step, the device's busy share of the step, and the
    largest kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model
    cfg, dev = eng.cfg, eng.device
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "vision_embeds": torch.zeros(
                 (len(prompts), cfg.num_frontend_tokens, cfg.d_model),
                 dtype=torch.bfloat16, device=dev)}
    logits, cache = model.prefill(eng.params, cfg, batch,
                                  cache_len=eng.max_seq)
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    logits, cache = model.decode_step(eng.params, cfg, cache, tok)
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.decode_step(eng.params, cfg, cache, tok)
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    logits, cache = model.decode_step(eng.params, cfg, cache, tok)
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(eng.params, cfg, cache, tok)
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
    print(f"profile decode step (B={len(prompts)}, kv_len {plen + 2}): "
          f"{unprofiled * 1e3:.2f} ms unprofiled, {step * 1e3:.2f} ms "
          f"profiled; {n_kernels} kernels on the device, {launches} launch "
          f"calls; kernels busy {kern_us / 1e3:.2f} ms = "
          f"{kern_us / 1e6 / step * 100:.1f} % of the step")
    if kern_us == 0:
        print("profile: no device time recorded (not measured)")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d} x  {e.key[:90]}")


def serving_parity(dev) -> None:
    """The serving path on CUDA and on the CPU at the smoke config in
    f32: prefill and 4 decode steps' logits within SERVE_PARITY_RTOL of
    the largest value, identical greedy tokens, and an engine wave with
    identical outputs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(4, 24)).astype(np.int32)
    runs = {}
    for name in ("cuda", "cpu"):
        p = _to(params, name)
        batch = {"tokens": torch.as_tensor(toks, device=name)}
        logits, cache = model.prefill(p, cfg, batch, cache_len=32)
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
        eng = ServingEngine(cfg, params, device=name, max_batch=4,
                            max_seq=32)
        for i in range(4):
            eng.submit(Request(rid=i, tokens=toks[i, : 9 + 4 * i],
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
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phase 3: kernels against their plain versions, timed, at the main
    # paths' shapes (the serving waves' padded prompt lengths)
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    plens = [max(len(p) for p in w)
             for w in wave_prompts(get_config(ARCH).vocab_size)]
    kernels = [check_segment_sum(dev), check_flash(dev, max(plens)),
               check_decode(dev, max(plens))]
    for k in kernels:
        print(f"{k['name']}: {k['ms'] * 1e3:.2f} us kernel, "
              f"{k['plain_ms'] * 1e3:.2f} us plain, "
              f"{k['library_ms'] * 1e3:.2f} us library, "
              f"bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']})")
    sync_us = sync_cost_us(dev)
    print(f"host sync (bool(mask.any()) on (256, 1000)): {sync_us:.1f} us")

    # phase 4: the simulation path at full width
    segment_sum.launches = flash_attention.launches = 0
    decode_attention.launches = 0
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
            print(f"  {scen}/{pol}: wall {r.wall_s:.2f} s, loop "
                  f"{r.loop_s:.2f} s = {r.loop_s / J * 1e6:.0f} us/step, "
                  f"host syncs {r.host_syncs} (~{r.host_syncs * sync_us / 1e6:.2f} s), "
                  f"mean_rtt {r.stat('mean_rtt'):.4f} p99_rtt "
                  f"{r.stat('p99_rtt'):.4f}{ineff}")
        if scen == "baseline":
            pa, rr = res["perf_aware"].stat("mean_rtt"), \
                res["round_robin"].stat("mean_rtt")
            assert pa < rr, f"baseline perf_aware {pa} >= round_robin {rr}"
    main_launches = segment_sum.launches
    for scen in KERNEL_SCENARIOS:
        assert per_scen[scen] > 0, f"segment_sum never launched on {scen}"
    kernels[0]["launches"] = main_launches
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")

    # where the loop's time goes (not part of the main-path count)
    profile_pass("stale-predictions", "perf_aware", 100)
    profile_pass("stale-predictions", "least_conn", 100)

    # phase 5: the serving path at full width
    segment_sum.launches = 0
    served = serve_full_width(dev)
    assert segment_sum.launches == 0
    for k in kernels[1:]:
        k["launches"] = served["launches"][k["name"]]
        assert k["launches"] > 0, f"{k['name']} never launched"
    profile_decode(served["engine"], served["prompts"])
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
            for k in SUMMARY_STATS + ("hedged",):
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
    serving_parity(dev)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
