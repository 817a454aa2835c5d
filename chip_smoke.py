#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, with no result line):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build every kernel under ``src/repro_torch/kernels/csrc`` with nvcc
   into the git-ignored ``build/`` directory;
3. hold each kernel against its plain PyTorch version on the card (the
   main path's shape and edge cases) and time kernel, plain version and
   a one-call library yardstick;
4. the main path: ``run_scenario`` at full width (250 nodes, 200
   replicas per app, 1000 requests, 8 seeds x 32 trials) on baseline,
   stale-predictions and churn with the four default policies and the
   oracle, counting kernel launches; then a profiled full-width pass
   cut to 100 requests (device busy share, largest kernels and host
   ops), outside the launch count;
5. the same entry point on CUDA and on the CPU at a mid shape; summary
   stats must agree within 1e-5 relative;
6. a ``kernels`` JSON line, then the result line.
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

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
#: FP64 / FP32 rates outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"torch.float64": 34e12, "torch.float32": 67e12}

LARGE = dict(n_nodes=250, n_replicas_per_app=200, n_requests=1000)
LARGE_SEEDS, LARGE_TRIALS = tuple(range(8)), 32
MID = dict(n_nodes=60, n_replicas_per_app=50, n_requests=200)
MID_SEEDS, MID_TRIALS = tuple(range(4)), 16
MAIN_SCENARIOS = ("baseline", "stale-predictions", "churn")
KERNEL_SCENARIOS = ("stale-predictions", "churn")
PARITY_SCENARIOS = ("stale-predictions", "churn")
PARITY_RTOL = 1e-5


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

    # phase 3: kernels against their plain versions, timed
    kernels = [check_segment_sum(dev)]
    for k in kernels:
        print(f"{k['name']}: {k['ms'] * 1e3:.2f} us kernel, "
              f"{k['plain_ms'] * 1e3:.2f} us plain, "
              f"{k['library_ms'] * 1e3:.2f} us library, "
              f"bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']})")
    sync_us = sync_cost_us(dev)
    print(f"host sync (bool(mask.any()) on (256, 1000)): {sync_us:.1f} us")

    # phase 4: the main path at full width
    segment_sum.launches = 0
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

    # phase 5: CUDA against the CPU at the mid shape
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

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
