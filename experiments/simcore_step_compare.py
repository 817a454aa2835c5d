#!/usr/bin/env python3
"""The simulation core's step on the card, one source tree against another.

For each ``--src`` directory (a checkout's ``src/``: this one, or a
``git archive`` of another commit unpacked under a git-ignored
directory), a child process runs baseline at chip_smoke's full width
(250 nodes, 5 x 200 replicas, 8 seeds x 32 trials, ``--requests``
requests) with perf_aware and least_conn through
``repro_torch.core.simcore.run_compiled``, stepped eagerly, and prints
per policy: ms a step (two passes after a warm-up), the kernels the
device ran and the host's kernel or graph launch calls a step, the
host's waits on the device and the device's busy ms a step (one pass
under torch.profiler), the core's own ``host_syncs``; and, where the
tree has the compiled mode, ms a step of its CUDA-graph replay.  Give
the trees in turns (A, B, B, A) to see the host's drift::

    git archive <commit> | tar -x -C build/parent
    python3 experiments/simcore_step_compare.py \\
        --src build/parent/src src src build/parent/src

The card's name and power limit are printed first.  Needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys

CHILD = r'''
import sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import simcore
from repro_torch.core.campaign import stack_clusters
from repro_torch.core.rng import rng_seed
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.simulator import _build_cluster

label, J = sys.argv[1], int(sys.argv[2])
spec = get_scenario("baseline")
cfgs = [spec.compile(seed=s, n_trials=32, n_nodes=250,
                     n_replicas_per_app=200, n_requests=J) for s in range(8)]
cluster = stack_clusters([_build_cluster(c) for c in cfgs])
kw = dict(seed_blocks=[(rng_seed(c.seed, "policy"), c.n_trials)
                       for c in cfgs])
graphs = hasattr(simcore, "prepare_compiled")
if graphs:
    kw["eager"] = True
for pol in ("perf_aware", "least_conn"):
    simcore.run_compiled(cluster, pol, **kw)                  # warm-up
    ms = [simcore.run_compiled(cluster, pol, **kw)["loop_s"] / J * 1e3
          for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = simcore.run_compiled(cluster, pol, **kw)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    dev = [e for e in ev if str(e.device_type).endswith("CUDA")
           and not e.key.startswith("Mem")]
    kernels = sum(e.count for e in dev) / J
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / J
    calls = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")) / J
    waits = sum(e.count for e in ev if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize"))
    graph = ""
    if graphs:
        run = simcore.prepare_compiled(cluster, pol,
                                       seed_blocks=kw["seed_blocks"])
        run()                                                  # captures
        g = min(run()["loop_s"] for _ in range(2)) / J * 1e3
        graph = f", graph {g:.4f} ms/step"
        simcore.clear_cache()
    print(f"{label} {pol} (T = {cluster.cfg.n_trials}, J = {J}): eager "
          f"{ms[0]:.4f} / {ms[1]:.4f} ms/step, {kernels:.1f} kernels and "
          f"{calls:.1f} launch calls a step, {waits} host waits in the "
          f"pass (the core's host_syncs {out['host_syncs']}), device busy "
          f"{busy:.4f} ms/step{graph}; mean_rtt[0] {out['mean_rtt'][0]!r}",
          flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", nargs="+", default=["src"])
    ap.add_argument("--requests", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("simcore_step_compare: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for src in args.src:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        r = subprocess.run([sys.executable, "-c", CHILD, src,
                            str(args.requests)], env=env)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
