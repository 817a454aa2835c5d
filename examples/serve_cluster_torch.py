"""End-to-end example (the paper's Fig. 1, serving edition) on the PyTorch
port: one model served by three heterogeneous replicas (one fast, one
medium, one slow, contended) behind the Morpheus router, under four
policies.  The knowledge base is seeded from one observed wave per
replica; the performance-aware router should send the least work to
the slow replica and beat round-robin / random on mean RTT.

Run (from the repository root):
    PYTHONPATH=src python examples/serve_cluster_torch.py [--requests 24]
    PYTHONPATH=src python examples/serve_cluster_torch.py --smoke --device cpu
By default it serves qwen2-vl-7b at full width (28 layers, bf16, random
weights from a seed, ~16 GB) on the CUDA card under the wall clock:
prompts of 256-1024 tokens, 8 new tokens each, slowdowns of 0, 0.02 and
0.08 s a decode step.  --smoke serves deepseek-67b's smoke config with
the JAX package's example's setup (8-token prompts, 4 new tokens, a
simulated clock), so its routing shares equal that example's.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.monitoring.metrics import SimClock
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.router import MorpheusRouter

SLOWDOWNS = (0.0, 0.02, 0.08)     # fast, medium, slow (contended)
POLICIES = ("round_robin", "random", "least_conn", "perf_aware")


def setup(smoke: bool):
    """(model config, engine kwargs, prompt lengths, new tokens)."""
    if smoke:
        cfg = get_config("deepseek-67b", smoke=True).resolve(tp=1)
        return cfg, dict(max_batch=4, max_seq=64), (8, 8), 4
    cfg = get_config("qwen2-vl-7b").resolve(tp=1)
    return cfg, dict(max_batch=4, max_seq=2048), (256, 1024), 8


def _prompt(rng, cfg, lengths, smoke: bool):
    lo, hi = lengths
    n = lo if lo == hi else int(rng.integers(lo, hi + 1))
    return rng.integers(0, 100 if smoke else cfg.vocab_size, size=n)


def run_policy(policy, cfg, params, n_requests, *, device, smoke, seed=0):
    """Route ``n_requests`` under ``policy``; (RTTs, routed replicas)."""
    _, engine_kw, lengths, new_tokens = setup(smoke)
    clock = SimClock(simulated=smoke)
    replicas = [ServingEngine(cfg, params, device=device, node=f"node-{i}",
                              slowdown=s, clock=clock, seed=i, **engine_kw)
                for i, s in enumerate(SLOWDOWNS)]
    router = MorpheusRouter(replicas, policy=policy, seed=seed,
                            device=device)
    # seed the knowledge base from one observed wave per replica
    rng = np.random.default_rng(seed)
    for rep in replicas:
        rep.submit(Request(rid=-1, tokens=_prompt(rng, cfg, lengths, smoke),
                           max_new_tokens=new_tokens))
        done = rep.step_wave()
        router.kb.put("serve", rep.node, clock.now(), done[0].rtt or 0.1)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, tokens=_prompt(rng, cfg, lengths, smoke),
                    max_new_tokens=new_tokens) for i in range(n_requests)]
    for r in reqs:
        router.route(r)
    router.drain()
    return np.array([r.rtt for r in reqs]), router.routed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="deepseek-67b's smoke config, simulated clock")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg, _, _, _ = setup(args.smoke)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    print(f"serving {cfg.name} ({cfg.param_count() / 1e6:.1f}M params) on 3 "
          f"heterogeneous replicas, {args.requests} requests, {dev}\n")
    for policy in POLICIES:
        rtts, routed = run_policy(policy, cfg, params, args.requests,
                                  device=dev, smoke=args.smoke)
        share = [routed.count(i) / len(routed) for i in range(3)]
        print(f"{policy:12s} mean RTT={rtts.mean():7.3f}s  "
              f"p95={np.percentile(rtts, 95):7.3f}s  "
              f"routing=[fast {share[0]:.2f}, med {share[1]:.2f}, "
              f"slow {share[2]:.2f}]")


if __name__ == "__main__":
    main()
