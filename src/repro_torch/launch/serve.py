"""Serving launcher: replicas + the Morpheus router.

Translated from the reference's ``launch/serve.py``: ``--replicas``
``ServingEngine`` replicas of one model, slowed down by 0 to 0.08 s a decode
step, share a simulated clock behind a ``MorpheusRouter``; a
knowledge-base bootstrap wave on each replica seeds the router, then
``--requests`` requests are routed and drained, and the mean and p95 RTT
are printed.  Under the simulated clock a request's RTT depends on its
route and the slowdowns only, not on the weights, so the line equals the
reference launcher's on the same arguments.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \\
      --smoke --replicas 3 --requests 24 --policy perf_aware --device cpu

The port adds ``--device``, and ``--prompt-len`` / ``--max-seq`` (the
reference's 8 and 64), which a full-width config needs: qwen2-vl-7b's
vision stub takes the first 256 positions of a prompt.
"""
from __future__ import annotations

import argparse
import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.monitoring.metrics import SimClock
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.router import MorpheusRouter

POLICIES = ("perf_aware", "round_robin", "random", "least_conn")


def run(cfg, params, *, replicas: int = 3, requests: int = 24,
        policy: str = "perf_aware", max_new_tokens: int = 4,
        prompt_len: int = 8, max_seq: int = 64,
        device: DeviceLike = None) -> dict:
    """Serve ``requests`` requests of ``prompt_len`` tokens on
    ``replicas`` engines behind the router.  Returns ``{"rtts", "routed"
    (the replica of each request), "shares", "mean_rtt", "p95"}``."""
    dev = resolve_device(device)
    clock = SimClock()
    slow = np.linspace(0.0, 0.08, replicas)
    engines = [ServingEngine(cfg, params, device=dev, node=f"node-{i}",
                             max_batch=4, max_seq=max_seq,
                             slowdown=float(s), clock=clock)
               for i, s in enumerate(slow)]
    router = MorpheusRouter(engines, policy=policy, device=dev)
    rng = np.random.default_rng(0)
    for rep in engines:   # knowledge-base bootstrap wave
        rep.submit(Request(rid=-1, tokens=rng.integers(0, 100, prompt_len),
                           max_new_tokens=max_new_tokens))
        done = rep.step_wave()
        router.kb.put("serve", rep.node, clock.now(), done[0].rtt or 0.1)
    reqs = [Request(rid=i, tokens=rng.integers(0, 100, prompt_len),
                    max_new_tokens=max_new_tokens)
            for i in range(requests)]
    for r in reqs:
        router.route(r)
    router.drain()
    rtts = np.array([r.rtt for r in reqs])
    routed = list(router.routed)
    return {"rtts": rtts, "routed": routed,
            "shares": [routed.count(i) / len(routed)
                       for i in range(replicas)],
            "mean_rtt": float(rtts.mean()),
            "p95": float(np.percentile(rtts, 95))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--policy", default="perf_aware", choices=POLICIES)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke).resolve(tp=1)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    res = run(cfg, params, replicas=args.replicas, requests=args.requests,
              policy=args.policy, max_new_tokens=args.max_new_tokens,
              prompt_len=args.prompt_len, max_seq=args.max_seq, device=dev)
    print(f"[serve] {cfg.name} policy={args.policy} "
          f"mean_rtt={res['mean_rtt']:.3f}s p95={res['p95']:.3f}s")
    print("[serve] shares " + " ".join(f"{s:.2f}" for s in res["shares"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
