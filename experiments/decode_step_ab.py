#!/usr/bin/env python3
"""The single-device decode step's time of one or more source trees, on
one card.

For each arch (default: minicpm3-4b and zamba2-2.7b, the families whose
decode goes through ``attention.decode_block``'s write and a
log-sum-exp) at full width and depth, random bf16 weights from a seeded
generator: 8 seeded prompts of 512 tokens prefilled into a 2048-row
cache, WARM greedy decode steps, then ROUNDS rounds of STEPS steps, each
timed by the host clock with the card waited for.  Each tree runs in a
child process of its own with its ``src`` first on the path, the trees
in the order given, so parent, change, change, parent interleaves two
trees::

    python3 experiments/decode_step_ab.py --tree build/parent --tree . \\
        --tree . --tree build/parent

Each child prints one line a arch: the median and range of its rounds'
ms a step.  The card's name and power limit are printed first.  Needs a
CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = ("minicpm3-4b", "zamba2-2.7b")
B, PROMPT, CACHE = 8, 512, 2048
WARM, ROUNDS, STEPS = 3, 5, 20


def child(archs) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    out = {}
    for arch in archs:
        cfg = get_config(arch).resolve(tp=1)
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, size=(B, PROMPT))
        batch = {"tokens": torch.as_tensor(toks.astype(np.int32),
                                           device=dev)}
        with torch.no_grad():
            logits, cache = M.prefill(params, cfg, batch, CACHE)
            tok = logits.argmax(-1, keepdim=True).int()
            for _ in range(WARM):
                logits, cache = M.decode_step(params, cfg, cache, tok)
                tok = logits.argmax(-1, keepdim=True).int()
            torch.cuda.synchronize()
            ms = []
            for _ in range(ROUNDS):
                t0 = time.perf_counter()
                for _ in range(STEPS):
                    logits, cache = M.decode_step(params, cfg, cache, tok)
                    tok = logits.argmax(-1, keepdim=True).int()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / STEPS)
        out[arch] = ms
        del params, cache, logits
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=None,
                    help="a source tree (its src/ is imported); repeat")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    archs = args.arch or list(ARCHS)
    if args.child:
        child(archs)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for tree in args.tree or [ROOT]:
        env = {**os.environ,
               "PYTHONPATH": os.path.join(os.path.abspath(tree), "src")}
        cmd = [sys.executable, os.path.abspath(__file__), "--child"]
        for a in archs:
            cmd += ["--arch", a]
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             cwd=os.path.abspath(tree))
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        for arch, ms in json.loads(res.stdout.strip().splitlines()[-1]
                                   ).items():
            print(f"{tree}: {arch} decode, B {B}, prompt {PROMPT}, cache "
                  f"{CACHE}: median {statistics.median(ms):.3f} ms a step "
                  f"(range {min(ms):.3f}-{max(ms):.3f}, {ROUNDS} rounds of "
                  f"{STEPS} steps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
