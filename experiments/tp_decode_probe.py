#!/usr/bin/env python3
"""Where a tensor-parallel decode step's time goes on one card.

qwen2-vl-7b at full width and depth (random bf16 weights from a seeded
generator), phase 5's first wave of 8 prompts prefilled into a 2048-row
cache, then greedy decode steps timed by the host clock around 10 steps
(the card waited for), three ways, in ROUNDS interleaved rounds (the
host's clock varies between calls; the median and the least a round
are printed):

- ``single``: the single-device path, no rules;
- ``tp``: the tensor-parallel path on a one-rank NCCL group, mesh (1, 1)
  data x model, under ``rules_for(cfg, mesh, "decode")``;
- ``tp, no collectives``: the same, with the collectives over the model
  axis replaced by local copies (what a one-rank collective computes),
  so the difference to ``tp`` is the collectives' own cost.

Each runs in child processes, with PyTorch's NCCL flight recorder as it
comes (it records every collective with its stack) and with it off
(``TORCH_FR_BUFFER_SIZE=0``, read when the first NCCL group is made):
``--repeats`` pairs of children, the order of the two settings
alternating pair by pair (on, off, off, on, ...), each child's line
printed::

    python3 experiments/tp_decode_probe.py [--layers N] [--repeats N]

The card's name and power limit are printed first.  Needs a CUDA card.
"""
import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


#: interleaved rounds of the three ways
ROUNDS = 5


def child(layers: int) -> None:
    import torch
    import torch.distributed as dist
    import chip_smoke as C
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import rules_for
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    dev = torch.device("cuda")
    store = os.path.join(ROOT, "build", f"nccl_probe{os.getpid()}")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        cfg = get_config("qwen2-vl-7b")
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg = cfg.resolve(tp=1, dp=1)
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               dev)
        batch = C._batch(cfg, C.wave_prompts(cfg.vocab_size)[0], dev)
        pre, dec = rules_for(cfg, mesh, "prefill"), rules_for(cfg, mesh,
                                                              "decode")

        def step_ms(tp: bool) -> float:
            with SH.axis_rules(pre if tp else None):
                logits, cache = M.prefill(params, cfg, batch,
                                          C.SERVE["max_seq"])
            tok = logits.argmax(-1, keepdim=True).int()
            with SH.axis_rules(dec if tp else None):
                for _ in range(3):
                    logits, cache = M.decode_step(params, cfg, cache, tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    logits, cache = M.decode_step(params, cfg, cache, tok)
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) / 10 * 1e3

        def local_copies() -> float:
            reduce, gather = SH._all_reduce, SH._all_gather
            SH._all_reduce = lambda x, group, op=None: x.detach().clone()
            SH._all_gather = lambda x, dim, group, n: x.contiguous()
            try:
                return step_ms(True)
            finally:
                SH._all_reduce, SH._all_gather = reduce, gather

        ways = {"single": lambda: step_ms(False),
                "tp": lambda: step_ms(True),
                "tp, no collectives": local_copies}
        got = {k: [] for k in ways}
        for _ in range(ROUNDS):
            for k, fn in ways.items():
                got[k].append(fn())
        fr = os.environ.get("TORCH_FR_BUFFER_SIZE", "as it comes")
        print(f"{cfg.name} {cfg.num_layers} layers, flight recorder "
              f"{fr}, {ROUNDS} rounds: " + ", ".join(
                  f"{k} {statistics.median(v):.2f} ms a step (least "
                  f"{min(v):.2f})" for k, v in got.items()), flush=True)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    ap.add_argument("--repeats", type=int, default=2,
                    help="pairs of children, one a setting each")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.layers)
        return 0
    import chip_smoke as C
    print(C.card_line(), flush=True)
    rc = 0
    on, off = {}, {"TORCH_FR_BUFFER_SIZE": "0"}
    for env in [e for i in range(args.repeats)
                for e in ((on, off) if i % 2 == 0 else (off, on))]:
        e = {k: v for k, v in os.environ.items()
             if k != "TORCH_FR_BUFFER_SIZE"}
        e.update(env)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", "--layers", str(args.layers)],
                             env=e, timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
