"""Train an LM with the PyTorch port: the train step (AdamW + cosine,
global-norm clipping), the prefetching data pipeline, async
checkpointing, SIGTERM preemption handling and auto-resume, as
``examples/train_lm.py`` does with the JAX package.

The presets are the reference example's (a dense decoder); ``--device``
picks the card (default) or the CPU.

Run:     PYTHONPATH=src python examples/train_lm_torch.py --steps 200
CPU:     PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
Resume after interruption: re-run the same command (auto-restores).
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer, install_sigterm_handler
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.training.train_step import make_train_state, make_train_step

PRESETS = {
    "tiny": dict(num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
                 head_dim=32, d_ff=512, vocab_size=2048),
    "20m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
                head_dim=64, d_ff=1536, vocab_size=8192),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm_torch"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    cfg = ModelConfig(name=f"lm-{args.preset}", family="dense", dtype=dtype,
                      **PRESETS[args.preset]).resolve(tp=1)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=20,
                       total_steps=args.steps)
    print(f"model: {cfg.param_count()/1e6:.1f}M params | "
          f"{args.batch}x{args.seq} tokens/step | {dev} {dtype}")

    state = make_train_state(cfg, tcfg, torch.Generator(dev).manual_seed(0),
                             dev)
    step_fn = make_train_step(cfg, tcfg, rules=None)
    ck = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    if ck.latest_step() is not None:
        state = ck.restore(state)
        start = ck.latest_step()
        print(f"resumed from checkpoint step {start}")

    def save_now():
        s = int(state["opt"]["step"])
        ck.save(s, state, blocking=True)
        print(f"\n[preemption] checkpointed at step {s}; exiting cleanly")

    install_sigterm_handler(save_now)

    data = SyntheticLMData(cfg.vocab_size, seed=0)
    it = make_batch_iterator(data, args.batch, args.seq, seed=start,
                             device=dev)
    t0 = time.time()
    tok_per_step = args.batch * args.seq
    metrics = None
    try:
        for i in range(start, args.steps):
            state, metrics = step_fn(state, next(it))
            if (i + 1) % 10 == 0:
                dt = time.time() - t0
                print(f"step {i+1:4d} loss={float(metrics['loss']):6.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):6.2f} "
                      f"{tok_per_step*10/dt:7.0f} tok/s")
                t0 = time.time()
            if (i + 1) % args.ckpt_every == 0:
                ck.save(i + 1, state)           # async, non-blocking
        ck.wait()
    finally:
        it.close()
    if metrics is not None:
        print("done; final loss", float(metrics["loss"]))
    return state, metrics


if __name__ == "__main__":
    main()
