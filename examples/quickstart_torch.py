"""Quickstart on the PyTorch port: train Morpheus RTT predictors on a
simulated node and serve them, the paper's §3 pipeline (workload ->
collection -> correlations -> selection -> training -> plane ->
knowledge base) as ``examples/quickstart.py`` runs it in the JAX package.

Run on the card:  PYTHONPATH=src python examples/quickstart_torch.py
On the CPU:       ... examples/quickstart_torch.py --device cpu
Smaller:          ... --cycles 4 --cycle-s 240 --noise-metrics 4
"""
import argparse

import numpy as np

from repro_torch.core.manager import PredictionManager
from repro_torch.core.workload import NodeWorkload
from repro_torch.monitoring.metrics import SimClock


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--cycles", type=int, default=6)
    ap.add_argument("--cycle-s", type=float, default=300.0)
    ap.add_argument("--noise-metrics", type=int, default=24)
    args = ap.parse_args()

    clock = SimClock()                      # simulated time: runs in seconds
    node = NodeWorkload("worker-1", instances_per_app=1, node_factor=1.2,
                        clock=clock, seed=0,
                        n_noise_metrics=args.noise_metrics)
    mgr = PredictionManager(c_max=40, device=args.device)
    on_complete = mgr.attach(node)
    print(f"device {mgr.device}, {len(node.instances)} apps, "
          f"{args.noise_metrics} noise metrics")

    print("== bootstrap: noisy-server injection (paper §4.4) ==")
    mgr.bootstrap_noise(node, load=3.0, duration_s=120,
                        on_complete=on_complete)

    print("== run workload + collection/training cycles ==")
    history = mgr.run_cycles(node, n_cycles=args.cycles,
                             cycle_s=args.cycle_s, on_complete=on_complete)
    for t, app, rmse in history[-5:]:
        print(f"  t={t:7.1f}s  {app:12s} normalized RMSE={rmse:.3f}")

    print("== predictors ==")
    for (app, nname), p in mgr.predictors.items():
        if p.choice is None:
            print(f"  {app:12s}: no model within the inference budget yet")
            continue
        sel = p.selected
        print(f"  {app:12s}: model={p.choice.name:4s} window={sel.window_s}s "
              f"k={len(sel.metric_idx)} method={sel.method} "
              f"rmse={p.choice.rmse:.3f}")
        rec = p.predict()
        mean_rtt = float(np.mean(p.dataset.rtts))
        print(f"  {'':12s}  predicted RTT={rec.rtt_pred:.2f}s "
              f"(node mean {mean_rtt:.2f}s), prediction delay="
              f"{rec.t_prediction*1e3:.1f}ms "
              f"[state={rec.t_state*1e3:.1f} feat={rec.t_feature*1e3:.1f} "
              f"inf={rec.t_inference*1e3:.1f}]")

    print("== fleet prediction plane: one batched sweep (DESIGN.md §9) ==")
    spent0 = node.store.query_time_spent
    disp0 = mgr.plane.dispatches
    recs = mgr.plane.predict_all()
    if recs:
        serial_state = sum(
            node.store.retrieval.delay(
                len(mgr.predictors[key].selected.metric_idx),
                mgr.predictors[key].selected.window_s) for key in recs)
        print(f"  {len(recs)} predictors, "
              f"{len(mgr.plane.buckets())} model bucket(s), "
              f"{mgr.plane.dispatches - disp0} device dispatch(es) "
              f"this sweep")
        print(f"  modeled state retrieval: batched="
              f"{(node.store.query_time_spent - spent0)*1e3:.0f}ms vs "
              f"serial={serial_state*1e3:.0f}ms")
        for (app, nname), rec in sorted(recs.items()):
            print(f"  {app:12s} predicted RTT={rec.rtt_pred:.2f}s "
                  f"({rec.basis} delay {rec.t_prediction*1e3:.1f}ms)")


if __name__ == "__main__":
    main()
