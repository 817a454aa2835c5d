"""The paper's Fig. 11 (all four subplots) as text tables, on the PyTorch
port's batched simulation core, plus the scenario x policy campaign.

Run (from the repository root):
    PYTHONPATH=src python examples/lb_simulation_torch.py [--trials 200]
    PYTHONPATH=src python examples/lb_simulation_torch.py --campaign
    PYTHONPATH=src python examples/lb_simulation_torch.py --smoke
Everything runs on the CUDA card; ``--device cpu`` runs it on the CPU
(use small ``--trials`` there).  --campaign runs the registered scenario
x policy x seed grid through ``run_campaign`` and prints its table.
--smoke runs every policy, three scenario variants and a mini-campaign
over every registered scenario on tiny configs.
"""
import argparse
from dataclasses import replace

from repro_torch.core.balancer import POLICIES
from repro_torch.core.campaign import campaign_table, run_campaign
from repro_torch.core.scenarios import SCENARIOS
from repro_torch.core.simcore import run_sim_compiled
from repro_torch.core.simulator import SimConfig
from repro_torch.core.sweeps import (sweep_accuracy, sweep_heterogeneity,
                                     sweep_replicas)
from repro_torch.device import resolve_device


def smoke(dev, trials: int = 8) -> None:
    """Every policy, scenario variants and a mini-campaign, tiny."""
    cfg = SimConfig(n_trials=trials, n_requests=50)
    print(f"== policy smoke ({trials} trials x 50 requests, {dev}) ==")
    for pol in sorted(POLICIES):
        res = run_sim_compiled(cfg, pol, device=dev)
        print(f"  {pol:12s} mean={res['mean_rtt'].mean():6.2f}s "
              f"p50={res['p50_rtt'].mean():6.2f}s "
              f"p95={res['p95_rtt'].mean():6.2f}s "
              f"p99={res['p99_rtt'].mean():6.2f}s")
    variants = {
        "hedged": replace(cfg, arrival_rate=4.0, hedge_factor=0.7),
        "stale_pred": replace(cfg, prediction_lag_s=20.0),
        "node_churn": replace(cfg, churn=(5.0, 30.0)),
    }
    for name, vcfg in variants.items():
        res = run_sim_compiled(vcfg, "perf_aware", device=dev)
        print(f"  {name:12s} mean={res['mean_rtt'].mean():6.2f}s "
              f"p99={res['p99_rtt'].mean():6.2f}s "
              f"hedged={res['n_hedged']}")
    print(f"== scenario smoke ({len(SCENARIOS)} scenarios, batched "
          "campaign) ==")
    results = run_campaign(seeds=range(2), n_trials=2, n_requests=40,
                           device=dev)
    for scen, cell in results.items():
        r = cell["perf_aware"]
        print(f"  {scen:25s} p99={r.stat('p99_rtt'):7.2f}s "
              f"ineff={r.inefficiency_pct:5.1f}%")
    print("smoke OK")


def campaign(dev) -> None:
    """The registered scenario x policy x seed grid."""
    results = run_campaign(device=dev)
    print("== scenario x policy campaign "
          f"({len(results)} scenarios x 12 seeds, {dev}) ==")
    print(campaign_table(results))


def fig11(dev, trials: int) -> None:
    base = SimConfig(n_trials=trials, n_requests=300)
    print("== Fig 11.1: scheduling inefficiency vs prediction accuracy ==")
    for p, r in sweep_accuracy(base, accuracies=[0, .2, .4, .6, .8, 1.0],
                               device=dev):
        bar = "#" * max(0, int(r["inefficiency_pct"]))
        print(f"  p={p:.1f}  {r['inefficiency_pct']:6.2f}%  "
              f"(p99 {r['p99_inefficiency_pct']:6.2f}%)  {bar}")
    print("  (paper: inefficiency ~0 once accuracy reaches ~80%)\n")

    print("== Fig 11.2/3: inefficiency + resource waste vs replicas ==")
    rep = sweep_replicas(base, counts=(1, 2, 4, 8), device=dev)
    for pol, series in rep.items():
        cells = "  ".join(f"r={c}: {r['inefficiency_pct']:5.1f}%/"
                          f"{r['resource_waste_pct']:5.1f}%"
                          for c, r in series)
        print(f"  {pol:12s} {cells}")
    print("  (inefficiency% / resource-waste% — perf-aware stays flat)\n")

    print("== Fig 11.4: inefficiency vs CPU heterogeneity ==")
    het = sweep_heterogeneity(base, hs=(0.0, 0.3, 0.6, 1.0), device=dev)
    for pol, series in het.items():
        cells = "  ".join(f"h={h:.1f}: {r['inefficiency_pct']:5.1f}%"
                          for h, r in series)
        print(f"  {pol:12s} {cells}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="fast every-policy sanity sweep")
    ap.add_argument("--campaign", action="store_true",
                    help="scenario x policy x seed campaign table")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        smoke(dev, min(args.trials, 8))
    elif args.campaign:
        campaign(dev)
    else:
        fig11(dev, args.trials)


if __name__ == "__main__":
    main()
