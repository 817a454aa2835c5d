"""The paper's Fig. 11 sweeps on the batched core (a port of the
reference's ``core/simulator.py:1223-1273``).

Each point builds ``cfg``'s cluster, runs it under a policy and under
the oracle through :func:`repro_torch.core.simcore.run_sim_compiled`
(policy seed ``rng_seed(cfg.seed, "policy")``, as the reference's
``run_sim``), and reports the policy's loss against the oracle in %.
The four sweeps give the minimum prediction accuracy and the
system-level factors (replicas per app, node heterogeneity) of the
paper's abstract.  This lives beside ``simulator.py`` rather than in
it because ``simcore`` imports the cluster builder.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np

from repro_torch.core.simcore import run_sim_compiled
from repro_torch.core.simulator import SimConfig
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["scheduling_inefficiency", "sweep_accuracy", "sweep_replicas",
           "sweep_heterogeneity"]

_SWEEP_POLICIES = ("perf_aware", "least_conn", "round_robin", "random")


def scheduling_inefficiency(cfg: SimConfig, policy: str,
                            device: DeviceLike = None) -> Dict[str, float]:
    """Performance loss vs the oracle LB (paper's metric), in %.
    ``device=None`` runs on the CUDA card (RuntimeError without one)."""
    dev = resolve_device(device)
    res = run_sim_compiled(cfg, policy, device=dev)
    ora = run_sim_compiled(cfg, "oracle", device=dev)
    ineff = (res["mean_rtt"] - ora["mean_rtt"]) / ora["mean_rtt"] * 100.0
    tail = (res["p99_rtt"] - ora["p99_rtt"]) \
        / np.maximum(ora["p99_rtt"], 1e-9) * 100.0
    waste_cpu = (res["cpu_s"] - ora["cpu_s"]) \
        / np.maximum(ora["cpu_s"], 1e-9) * 100.0
    return {"inefficiency_pct": float(np.mean(ineff)),
            "inefficiency_std": float(np.std(ineff)),
            "p99_inefficiency_pct": float(np.mean(tail)),
            "resource_waste_pct": float(np.mean(waste_cpu))}


def sweep_accuracy(base: SimConfig, accuracies=np.linspace(0, 1, 11),
                   device: DeviceLike = None):
    """Fig. 11 subplot 1: perf_aware's inefficiency per accuracy p."""
    dev = resolve_device(device)
    return [(float(p), scheduling_inefficiency(
                replace(base, accuracy=float(p)), "perf_aware", dev))
            for p in accuracies]


def sweep_replicas(base: SimConfig, counts=(1, 2, 3, 4, 6, 8, 10),
                   policies=_SWEEP_POLICIES, device: DeviceLike = None):
    """Fig. 11 subplots 2-3: policy -> [(replicas per app, result)]."""
    dev = resolve_device(device)
    return {pol: [(int(c), scheduling_inefficiency(
                      replace(base, n_replicas_per_app=int(c)), pol, dev))
                  for c in counts]
            for pol in policies}


def sweep_heterogeneity(base: SimConfig,
                        hs=(0.0, 0.15, 0.3, 0.5, 0.75, 1.0),
                        policies=_SWEEP_POLICIES, device: DeviceLike = None):
    """Fig. 11 subplot 4: policy -> [(heterogeneity, result)]."""
    dev = resolve_device(device)
    return {pol: [(float(h), scheduling_inefficiency(
                      replace(base, heterogeneity=float(h)), pol, dev))
                  for h in hs]
            for pol in policies}
