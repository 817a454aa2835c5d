"""Batched multi-seed campaign runner (a port of the reference's
``core/campaign.py``).

A campaign cell is one scenario x policy over a grid of seeds.  The
per-seed clusters are built once, stacked along the trial axis into one
cluster, and each policy steps the whole stack in one pass of the
batched core.  All seeds share the scenario's arrival stream
(``ScenarioSpec.compile`` pins ``stream_seed``), and RandomChoice draws
per-seed blocks, so the stacked pass equals the per-seed serial runs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import simcore
from repro_torch.core.rng import rng_seed
from repro_torch.core.scenarios import ScenarioSpec, get_scenario
from repro_torch.core.simulator import _build_cluster, _Cluster
from repro_torch.device import DeviceLike, resolve_device

DEFAULT_POLICIES = ("perf_aware", "least_conn", "round_robin", "random")

#: summary stats aggregated per seed (means over that seed's trials)
SUMMARY_STATS = ("mean_rtt", "p50_rtt", "p95_rtt", "p99_rtt",
                 "cpu_s", "mem_s", "waste", "shed_rate",
                 "slo_violation_s", "goodput", "timeout_rate")


def _resolve(scenario) -> ScenarioSpec:
    return get_scenario(scenario) if isinstance(scenario, str) else scenario


def stack_clusters(clusters: Sequence[_Cluster]) -> _Cluster:
    """Concatenate per-seed clusters along the trial axis.

    Every cluster must carry the same request sequence and the same
    config up to ``seed``: the lockstep pass advances all stacked trials
    through one (app, now) per step under one set of knobs.
    """
    c0 = clusters[0]
    for c in clusters[1:]:
        if not (np.array_equal(c.req_app, c0.req_app)
                and np.array_equal(c.req_t, c0.req_t)):
            raise ValueError(
                "stacked clusters must share one arrival stream; compile "
                "the configs from a ScenarioSpec (or set stream_seed)")
        if replace(c.cfg, seed=c0.cfg.seed) != c0.cfg:
            raise ValueError(
                "stacked clusters must share every SimConfig field "
                f"except seed; got {c.cfg} vs {c0.cfg}")
    trials = [c.cfg.n_trials for c in clusters]

    def cat(attr):
        return np.concatenate([getattr(c, attr) for c in clusters], axis=0)

    # each seed drew its own interference mix -> per-trial (T, A, A)
    def cat_imat(attr):
        return np.concatenate(
            [np.broadcast_to(getattr(c, attr),
                             (t,) + getattr(c, attr).shape)
             for c, t in zip(clusters, trials)], axis=0)

    # the post-drift regime stacks like its pre-drift counterpart; the
    # shared mean_rtt_post is config-derived, equal across seeds
    return _Cluster(
        cfg=replace(c0.cfg, n_trials=sum(trials)),
        app_of=c0.app_of, mean_rtt=c0.mean_rtt,
        cpu_req=c0.cpu_req, mem_req=c0.mem_req,
        imat=cat_imat("imat"), node_of=cat("node_of"), accel=cat("accel"),
        req_app=c0.req_app, req_t=c0.req_t,
        z_rtt=cat("z_rtt"), z_pred=cat("z_pred"),
        failed_node=None if c0.failed_node is None else cat("failed_node"),
        imat_post=None if c0.imat_post is None else cat_imat("imat_post"),
        accel_post=None if c0.accel_post is None else cat("accel_post"),
        mean_rtt_post=c0.mean_rtt_post)


@dataclass
class PolicyResult:
    """One (scenario, policy) cell: per-seed stats + oracle-relative %."""
    scenario: str
    policy: str
    seeds: Tuple[int, ...]
    per_seed: Dict[str, np.ndarray]          # stat -> (S,)
    n_hedged: int = 0
    #: routings the closed loop's accuracy fallback sent by least_conn
    #: (per seed in ``per_seed["fallback"]``)
    n_fallback: int = 0
    inefficiency_pct: Optional[float] = None     # mean over seeds
    inefficiency_std: Optional[float] = None     # std over seeds
    p99_inefficiency_pct: Optional[float] = None
    resource_waste_pct: Optional[float] = None
    #: wall seconds of the cell's pass through the core, results on the
    #: host (cluster build excluded), and of its request loop alone
    wall_s: Optional[float] = None
    loop_s: Optional[float] = None
    #: host syncs the pass made (the expiry rounds' checks)
    host_syncs: int = 0

    def stat(self, name: str) -> float:
        return float(self.per_seed[name].mean())


def _block_reduce(values: np.ndarray, trials: Sequence[int],
                  fn=np.mean) -> np.ndarray:
    """Reduce a per-trial array to one value per seed block."""
    edges = np.cumsum([0] + list(trials))
    return np.array([fn(values[edges[i]:edges[i + 1]])
                     for i in range(len(trials))])


def _split_per_seed(summary: Dict[str, np.ndarray],
                    trials: Sequence[int]) -> Dict[str, np.ndarray]:
    """Collapse each seed's trial block to its mean, stat by stat."""
    out = {k: _block_reduce(summary[k], trials) for k in SUMMARY_STATS}
    out["hedged"] = _block_reduce(summary["hedged_per_trial"], trials,
                                  np.sum)
    out["fallback"] = _block_reduce(summary["fallback_per_trial"], trials,
                                    np.sum)
    # inefficiency is defined per trial, then averaged
    out["_trial_mean_rtt"] = summary["mean_rtt"]
    out["_trial_p99_rtt"] = summary["p99_rtt"]
    out["_trial_cpu_s"] = summary["cpu_s"]
    return out


def _attach_inefficiency(res: PolicyResult, ora: PolicyResult,
                         trials: Sequence[int]):
    pm, om = res.per_seed["_trial_mean_rtt"], ora.per_seed["_trial_mean_rtt"]
    pt, ot = res.per_seed["_trial_p99_rtt"], ora.per_seed["_trial_p99_rtt"]
    pc, oc = res.per_seed["_trial_cpu_s"], ora.per_seed["_trial_cpu_s"]
    ineff = (pm - om) / om * 100.0
    tail = (pt - ot) / np.maximum(ot, 1e-9) * 100.0
    waste = (pc - oc) / np.maximum(oc, 1e-9) * 100.0
    per_seed_ineff = _block_reduce(ineff, trials)
    res.inefficiency_pct = float(per_seed_ineff.mean())
    res.inefficiency_std = float(per_seed_ineff.std())
    res.p99_inefficiency_pct = float(tail.mean())
    res.resource_waste_pct = float(waste.mean())


def run_scenario(scenario, policies: Sequence[str] = DEFAULT_POLICIES,
                 seeds: Sequence[int] = tuple(range(12)),
                 include_oracle: bool = True, device: DeviceLike = None,
                 **overrides) -> Dict[str, PolicyResult]:
    """One scenario's policy x seed grid in len(policies) batched passes.

    ``overrides`` patch the compiled SimConfigs (tests shrink sizes).
    Returns policy -> :class:`PolicyResult`; with ``include_oracle`` the
    oracle runs too and every result carries oracle-relative
    inefficiency / p99 / waste percentages.  ``device=None`` runs on the
    CUDA card (RuntimeError without one), ``device="cpu"`` on the CPU.
    Raises NotImplementedError, naming the feature, when the scenario
    needs one the port does not lower yet.
    """
    dev = resolve_device(device)
    spec = _resolve(scenario)
    seeds = tuple(int(s) for s in seeds)
    cfgs = [spec.compile(seed=s, **overrides) for s in seeds]
    wanted = list(policies)
    if include_oracle and "oracle" not in wanted:
        wanted.append("oracle")
    for pol_name in wanted:
        reason = simcore.supports(cfgs[0], pol_name)
        if reason is not None:
            raise NotImplementedError(
                f"{spec.name}/{pol_name}: {reason}")
    stacked = stack_clusters([_build_cluster(c) for c in cfgs])
    trials = [c.n_trials for c in cfgs]
    blocks = [(rng_seed(c.seed, "policy"), c.n_trials) for c in cfgs]

    out: Dict[str, PolicyResult] = {}
    for pol_name in wanted:
        t0 = time.perf_counter()
        summary = simcore.run_compiled(stacked, pol_name, seed_blocks=blocks,
                                       device=dev)
        wall = time.perf_counter() - t0
        out[pol_name] = PolicyResult(
            scenario=spec.name, policy=pol_name, seeds=seeds,
            per_seed=_split_per_seed(summary, trials),
            n_hedged=summary["n_hedged"],
            n_fallback=summary["n_fallback"], wall_s=wall,
            loop_s=summary["loop_s"], host_syncs=summary["host_syncs"])
    if include_oracle:
        for pol_name in wanted:
            if pol_name != "oracle":
                _attach_inefficiency(out[pol_name], out["oracle"], trials)
    return out
