"""Batched multi-seed campaign runner (a port of the reference's
``core/campaign.py``).

A campaign cell is one scenario x policy over a grid of seeds.  The
per-seed clusters are built once, stacked along the trial axis into one
cluster, and each policy steps the whole stack in one pass of the
batched core.  All seeds share the scenario's arrival stream
(``ScenarioSpec.compile`` pins ``stream_seed``), and RandomChoice draws
per-seed blocks, so the stacked pass equals the per-seed serial runs.
:func:`run_campaign` runs the scenario x policy x seed grid and
:func:`campaign_table` renders it as the EXPERIMENTS.md tables do.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import simcore
from repro_torch.core.rng import rng_seed
from repro_torch.core.scenarios import (ScenarioSpec, get_scenario,
                                        scenario_names)
from repro_torch.core.simulator import _build_cluster, _Cluster
from repro_torch.core.telemetry import PhaseTimer
from repro_torch.device import DeviceLike, resolve_device

DEFAULT_POLICIES = ("perf_aware", "least_conn", "round_robin", "random")

#: wall seconds per phase of the most recent :func:`run_scenario` call
#: ("build" + one "run:<policy>" entry per pass), refreshed per call;
#: the phases are also torch profiler ranges (:class:`PhaseTimer`)
LAST_PHASES: Dict[str, float] = {}

#: summary stats aggregated per seed (means over that seed's trials)
SUMMARY_STATS = ("mean_rtt", "p50_rtt", "p95_rtt", "p99_rtt",
                 "cpu_s", "mem_s", "waste", "shed_rate",
                 "slo_violation_s", "goodput", "timeout_rate")
#: the client plane's per-trial stats, aggregated per seed the same way
RESILIENCE_STATS = ("client_timeout_rate", "fail_fast_rate",
                    "attempts_per_req", "wasted_work_s")


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

    def cat_opt(attr):
        return None if getattr(c0, attr) is None else cat(attr)

    # the post-drift regime stacks like its pre-drift counterpart; the
    # shared mean_rtt_post is config-derived, equal across seeds.  Every
    # seed shares the arrival stream, hence one membership timeline.
    return _Cluster(
        cfg=replace(c0.cfg, n_trials=sum(trials)),
        app_of=c0.app_of, mean_rtt=c0.mean_rtt,
        cpu_req=c0.cpu_req, mem_req=c0.mem_req,
        imat=cat_imat("imat"), node_of=cat("node_of"), accel=cat("accel"),
        req_app=c0.req_app, req_t=c0.req_t,
        z_rtt=cat("z_rtt"), z_pred=cat("z_pred"),
        failed_node=cat_opt("failed_node"),
        imat_post=None if c0.imat_post is None else cat_imat("imat_post"),
        accel_post=cat_opt("accel_post"), mean_rtt_post=c0.mean_rtt_post,
        preempted_node=cat_opt("preempted_node"),
        gray_rep=cat_opt("gray_rep"), group_rep=cat_opt("group_rep"),
        z_jitter=cat_opt("z_jitter"))


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
    #: host syncs the pass made (the capacity plane's completion folds'
    #: round counts)
    host_syncs: int = 0
    #: how the core ran the pass: ``"graph"`` (replayed from CUDA
    #: graphs) or ``"eager"``
    backend: Optional[str] = None
    #: the capacity plane's telemetry over the stacked trials (epochs,
    #: per-trial scale-ups / downs, wakes and final active counts,
    #: routings onto a drained replica, mean utilisation); None without
    #: a capacity plane
    telemetry: Optional[Dict[str, object]] = None
    #: the flight recorder's block over the stacked trials; None when
    #: the scenario is not traced
    trace: Optional[Dict[str, object]] = None

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
    """Collapse each seed's trial block to its mean, stat by stat, and
    the per-trial counts (hedges, fallback routings, timed-out requests,
    breaker trips) to their sum."""
    out = {k: _block_reduce(summary[k], trials)
           for k in SUMMARY_STATS + RESILIENCE_STATS}
    for k, src in (("hedged", "hedged_per_trial"),
                   ("fallback", "fallback_per_trial"),
                   ("timeouts", "timeouts_per_trial"),
                   ("trips", "breaker_trips_per_trial")):
        out[k] = _block_reduce(summary[src], trials, np.sum)
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
    needs one the port does not lower.
    """
    dev = resolve_device(device)
    spec = _resolve(scenario)
    timer = PhaseTimer()
    with timer.phase("build"):
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
        with timer.phase(f"run:{pol_name}"):
            summary = simcore.run_compiled(stacked, pol_name,
                                           seed_blocks=blocks, device=dev)
        out[pol_name] = PolicyResult(
            scenario=spec.name, policy=pol_name, seeds=seeds,
            per_seed=_split_per_seed(summary, trials),
            n_hedged=summary["n_hedged"],
            n_fallback=summary["n_fallback"],
            wall_s=timer.wall[f"run:{pol_name}"],
            loop_s=summary["loop_s"], host_syncs=summary["host_syncs"],
            backend=summary["backend"],
            telemetry=summary.get("capacity"), trace=summary.get("trace"))
    if include_oracle:
        for pol_name in wanted:
            if pol_name != "oracle":
                _attach_inefficiency(out[pol_name], out["oracle"], trials)
    LAST_PHASES.clear()
    LAST_PHASES.update(timer.summary())
    return out


def run_campaign(scenarios: Optional[Sequence] = None,
                 policies: Sequence[str] = DEFAULT_POLICIES,
                 seeds: Sequence[int] = tuple(range(12)),
                 include_oracle: bool = True, device: DeviceLike = None,
                 **overrides) -> Dict[str, Dict[str, PolicyResult]]:
    """The scenario x policy x seed grid: one :func:`run_scenario` per
    scenario (every registered one by default), keyed by name."""
    dev = resolve_device(device)
    names = scenario_names() if scenarios is None else list(scenarios)
    return {_resolve(n).name: run_scenario(n, policies, seeds,
                                           include_oracle, device=dev,
                                           **overrides)
            for n in names}


def campaign_table(results: Dict[str, Dict[str, PolicyResult]],
                   markdown: bool = False) -> str:
    """Render the scenario x policy grid as one table (p50/p95/p99 s,
    oracle-relative inefficiency % and resource waste %, plus the
    capacity plane's idle-provisioned fraction and shed rate)."""
    rows = [("scenario", "policy", "p50 s", "p95 s", "p99 s",
             "ineff %", "waste %", "idle", "shed")]
    for scen, cell in results.items():
        for pol, r in cell.items():
            if pol == "oracle":
                continue
            ineff = "-" if r.inefficiency_pct is None \
                else f"{r.inefficiency_pct:.1f}±{r.inefficiency_std:.1f}"
            waste = "-" if r.resource_waste_pct is None \
                else f"{r.resource_waste_pct:.1f}"
            rows.append((scen, pol, f"{r.stat('p50_rtt'):.2f}",
                         f"{r.stat('p95_rtt'):.2f}",
                         f"{r.stat('p99_rtt'):.2f}", ineff, waste,
                         f"{r.stat('waste'):.2f}",
                         f"{r.stat('shed_rate'):.3f}"))
    if markdown:
        lines = ["| " + " | ".join(rows[0]) + " |",
                 "|" + "---|" * len(rows[0])]
        lines += ["| " + " | ".join(r) + " |" for r in rows[1:]]
        return "\n".join(lines)
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                     for r in rows)


def compiled_coverage(policies: Optional[Sequence[str]] = None
                      ) -> List[Tuple[str, str, str]]:
    """Every (registered scenario, policy) pair the batched core does not
    run, as ``(scenario, policy, reason)`` rows; empty means the port
    runs the whole registry."""
    pols = tuple(policies) if policies is not None \
        else DEFAULT_POLICIES + ("oracle",)
    out: List[Tuple[str, str, str]] = []
    for name in scenario_names():
        cfg = get_scenario(name).compile(seed=0)
        for pol in pols:
            reason = simcore.supports(cfg, pol)
            if reason is not None:
                out.append((name, pol, reason))
    return out
