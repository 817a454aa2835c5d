"""Rank functions of the sharded simulation core's tests (gloo on the CPU).

``torch.multiprocessing.spawn`` pickles its function by reference, so the
functions live in this importable module.  Every rank joins through a
``file://`` store (no TCP port: the suite runs several workers at once)
with one thread, builds each case's cluster with the port's own
``_build_cluster`` (bit for bit the reference's), runs it under the
group and pickles its summary into ``out_dir``; the assertions are the
test's.  Nothing here imports jax.
"""
import os
import pickle
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import simcore
from repro_torch.core.campaign import run_scenario
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.simulator import APPS, SimConfig
from repro_torch.core.telemetry import TraceConfig

#: the fleet-mode case: a small fleet whose two trials are run twice over
FLEET = dict(n_requests=120, n_nodes=12, n_replicas_per_app=6, n_apps=3,
             n_trials=2, policy="perf_aware", seed=3, arrival_rate=50.0)
FLEET_NOISE = 9


def case_config(name: str, T: int, J: int, kw: dict):
    """The case's SimConfig: the scenario at seed 0 with T trials and J
    requests; ``trace`` as a sampling stride."""
    kw = dict(kw)
    if "trace" in kw:
        kw["trace"] = TraceConfig(sample_every=kw["trace"])
    return get_scenario(name).compile(seed=0, n_trials=T, n_requests=J, **kw)


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def _dump(out_dir: str, name: str, rank: int, obj) -> None:
    with open(os.path.join(out_dir, f"{name}-r{rank}.pkl"), "wb") as fh:
        pickle.dump(obj, fh)


def fleet_block_noise(group):
    """The fleet mode's responses on four trials that are two trials twice
    over, under ``group`` and on one process."""
    apps = tuple(APPS)[:FLEET["n_apps"]]
    cfg = SimConfig(n_nodes=FLEET["n_nodes"],
                    n_replicas_per_app=FLEET["n_replicas_per_app"], apps=apps,
                    n_requests=FLEET["n_requests"], n_trials=FLEET["n_trials"],
                    seed=FLEET["seed"], arrival_rate=FLEET["arrival_rate"])
    st = replace(simcore._static_for(cfg, FLEET["policy"]), native_noise=True)
    consts, plan = simcore._fleet_inputs(
        st, FLEET["seed"], FLEET["n_requests"], FLEET["n_trials"],
        FLEET["arrival_rate"], np.array([APPS[a][0] for a in apps]))
    twice = simcore._take_trials(st, consts, np.array([0, 1, 0, 1]))
    out = {}
    for label, g in (("group", group), ("single", None)):
        final, facts = simcore._execute(st, twice, plan, torch.device("cpu"),
                                        False, g, FLEET_NOISE)
        out[label] = (final["ys"]["resp"].numpy(), facts["simcore_backend"])
    return out


def sim_cases(rank, world, store, T, J, cases, campaign, out_dir):
    """Each case ``(label, scenario, policy, kw)`` through
    ``run_sim_compiled`` under the group; then ``run_scenario`` on
    ``campaign`` (scenario, seeds, trials a seed) under the group, the
    fleet mode through ``fleet_throughput`` and on duplicated trials."""
    _join(rank, world, store)
    try:
        group = dist.group.WORLD
        for label, name, policy, kw in cases:
            cfg = case_config(name, T, J, kw)
            _dump(out_dir, label, rank, simcore.run_sim_compiled(
                cfg, policy, device="cpu", group=group))
        name, seeds, trials = campaign
        res = run_scenario(name, seeds=seeds, device="cpu", group=group,
                           n_trials=trials, n_requests=J)
        _dump(out_dir, "campaign", rank, {
            p: (r.per_seed, r.inefficiency_pct, r.simcore_backend, r.ranks)
            for p, r in res.items()})
        _, stats = simcore.fleet_throughput(device="cpu", group=group,
                                            **FLEET)
        _dump(out_dir, "fleet", rank, stats)
        _dump(out_dir, "fleet-noise", rank, fleet_block_noise(group))
    finally:
        dist.destroy_process_group()
