"""The simulation core's compiled mode on the CPU: the one-pass count
expiry, ``prepare_compiled``, the loop cache and the fleet-scale
``fleet_throughput`` against the JAX package's.

Tolerances: the expiry's counts and masks are integers, exact; a
``prepare_compiled`` rerun repeats ``run_compiled`` exactly (the same
steps on the same inputs).  The fleet mode draws its noise from a torch
generator and the reference's from a JAX key, so the two are the same
model on two random streams and agree only in distribution: each side
runs ``N_NOISE`` noise streams on one cluster, and the means of their
mean and p99 RTT may differ by at most ``T_9995`` standard errors of
that difference (a two-sided Welch test at 1e-3).  The cluster both
sides draw from ``rng_stream(seed, "fleet-demo")`` is equal bit for bit.
"""
import json
import os
import subprocess
import sys
from collections import OrderedDict
from dataclasses import replace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from repro_torch.core import simcore
from repro_torch.core.campaign import run_campaign
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.simulator import SimConfig, _build_cluster
from repro_torch.core.telemetry import TraceConfig

POLICIES = ("round_robin", "random", "least_conn", "perf_aware", "oracle")
#: the fleet mode against the reference: a few thousand requests, 50
#: nodes, 3 apps x 40 replicas, 2 trials
FLEET = dict(n_requests=2000, n_nodes=50, n_replicas_per_app=40, n_apps=3,
             n_trials=2)
FLEET_SEEDS = (0, 1)
FLEET_POLICIES = ("perf_aware", "least_conn")
#: noise streams a side runs on one cluster
N_NOISE = 4
#: Student's t, two-sided 1e-3 (0.9995 quantile), 2 (N_NOISE - 1) = 6
#: degrees of freedom
T_9995 = 5.959
HERE = os.path.dirname(os.path.abspath(__file__))


# ----------------------------------------------------------------------
# the one-pass expiry against the reference's rounds
def _pop_round(cnt, counted, ex, node_of, K):
    """The rounds' expiry as the port ran it before (a copy of the
    reference's ``expire`` body): pop the first and the last replica
    marked in ``ex`` of every app block of every trial."""
    T, R = ex.shape
    A = R // K
    kio = torch.arange(K)[None, None, :]
    exv = ex.view(T, A, K)
    k1 = torch.where(exv, kio, K).amin(2)
    k2 = torch.where(exv, kio, -1).amax(2)
    hasb = k2 >= 0
    k1 = torch.where(hasb, k1, 0)
    has2 = hasb & (k2 != k1)
    k2 = torch.where(hasb, k2, 0)
    blk = (torch.arange(A) * K)[None, :]
    i1, i2 = blk + k1, blk + k2
    nn = torch.cat([node_of.gather(1, i1), node_of.gather(1, i2)], 1)
    dec = torch.cat([hasb, has2], 1)
    app2 = torch.arange(A).repeat(2)[None, :].expand(T, 2 * A)
    trial2 = torch.arange(T)[:, None].expand(T, 2 * A)
    cnt.index_put_((app2, trial2, nn), -dec.to(cnt.dtype), accumulate=True)
    ii = torch.cat([torch.where(hasb, i1, R), torch.where(has2, i2, R)], 1)
    counted.scatter_(1, ii, False)


def _round_expire(cnt, counted, busy, now, node_of, K):
    """The oracle: rounds until no counted replica has expired."""
    R = busy.shape[1]
    expm = busy <= now
    while True:
        ex = expm & counted[:, :R]
        if not bool(ex.any()):
            return
        _pop_round(cnt, counted, ex, node_of, K)


@settings(max_examples=60, deadline=None)
@given(T=hs.integers(1, 5), A=hs.integers(1, 4), K=hs.integers(1, 7),
       N=hs.integers(1, 6), now=hs.floats(0.0, 1.0),
       seed=hs.integers(0, 2 ** 32 - 1))
def test_one_pass_expiry_matches_the_rounds(T, A, K, N, now, seed):
    rng = np.random.default_rng(seed)
    R = A * K
    node_of = torch.as_tensor(rng.integers(0, N, size=(T, R)))
    # busy times on a coarse grid, so that ties with ``now`` occur
    busy = torch.as_tensor(rng.integers(0, 5, size=(T, R)) / 4.0)
    counted = torch.zeros((T, R + 1), dtype=torch.bool)
    counted[:, :R] = torch.as_tensor(rng.random((T, R)) < 0.7)
    cnt = torch.as_tensor(rng.integers(0, 3, size=(A, T, N)),
                          dtype=torch.int32)
    for t in range(T):                 # counts hold the counted replicas
        for r in range(R):
            if counted[t, r]:
                cnt[r // K, t, node_of[t, r]] += 1
    want_cnt, want_counted = cnt.clone(), counted.clone()
    _round_expire(want_cnt, want_counted, busy, now, node_of, K)
    idx, _ = simcore._count_index(node_of.numpy(), A, K, N)
    simcore._expire(cnt, counted, busy, now, torch.as_tensor(idx))
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(counted[:, :R], want_counted[:, :R])


# ----------------------------------------------------------------------
# prepare_compiled
def _assert_same_summary(got, want, label):
    assert set(got) == set(want), label
    for k, v in want.items():
        if k in ("loop_s", "capture_s"):
            continue
        if isinstance(v, dict):
            _assert_same_summary(got[k], v, f"{label}/{k}")
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=f"{label}/{k}")


@pytest.mark.parametrize("policy", POLICIES)
def test_prepare_compiled_reruns_equal_run_compiled(policy):
    cfg = get_scenario("baseline").compile(seed=2, n_trials=4,
                                           n_requests=150)
    cluster = _build_cluster(cfg)
    want = simcore.run_compiled(cluster, policy, device="cpu")
    run = simcore.prepare_compiled(cluster, policy, device="cpu")
    for rerun in range(2):
        got = run()
        _assert_same_summary(got, want, f"{policy}/rerun {rerun}")
        assert got["backend"] == "eager" and got["capture_s"] == 0.0
        assert got["host_syncs"] == 0


def test_prepare_compiled_hedging_reruns_equal_run_compiled():
    """Hedging rides the graphable step too."""
    cfg = SimConfig(n_trials=4, n_requests=150, seed=1, hedge_factor=0.5,
                    arrival_rate=8.0)
    cluster = _build_cluster(cfg)
    for policy in ("perf_aware", "oracle"):
        want = simcore.run_compiled(cluster, policy, device="cpu")
        assert want["n_hedged"] > 0, policy
        _assert_same_summary(
            simcore.prepare_compiled(cluster, policy, device="cpu")(), want,
            policy)


def _host_free_run(st, c, plan, gen=None):
    """The loop as a CUDA graph runs it: blocks with no host step index
    (``j0`` None), so the step may read nothing of the host's schedule."""
    J, T = len(plan["req_t"]), c["node_of"].shape[0]
    s = simcore._new_carry(st, T, J, torch.device("cpu"))
    block, finish = simcore._step_fn(st, c, plan, s, gen)
    for _, n in simcore._blocks(J, simcore._BLOCK):
        block(None, n)
    final = finish()
    return dict(final, busy=final["busy"].numpy())


@pytest.mark.parametrize("scenario,policy,kw", [
    ("baseline", p, {}) for p in POLICIES] + [
    ("baseline", "perf_aware", dict(hedge_factor=0.5, arrival_rate=8.0)),
    ("baseline", "oracle", dict(hedge_factor=0.5, arrival_rate=8.0)),
    ("retry-storm", "perf_aware", {}), ("retry-storm", "round_robin", {})])
def test_graphable_steps_read_nothing_of_the_host(scenario, policy, kw):
    """Every ``_graphable`` configuration runs its steps without the
    host's step index, as a capture does, to the eager loop's summary."""
    size = {} if scenario == "retry-storm" else dict(n_requests=150)
    cfg = get_scenario(scenario).compile(seed=4, n_trials=3, **size, **kw)
    cluster = _build_cluster(cfg)
    st, consts, plan = simcore._lower(cluster, policy)
    assert simcore._graphable(st)
    c = {k: torch.as_tensor(v) for k, v in consts.items()}
    got = simcore._summarize(cluster, st, _host_free_run(st, c, plan), plan)
    want = simcore.run_compiled(cluster, policy, device="cpu")
    for k in ("loop_s", "capture_s", "backend", "device", "host_syncs",
              "simcore_backend", "ranks"):
        want.pop(k)
    _assert_same_summary(got, want, f"{scenario}/{policy}")


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_steps_read_nothing_of_the_host(policy):
    """The fleet mode's blocks draw their noise inside the block: run
    without the host's step index, they give the eager loop's
    responses."""
    kw = dict(n_requests=150, n_nodes=12, n_replicas_per_app=6, n_apps=3,
              n_trials=2, policy=policy, seed=3, arrival_rate=50.0)
    _, want = simcore._fleet(noise_seed=9, device="cpu", **kw)
    cfg = SimConfig(n_nodes=12, n_replicas_per_app=6,
                    apps=("upload", "motioncor2", "fft_mock"),
                    n_requests=150, n_trials=2, seed=3, arrival_rate=50.0)
    st = replace(simcore._static_for(cfg, policy), native_noise=True)
    assert simcore._graphable(st)
    consts, plan = simcore._fleet_inputs(st, 3, 150, 2, 50.0,
                                         np.array([20.0, 5.0, 10.0]))
    c = {k: torch.as_tensor(v) for k, v in consts.items()}
    final = _host_free_run(st, c, plan,
                           torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(final["ys"]["resp"].numpy(), want)


def test_graphable_names_the_host_free_configurations():
    def st(scenario, policy, **kw):
        cfg = get_scenario(scenario).compile(seed=0, n_trials=2,
                                             n_requests=20, **kw)
        return simcore._static_for(cfg, policy)
    for policy in POLICIES:
        assert simcore._graphable(st("baseline", policy)), policy
    assert simcore._graphable(st("retry-storm", "perf_aware"))
    for scenario in ("churn", "stale-predictions", "cold-start",
                     "drift-fallback", "overload-ramp", "gray-failure",
                     "correlated-outage", "breaker-saves-retry-storm",
                     "tier-drift"):
        assert not simcore._graphable(st(scenario, "perf_aware")), scenario
    assert not simcore._graphable(st("baseline", "perf_aware",
                                     trace=TraceConfig(4)))


# ----------------------------------------------------------------------
# the loop cache (tests/test_simcore.py's, on the port's cache)
def test_fn_cache_bounded_over_full_campaign():
    run_campaign(seeds=(0, 1), n_trials=2, n_requests=30, device="cpu")
    stats = simcore.cache_stats()
    assert stats["size"] <= stats["max"]
    assert stats["misses"] >= 1


def test_fn_cache_lru_eviction(monkeypatch):
    monkeypatch.setattr(simcore, "_FN_CACHE", OrderedDict())
    monkeypatch.setattr(simcore, "_FN_CACHE_MAX", 2)
    monkeypatch.setattr(simcore, "_FN_STATS",
                        {"hits": 0, "misses": 0, "evictions": 0})
    cfg = SimConfig(n_trials=2, n_requests=10, seed=0)
    for pol in ("least_conn", "round_robin", "random"):
        simcore.run_sim_compiled(cfg, pol, device="cpu")
    stats = simcore.cache_stats()
    assert stats["size"] <= 2
    assert stats["misses"] == 3 and stats["evictions"] == 1
    # most-recently-used survives: re-running it is a hit, not a miss
    simcore.run_sim_compiled(cfg, "random", device="cpu")
    assert simcore.cache_stats()["hits"] == 1
    assert simcore.cache_stats() == {"size": 2, "max": 2, "hits": 1,
                                     "misses": 3, "evictions": 1}


def test_prepare_compiled_twice_is_a_hit(monkeypatch):
    monkeypatch.setattr(simcore, "_FN_CACHE", OrderedDict())
    monkeypatch.setattr(simcore, "_FN_STATS",
                        {"hits": 0, "misses": 0, "evictions": 0})
    cluster = _build_cluster(SimConfig(n_trials=2, n_requests=30, seed=3))
    first = simcore.prepare_compiled(cluster, "perf_aware", device="cpu")
    second = simcore.prepare_compiled(cluster, "perf_aware", device="cpu")
    assert simcore.cache_stats()["hits"] == 1
    assert simcore.cache_stats()["misses"] == 1
    _assert_same_summary(second(), first(), "shared loop")
    simcore.clear_cache()
    assert simcore.cache_stats()["size"] == 0


# ----------------------------------------------------------------------
# the fleet mode
def test_fleet_throughput_smoke():
    eps, stats = simcore.fleet_throughput(n_requests=200, n_nodes=12,
                                          n_replicas_per_app=6, n_apps=3,
                                          n_trials=2, arrival_rate=50.0,
                                          device="cpu")
    assert eps > 0
    assert np.isfinite(stats["mean_rtt"]) and stats["mean_rtt"] > 0
    assert np.isfinite(stats["p99_rtt"])
    assert stats["n_replicas"] == 18
    assert stats["backend"] == "eager"
    assert set(stats) >= {"mean_rtt", "p99_rtt", "n_requests", "n_replicas",
                          "n_trials", "wall_s", "backend", "events_per_s"}


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_throughput_repeats_under_one_seed(policy):
    kw = dict(n_requests=120, n_nodes=12, n_replicas_per_app=6, n_apps=3,
              n_trials=2, arrival_rate=50.0, policy=policy, device="cpu")
    a = simcore.fleet_throughput(seed=5, **kw)[1]
    b = simcore.fleet_throughput(seed=5, **kw)[1]
    c = simcore.fleet_throughput(seed=6, **kw)[1]
    for k in ("mean_rtt", "p99_rtt"):
        assert a[k] == b[k] and a[k] != c[k], k


def test_fleet_throughput_refuses_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simcore.fleet_throughput(n_requests=10, n_nodes=4,
                                 n_replicas_per_app=2, n_apps=2, n_trials=1)


@pytest.fixture(scope="module")
def reference_fleet(tmp_path_factory):
    """The reference's ``fleet_throughput`` on FLEET for every seed and
    policy, under N_NOISE noise keys, run by the helper in a process of
    its own (its enable_x64 alias stays there).  The process starts with
    the fixture and runs beside the port's runs; calling the fixture's
    value waits for it and returns (seed, policy) -> [(stats, arrays)]."""
    tmp = tmp_path_factory.mktemp("reference_fleet")
    cases = [dict(FLEET, seed=s, policy=p, noise_key=k)
             for s in FLEET_SEEDS for p in FLEET_POLICIES
             for k in range(N_NOISE)]
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(HERE), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable,
                             os.path.join(HERE, "_torch_reference_fleet.py"),
                             str(tmp / "cases.json"), str(tmp / "out.npz")],
                            env=env)
    runs = {}

    def result():
        if not runs:
            assert proc.wait() == 0, "the reference's fleet run failed"
            out = np.load(tmp / "out.npz")
            for i, case in enumerate(cases):
                stats = json.loads(str(out[f"{i}/stats"]))
                arrays = {k.split("/", 1)[1]: out[k] for k in out.files
                          if k.startswith(f"{i}/")
                          and not k.endswith("/stats")}
                runs.setdefault((case["seed"], case["policy"]), []).append(
                    (stats, arrays))
        return runs

    yield result
    proc.wait()


def _noise_stats(seed, policy):
    """The port's (N_NOISE, 2) mean and p99 RTT: fleet_throughput's own
    noise stream, then N_NOISE - 1 others on the same cluster."""
    out = [simcore.fleet_throughput(seed=seed, policy=policy, device="cpu",
                                    **FLEET)[1]]
    for k in range(1, N_NOISE):
        out.append(simcore._fleet(seed=seed, policy=policy, noise_seed=k,
                                  arrival_rate=2000.0, device="cpu",
                                  **FLEET)[0])
    return np.array([[s["mean_rtt"], s["p99_rtt"]] for s in out])


@pytest.mark.parametrize("seed", FLEET_SEEDS)
def test_fleet_stats_agree_with_the_reference(reference_fleet, seed):
    port = {p: _noise_stats(seed, p) for p in FLEET_POLICIES}
    ref = {p: np.array([[s["mean_rtt"], s["p99_rtt"]]
                        for s, _ in reference_fleet()[seed, p]])
           for p in FLEET_POLICIES}
    for p in FLEET_POLICIES:
        assert ref[p].shape == port[p].shape == (N_NOISE, 2)
        assert np.isfinite(port[p]).all()
        se = np.sqrt((port[p].var(0, ddof=1) + ref[p].var(0, ddof=1))
                     / N_NOISE)
        diff = np.abs(port[p].mean(0) - ref[p].mean(0))
        assert (diff <= T_9995 * se).all(), (p, diff, se)
        assert (se < 0.05 * ref[p].mean(0)).all(), (p, se)
    # the test tells the policies apart: each side's perf_aware mean RTT
    # sits outside the tolerance of the other side's least_conn
    for a, b in ((port, ref), (ref, port)):
        se = np.sqrt((a["perf_aware"][:, 0].var(ddof=1)
                      + b["least_conn"][:, 0].var(ddof=1)) / N_NOISE)
        gap = b["least_conn"][:, 0].mean() - a["perf_aware"][:, 0].mean()
        assert gap > T_9995 * se, (gap, se)


@pytest.mark.parametrize("seed", FLEET_SEEDS)
def test_fleet_cluster_draws_are_the_references(reference_fleet, seed):
    _, ref = reference_fleet()[seed, "perf_aware"][0]
    apps = ("upload", "motioncor2", "fft_mock")
    cfg = SimConfig(n_nodes=FLEET["n_nodes"],
                    n_replicas_per_app=FLEET["n_replicas_per_app"],
                    apps=apps, n_requests=FLEET["n_requests"],
                    n_trials=FLEET["n_trials"], seed=seed)
    st = simcore._static_for(cfg, "perf_aware")
    consts, plan = simcore._fleet_inputs(
        st, seed, FLEET["n_requests"], FLEET["n_trials"], 2000.0,
        ref["mean_rtt"])
    pairs = {"node_of": "node_of", "imat": "imat_pre", "speed": "speed_pre",
             "cand_node": "cand_node", "mate_idx": "mate_idx",
             "mate_app": "mate_app", "mate_pad": "mate_pad",
             "log_rbar": "log_rbar_pre", "mean_rtt": "mean_rtt",
             "app": "xs_app", "t": "xs_t"}
    for mine, theirs in pairs.items():
        np.testing.assert_array_equal(consts[mine], ref[theirs],
                                      err_msg=mine)
    np.testing.assert_array_equal(plan["req_t"], ref["xs_t"])
    np.testing.assert_array_equal(ref["mean_rtt"], [20.0, 5.0, 10.0])
