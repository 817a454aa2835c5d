"""The port's batched simulation core against the JAX package's serial
stepper, the reference semantics of the compiled core.

Both sides run one and the same cluster: the reference draws it and
``repro_torch.interop.cluster_from_reference`` carries it across (the
port's own ``_build_cluster`` is checked bit for bit against the
reference's separately).  The port runs with ``device="cpu"``.  Summary
stats must agree to 1e-5 relative (the reference's own contract); in
practice the two differ by rounding only and pick the same replicas.
"""
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

from repro.core.balancer import make_policy
from repro.core.rng import rng_seed
from repro.core.scenarios import get_scenario as ref_scenario
from repro.core.scenarios import scenario_names as ref_scenario_names
from repro.core.simulator import SimStepper
from repro.core.simulator import _build_cluster as ref_build
from repro_torch.core import simcore
from repro_torch.core.campaign import SUMMARY_STATS
from repro_torch.core.scenarios import get_scenario, scenario_names
from repro_torch.core.simulator import _build_cluster, _Cluster, unlowered
from repro_torch.interop import cluster_from_reference, config_from_reference

NINE = ("baseline", "colocation-surge", "hetero-tiers", "diurnal",
        "flash-crowd", "bursty", "churn", "stale-predictions",
        "metric-outage")
#: the scenarios this slice lowers: cold start, the closed-loop drift
#: scenarios (with the fallback) and the mixed fleet
SIX = ("cold-start", "tier-drift", "app-drift", "colocation-drift",
       "drift-fallback", "mixed-app-fleet")
#: the registry, in the reference's order
FIFTEEN = ("baseline", "colocation-surge", "hetero-tiers", "diurnal",
           "flash-crowd", "bursty", "churn", "stale-predictions",
           "cold-start", "metric-outage", "tier-drift", "app-drift",
           "colocation-drift", "drift-fallback", "mixed-app-fleet")
POLICIES = ("round_robin", "random", "least_conn", "perf_aware", "oracle")
SMALL = dict(n_trials=4, n_requests=150)
RTOL = 1e-5
#: the drift scenarios with the timeline compressed so the drift onset,
#: warm-up and several retrains fall inside the run
CROSSING = dict(n_trials=3, n_requests=80, arrival_rate=2.0, t_drift=20.0)
FALLBACK_CROSSING = dict(CROSSING, online_warmup_s=8.0,
                         retrain_every_s=6.0)


def _serial(cluster, policy):
    cfg = cluster.cfg
    pol = make_policy(policy, seed=rng_seed(cfg.seed, "policy"),
                      hedge_factor=cfg.hedge_factor)
    return SimStepper(cluster, pol).run()


def _assert_summary_close(port, serial, label):
    for k in SUMMARY_STATS:
        np.testing.assert_allclose(port[k], serial[k], rtol=RTOL, atol=1e-7,
                                   err_msg=f"{label}/{k}")
    assert port["n_hedged"] == serial["n_hedged"], label
    np.testing.assert_array_equal(port["hedged_per_trial"],
                                  serial["hedged_per_trial"])
    assert port["n_fallback"] == serial["n_fallback"], label
    assert ("online" in port) == ("online" in serial), label
    if "online" in serial:
        got, want = port["online"], serial["online"]
        np.testing.assert_array_equal(got["versions"], want["versions"])
        np.testing.assert_allclose(got["retrain_times"],
                                   want["retrain_times"], rtol=0, atol=0)
        np.testing.assert_allclose(got["trained_frac"], want["trained_frac"],
                                   rtol=RTOL, err_msg=f"{label}/trained")
        np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                                   rtol=RTOL, atol=1e-7,
                                   err_msg=f"{label}/accuracy")


def test_registry_is_the_nine_standing_scenarios():
    """The registry: the nine standing-matrix scenarios and the six this
    slice lowers, in the reference's order."""
    assert tuple(scenario_names()) == FIFTEEN
    assert set(NINE) | set(SIX) == set(FIFTEEN)


@pytest.mark.parametrize("name", FIFTEEN)
def test_cluster_build_bit_identical(name):
    ref_cfg = ref_scenario(name).compile(seed=3, **SMALL)
    cfg = get_scenario(name).compile(seed=3, **SMALL)
    assert config_from_reference(ref_cfg) == cfg
    mine, theirs = _build_cluster(cfg), ref_build(ref_cfg)
    for f in fields(_Cluster):
        if f.name == "cfg":
            continue
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


def test_cluster_from_reference_round_trips():
    ref = ref_build(ref_scenario("churn").compile(seed=1, **SMALL))
    port = cluster_from_reference(ref)
    again = cluster_from_reference(port)
    assert port.cfg == again.cfg
    for f in fields(_Cluster):
        if f.name == "cfg":
            continue
        a, b, c = (getattr(x, f.name) for x in (ref, port, again))
        if a is None:
            assert b is None and c is None
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
            np.testing.assert_array_equal(c, a, err_msg=f.name)
            assert b is not getattr(ref, f.name)      # a copy, not a view


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", FIFTEEN)
def test_core_matches_serial_stepper(name, policy):
    ref = ref_build(ref_scenario(name).compile(seed=0, **SMALL))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    _assert_summary_close(port, serial, f"{name}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])


@pytest.mark.parametrize("policy", ("perf_aware", "oracle"))
@pytest.mark.parametrize("name", ("baseline", "stale-predictions", "churn"))
def test_hedging_matches_serial_stepper(name, policy):
    # aggressive threshold + load so the hedge fires inside the horizon;
    # on stale-predictions perf_aware draws the runner-up pick-only
    ref = ref_build(ref_scenario(name).compile(
        seed=0, hedge_factor=0.5, arrival_rate=8.0, **SMALL))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    assert serial["n_hedged"] > 0          # the hedge actually fired
    _assert_summary_close(port, serial, f"hedge/{name}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,kw", [
    ("tier-drift", CROSSING), ("app-drift", CROSSING),
    ("colocation-drift", CROSSING), ("drift-fallback", FALLBACK_CROSSING)])
def test_drift_crossing_matches_serial_stepper(name, kw, policy):
    """The registry's horizon at test size ends before t_drift; these
    compress the timeline so the regime switch (and, for drift-fallback,
    warm-up, retrains and the fallback) happen inside the run."""
    ref = ref_build(ref_scenario(name).compile(seed=0, **kw))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    _assert_summary_close(port, serial, f"crossing/{name}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])
    if name == "drift-fallback" and policy == "perf_aware":
        assert serial["n_fallback"] > 0        # the fallback fired


@pytest.mark.parametrize("policy", ("perf_aware", "oracle"))
@pytest.mark.parametrize("name,kw", [
    ("drift-fallback", dict(FALLBACK_CROSSING, hedge_factor=0.5)),
    ("drift-fallback", dict(FALLBACK_CROSSING, prediction_lag_s=5.0,
                            outage=(15.0, 10.0), hedge_factor=0.7)),
    ("cold-start", dict(SMALL, prediction_lag_s=5.0)),
    ("cold-start", dict(SMALL, hedge_factor=0.5, arrival_rate=8.0))])
def test_closed_loop_and_cold_start_compose(name, kw, policy):
    """Combinations no registered scenario has: the fleet with hedging
    (the oracle then carries a fleet too) and with a stale, outage-frozen
    snapshot; cold start with a snapshot (consulted only past cold start)
    and with hedging."""
    ref = ref_build(ref_scenario(name).compile(seed=1, **kw))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    _assert_summary_close(port, serial, f"{name}/{kw}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])


def test_post_drift_regime_carries_across():
    ref = ref_build(ref_scenario("colocation-drift").compile(seed=2, **SMALL))
    port = cluster_from_reference(ref)
    for name in ("imat_post", "accel_post", "mean_rtt_post"):
        assert getattr(ref, name) is not None
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name))
    assert port.cfg.t_drift == ref.cfg.t_drift == 80.0


def test_tied_argmin_takes_first_index():
    row = torch.tensor([[3.0, 1.0, 1.0, 1.0], [2.0, 2.0, 2.0, 2.0]],
                       dtype=torch.float64)
    assert torch.argmin(row, dim=1).tolist() == [1, 0]
    # least_conn on an idle cluster: every candidate ties at the first
    # request, and the first replica of the app wins, as in the serial
    cfg = get_scenario("baseline").compile(seed=0, **SMALL)
    cluster = _build_cluster(cfg)
    out = simcore.run_compiled(cluster, "least_conn", device="cpu")
    a0 = int(cluster.req_app[0]) * cfg.n_replicas_per_app
    assert (out["chosen"][:, 0] == a0).all()


def _brute_expire(cnt, counted, busy, now, node_of, K):
    cnt, counted = cnt.clone(), counted.clone()
    T, R = busy.shape
    for t in range(T):
        for r in range(R):
            if counted[t, r] and busy[t, r] <= now:
                cnt[r // K, t, node_of[t, r]] -= 1
                counted[t, r] = False
    return cnt, counted


def test_expire_duplicate_pops_accumulate():
    """One app block whose expired replicas all sit on one node: the
    first round pops its first and last replica at the same (a, t, n),
    which must count twice; later rounds finish the block."""
    T, A, K, N = 2, 2, 5, 3
    node_of = torch.zeros((T, A * K), dtype=torch.int64)
    node_of[1] = torch.tensor([2, 2, 2, 1, 0, 1, 1, 1, 1, 0])
    busy = torch.tensor([[0.0] * 5 + [9.0, 0.0, 9.0, 0.0, 0.0],
                         [0.0, 9.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 9.0, 0.0]],
                        dtype=torch.float64)
    counted = torch.zeros((T, A * K + 1), dtype=torch.bool)
    counted[:, :A * K] = True
    cnt = torch.zeros((A, T, N), dtype=torch.int32)
    for t in range(T):
        for r in range(A * K):
            cnt[r // K, t, node_of[t, r]] += 1
    want_cnt, want_counted = _brute_expire(cnt, counted, busy, 1.0,
                                           node_of, K)
    syncs = simcore._expire(cnt, counted, busy, 1.0, node_of, K)
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(counted[:, :A * K], want_counted[:, :A * K])
    assert cnt[0, 0, 0] == 0 and cnt[1, 0, 0] == 2
    assert syncs == 3     # 5 expired in one block: rounds of 2, 2, 1


def test_expire_random_states_match_brute_force():
    rng = np.random.default_rng(7)
    T, A, K, N = 6, 3, 8, 4
    node_of = torch.as_tensor(rng.integers(0, N, size=(T, A * K)))
    busy = torch.as_tensor(rng.random((T, A * K)) * 2.0)
    counted = torch.zeros((T, A * K + 1), dtype=torch.bool)
    counted[:, :A * K] = torch.as_tensor(rng.random((T, A * K)) < 0.7)
    cnt = torch.zeros((A, T, N), dtype=torch.int32)
    for t in range(T):
        for r in range(A * K):
            if counted[t, r]:
                cnt[r // K, t, node_of[t, r]] += 1
    want_cnt, want_counted = _brute_expire(cnt, counted, busy, 1.0,
                                           node_of, K)
    simcore._expire(cnt, counted, busy, 1.0, node_of, K)
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(counted[:, :A * K], want_counted[:, :A * K])


@pytest.mark.parametrize("name,feature", [
    ("retry-storm", "resilience"),
    ("flash-crowd-autoscale", "capacity plane"),
    ("overload-ramp", "capacity plane"), ("gray-failure", "resilience")])
def test_unlowered_planes_are_named_and_refused(name, feature):
    ref_cfg = ref_scenario(name).compile(seed=0, n_trials=2, n_requests=40)
    cfg = config_from_reference(ref_cfg)
    reason = simcore.supports(cfg, "perf_aware")
    assert reason is not None and feature in reason
    cluster = cluster_from_reference(ref_build(ref_cfg))
    with pytest.raises(NotImplementedError, match=feature):
        simcore.run_compiled(cluster, "perf_aware", device="cpu")
    with pytest.raises(NotImplementedError, match=feature):
        _build_cluster(cfg)


def test_supports_rejects_unknown_policy():
    cfg = get_scenario("baseline").compile(seed=0, **SMALL)
    assert "unknown policy" in simcore.supports(cfg, "no_such_policy")
    for pol in POLICIES:
        assert simcore.supports(cfg, pol) is None


def test_supports_every_registered_scenario_and_names_the_rest():
    for name in FIFTEEN:
        cfg = get_scenario(name).compile(seed=0, **SMALL)
        for pol in POLICIES:
            assert simcore.supports(cfg, pol) is None, (name, pol)
    named = set()
    for name in ref_scenario_names():
        if name in FIFTEEN:
            continue
        cfg = config_from_reference(ref_scenario(name).compile(seed=0))
        reason = simcore.supports(cfg, "perf_aware")
        assert reason is not None, name
        named |= {w for w in ("capacity", "preemption", "resilience",
                              "trace") if w in reason}
    assert named == {"capacity", "resilience"}
    traced = get_scenario("baseline").compile(seed=0, trace=object())
    assert "trace" in simcore.supports(traced, "perf_aware")
    preempt = config_from_reference(ref_scenario("spot-preemption")
                                    .compile(seed=0))
    assert "preemption" in unlowered(replace(preempt, capacity=None))
