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
from repro.core.capacity import CapacityConfig as RefCapacityConfig
from repro.core.capacity import _take_highest as ref_take_highest
from repro.core.capacity import _take_lowest as ref_take_lowest
from repro.core.capacity import membership_timeline as ref_timeline
from repro.core.resilience import ResilienceConfig as RefResilienceConfig
from repro.core.rng import rng_seed
from repro.core.scenarios import get_scenario as ref_scenario
from repro.core.scenarios import scenario_names as ref_scenario_names
from repro.core.simulator import SimStepper
from repro.core.simulator import _build_cluster as ref_build
from repro.core.telemetry import TraceConfig
from repro_torch.core import simcore
from repro_torch.core.campaign import RESILIENCE_STATS, SUMMARY_STATS
from repro_torch.core.capacity import (CapacityConfig, membership_timeline,
                                       take_highest, take_lowest)
from repro_torch.core.scenarios import get_scenario, scenario_names
from repro_torch.core.simulator import (_build_cluster, _Cluster,
                                        fault_draws, unlowered)
from repro_torch.interop import cluster_from_reference, config_from_reference
from repro_torch.kernels.segment_sum import segment_sum

NINE = ("baseline", "colocation-surge", "hetero-tiers", "diurnal",
        "flash-crowd", "bursty", "churn", "stale-predictions",
        "metric-outage")
#: cold start, the closed-loop drift scenarios (with the fallback) and
#: the mixed fleet
SIX = ("cold-start", "tier-drift", "app-drift", "colocation-drift",
       "drift-fallback", "mixed-app-fleet")
#: the capacity plane (with spot preemption)
CAPACITY = ("overload-ramp", "flash-crowd-autoscale", "scale-to-zero-idle",
            "spot-preemption")
#: the resilience plane's faults that need no client semantics
FAULTS = ("gray-failure", "staleness-storm")
#: the scenarios with client-side resilience (timeouts, retries,
#: breakers), the correlated outage among them
CLIENT_SIDE = ("correlated-outage", "retry-storm",
               "breaker-saves-retry-storm")
#: the registry, in the reference's order
LOWERED = ("baseline", "colocation-surge", "hetero-tiers", "diurnal",
           "flash-crowd", "bursty", "churn", "stale-predictions",
           "cold-start", "metric-outage", "tier-drift", "app-drift",
           "colocation-drift", "drift-fallback") + CAPACITY + FAULTS \
    + CLIENT_SIDE + ("mixed-app-fleet",)
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
    stepper = SimStepper(cluster, pol)
    out = stepper.run()
    # the breakers' trip events, which the summary does not carry
    out["breaker_trips"] = 0 if stepper.breaker is None \
        else stepper.breaker.trips
    return out


def _assert_summary_close(port, serial, label):
    for k in SUMMARY_STATS:
        np.testing.assert_allclose(port[k], serial[k], rtol=RTOL, atol=1e-7,
                                   err_msg=f"{label}/{k}")
    assert port["n_hedged"] == serial["n_hedged"], label
    np.testing.assert_array_equal(port["hedged_per_trial"],
                                  serial["hedged_per_trial"])
    assert port["n_fallback"] == serial["n_fallback"], label
    assert port["n_shed"] == serial["n_shed"], label
    # the client plane: the rates to rounding, the counts exactly
    for k in RESILIENCE_STATS:
        np.testing.assert_allclose(port[k], serial[k], rtol=RTOL, atol=1e-7,
                                   err_msg=f"{label}/{k}")
    for k in ("n_timeouts", "n_client_timeout", "n_fail_fast"):
        assert port[k] == serial[k], f"{label}/{k}"
    np.testing.assert_array_equal(port["attempts_per_req"],
                                  serial["attempts_per_req"])
    assert int(port["breaker_trips_per_trial"].sum()) \
        == serial["breaker_trips"], f"{label}/breaker_trips"
    assert ("capacity" in port) == ("capacity" in serial), label
    if "capacity" in serial:
        _assert_telemetry_equal(port, serial, label)
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


def _assert_telemetry_equal(port, serial, label):
    """The capacity plane's integer telemetry exactly (a flipped ceiling
    in a target shows here first), no served request on a drained
    replica, and the ledger to rounding."""
    got, want = port["capacity"], serial["capacity"]
    assert got["decisions"] == want["decisions"], label
    for k in ("scale_ups", "scale_downs", "wakeups", "active_final"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label}/{k}")
    assert got["routed_inactive"] == want["routed_inactive"] == 0, label
    np.testing.assert_allclose(got["mean_util"], want["mean_util"],
                               rtol=RTOL, err_msg=f"{label}/mean_util")
    np.testing.assert_allclose(port["provisioned_s"], serial["provisioned_s"],
                               rtol=RTOL, err_msg=f"{label}/provisioned_s")


def test_registry_is_the_nine_standing_scenarios():
    """The registry: the nine standing-matrix scenarios and the fifteen
    lowered since; the reference's twenty-four in its order."""
    assert tuple(scenario_names()) == LOWERED == tuple(ref_scenario_names())
    assert set(NINE) | set(SIX) | set(CAPACITY) | set(FAULTS) \
        | set(CLIENT_SIDE) == set(LOWERED)
    assert len(LOWERED) == 24


@pytest.mark.parametrize("name", LOWERED)
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


@pytest.mark.parametrize("name", ref_scenario_names())
def test_fault_draws_bit_identical(name):
    """The fault stream's draws (gray node, group start, backoff jitter)
    on every reference scenario."""
    ref = ref_build(ref_scenario(name).compile(seed=4, **SMALL))
    cfg = config_from_reference(ref.cfg)
    got = fault_draws(cfg, ref.node_of)
    for f, a in zip(("gray_rep", "group_rep", "z_jitter"), got):
        b = getattr(ref, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
    res = ref.cfg.resilience
    assert (got[0] is not None) == (res is not None and res.gray is not None)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", LOWERED)
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
    """One app block whose expired replicas all sit on one node: the one
    pass pops them all at the same (a, t, n), which must count each of
    them."""
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
    idx, _ = simcore._count_index(node_of.numpy(), A, K, N)
    simcore._expire(cnt, counted, busy, 1.0, torch.as_tensor(idx))
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(counted[:, :A * K], want_counted[:, :A * K])
    assert cnt[0, 0, 0] == 0 and cnt[1, 0, 0] == 2


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
    idx, _ = simcore._count_index(node_of.numpy(), A, K, N)
    simcore._expire(cnt, counted, busy, 1.0, torch.as_tensor(idx))
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(counted[:, :A * K], want_counted[:, :A * K])


@pytest.mark.parametrize("name,kw,feature", [
    ("retry-storm", {}, "client-side resilience"),
    ("correlated-outage", {}, "correlated outage"),
    ("breaker-saves-retry-storm", {}, "client-side resilience"),
    ("baseline", dict(trace=TraceConfig(sample_every=4)), "trace")])
def test_unlowered_planes_are_named_and_refused(name, kw, feature):
    """The planes the port once refused by name (client-side resilience,
    the correlated outage, the trace) are supported and run: the same
    inputs now match the serial stepper, the trace row for row."""
    ref_cfg = ref_scenario(name).compile(seed=0, n_trials=2, n_requests=40,
                                         **kw)
    cfg = config_from_reference(ref_cfg)
    assert simcore.supports(cfg, "perf_aware") is None, feature
    assert unlowered(cfg) is None
    ref = ref_build(ref_cfg)
    port = simcore.run_compiled(cluster_from_reference(ref), "perf_aware",
                                device="cpu")
    serial = _serial(ref, "perf_aware")
    _assert_summary_close(port, serial, f"{name}/{feature}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])
    assert ("trace" in port) == ("trace" in serial) == ("trace" in kw)
    if "trace" in kw:
        a, b = port["trace"]["data"], serial["trace"]["data"]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=RTOL, atol=1e-7)
    _build_cluster(cfg)


def test_supports_rejects_unknown_policy():
    cfg = get_scenario("baseline").compile(seed=0, **SMALL)
    assert "unknown policy" in simcore.supports(cfg, "no_such_policy")
    for pol in POLICIES:
        assert simcore.supports(cfg, pol) is None


def test_supports_every_registered_scenario_and_names_the_rest():
    """Every registered scenario x policy is supported, traced or not;
    what stays refused is what the reference refuses: preemption without
    a capacity plane, hedging with client timeouts."""
    for name in LOWERED:
        cfg = get_scenario(name).compile(seed=0, **SMALL)
        for pol in POLICIES:
            assert simcore.supports(cfg, pol) is None, (name, pol)
        ref = config_from_reference(ref_scenario(name).compile(seed=0))
        assert unlowered(ref) is None, name
    traced = get_scenario("baseline").compile(seed=0, trace=TraceConfig(16))
    assert simcore.supports(traced, "perf_aware") is None
    spot = config_from_reference(ref_scenario("spot-preemption")
                                 .compile(seed=0))
    assert unlowered(spot) is None
    with pytest.raises(ValueError, match="preempt requires"):
        _build_cluster(replace(spot, capacity=None))
    storm = get_scenario("retry-storm").compile(seed=0, **SMALL)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _build_cluster(replace(storm, hedge_factor=0.5))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", CAPACITY)
def test_capacity_telemetry_matches_serial_exactly(name, policy):
    """The registered capacity scenarios at their own length (every
    autoscaler epoch of the run, the preemption window, the idle
    valleys' scale-to-zero and wakes): the integer telemetry equals the
    serial stepper's, and no served request lands on a drained
    replica."""
    ref = ref_build(ref_scenario(name).compile(seed=1, n_trials=2))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    assert serial["capacity"]["decisions"] > 20
    assert serial["capacity"]["scale_ups"].sum() > 0
    _assert_summary_close(port, serial, f"{name}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])


#: capacity planes that shed, wake every arrival and break glass
_REACTIVE_SHED = RefCapacityConfig(autoscaler="reactive", min_replicas=1,
                                   admission_limit_s=3.0)
_FIXED_ZERO = RefCapacityConfig(autoscaler="fixed", min_replicas=0,
                                initial_replicas=0, max_replicas=3,
                                admission_limit_s=2.0)
_PREDICT_SHED = RefCapacityConfig(min_replicas=1, admission_limit_s=3.0)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,kw", [
    ("overload-ramp", dict(capacity=_REACTIVE_SHED)),
    ("spot-preemption", dict(capacity=_FIXED_ZERO)),
    ("spot-preemption", dict(n_nodes=1))])
def test_capacity_shed_wake_and_break_glass_match_serial(name, kw, policy):
    """Admission sheds (NaN responses, ``chosen = -1``, NaN-aware stats)
    under the reactive and the fixed autoscaler, a pool that starts
    empty and wakes at every arrival, and a preemption that takes every
    replica's node (the wake breaks glass)."""
    ref = ref_build(ref_scenario(name).compile(seed=0, n_trials=3,
                                               n_requests=200, **kw))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    assert serial["n_shed"] > 0
    if "n_nodes" in kw or kw["capacity"].initial == 0:
        assert serial["capacity"]["wakeups"].sum() > 0
    _assert_summary_close(port, serial, f"{name}/{kw}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,kw", [
    ("spot-preemption", dict(churn=(30.0, 40.0))),
    ("overload-ramp", dict(churn=(40.0, 30.0), capacity=_REACTIVE_SHED)),
    ("overload-ramp", dict(closed_loop=True, online_warmup_s=20.0,
                           retrain_every_s=10.0, fallback_threshold=0.55)),
    ("overload-ramp", dict(closed_loop=True, online_warmup_s=20.0,
                           retrain_every_s=10.0, fallback_threshold=0.55,
                           hedge_factor=0.7, capacity=_PREDICT_SHED))])
def test_capacity_with_churn_and_closed_loop_matches_serial(name, kw,
                                                            policy):
    """Churn inside the membership walk (its busy bump lands mid-walk,
    the resync at the churn step) and the closed-loop fleet under the
    capacity plane (the fleet's raw prediction feeds the autoscaler,
    shed requests train nothing), with hedging and admission."""
    ref = ref_build(ref_scenario(name).compile(seed=0, n_trials=3,
                                               n_requests=200, **kw))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    _assert_summary_close(port, serial, f"{name}/{kw}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])
    if kw.get("closed_loop") and policy == "perf_aware":
        assert serial["n_fallback"] > 0


@pytest.mark.parametrize("policy", ("perf_aware", "oracle"))
@pytest.mark.parametrize("name,kw", [
    ("spot-preemption", dict(hedge_factor=0.5)),
    ("scale-to-zero-idle", dict(cold_start_s=40.0, prediction_lag_s=5.0)),
    ("overload-ramp", dict(hedge_factor=0.5, prediction_lag_s=5.0,
                           capacity=_PREDICT_SHED)),
    ("gray-failure", dict(hedge_factor=0.5, prediction_lag_s=5.0,
                          arrival_rate=4.0)),
    ("gray-failure", dict(capacity=_PREDICT_SHED, preempt=(30.0, 30.0))),
    ("staleness-storm", dict(outage=(20.0, 10.0)))])
def test_planes_compose_with_hedging_snapshot_and_cold_start(name, kw,
                                                             policy):
    """Combinations no registered scenario has: the capacity plane with
    hedging (drained candidates neither take nor anchor a hedge), cold
    start and a stale snapshot (cold replicas predicted slow); gray
    failure under hedging, a snapshot and a capacity plane; a staleness
    storm beside a metric outage."""
    ref = ref_build(ref_scenario(name).compile(seed=2, n_trials=3,
                                               n_requests=200, **kw))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    _assert_summary_close(port, serial, f"{name}/{kw}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])
    if "hedge_factor" in kw:
        assert serial["n_hedged"] > 0


_CAP_PORT = CapacityConfig(decide_every_s=3.0)
_CAP_REF = RefCapacityConfig(decide_every_s=3.0)


@pytest.mark.parametrize("horizon,kw", [
    (40.0, dict(churn=(12.0, 5.0))),
    (40.0, dict(capacity=True)),
    (40.0, dict(capacity=True, preempt=(9.0, 6.0), churn=(9.0, 1.0))),
    (30.0, dict(capacity=True, preempt=(6.0, 30.0),
                outage_group=(3.0, 4.0, 2))),
    (2.0, dict(capacity=True, churn=(1.0, 1.0)))])
def test_membership_timeline_matches_reference(horizon, kw):
    """The heap order, same-instant ties (by push order) and the horizon
    cut, event for event."""
    port = membership_timeline(horizon, **{
        k: (_CAP_PORT if k == "capacity" else v) for k, v in kw.items()})
    ref = ref_timeline(horizon, **{
        k: (_CAP_REF if k == "capacity" else v) for k, v in kw.items()})
    assert [(e.t, e.seq, e.kind) for e in port] \
        == [(e.t, e.seq, e.kind) for e in ref]


def test_take_lowest_and_highest_match_brute_force():
    rng = np.random.default_rng(3)
    elig = rng.random((40, 9)) < 0.6
    k = rng.integers(0, 8, size=40)
    lo = take_lowest(torch.as_tensor(elig), torch.as_tensor(k)).numpy()
    hi = take_highest(torch.as_tensor(elig), torch.as_tensor(k)).numpy()
    for t in range(40):
        idx = np.flatnonzero(elig[t])
        want_lo = np.zeros(9, bool)
        want_lo[idx[:k[t]]] = True
        want_hi = np.zeros(9, bool)
        want_hi[idx[::-1][:k[t]]] = True
        np.testing.assert_array_equal(lo[t], want_lo)
        np.testing.assert_array_equal(hi[t], want_hi)
    np.testing.assert_array_equal(lo, ref_take_lowest(elig, k))
    np.testing.assert_array_equal(hi, ref_take_highest(elig, k))
    # over the (T, A, K) blocks the autoscaler applies them to
    blocks = torch.as_tensor(elig.reshape(40, 3, 3))
    kb = torch.as_tensor(rng.integers(0, 4, size=(40, 3)))
    for a in range(3):
        np.testing.assert_array_equal(
            take_highest(blocks, kb)[:, a].numpy(),
            ref_take_highest(blocks[:, a].numpy(), kb[:, a].numpy()))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,kw", [
    ("correlated-outage", dict(churn=(40.0, 25.0))),
    ("correlated-outage", dict(churn=(40.0, 10.0),
                               capacity=RefCapacityConfig(decide_every_s=5.0,
                                                          min_replicas=2))),
    ("baseline", dict(churn=(30.0, 20.0), resilience=RefResilienceConfig(
        outage_group=(30.0, 30.0, 3))))])
def test_group_outage_in_one_walk_with_churn(name, kw, policy):
    """The group outage's busy bump in the same membership walk as a
    churn event (and an autoscaler epoch at the same instant): the
    bumps land in heap order and the count carry resyncs once, after
    the walk; without client timeouts the plain step takes the bump."""
    ref = ref_build(ref_scenario(name).compile(seed=1, n_trials=3,
                                               n_requests=150, **kw))
    calls = segment_sum.plain_calls
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    _assert_summary_close(port, serial, f"{name}/{kw}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])
    steps = {ev.t for ev in ref_timeline(
        float(ref.req_t[-1]), churn=ref.cfg.churn,
        capacity=ref.cfg.capacity,
        outage_group=ref.cfg.resilience.outage_group)}
    assert ref.cfg.churn[0] in steps
    # perf_aware and the oracle keep a live count carry: one resync
    assert (segment_sum.plain_calls > calls) \
        == (policy in ("perf_aware", "oracle"))


#: capacity planes and a gray failure for the client plane to ride
_FIXED = RefCapacityConfig(autoscaler="fixed", min_replicas=6)
_FIXED_SHED = RefCapacityConfig(autoscaler="fixed", min_replicas=6,
                                admission_limit_s=25.0)
_STORM = RefResilienceConfig(timeout_s=25.0, max_retries=3,
                             backoff_base_s=0.5, breaker_threshold=3,
                             gray=(40.0, 60.0, 4.0))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,kw", [
    ("retry-storm", dict(closed_loop=True, online_warmup_s=20.0,
                         retrain_every_s=10.0, fallback_threshold=0.55)),
    ("retry-storm", dict(closed_loop=True, online_warmup_s=20.0,
                         retrain_every_s=10.0, capacity=_FIXED,
                         prediction_lag_s=5.0)),
    ("retry-storm", dict(prediction_lag_s=5.0, cold_start_s=30.0)),
    ("retry-storm", dict(resilience=_STORM, capacity=_FIXED_SHED,
                         t_drift=60.0, drift_tier_shuffle=True)),
    ("breaker-saves-retry-storm", dict(n_requests=200, arrival_rate=2.0,
                                       capacity=None))])
def test_client_plane_composes_with_every_plane(name, kw, policy):
    """The attempt loop under the closed loop (only completed requests
    train the fleet or fold into its accuracy), with a stale snapshot
    and cold start, under admission with breakers, gray failure and
    drift, and the breakers' storm at a heavier load without admission
    (every breaker of an app open: fail-fast requests)."""
    kw = dict(dict(n_trials=3, n_requests=150), **kw)
    ref = ref_build(ref_scenario(name).compile(seed=2, **kw))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    serial = _serial(ref, policy)
    assert serial["n_timeouts"] > 0
    _assert_summary_close(port, serial, f"{name}/{kw}/{policy}")
    np.testing.assert_array_equal(port["chosen"], serial["chosen"])
    if name == "breaker-saves-retry-storm":
        assert serial["n_fail_fast"] > 0
