"""The port's policy engine (``repro_torch.core.balancer``) against the JAX
package's (numpy, no jax), on the CPU.

Both sides get the same seeded (T, C) states, with and without
``active`` masks and with idle and busy replicas; scores must be equal
in float64 exactly, picks and the round-robin cursor over sequences of
picks, ``RandomChoice`` draw for draw (also with ``seed_blocks``),
``hedge_plan``'s ``(second, mask)``, ``choose`` and
``hedge_candidates``.  The reference's policy-engine tests
(``tests/test_policy_engine.py``) and its three policy properties
(``tests/test_policy_properties.py``) are replayed on the port.
"""
import inspect

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as hst
except ImportError:                                   # pragma: no cover
    from _hypothesis_shim import given, settings, strategies as hst

from repro.core import balancer as R
from repro_torch.core.balancer import (BUSY_PENALTY, POLICIES, ClusterState,
                                       LeastConnections, PerfAware, Replica,
                                       make_policy)
from repro_torch.core.simcore import run_sim_compiled
from repro_torch.core.simulator import SimConfig
from repro_torch.core.sweeps import scheduling_inefficiency

CPU = "cpu"
NAMES = sorted(POLICIES)
ELEMENTWISE = ("least_conn", "perf_aware", "oracle")


def _pol(name, **kw):
    return make_policy(name, device=CPU, **kw)


def _arrays(rng, T, C, now, active, idle_frac):
    """A seeded state: ``idle_frac`` of the replicas idle at ``now``."""
    busy = now + rng.uniform(0.01, 5.0, (T, C))
    idle = rng.random((T, C)) < idle_frac
    busy[idle] = now - rng.uniform(0.0, 5.0, int(idle.sum()))
    arr = dict(busy_until=busy,
               queue_depth=rng.integers(0, 4, (T, C)).astype(float),
               predicted=rng.uniform(1.0, 10.0, (T, C)),
               actual=rng.uniform(1.0, 10.0, (T, C)))
    if active:
        act = rng.random((T, C)) < 0.7
        act[np.arange(T), rng.integers(0, C, T)] = True   # one per trial
        arr["active"] = act
    return arr


def _states(arr, now):
    ref = R.ClusterState(now=now, **{k: v.copy() for k, v in arr.items()})
    port = ClusterState(now=now, **{k: torch.as_tensor(v)
                                    for k, v in arr.items()})
    return ref, port


def _cases():
    for T in (1, 4):
        for active in (False, True):
            for idle_frac in (0.0, 0.4, 1.0):
                yield T, active, idle_frac


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("T,active,idle_frac", list(_cases()))
def test_scores_and_picks_equal_reference(name, T, active, idle_frac):
    """50 picks on fresh random states: every score equal in f64, every
    pick and the round-robin cursor equal."""
    rng = np.random.default_rng(T * 100 + 10 * active + int(10 * idle_frac))
    ref, port = R.make_policy(name, seed=3), _pol(name, seed=3)
    C, now = 6, 10.0
    for _ in range(50):
        rs, ps = _states(_arrays(rng, T, C, now, active, idle_frac), now)
        got = port.score(ps)
        assert got.dtype == torch.float64 and got.device.type == CPU
        np.testing.assert_array_equal(got.numpy(), ref.score(rs))
        # the draws above advanced both generators; pick draws again
        np.testing.assert_array_equal(port.pick(ps).numpy(), ref.pick(rs))
        if name == "round_robin":
            np.testing.assert_array_equal(port._cursor.numpy(), ref._cursor)


def test_random_seed_blocks_draw_for_draw():
    blocks = [(5, 2), (9, 3), (11, 1)]
    ref = R.RandomChoice(seed=0, seed_blocks=blocks)
    port = make_policy("random", seed=0, seed_blocks=blocks, device=CPU)
    rng = np.random.default_rng(4)
    for _ in range(20):
        rs, ps = _states(_arrays(rng, 6, 5, 3.0, False, 0.6), 3.0)
        np.testing.assert_array_equal(port.score(ps).numpy(), ref.score(rs))
    rs, ps = _states(_arrays(rng, 5, 5, 3.0, False, 0.6), 3.0)
    with pytest.raises(ValueError):
        port.score(ps)


@pytest.mark.parametrize("hedge_factor", [0.5, 0.7, 1.0, 1.5])
@pytest.mark.parametrize("active", [False, True])
def test_hedge_plan_equal_reference(hedge_factor, active):
    rng = np.random.default_rng(int(hedge_factor * 10) + active)
    for name in ("perf_aware", "oracle"):
        ref = R.make_policy(name, hedge_factor=hedge_factor)
        port = _pol(name, hedge_factor=hedge_factor)
        for _ in range(30):
            rs, ps = _states(_arrays(rng, 5, 6, 10.0, active, 0.5), 10.0)
            picks = rng.integers(0, 6, 5)
            for scores in (None, "given"):
                rsc = None if scores is None else ref.score(rs)
                psc = None if scores is None else port.score(ps)
                want = ref.hedge_plan(rs, picks, rsc)
                got = port.hedge_plan(ps, torch.as_tensor(picks), psc)
                np.testing.assert_array_equal(got[0].numpy(), want[0])
                np.testing.assert_array_equal(got[1].numpy(), want[1])


def _random_cluster(rng, C=6, now=10.0):
    busy = now + rng.uniform(-5.0, 5.0, C)
    queue = rng.integers(0, 4, C).astype(float)
    pred = rng.uniform(1.0, 10.0, C)
    actual = rng.uniform(1.0, 10.0, C)
    replicas = [Replica(idx=i, app="a", node=f"n{i}", busy_until=busy[i],
                        queue_depth=queue[i]) for i in range(C)]
    state = ClusterState(now=now, busy_until=busy[None, :].copy(),
                         queue_depth=queue[None, :].copy(),
                         predicted=pred[None, :].copy(),
                         actual=actual[None, :].copy(), device=CPU)
    return replicas, state, pred, actual


@pytest.mark.parametrize("name", NAMES)
def test_choose_and_hedge_candidates_equal_reference(name):
    rng = np.random.default_rng(8)
    ref, port = R.make_policy(name, seed=2, hedge_factor=0.7), \
        _pol(name, seed=2, hedge_factor=0.7)
    for _ in range(30):
        replicas, _, pred, actual = _random_cluster(rng)
        ref_reps = [R.Replica(r.idx, r.app, r.node, r.busy_until,
                              r.queue_depth) for r in replicas]
        assert port.choose(replicas, 10.0, pred, actual) \
            == ref.choose(ref_reps, 10.0, pred, actual)
        if name == "perf_aware":
            assert port.hedge_candidates(replicas, 10.0, pred) \
                == ref.hedge_candidates(ref_reps, 10.0, pred)
    assert port.choose([], 0.0) is None


def test_registry_and_simcore_attributes():
    """``POLICIES`` maps names to classes with the reference's
    ``requires`` / ``scan_lowered``, which the simulation core reads."""
    assert sorted(POLICIES) == sorted(R.POLICIES)
    for name, cls in POLICIES.items():
        ref = R.POLICIES[name]
        assert cls.name == name
        assert cls.requires == ref.requires
        assert cls.scan_lowered == ref.scan_lowered
    assert BUSY_PENALTY == R.BUSY_PENALTY


# ---------------------------------------------------------------------------
# tests/test_policy_engine.py, replayed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_vector_and_scalar_paths_agree(name):
    rng = np.random.default_rng(42)
    vec = _pol(name, seed=7)
    scal = _pol(name, seed=7)
    for _ in range(25):
        replicas, state, pred, actual = _random_cluster(rng)
        a = int(vec.pick(state)[0])
        b = scal.choose(replicas, now=state.now, predicted=pred,
                        actual=actual)
        assert a == b, (name, a, b)


@pytest.mark.parametrize("name", [n for n in NAMES if n != "random"])
def test_vectorized_trials_match_independent_scalar_runs(name):
    rng = np.random.default_rng(3)
    T, C, now = 5, 4, 10.0
    busy = now + rng.uniform(-5.0, 5.0, (T, C))
    pred = rng.uniform(1.0, 10.0, (T, C))
    actual = rng.uniform(1.0, 10.0, (T, C))
    state = ClusterState(now=now, busy_until=busy.copy(),
                         predicted=pred.copy(), actual=actual.copy(),
                         device=CPU)
    picks = _pol(name, seed=0).pick(state)
    for t in range(T):
        one = ClusterState(now=now, busy_until=busy[t:t + 1].copy(),
                           predicted=pred[t:t + 1].copy(),
                           actual=actual[t:t + 1].copy(), device=CPU)
        assert int(_pol(name, seed=0).pick(one)[0]) == int(picks[t])


def test_no_policy_name_dispatch_chains():
    import repro_torch.core.simcore as core
    import repro_torch.serving.router as rt
    src = inspect.getsource(rt)
    assert "elif self.policy_name" not in src
    assert 'policy == "' not in src and 'policy_name == "' not in src
    # the core reads the registry's classes, never a name chain
    assert "POLICIES" in inspect.getsource(core)


def test_make_policy_unknown_name():
    with pytest.raises(KeyError):
        make_policy("weighted_magic")
    # the batched core names what it cannot run (the reference's serial
    # stepper raises KeyError through make_policy)
    with pytest.raises(NotImplementedError, match="unknown policy"):
        run_sim_compiled(SimConfig(n_trials=2, n_requests=5),
                         "weighted_magic", device=CPU)


def test_hedges_when_chosen_prediction_exceeds_factor():
    pol = PerfAware(hedge_factor=0.7, device=CPU)
    reps = [Replica(0, "a", "n0", busy_until=0.0),
            Replica(1, "a", "n1", busy_until=2.0)]
    assert pol.hedge_candidates(reps, 0.0, [5.0, 4.0]) == [0, 1]


def test_no_hedge_when_predictions_close():
    pol = PerfAware(hedge_factor=1.5, device=CPU)
    reps = [Replica(0, "a", "n0", busy_until=0.0),
            Replica(1, "a", "n1", busy_until=0.0),
            Replica(2, "a", "n2", busy_until=2.0)]
    assert pol.hedge_candidates(reps, 0.0, [2.0, 2.1, 1.0]) == [0]


def test_no_hedge_without_busy_reference():
    pol = PerfAware(hedge_factor=0.5, device=CPU)
    reps = [Replica(0, "a", "n0"), Replica(1, "a", "n1")]
    assert pol.hedge_candidates(reps, 0.0, [10.0, 12.0]) == [0]


def test_hedge_candidates_wraps_hedge_plan():
    pol = PerfAware(hedge_factor=0.7, device=CPU)
    rng = np.random.default_rng(5)
    for _ in range(30):
        replicas, state, pred, _ = _random_cluster(rng)
        scores = pol.score(state)
        picks = torch.argmin(scores, dim=1)
        second, mask = pol.hedge_plan(state, picks, scores)
        want = [int(picks[0]), int(second[0])] if mask[0] \
            else [int(picks[0])]
        assert pol.hedge_candidates(replicas, state.now, pred) == want


def test_hedge_plan_fires_on_forced_slow_pick():
    pol = PerfAware(hedge_factor=1.5, device=CPU)
    state = ClusterState(now=0.0, busy_until=np.array([[0.0, 0.0, 2.0]]),
                         predicted=np.array([[10.0, 12.0, 1.0]]), device=CPU)
    picks = torch.argmin(pol.score(state), dim=1)
    second, mask = pol.hedge_plan(state, picks)
    assert int(picks[0]) == 2 and not bool(mask[0])
    second, mask = pol.hedge_plan(state, torch.tensor([0]))
    assert bool(mask[0]) and int(second[0]) != 0


def test_oracle_refuses_to_run_on_predictions():
    state = ClusterState(now=0.0, busy_until=np.zeros((1, 2)),
                         predicted=np.ones((1, 2)), device=CPU)
    with pytest.raises(ValueError):
        _pol("oracle").pick(state)


def test_least_conn_router_semantics():
    pol = LeastConnections(device=CPU)
    state = ClusterState(now=0.0, busy_until=np.zeros((1, 3)),
                         queue_depth=np.array([[4.0, 1.0, 2.0]]), device=CPU)
    assert int(pol.pick(state)[0]) == 1


def test_state_without_card_raises(monkeypatch):
    """A state built from arrays goes to the CUDA card unless told."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterState(now=0.0, busy_until=np.zeros((1, 2)))


# ---------------------------------------------------------------------------
# tests/test_policy_properties.py, replayed
# ---------------------------------------------------------------------------
def _replicas(rng, C, now):
    return [Replica(idx=i, app="a", node=f"n{i}",
                    busy_until=now + float(rng.uniform(-6.0, 6.0)),
                    queue_depth=float(rng.integers(0, 4)))
            for i in range(C)]


@settings(max_examples=25, deadline=None)
@given(hst.integers(min_value=1, max_value=12),
       hst.integers(min_value=0, max_value=10_000),
       hst.floats(min_value=0.0, max_value=100.0))
def test_choose_returns_in_candidate_index(C, seed, now):
    rng = np.random.default_rng(seed)
    replicas = _replicas(rng, C, now)
    pred = rng.uniform(0.5, 20.0, C)
    actual = rng.uniform(0.5, 20.0, C)
    for name in NAMES:
        pick = _pol(name, seed=seed).choose(replicas, now, predicted=pred,
                                            actual=actual)
        assert pick is not None and 0 <= pick < C, (name, pick)
    assert _pol("perf_aware").choose([], now) is None


@settings(max_examples=25, deadline=None)
@given(hst.integers(min_value=2, max_value=10),
       hst.integers(min_value=3, max_value=16),
       hst.integers(min_value=0, max_value=10_000))
def test_score_permutation_equivariant(T, C, seed):
    rng = np.random.default_rng(seed)
    now = float(rng.uniform(0.0, 50.0))
    busy = now + rng.uniform(-5.0, 5.0, (T, C))
    queue = rng.integers(0, 5, (T, C)).astype(float)
    pred = rng.uniform(0.5, 20.0, (T, C))
    actual = rng.uniform(0.5, 20.0, (T, C))
    perm = rng.permutation(C)
    state = ClusterState(now=now, busy_until=busy, queue_depth=queue,
                         predicted=pred, actual=actual, device=CPU)
    permuted = ClusterState(now=now, busy_until=busy[:, perm],
                            queue_depth=queue[:, perm],
                            predicted=pred[:, perm],
                            actual=actual[:, perm], device=CPU)
    for name in ELEMENTWISE:
        pol = _pol(name, seed=seed)
        np.testing.assert_array_equal(pol.score(state)[:, perm].numpy(),
                                      pol.score(permuted).numpy(),
                                      err_msg=name)


def test_perf_aware_converges_to_oracle_as_accuracy_to_one():
    base = SimConfig(n_trials=12, n_requests=100, seed=3)
    perfect = run_sim_compiled(SimConfig(**{**base.__dict__,
                                            "accuracy": 1.0}),
                               "perf_aware", device=CPU)
    oracle = run_sim_compiled(SimConfig(**{**base.__dict__,
                                           "accuracy": 1.0}),
                              "oracle", device=CPU)
    np.testing.assert_array_equal(perfect["chosen"], oracle["chosen"])
    np.testing.assert_allclose(perfect["mean_rtt"], oracle["mean_rtt"],
                               rtol=1e-12)
    ineffs = [scheduling_inefficiency(
        SimConfig(**{**base.__dict__, "accuracy": p}),
        "perf_aware", device=CPU)["inefficiency_pct"] for p in (0.0, 0.5, 1.0)]
    assert ineffs[2] <= 1e-9, ineffs
    assert ineffs[2] <= ineffs[1] <= ineffs[0], ineffs
