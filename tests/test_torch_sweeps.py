"""The port's Fig. 11 sweeps against the JAX package's.

``repro_torch.core.sweeps`` runs each point through the batched core
(``device="cpu"``); ``repro.core.simulator``'s sweeps run the serial
stepper on the same ``SimConfig`` (carried across by
``config_from_reference``).  At ``SimConfig(n_trials=8, n_requests=60)``
every returned percentage agrees to rtol 1e-5 and atol 1e-4 percentage
points, at the sweeps' ends too: accuracy 0 and 1 (the ends of Eq. 12's
draw), one replica per app (a single candidate) and heterogeneity 0
(equal nodes, ties broken by argmin order).
"""
from dataclasses import replace

import numpy as np
import pytest

from repro.core import simulator as ref
from repro_torch.core import sweeps
from repro_torch.interop import config_from_reference

BASE = ref.SimConfig(n_trials=8, n_requests=60)
POLICIES = ("perf_aware", "least_conn", "round_robin", "random")
KEYS = ("inefficiency_pct", "inefficiency_std", "p99_inefficiency_pct",
        "resource_waste_pct")


def assert_same(got, want, what):
    assert set(got) == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4,
                                   err_msg=f"{what}/{k}")


def assert_same_series(got, want, what):
    assert [x for x, _ in got] == [x for x, _ in want]
    for (x, g), (_, w) in zip(got, want):
        assert_same(g, w, f"{what}@{x}")


@pytest.mark.parametrize("policy", POLICIES + ("oracle",))
def test_scheduling_inefficiency_matches_reference(policy):
    cfg = replace(BASE, seed=3)
    got = sweeps.scheduling_inefficiency(config_from_reference(cfg), policy,
                                         device="cpu")
    assert_same(got, ref.scheduling_inefficiency(cfg, policy), policy)
    if policy == "oracle":
        assert all(v == 0.0 for v in got.values())


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_sweep_accuracy_matches_reference(p):
    got = sweeps.sweep_accuracy(config_from_reference(BASE), [p],
                                device="cpu")
    assert_same_series(got, ref.sweep_accuracy(BASE, [p]), "accuracy")
    if p == 0.0:       # random predictions lose against the oracle
        assert got[0][1]["inefficiency_pct"] > 1.0


@pytest.mark.parametrize("count", [1, 2, 4])
def test_sweep_replicas_matches_reference(count):
    got = sweeps.sweep_replicas(config_from_reference(BASE), [count],
                                device="cpu")
    want = ref.sweep_replicas(BASE, [count])
    assert list(got) == list(want) == list(POLICIES)
    for pol in POLICIES:
        assert_same_series(got[pol], want[pol], f"replicas/{pol}")


@pytest.mark.parametrize("h", [0.0, 0.5])
def test_sweep_heterogeneity_matches_reference(h):
    got = sweeps.sweep_heterogeneity(config_from_reference(BASE), [h],
                                     device="cpu")
    want = ref.sweep_heterogeneity(BASE, [h])
    assert list(got) == list(want) == list(POLICIES)
    for pol in POLICIES:
        assert_same_series(got[pol], want[pol], f"heterogeneity/{pol}")


def test_sweeps_keep_the_reference_defaults():
    import inspect
    for name in ("sweep_accuracy", "sweep_replicas", "sweep_heterogeneity"):
        want = inspect.signature(getattr(ref, name)).parameters
        got = inspect.signature(getattr(sweeps, name)).parameters
        assert list(got)[:len(want)] == list(want)
        for k, p in want.items():
            np.testing.assert_array_equal(got[k].default, p.default,
                                          err_msg=f"{name}/{k}")


def test_one_replica_per_app_has_no_inefficiency():
    """K = 1: every policy has one candidate, the oracle's, so every
    percentage is exactly 0."""
    cfg = config_from_reference(replace(BASE, n_replicas_per_app=1))
    out = sweeps.sweep_replicas(cfg, [1], device="cpu")
    for pol in POLICIES:
        (count, res), = out[pol]
        assert count == 1
        assert all(v == 0.0 for v in res.values()), (pol, res)
