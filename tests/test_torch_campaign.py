"""The port's campaign runner against the JAX package's serial campaign.

``repro_torch.core.campaign.run_scenario(device="cpu")`` builds its own
clusters (bit-identical to the reference's) and steps each policy over
the stacked seed grid; ``repro.core.campaign.run_scenario(backend=
"serial")`` steps the same grid through the serial stepper.  Per-seed
stats and oracle-relative inefficiency must agree within 1e-5, and the
scenarios that rebuild counts from scratch must have gone through the
segment sum (its plain version, on the CPU).
"""
import numpy as np
import pytest

from repro.core.campaign import run_scenario as ref_run_scenario
from repro_torch.core.campaign import (RESILIENCE_STATS, SUMMARY_STATS,
                                       compiled_coverage, run_scenario)
from repro_torch.kernels.segment_sum import segment_sum

KW = dict(seeds=(0, 1), n_trials=4, n_requests=120)
RTOL = 1e-5


@pytest.mark.parametrize("name", ("stale-predictions", "churn",
                                  "metric-outage", "baseline"))
def test_campaign_matches_serial(name):
    calls = segment_sum.plain_calls
    port = run_scenario(name, device="cpu", **KW)
    recounts = segment_sum.plain_calls - calls
    serial = ref_run_scenario(name, backend="serial", **KW)
    assert set(port) == set(serial)
    for pol, want in serial.items():
        got = port[pol]
        for k in SUMMARY_STATS + ("hedged",):
            np.testing.assert_allclose(got.per_seed[k], want.per_seed[k],
                                       rtol=RTOL, atol=1e-7,
                                       err_msg=f"{name}/{pol}/{k}")
        assert got.n_hedged == want.n_hedged
        if want.inefficiency_pct is not None:
            for attr in ("inefficiency_pct", "inefficiency_std",
                         "p99_inefficiency_pct", "resource_waste_pct"):
                np.testing.assert_allclose(getattr(got, attr),
                                           getattr(want, attr),
                                           rtol=RTOL, atol=1e-7,
                                           err_msg=f"{name}/{pol}/{attr}")
        assert got.wall_s > 0 and got.loop_s > 0
    if name == "baseline":
        assert recounts == 0     # no churn, no snapshot: no rebuild
    else:
        assert recounts > 0


@pytest.mark.parametrize("name,kw", [
    ("cold-start", KW), ("mixed-app-fleet", KW),
    ("drift-fallback", dict(KW, arrival_rate=2.0, t_drift=20.0,
                            online_warmup_s=8.0, retrain_every_s=6.0)),
    ("colocation-drift", dict(KW, arrival_rate=2.0, t_drift=20.0,
                              online_warmup_s=8.0, retrain_every_s=6.0))])
def test_campaign_matches_serial_on_new_scenarios(name, kw):
    """The stacked seed grid through the closed loop and the drift
    switch equals the serial campaign; the per-seed fallback counts
    equal the serial stepper's on each seed's own cluster."""
    port = run_scenario(name, device="cpu", **kw)
    serial = ref_run_scenario(name, backend="serial", **kw)
    for pol, want in serial.items():
        got = port[pol]
        for k in SUMMARY_STATS + ("hedged",):
            np.testing.assert_allclose(got.per_seed[k], want.per_seed[k],
                                       rtol=RTOL, atol=1e-7,
                                       err_msg=f"{name}/{pol}/{k}")
        if want.inefficiency_pct is not None:
            np.testing.assert_allclose(got.inefficiency_pct,
                                       want.inefficiency_pct, rtol=RTOL,
                                       atol=1e-7)
    fb = port["perf_aware"].per_seed["fallback"]
    assert port["perf_aware"].n_fallback == fb.sum()
    seeds = kw["seeds"]
    want_fb = [_serial_fallback(name, s, kw) for s in seeds]
    np.testing.assert_array_equal(fb, want_fb)
    if name == "drift-fallback":
        assert fb.sum() > 0


def _serial_fallback(name, seed, kw):
    from repro.core.balancer import make_policy
    from repro.core.rng import rng_seed
    from repro.core.scenarios import get_scenario as ref_scenario
    from repro.core.simulator import SimStepper, _build_cluster
    over = {k: v for k, v in kw.items() if k != "seeds"}
    cfg = ref_scenario(name).compile(seed=seed, **over)
    pol = make_policy("perf_aware", seed=rng_seed(seed, "policy"),
                      hedge_factor=cfg.hedge_factor)
    return SimStepper(_build_cluster(cfg), pol).run()["n_fallback"]


@pytest.mark.parametrize("name", ("overload-ramp", "flash-crowd-autoscale",
                                  "scale-to-zero-idle", "spot-preemption",
                                  "gray-failure", "staleness-storm"))
def test_campaign_matches_serial_on_capacity_and_fault_scenarios(name):
    """The stacked seed grid shares one membership timeline (one arrival
    stream): the elastic replica set, admission, gray failure and the
    staleness storm per seed equal the serial campaign's, waste and shed
    included."""
    calls = segment_sum.plain_calls
    port = run_scenario(name, device="cpu", **KW)
    recounts = segment_sum.plain_calls - calls
    serial = ref_run_scenario(name, backend="serial", **KW)
    for pol, want in serial.items():
        got = port[pol]
        for k in SUMMARY_STATS + ("hedged",):
            np.testing.assert_allclose(got.per_seed[k], want.per_seed[k],
                                       rtol=RTOL, atol=1e-7,
                                       err_msg=f"{name}/{pol}/{k}")
        if want.inefficiency_pct is not None:
            np.testing.assert_allclose(got.inefficiency_pct,
                                       want.inefficiency_pct, rtol=RTOL,
                                       atol=1e-7)
    if name in ("overload-ramp", "flash-crowd-autoscale",
                "scale-to-zero-idle", "spot-preemption"):
        waste = port["perf_aware"].per_seed["waste"]
        assert ((waste > 0) & (waste < 1)).all()
    # the storm's snapshot refreshes rebuild perf_aware's counts
    assert (recounts > 0) == (name == "staleness-storm")


def test_campaign_refuses_unlowered_scenario():
    """A retry-storm-like spec built field by field (timeouts and
    retries, no breaker) once refused by name: it now runs, and equals
    the serial campaign on the same spec."""
    from repro.core.resilience import ResilienceConfig as RefResilience
    from repro.core.scenarios import ScenarioSpec as RefSpec
    from repro.core.scenarios import get_scenario as ref_scenario
    from repro_torch.core.resilience import ResilienceConfig
    from repro_torch.core.scenarios import ScenarioSpec
    ref = ref_scenario("retry-storm")
    knobs = dict(timeout_s=ref.resilience.timeout_s,
                 max_retries=ref.resilience.max_retries)
    common = dict(name=ref.name, arrival_process=ref.arrival_process,
                  arrival_params=ref.arrival_params)
    port = run_scenario(ScenarioSpec(
        **common, resilience=ResilienceConfig(**knobs)), device="cpu", **KW)
    serial = ref_run_scenario(RefSpec(
        **common, resilience=RefResilience(**knobs)), backend="serial", **KW)
    for pol, want in serial.items():
        for k in SUMMARY_STATS:
            np.testing.assert_allclose(port[pol].per_seed[k],
                                       want.per_seed[k], rtol=RTOL,
                                       atol=1e-7, err_msg=f"{pol}/{k}")


def _serial_seed(name, seed, policy, kw):
    """The serial stepper's summary on one seed's own cluster."""
    from repro.core.balancer import make_policy
    from repro.core.rng import rng_seed
    from repro.core.scenarios import get_scenario as ref_scenario
    from repro.core.simulator import SimStepper, _build_cluster
    over = {k: v for k, v in kw.items() if k != "seeds"}
    cfg = ref_scenario(name).compile(seed=seed, **over)
    pol = make_policy(policy, seed=rng_seed(seed, "policy"),
                      hedge_factor=cfg.hedge_factor)
    stepper = SimStepper(_build_cluster(cfg), pol)
    out = stepper.run()
    # the breakers' trip events, which the summary does not carry
    out["breaker_trips"] = 0 if stepper.breaker is None \
        else stepper.breaker.trips
    return out


@pytest.mark.parametrize("name", ("correlated-outage", "retry-storm",
                                  "breaker-saves-retry-storm"))
def test_campaign_matches_serial_on_client_scenarios(name):
    """The stacked seed grid through the attempt loop equals the serial
    campaign, and each seed's timed-out requests, breaker trips,
    client-timeout and fail-fast rates, attempts and wasted work equal the serial stepper's
    on that seed's own cluster; the correlated outage's resync runs the
    segment sum."""
    kw = dict(KW, n_requests=150)
    calls = segment_sum.plain_calls
    port = run_scenario(name, device="cpu", **kw)
    recounts = segment_sum.plain_calls - calls
    serial = ref_run_scenario(name, backend="serial", **kw)
    for pol, want in serial.items():
        got = port[pol]
        for k in SUMMARY_STATS + ("hedged",):
            np.testing.assert_allclose(got.per_seed[k], want.per_seed[k],
                                       rtol=RTOL, atol=1e-7,
                                       err_msg=f"{name}/{pol}/{k}")
        if want.inefficiency_pct is not None:
            np.testing.assert_allclose(got.inefficiency_pct,
                                       want.inefficiency_pct, rtol=RTOL,
                                       atol=1e-7)
        per_seed = [_serial_seed(name, s, pol, kw) for s in kw["seeds"]]
        np.testing.assert_array_equal(
            got.per_seed["timeouts"], [o["n_timeouts"] for o in per_seed])
        np.testing.assert_array_equal(
            got.per_seed["trips"], [o["breaker_trips"] for o in per_seed])
        for k in RESILIENCE_STATS:
            np.testing.assert_allclose(
                got.per_seed[k], [o[k].mean() for o in per_seed],
                rtol=RTOL, atol=1e-7, err_msg=f"{name}/{pol}/{k}")
    assert port["least_conn"].per_seed["timeouts"].sum() > 0
    # perf_aware's and the oracle's live carries resync after the bump
    assert (recounts > 0) == (name == "correlated-outage")


def test_compiled_coverage_is_complete():
    """The port runs every registered scenario under every policy."""
    assert compiled_coverage() == []
    assert compiled_coverage(("perf_aware", "no_such_policy"))[0][1] \
        == "no_such_policy"


# ----------------------------------------------------------------------
# the campaign's outer surface: run_campaign, campaign_table, the phase
# timer and the tail attribution
CAMPAIGN = ("baseline", "stale-predictions", "overload-ramp")
CAMPAIGN_KW = dict(seeds=(0, 1, 2), n_trials=3, n_requests=100)


@pytest.fixture(scope="module")
def campaigns():
    from repro.core.campaign import run_campaign as ref_run_campaign
    from repro_torch.core.campaign import run_campaign
    port = run_campaign(CAMPAIGN, device="cpu", **CAMPAIGN_KW)
    serial = ref_run_campaign(CAMPAIGN, backend="serial", **CAMPAIGN_KW)
    return port, serial


def test_run_campaign_matches_serial(campaigns):
    """Every field the reference's PolicyResult has agrees to 1e-5."""
    from dataclasses import fields

    from repro.core.campaign import PolicyResult as RefResult
    port, serial = campaigns
    assert list(port) == list(serial) == list(CAMPAIGN)
    for scen, cell in serial.items():
        assert list(port[scen]) == list(cell)
        for pol, want in cell.items():
            got = port[scen][pol]
            for f in fields(RefResult):
                a, b = getattr(got, f.name), getattr(want, f.name)
                what = f"{scen}/{pol}/{f.name}"
                if f.name == "per_seed":
                    for k, v in b.items():
                        np.testing.assert_allclose(a[k], v, rtol=RTOL,
                                                   atol=1e-7, err_msg=k)
                elif f.name == "telemetry":
                    assert (a is None) == (b is None), what
                    for k, v in (b or {}).items():
                        np.testing.assert_allclose(
                            np.asarray(a[k], float), np.asarray(v, float),
                            rtol=RTOL, atol=1e-7, err_msg=f"{what}/{k}")
                elif isinstance(b, float):
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7,
                                               err_msg=what)
                else:
                    assert a == b, what
    assert port["overload-ramp"]["perf_aware"].telemetry is not None


@pytest.mark.parametrize("markdown", [False, True])
def test_campaign_table_renders_the_same_string(campaigns, markdown):
    from repro.core.campaign import campaign_table as ref_table
    from repro_torch.core.campaign import campaign_table
    port, serial = campaigns
    got = campaign_table(port, markdown=markdown)
    assert got == ref_table(serial, markdown=markdown)
    assert len(got.splitlines()) == 1 + markdown + 3 * 4


def test_last_phases_has_the_reference_keys():
    from repro.core.campaign import LAST_PHASES as REF_PHASES
    from repro_torch.core.campaign import LAST_PHASES
    kw = dict(seeds=(0,), n_trials=2, n_requests=40)
    run_scenario("baseline", policies=("perf_aware", "random"),
                 device="cpu", **kw)
    ref_run_scenario("baseline", policies=("perf_aware", "random"),
                     backend="serial", **kw)
    assert list(LAST_PHASES) == list(REF_PHASES) == [
        "build", "run:oracle", "run:perf_aware", "run:random"]
    assert all(v > 0 for v in LAST_PHASES.values())


def test_phases_are_profiler_ranges():
    import torch

    from repro_torch.core.telemetry import PhaseTimer
    timer = PhaseTimer()
    with torch.profiler.profile() as prof:
        with timer.phase("run:x"):
            torch.ones(4).sum()
        with timer.phase("run:x"):
            pass
    assert "run:x" in {e.key for e in prof.key_averages()}
    assert list(timer.summary()) == ["run:x"] and timer.wall["run:x"] > 0


@pytest.mark.parametrize("name,kw", [
    ("baseline", dict(hedge_factor=0.7)),
    ("retry-storm", {}), ("overload-ramp", {})])
def test_tail_attribution_matches_serial(name, kw):
    """Over a traced port run and the serial stepper's trace of the same
    config: counts exactly, means and shares to 1e-5."""
    from repro.core.balancer import make_policy
    from repro.core.rng import rng_seed
    from repro.core.scenarios import get_scenario as ref_scenario
    from repro.core.simulator import SimStepper, _build_cluster
    from repro.core.telemetry import TraceConfig as RefTrace
    from repro.core.telemetry import tail_attribution as ref_tail
    from repro_torch.core.simcore import run_sim_compiled
    from repro_torch.core.telemetry import tail_attribution
    from repro_torch.interop import config_from_reference
    cfg = ref_scenario(name).compile(seed=1, n_trials=4, n_requests=150,
                                     trace=RefTrace(sample_every=1), **kw)
    pol = make_policy("perf_aware", seed=rng_seed(cfg.seed, "policy"),
                      hedge_factor=cfg.hedge_factor)
    want = ref_tail(SimStepper(_build_cluster(cfg), pol).run()["trace"],
                    quantiles=(0.5, 0.99, 0.999))
    got = tail_attribution(
        run_sim_compiled(config_from_reference(cfg), "perf_aware",
                         device="cpu")["trace"],
        quantiles=(0.5, 0.99, 0.999))
    assert list(got) == list(want)
    for key in ("n_rows", "n_served", "dispositions"):
        assert got[key] == want[key], key
    for q in ("p50", "p99", "p99_9"):
        g, w = got[q], want[q]
        assert g["n_tail"] == w["n_tail"], q
        for k in ("cut_s", "mean_response_s"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL)
        for comp, v in w["components"].items():
            for k in ("mean_s", "share"):
                np.testing.assert_allclose(g["components"][comp][k], v[k],
                                           rtol=RTOL, atol=1e-9,
                                           err_msg=f"{q}/{comp}/{k}")
    if name == "retry-storm":
        assert got["dispositions"]["client_timeout"] > 0
    if name == "baseline":
        assert any(want[q]["components"]["hedge_s"]["mean_s"] > 0
                   for q in ("p50", "p99", "p99_9"))


def test_entry_points_refuse_to_move_to_the_cpu():
    """device=None means the CUDA card: without one every entry point
    raises instead of running on the CPU."""
    import torch

    from repro_torch.core import sweeps
    from repro_torch.core.campaign import run_campaign
    from repro_torch.core.prediction_plane import PredictionPlane
    from repro_torch.core.simulator import SimConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    cfg = SimConfig(n_trials=2, n_requests=20)
    calls = [
        lambda: run_scenario("baseline", seeds=(0,), n_trials=2,
                             n_requests=20),
        lambda: run_campaign(("baseline",), seeds=(0,), n_trials=2,
                             n_requests=20),
        lambda: sweeps.scheduling_inefficiency(cfg, "perf_aware"),
        lambda: sweeps.sweep_accuracy(cfg, [0.5]),
        lambda: sweeps.sweep_replicas(cfg, [2]),
        lambda: sweeps.sweep_heterogeneity(cfg, [0.3]),
        lambda: PredictionPlane(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
