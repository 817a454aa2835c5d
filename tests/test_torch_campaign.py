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
from repro_torch.core.campaign import SUMMARY_STATS, run_scenario
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


def test_campaign_refuses_unlowered_scenario():
    from repro.core.scenarios import get_scenario as ref_scenario
    from repro_torch.core.scenarios import ScenarioSpec
    ref = ref_scenario("overload-ramp")
    spec = ScenarioSpec(name=ref.name, capacity=ref.capacity,
                        arrival_process=ref.arrival_process,
                        arrival_params=ref.arrival_params)
    with pytest.raises(NotImplementedError, match="capacity plane"):
        run_scenario(spec, device="cpu", **KW)
