"""The port's flight recorder and client-side resilience against the JAX
package: the trace schema helpers, the breakers and the backoff rule,
the traced core against the reference's serial stepper, and the serving
router's telemetry (the counter / gauge / histogram registry scraped
into a ``MetricsStore``).

Both sides run one and the same cluster (the reference draws it,
``repro_torch.interop.cluster_from_reference`` carries it across); the
port runs with ``device="cpu"``.  Trace rows agree to 1e-5 relative
(atol 1e-7) with equal NaN masks, and on both sides the decomposition
sums to the response within 1e-6.
"""
import numpy as np
import pytest
import torch

from repro.core.balancer import make_policy
from repro.core.resilience import BreakerBoard
from repro.core.resilience import ResilienceConfig as RefResilienceConfig
from repro.core.resilience import backoff_delay as ref_backoff_delay
from repro.core.rng import rng_seed
from repro.core.scenarios import get_scenario as ref_scenario
from repro.core.scenarios import scenario_names as ref_scenario_names
from repro.core.simulator import SimStepper
from repro.core.simulator import _build_cluster as ref_build
from repro.core import telemetry as RT
from repro.core.telemetry import TraceConfig as RefTraceConfig
from repro.testing import make_store as ref_make_store
from repro.core.telemetry import compose_row as ref_compose_row
from repro.core.telemetry import trace_block as ref_trace_block
from repro_torch.core import simcore
from repro_torch.core.resilience import Breakers, ResilienceConfig, \
    backoff_delay
from repro_torch.core.telemetry import (COMPONENTS, DISP_FAIL_FAST,
                                        DISP_SERVED, DISP_SHED, DISP_TIMEOUT,
                                        TRACE_FIELDS, TRACE_IDX,
                                        Histogram,
                                        MetricsRegistry, TraceConfig,
                                        compose_row, trace_block, trace_row)
from repro_torch.interop import cluster_from_reference, config_from_reference
from repro_torch.testing import make_store

SMALL = dict(n_trials=4, n_requests=50)
RTOL = 1e-5


def _signed_sum(data):
    return sum(data[..., TRACE_IDX[c]] for c in COMPONENTS
               if c != "hedge_s") - data[..., TRACE_IDX["hedge_s"]]


def _sum_rule_err(data):
    served = data[..., TRACE_IDX["disposition"]] == DISP_SERVED
    err = np.abs(_signed_sum(data)
                 - data[..., TRACE_IDX["response"]])[served]
    return float(err.max()) if err.size else 0.0


def _traced_pair(name, k, policy, **kw):
    """(port summary, serial summary) of one traced run on one cluster."""
    ref = ref_build(ref_scenario(name).compile(
        seed=0, trace=RefTraceConfig(sample_every=k), **{**SMALL, **kw}))
    port = simcore.run_compiled(cluster_from_reference(ref), policy,
                                device="cpu")
    pol = make_policy(policy, seed=rng_seed(0, "policy"),
                      hedge_factor=ref.cfg.hedge_factor)
    return port, SimStepper(ref, pol).run()


def _assert_trace_equal(got, want, label):
    assert got["fields"] == want["fields"] == list(TRACE_FIELDS)
    assert got["sample_every"] == want["sample_every"]
    np.testing.assert_array_equal(got["requests"], want["requests"])
    a, b = got["data"], want["data"]
    assert a.shape == b.shape, label
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=label)
    both = np.isnan(a) & np.isnan(b)
    np.testing.assert_allclose(np.where(both, 0.0, a),
                               np.where(both, 0.0, b), rtol=RTOL, atol=1e-7,
                               err_msg=label)
    assert _sum_rule_err(a) < 1e-6, f"{label}/port"
    assert _sum_rule_err(b) < 1e-6, f"{label}/serial"


# ----------------------------------------------------------------------
# the schema helpers
def test_schema_is_the_references():
    from repro.core import telemetry as ref
    from repro_torch.core import telemetry as port
    for name in ("TRACE_FIELDS", "TRACE_IDX", "COMPONENTS", "DISP_SERVED",
                 "DISP_SHED", "DISP_TIMEOUT", "DISP_FAIL_FAST",
                 "DISPOSITIONS"):
        assert getattr(port, name) == getattr(ref, name), name
    assert TraceConfig().sample_every == RefTraceConfig().sample_every == 16


def _random_row_inputs(rng, T):
    disp = rng.choice([DISP_SERVED, DISP_SHED, DISP_TIMEOUT,
                       DISP_FAIL_FAST], size=T)
    return dict(
        rep=rng.integers(0, 30, size=T).astype(float),
        predicted=rng.random(T) * 10, score=rng.random(T) * 20,
        queue_wait=rng.random(T) * 3, raw=rng.random(T) * 8 + 1,
        base=rng.random(T) + 0.5, cold_mult=rng.choice([1.0, 2.0], size=T),
        gray_mult=rng.choice([1.0, 4.0], size=T), retry_s=rng.random(T),
        hedge_s=rng.random(T) * 0.5, disposition=disp,
        response=rng.random(T) * 30)


@pytest.mark.parametrize("seed", range(3))
def test_compose_row_and_trace_row_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = _random_row_inputs(rng, 40)
    want = ref_compose_row(**kw)
    np.testing.assert_array_equal(compose_row(**kw), want)
    got = trace_row(**{k: torch.as_tensor(v) for k, v in kw.items()})
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    # scalars broadcast as in compose_row
    mixed = dict(kw, cold_mult=1.0, gray_mult=1.0, retry_s=0.0,
                 hedge_s=0.0, predicted=float("nan"))
    got = trace_row(**{k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                       else v for k, v in mixed.items()})
    np.testing.assert_array_equal(got.numpy(), ref_compose_row(**mixed))


def test_trace_block_matches_the_reference():
    data = np.random.default_rng(0).random((4, 3, len(TRACE_FIELDS)))
    got, want = trace_block(data, 50, 16), ref_trace_block(data, 50, 16)
    assert got["fields"] == want["fields"]
    assert got["sample_every"] == want["sample_every"] == 16
    np.testing.assert_array_equal(got["requests"], want["requests"])
    np.testing.assert_array_equal(got["data"], want["data"])


# ----------------------------------------------------------------------
# breakers and backoff
@pytest.mark.parametrize("seed", range(6))
def test_breakers_match_breaker_board(seed):
    """Random states (closed, open and half-open breakers, counts below
    and at the threshold) under random attempts, half-open re-trips
    included: open masks, counts, trips and open times equal."""
    rng = np.random.default_rng(seed)
    T, R, thr = 7, 9, 3
    board = BreakerBoard(R, thr, 10.0, 25.0, n_trials=T)
    port = Breakers(T, R, thr, 10.0, 25.0, device="cpu")
    board.fail = rng.integers(0, thr + 1, size=(T, R))
    board.tripped = rng.random((T, R)) < 0.4
    board.open_until = rng.random((T, R)) * 60.0
    # copies: the board updates its arrays in place
    port.fail = torch.tensor(board.fail, dtype=torch.int32)
    port.tripped = torch.tensor(board.tripped)
    port.open_until = torch.tensor(board.open_until)
    half = 0
    for _ in range(25):
        t = rng.random(T) * 60.0
        np.testing.assert_array_equal(
            port.open_mask(torch.as_tensor(t)).numpy(), board.open_mask(t))
        np.testing.assert_array_equal(
            port.open_mask(torch.as_tensor(t), slice(3, 6)).numpy(),
            board.open_mask(t)[:, 3:6])
        picks = rng.integers(0, R, size=T)
        sent = rng.random(T) < 0.8
        ok = sent & (rng.random(T) < 0.4)
        tmo = sent & ~ok
        half += int((board.tripped[np.arange(T), picks]
                     & (t >= board.open_until[np.arange(T), picks])
                     & tmo).sum())
        board.record(t, picks, ok, tmo)
        port.record(torch.as_tensor(t), torch.as_tensor(picks),
                    torch.as_tensor(ok), torch.as_tensor(tmo))
        np.testing.assert_array_equal(port.fail.numpy(), board.fail)
        np.testing.assert_array_equal(port.tripped.numpy(), board.tripped)
        np.testing.assert_array_equal(port.open_until.numpy(),
                                      board.open_until)
        assert int(port.trips) == board.trips
    assert half > 0                     # a half-open probe re-tripped


def test_breaker_full_cycle():
    """Closed -> open at the threshold -> half-open after the cooldown
    -> re-trip on a failed probe -> closed on a successful one."""
    br = Breakers(1, 2, 2, 10.0, 5.0, device="cpu")
    one = torch.tensor([0])
    yes, no = torch.tensor([True]), torch.tensor([False])

    def at(t):
        return torch.tensor([float(t)])
    br.record(at(0.0), one, no, yes)
    assert not br.open_mask(at(1.0))[0, 0]
    br.record(at(1.0), one, no, yes)                 # trips: 1 + 5 + 10
    assert br.open_mask(at(15.9))[0, 0] and not br.open_mask(at(16.0))[0, 0]
    br.record(at(16.0), one, no, yes)                # half-open probe fails
    assert br.open_mask(at(30.9))[0, 0] and not br.open_mask(at(31.0))[0, 0]
    assert int(br.trips) == 2
    br.record(at(40.0), one, yes, no)                # probe succeeds
    assert not br.tripped[0, 0] and br.fail[0, 0] == 0


@pytest.mark.parametrize("attempt", range(4))
def test_backoff_delay_matches_the_reference(attempt):
    u = np.random.default_rng(attempt).random(64)
    kw = dict(timeout_s=25.0, max_retries=3, backoff_base_s=0.5,
              backoff_mult=2.0, backoff_jitter=0.5)
    want = ref_backoff_delay(RefResilienceConfig(**kw), attempt, u)
    got = backoff_delay(ResilienceConfig(**kw), attempt, torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0.5 * 2.0 ** attempt).all()


# ----------------------------------------------------------------------
# the traced core against the serial stepper
@pytest.mark.parametrize("k", (1, 16))
@pytest.mark.parametrize("name", ref_scenario_names())
def test_trace_parity_per_scenario(name, k):
    port, serial = _traced_pair(name, k, "perf_aware")
    _assert_trace_equal(port["trace"], serial["trace"], f"{name}/k={k}")
    assert port["n_timeouts"] == serial["n_timeouts"]


@pytest.mark.parametrize("k", (1, 16))
@pytest.mark.parametrize("policy", ("least_conn", "round_robin", "random",
                                    "oracle"))
def test_trace_parity_other_policies(policy, k):
    port, serial = _traced_pair("baseline", k, policy)
    _assert_trace_equal(port["trace"], serial["trace"], f"{policy}/k={k}")


@pytest.mark.parametrize("policy", ("perf_aware", "oracle", "least_conn"))
@pytest.mark.parametrize("name,kw", [
    ("retry-storm", dict(n_requests=120)),
    ("breaker-saves-retry-storm", dict(n_requests=120)),
    ("churn", dict(hedge_factor=0.5, arrival_rate=8.0)),
    ("overload-ramp", dict(n_requests=120, closed_loop=True,
                           online_warmup_s=20.0, retrain_every_s=10.0,
                           fallback_threshold=0.55))])
def test_trace_parity_on_every_step_path(name, kw, policy):
    """Full tracing through the client step (timeouts and fail-fast
    rows), the hedged step and the closed loop under a capacity plane
    (shed rows, cold multipliers)."""
    port, serial = _traced_pair(name, 1, policy, **kw)
    _assert_trace_equal(port["trace"], serial["trace"], f"{name}/{policy}")
    disp = serial["trace"]["data"][..., TRACE_IDX["disposition"]]
    if name == "retry-storm":
        assert (disp == DISP_TIMEOUT).sum() == serial["n_client_timeout"] > 0
    if name == "churn" and policy != "least_conn":
        assert serial["n_hedged"] > 0
    if name == "churn" and policy == "perf_aware":
        # a duplicate that finished first saved time
        hedge = serial["trace"]["data"][..., TRACE_IDX["hedge_s"]]
        assert (hedge > 0).any()


def test_trace_counts_dispositions_like_the_summary():
    port, serial = _traced_pair("breaker-saves-retry-storm", 1, "least_conn",
                                n_requests=200)
    data = port["trace"]["data"]
    disp = data[..., TRACE_IDX["disposition"]]
    assert int((disp == DISP_TIMEOUT).sum()) == port["n_client_timeout"]
    assert int((disp == DISP_FAIL_FAST).sum()) == port["n_fail_fast"]
    assert int((disp == DISP_SHED).sum()) == port["n_shed"]
    assert port["n_client_timeout"] + port["n_fail_fast"] \
        == port["n_timeouts"] == serial["n_timeouts"]
    np.testing.assert_array_equal(data[..., TRACE_IDX["rep"]][disp != 0], -1)


def test_trace_leaves_the_summary_unchanged():
    """The recorder observes: every stat of a traced pass equals the
    untraced pass's, bit for bit."""
    cfg = config_from_reference(ref_scenario("retry-storm").compile(
        seed=1, n_trials=3, n_requests=80))
    from dataclasses import replace
    from repro_torch.core.simulator import _build_cluster
    plain = simcore.run_compiled(_build_cluster(cfg), "perf_aware",
                                 device="cpu")
    traced = simcore.run_compiled(
        _build_cluster(replace(cfg, trace=TraceConfig(4))), "perf_aware",
        device="cpu")
    for k, v in plain.items():
        if k in ("loop_s",):
            continue
        if isinstance(v, dict):
            assert set(v) == set(traced[k]), k
            for sub, arr in v.items():
                np.testing.assert_array_equal(arr, traced[k][sub])
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, traced[k], err_msg=k)
        else:
            assert v == traced[k], k
    assert "trace" in traced and "trace" not in plain


# ----------------------------------------------------------------------
# the serving router's telemetry
def _drive(reg, rng):
    """The same seeded counter / gauge / histogram traffic."""
    c, g = reg.counter("reqs_total"), reg.gauge("inflight")
    h = reg.histogram("rtt_seconds")
    h2 = reg.histogram("wait_seconds", buckets=(2.0, 0.5, 8.0))
    for _ in range(60):
        c.inc(float(rng.integers(0, 3)))
        g.inc() if rng.random() < 0.6 else g.dec(0.5)
        v = float(rng.choice([rng.exponential(1.0), 0.05, 10.0, 20.0]))
        h.observe(v)
        h2.observe(v)
    g.set(3.25)
    return h


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_registry_matches_the_reference(seed):
    """Counters, gauges and histograms (the reference's ``le`` buckets,
    ``_sum`` / ``_count``, interpolated quantiles), collected and
    scraped into each package's store, equal."""
    ref_store = ref_make_store(seed=seed, n_scrapes=20)
    port_store = make_store(seed=seed, n_scrapes=20)
    ref, port = RT.MetricsRegistry(ref_store), MetricsRegistry(port_store)
    hr = _drive(ref, np.random.default_rng(seed))
    hp = _drive(port, np.random.default_rng(seed))
    assert port.collect() == ref.collect()
    assert port_store.names == ref_store.names
    ref.scrape(t=5.0)
    port.scrape(t=5.0)
    np.testing.assert_array_equal(port_store._data, ref_store._data)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert hp.quantile(q) == hr.quantile(q)
    assert hp.count == hr.count
    assert np.isnan(Histogram("empty").quantile(0.5))
    with pytest.raises(ValueError):
        port.counter("reqs_total")          # duplicate
    with pytest.raises(ValueError):
        port._metrics["reqs_total"].inc(-1.0)


def test_registry_without_store_collects_only():
    reg = MetricsRegistry()
    reg.counter("a_total").inc(2.0)
    reg.scrape()                            # no store: a no-op
    assert reg.collect() == {"a_total": 2.0}
