"""The port's Morpheus router (``repro_torch.serving.router``) against the
JAX package's, on torch engines on the CPU.

Every router test of the reference (``tests/test_serving.py`` from the
perf-aware routing test on, the router half of
``tests/test_resilience.py`` and ``test_policy_engine.py::
test_router_dispatches_through_engine``) is replayed: each scenario runs
once on the reference's router and engines and once on the port's, the
reference test's assertions hold on both, and the two runs must agree:

- ``routed``, ``hedged``, the shed, fallback, retry and timeout counts,
  the breakers' trips;
- each request's RTT (SimClock: 1e-12) and output tokens (exact);
- ``pool.ledger()`` and ``pool.scale_events``;
- ``accuracy.accuracy()`` and ``count``;
- ``registry.collect()``;
- ``trace()["data"]`` row for row, NaN where the reference has NaN.

Both sides serve deepseek-67b's smoke config (the reference tests'
model) in float32, the port with the reference's parameters carried
across (``params_from_reference``); tokens are compared at f32, as
``tests/test_torch_serving.py`` holds the engine.  Where a scenario
routes on trained predictors, the port's are the reference's carried
across (``predictor_from_reference``), and the float32 inference of the
two frameworks rounds apart: predictions, the scores and accuracies
they feed, and the trace's ``predicted`` / ``score`` columns agree to
``rel=1e-5, abs=1e-5``, the reference's own plane-versus-serial
tolerance.
Requests are sized within ``max_seq`` (the port's engine refuses a wave
past it).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.core.capacity import CapacityConfig as RefCapacity
from repro.core.resilience import ResilienceConfig as RefResilience
from repro.models import model as JM
from repro.monitoring.metrics import SimClock as RefClock
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.router import MorpheusRouter as RefRouter
from repro.testing import make_store as ref_make_store
from repro.testing import make_trained_predictor as ref_trained
from repro_torch.configs.base import get_config
from repro_torch.core.balancer import make_policy
from repro_torch.core.capacity import CapacityConfig
from repro_torch.core.resilience import ResilienceConfig
from repro_torch.core.telemetry import (COMPONENTS, DISP_SERVED, DISP_SHED,
                                        DISP_TIMEOUT, TRACE_FIELDS, TRACE_IDX)
from repro_torch.interop import params_from_reference, predictor_from_reference
from repro_torch.monitoring.metrics import SimClock
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.router import MorpheusRouter
from repro_torch.testing import make_store

ARCH = "deepseek-67b"
#: predictions of the two frameworks' float32 inference
PRED_TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(ref_config(ARCH, smoke=True),
                               dtype="float32").resolve(tp=1)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype="float32").resolve(tp=1)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _ref_fns(max_seq):
    """One jitted prefill / decode per cache length, shared by every
    reference engine (each engine would compile its own)."""
    jcfg = _models()[0]
    return (jax.jit(lambda p, b: JM.prefill(p, jcfg, b, cache_len=max_seq)),
            jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t)))


class Ref:
    """The reference's side of a replay."""
    Request, SimClock, make_store = RefRequest, RefClock, ref_make_store
    Capacity, Resilience = RefCapacity, RefResilience

    @staticmethod
    def engine(node, clock, max_batch=2, max_seq=32, slowdown=0.0):
        jcfg, _, jparams, _ = _models()
        eng = RefEngine(jcfg, jparams, node=node, max_batch=max_batch,
                        max_seq=max_seq, clock=clock, slowdown=slowdown)
        eng._prefill, eng._decode = _ref_fns(max_seq)
        return eng

    @staticmethod
    def router(reps, **kw):
        return RefRouter(reps, **kw)

    @staticmethod
    def predictor(store, seed, node):
        return ref_trained("serve", store, "lr", seed=seed, node=node)


class Port:
    """The port's side: torch engines and router on the CPU."""
    Request, SimClock, make_store = Request, SimClock, make_store
    Capacity, Resilience = CapacityConfig, ResilienceConfig

    @staticmethod
    def engine(node, clock, max_batch=2, max_seq=32, slowdown=0.0):
        _, tcfg, _, tparams = _models()
        return ServingEngine(tcfg, tparams, device="cpu", node=node,
                             max_batch=max_batch, max_seq=max_seq,
                             clock=clock, slowdown=slowdown)

    @staticmethod
    def router(reps, **kw):
        return MorpheusRouter(reps, device="cpu", **kw)

    @staticmethod
    def predictor(store, seed, node):
        """The reference's trained predictor (on its own copy of the
        store's draws), carried across to read the port's store."""
        return predictor_from_reference(
            ref_trained("serve", ref_make_store(), "lr", seed=seed,
                        node=node), store, "cpu")


def _reqs(pkg, n, rng, max_new_tokens=4):
    return [pkg.Request(rid=i, tokens=rng.integers(0, 100, size=8),
                        max_new_tokens=max_new_tokens) for i in range(n)]


def _nan_equal(got, want, cols=()):
    """Equal arrays with NaN where the reference has NaN; the trace
    columns ``cols`` within ``PRED_TOL``."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    g, w = np.nan_to_num(got), np.nan_to_num(want)
    if cols:
        idx = [TRACE_IDX[c] for c in cols]
        np.testing.assert_allclose(g[..., idx], w[..., idx], **PRED_TOL)
        g, w = np.delete(g, idx, -1), np.delete(w, idx, -1)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def assert_same(ref, port, ref_reqs=(), port_reqs=(), predicted=False):
    """The two routers took the same decisions with the same results."""
    assert port.routed == ref.routed
    assert port.hedged == ref.hedged
    assert len(port.shed) == len(ref.shed)
    assert port.fallbacks == ref.fallbacks
    assert port.retries == ref.retries
    assert [r.rid for r in port.timeouts] == [r.rid for r in ref.timeouts]
    assert (port.breaker is None) == (ref.breaker is None)
    if ref.breaker is not None:
        assert int(port.breaker.trips) == ref.breaker.trips
    for a, b in zip(port_reqs, ref_reqs, strict=True):
        assert (a.t_done is None) == (b.t_done is None)
        if b.t_done is not None:
            assert abs(a.rtt - b.rtt) <= 1e-12, (a.rtt, b.rtt)
        if b.output is not None:
            np.testing.assert_array_equal(a.output, np.asarray(b.output))
    assert (port.pool is None) == (ref.pool is None)
    if ref.pool is not None:
        got, want = port.pool.ledger(), ref.pool.ledger()
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12), k
        assert port.pool.scale_events == ref.pool.scale_events
    np.testing.assert_array_equal(port.accuracy.count, ref.accuracy.count)
    np.testing.assert_allclose(port.accuracy.accuracy(),
                               ref.accuracy.accuracy(),
                               **(PRED_TOL if predicted else
                                  dict(rtol=0, atol=1e-12)))
    got, want = port.registry.collect(), ref.registry.collect()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12), k
    gt, wt = port.trace(), ref.trace()
    assert gt["fields"] == wt["fields"] == list(TRACE_FIELDS)
    assert gt["sample_every"] == wt["sample_every"]
    np.testing.assert_array_equal(gt["requests"], wt["requests"])
    _nan_equal(gt["data"], wt["data"],
               cols=("predicted", "score") if predicted else ())


def both(scenario):
    """Run ``scenario(pkg)`` on the reference, then on the port."""
    return scenario(Ref), scenario(Port)


def _trace_sum_err(data):
    served = data[..., TRACE_IDX["disposition"]] == DISP_SERVED
    comp = sum(data[..., TRACE_IDX[c]] for c in COMPONENTS
               if c != "hedge_s") - data[..., TRACE_IDX["hedge_s"]]
    err = np.abs(comp - data[..., TRACE_IDX["response"]])[served]
    return float(err.max()) if err.size else 0.0


# ----------------------------------------------------------------------
# tests/test_serving.py, replayed
def test_router_perf_aware_avoids_slow_replica():
    def run(pkg):
        clock = pkg.SimClock()
        fast = pkg.engine("fast", clock, slowdown=0.0)
        slow = pkg.engine("slow", clock, slowdown=0.5)
        router = pkg.router([fast, slow], policy="perf_aware")
        router.kb.put("serve", "fast", 0.0, 0.1)
        router.kb.put("serve", "slow", 0.0, 5.0)
        reqs = _reqs(pkg, 4, np.random.default_rng(2))
        for r in reqs:
            router.route(r)
        assert router.routed.count(0) >= 3
        router.drain()
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_predicted_rtts_is_one_plane_call():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock) for i in range(3)]
        store = pkg.make_store()
        preds = {f"n{i}": pkg.predictor(store, 500 + i, f"n{i}")
                 for i in range(3)}
        router = pkg.router(reps, policy="perf_aware", predictors=preds)
        calls = []
        orig = router.plane.predict_all

        def counted(keys=None):
            calls.append(keys)
            return orig(keys)
        router.plane.predict_all = counted
        rtts = router._predicted_rtts()
        assert len(calls) == 1 and len(calls[0]) == 3
        assert np.isfinite(rtts).all()
        # the plane matches each predictor's serial path (the port's
        # plane against the port's serial predict) and lands in the kb
        for i in range(3):
            serial = preds[f"n{i}"].predict().rtt_pred
            assert rtts[i] == pytest.approx(serial, rel=1e-5, abs=1e-5)
            assert router.kb.latest("serve", f"n{i}") \
                == pytest.approx(rtts[i])
        return router, rtts
    (ref, want), (port, got) = both(run)
    np.testing.assert_allclose(got, want, **PRED_TOL)
    assert port.plane.dispatches == ref.plane.dispatches == 1


def test_router_falls_back_without_trained_predictors():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock) for i in range(2)]
        router = pkg.router(reps, policy="perf_aware")
        router.kb.put("serve", "n0", 0.0, 2.5)
        rtts = router._predicted_rtts()
        assert rtts[0] == 2.5
        assert rtts[1] == 1.0 + reps[1].pending()
        return rtts
    want, got = both(run)
    np.testing.assert_array_equal(got, want)


def test_router_keyed_sweep_honors_outage_window():
    def run(pkg):
        store = pkg.make_store()
        clock = store.clock
        reps = [pkg.engine(f"n{i}", clock) for i in range(3)]
        preds = {f"n{i}": pkg.predictor(store, 900 + i, f"n{i}")
                 for i in range(3)}
        router = pkg.router(reps, policy="perf_aware", predictors=preds)
        now = clock.now()
        router.plane.add_outage(now + 5.0, now + 500.0)
        before = router._predicted_rtts()
        d0 = router.plane.dispatches
        clock.advance(10.0)
        rng = np.random.default_rng(0)
        for _ in range(20):
            store.scrape({n: float(v) * 100.0 for n, v in
                          zip(store.names, rng.standard_normal(10))})
        during = router._predicted_rtts()
        assert router.plane.dispatches == d0
        np.testing.assert_array_equal(during, before)
        clock.advance(600.0)
        after = router._predicted_rtts()
        assert router.plane.dispatches > d0
        assert not np.array_equal(after, before)
        return router, np.stack([before, during, after])
    (ref, want), (port, got) = both(run)
    np.testing.assert_allclose(got, want, **PRED_TOL)
    assert port.plane.dispatches == ref.plane.dispatches


def test_router_falls_back_to_least_conn_below_viability():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock) for i in range(2)]
        router = pkg.router(reps, policy="perf_aware",
                            fallback_threshold=0.6)
        router.kb.put("serve", "n0", 0.0, 0.1)
        router.kb.put("serve", "n1", 0.0, 5.0)
        rng = np.random.default_rng(4)
        reqs = []

        def route(rid):
            reqs.append(pkg.Request(rid=rid,
                                    tokens=rng.integers(0, 100, size=8)))
            router.route(reqs[-1])
        assert router.predictions_viable()
        route(0)
        assert router.fallbacks == 0
        for _ in range(router.accuracy.min_count):
            router.accuracy.update(np.array([0.9, 0.9]))
        assert not router.predictions_viable()
        before = len(router.routed)
        inflight_before = len(router._inflight)
        route(1)
        assert router.fallbacks == 1
        assert len(router.routed) == before + 1
        assert len(router._inflight) == inflight_before + 1
        good = np.zeros(2)
        for _ in range(router.accuracy.window):
            router.accuracy.update(good)
        assert router.predictions_viable()
        route(2)
        assert router.fallbacks == 1
        router.drain()
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_drain_settles_accuracy_tracker():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock, slowdown=0.01) for i in range(2)]
        store = pkg.make_store()
        preds = {f"n{i}": pkg.predictor(store, 950 + i, f"n{i}")
                 for i in range(2)}
        router = pkg.router(reps, policy="perf_aware", predictors=preds)
        reqs = _reqs(pkg, 4, np.random.default_rng(5))
        for r in reqs:
            router.route(r)
        assert len(router._inflight) == 4
        assert router.accuracy.count.sum() == 0
        router.drain()
        assert len(router._inflight) == 0
        assert router.accuracy.count.sum() == 4
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq, predicted=True)


def test_router_capacity_pool_masks_drained_engines():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock, slowdown=0.01) for i in range(4)]
        cap = pkg.Capacity(autoscaler="fixed", initial_replicas=2,
                           decide_every_s=1.0)
        router = pkg.router(reps, policy="round_robin", capacity=cap)
        assert [e.active for e in reps] == [True, True, False, False]
        reqs = _reqs(pkg, 6, np.random.default_rng(6))
        for r in reqs:
            clock.advance(0.1)
            assert router.route(r) in (0, 1)
        done = router.drain()
        assert len(done) == 6
        led = router.pool.ledger()
        assert led["provisioned_s"] > 0
        assert led["busy_s"] > 0
        assert 0.0 <= led["waste"] <= 1.0
        assert led["shed"] == 0
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_capacity_admission_sheds():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock, max_batch=1) for i in range(2)]
        cap = pkg.Capacity(autoscaler="fixed", initial_replicas=2,
                           admission_limit_s=0.5)
        router = pkg.router(reps, policy="least_conn", capacity=cap)
        router.pool.note_prediction(10.0)
        reqs = _reqs(pkg, 6, np.random.default_rng(7))
        results = [router.route(r) for r in reqs]
        assert -1 in results
        assert router.pool.shed == results.count(-1) == len(router.shed)
        served = [i for i in results if i >= 0]
        assert len(router.drain()) == len(served)
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_capacity_scales_up_reactively():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock, max_batch=1) for i in range(3)]
        cap = pkg.Capacity(autoscaler="reactive", initial_replicas=1,
                           min_replicas=1, decide_every_s=1.0,
                           cooldown_s=0.0, hi_util=0.5)
        router = pkg.router(reps, policy="least_conn", capacity=cap)
        assert sum(e.active for e in reps) == 1
        reqs = _reqs(pkg, 8, np.random.default_rng(8))
        for r in reqs:
            router.route(r)
            clock.advance(1.1)
        assert sum(e.active for e in reps) > 1
        assert any(d > 0 for _, d in router.pool.scale_events)
        router.drain()
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_pool_ledger_pays_drain_tails():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock, max_batch=1, slowdown=0.02)
                for i in range(3)]
        cap = pkg.Capacity(autoscaler="fixed", initial_replicas=3,
                           decide_every_s=1.0)
        router = pkg.router(reps, policy="round_robin", capacity=cap)
        reqs = _reqs(pkg, 6, np.random.default_rng(10))
        for r in reqs:
            router.route(r)
        for e in reps[1:]:
            e.active = False
        router.drain()
        clock.advance(0.5)
        led = router.pool.ledger()
        assert led["busy_s"] <= led["provisioned_s"] + 1e-9, led
        assert led["waste"] >= 0.0
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_engine_accumulates_busy_seconds():
    def run(pkg):
        clock = pkg.SimClock()
        eng = pkg.engine("node-0", clock, slowdown=0.01)
        assert eng.busy_s == 0.0
        reqs = _reqs(pkg, 2, np.random.default_rng(9))
        for r in reqs:
            eng.submit(r)
        eng.step_wave()
        assert eng.busy_s > 0.0
        return eng.busy_s, reqs
    (want, rq), (got, pq) = both(run)
    assert got == pytest.approx(want, rel=0, abs=1e-12)
    for a, b in zip(pq, rq):
        np.testing.assert_array_equal(a.output, np.asarray(b.output))


def test_router_round_robin_spreads():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock) for i in range(3)]
        router = pkg.router(reps, policy="round_robin")
        reqs = _reqs(pkg, 6, np.random.default_rng(3))
        for r in reqs:
            router.route(r)
        assert router.routed == [0, 1, 2, 0, 1, 2]
        assert len(router.drain()) == 6
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_trace_schema_and_sum_rule():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock, slowdown=0.01) for i in range(3)]
        router = pkg.router(reps, policy="round_robin")
        reqs = _reqs(pkg, 6, np.random.default_rng(20))
        for r in reqs:
            router.route(r)
        router.drain()
        blk = router.trace()
        assert blk["fields"] == list(TRACE_FIELDS)
        assert blk["sample_every"] == 1
        d = blk["data"]
        assert d.shape == (1, 6, len(TRACE_FIELDS))
        assert (d[0, :, TRACE_IDX["disposition"]] == DISP_SERVED).all()
        np.testing.assert_array_equal(d[0, :, TRACE_IDX["rep"]],
                                      [0, 1, 2, 0, 1, 2])
        assert np.isfinite(d[0, :, TRACE_IDX["response"]]).all()
        assert _trace_sum_err(d) < 1e-6
        assert np.isnan(d[0, :, TRACE_IDX["predicted"]]).all()
        assert np.isfinite(d[0, :, TRACE_IDX["score"]]).all()
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_trace_perf_aware_captures_decision():
    def run(pkg):
        clock = pkg.SimClock()
        fast = pkg.engine("fast", clock, slowdown=0.0)
        slow = pkg.engine("slow", clock, slowdown=0.5)
        router = pkg.router([fast, slow], policy="perf_aware")
        router.kb.put("serve", "fast", 0.0, 0.1)
        router.kb.put("serve", "slow", 0.0, 5.0)
        reqs = _reqs(pkg, 4, np.random.default_rng(21))
        for r in reqs:
            router.route(r)
        router.drain()
        d = router.trace()["data"]
        assert np.isfinite(d[0, :, TRACE_IDX["predicted"]]).all()
        np.testing.assert_array_equal(d[0, :, TRACE_IDX["rep"]],
                                      router.routed)
        assert (d[0, :, TRACE_IDX["score"]] <= 5.0 + 1e-9).all()
        assert _trace_sum_err(d) < 1e-6
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_trace_shed_rows():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine(f"n{i}", clock, max_batch=1) for i in range(2)]
        cap = pkg.Capacity(autoscaler="fixed", initial_replicas=2,
                           admission_limit_s=0.5)
        router = pkg.router(reps, policy="least_conn", capacity=cap)
        router.pool.note_prediction(10.0)
        reqs = _reqs(pkg, 6, np.random.default_rng(22))
        results = [router.route(r) for r in reqs]
        router.drain()
        d = router.trace()["data"]
        assert d.shape[1] == 6
        disp = d[0, :, TRACE_IDX["disposition"]]
        assert (disp == DISP_SHED).sum() == results.count(-1) > 0
        shed_rows = d[0, disp == DISP_SHED]
        assert (shed_rows[:, TRACE_IDX["rep"]] == -1).all()
        assert np.isnan(shed_rows[:, TRACE_IDX["response"]]).all()
        served_rows = d[0, disp == DISP_SERVED]
        assert np.isfinite(served_rows[:, TRACE_IDX["response"]]).all()
        exp = router.registry.collect()
        assert exp["router_requests_total"] == 6.0
        assert exp["router_shed_total"] == float(results.count(-1))
        assert exp["router_rtt_seconds_count"] == float(
            6 - results.count(-1))
        assert exp["router_inflight"] == 0.0
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_trace_timeout_and_retry_rows():
    def run(pkg):
        clock = pkg.SimClock()
        reps = [pkg.engine("n0", clock, slowdown=5.0)]
        res = pkg.Resilience(timeout_s=0.5, max_retries=1)
        router = pkg.router(reps, policy="round_robin", resilience=res)
        n = 2
        reqs = _reqs(pkg, n, np.random.default_rng(23))
        for r in reqs:
            router.route(r)
        router.drain()
        assert len(router.timeouts) == n
        d = router.trace()["data"]
        disp = d[0, :, TRACE_IDX["disposition"]]
        assert d.shape[1] == 2 * n
        assert (disp == DISP_TIMEOUT).all()
        assert np.isnan(d[0, :, TRACE_IDX["response"]]).all()
        assert (d[0, :, TRACE_IDX["rep"]] == -1).all()
        exp = router.registry.collect()
        assert exp["router_retries_total"] == float(n)
        assert exp["router_timeouts_total"] == float(n)
        assert exp["router_inflight"] == 0.0
        assert (disp == DISP_SERVED).sum() == 0
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_trace_hedge_effect():
    def run(pkg):
        clock = pkg.SimClock()
        slow = pkg.engine("slow", clock, max_batch=1, slowdown=0.3)
        twin = pkg.engine("twin", clock, max_batch=1, slowdown=0.0)
        router = pkg.router([slow, twin], policy="perf_aware",
                            hedge_factor=1.0)
        router.kb.put("serve", "slow", 0.0, 1.0)
        router.kb.put("serve", "twin", 0.0, 1.0)
        reqs = _reqs(pkg, 3, np.random.default_rng(24))
        for r in reqs:
            router.route(r)
        router.drain()
        d = router.trace()["data"]
        hs = d[0, :, TRACE_IDX["hedge_s"]]
        if router.hedged:
            assert float(router.registry.collect()["router_hedges_total"]) \
                == len(router.hedged)
        assert (hs[np.isfinite(hs)] >= 0).all()
        assert (d[0, :, TRACE_IDX["disposition"]] == DISP_SERVED).all()
        assert _trace_sum_err(d) < 1e-6
        return router, reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_winning_hedge_like_reference():
    """A hedge that fires and wins: the pick (the idle slow replica,
    predicted 5 s) is slower than half the busy twin's predicted
    completion, the duplicate lands on the twin, whose wave is served
    first and finishes earlier, and the primary's row carries the saved
    time."""
    def run(pkg):
        clock = pkg.SimClock()
        twin = pkg.engine("twin", clock, max_batch=8, slowdown=0.0)
        slow = pkg.engine("slow", clock, max_batch=1, slowdown=0.3)
        router = pkg.router([twin, slow], policy="perf_aware",
                            hedge_factor=0.5)
        router.kb.put("serve", "twin", 0.0, 4.0)
        router.kb.put("serve", "slow", 0.0, 5.0)
        rng = np.random.default_rng(26)
        queued = _reqs(pkg, 5, rng)
        for r in queued:
            twin.submit(r)
        reqs = _reqs(pkg, 3, rng)
        for r in reqs:
            router.route(r)
        router.drain()
        hs = router.trace()["data"][0, :, TRACE_IDX["hedge_s"]]
        assert router.hedged and (hs > 0).any()
        assert _trace_sum_err(router.trace()["data"]) < 1e-6
        return router, queued + reqs
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_registry_rides_metrics_store():
    def run(pkg):
        store = pkg.make_store()
        clock = store.clock
        reps = [pkg.engine(f"n{i}", clock) for i in range(2)]
        router = pkg.router(reps, policy="round_robin", metrics_store=store)
        reqs = _reqs(pkg, 4, np.random.default_rng(25))
        for r in reqs:
            router.route(r)
        router.drain()
        clock.advance(0.05)
        router.registry.scrape()
        arr, _ = store.query_window(
            ["router_requests_total", "router_rtt_seconds_count"], 0.2,
            fast=True)
        np.testing.assert_array_equal(arr[:, -1], [4.0, 4.0])
        return router, reqs, store
    (ref, rq, rs), (port, pq, ps) = both(run)
    assert_same(ref, port, rq, pq)
    assert ps.names == rs.names
    np.testing.assert_array_equal(ps._data, rs._data)


# ----------------------------------------------------------------------
# tests/test_resilience.py's router half, replayed
def _resilient(pkg, slowdowns, res, policy="round_robin"):
    clock = pkg.SimClock()
    reps = [pkg.engine(f"n{i}", clock, slowdown=s)
            for i, s in enumerate(slowdowns)]
    return pkg.router(reps, policy=policy, resilience=res)


def test_router_retries_and_breaker_mask():
    def run(pkg):
        rng = np.random.default_rng(0)
        res = pkg.Resilience(timeout_s=2.0, max_retries=2,
                             breaker_threshold=1, breaker_cooldown_s=1e3)
        r = _resilient(pkg, [0.0, 5.0], res)
        reqs = [pkg.Request(rid=i, tokens=rng.integers(0, 100, size=8),
                            max_new_tokens=4) for i in range(4)]
        for q in reqs:
            r.route(q)
        finished = r.drain()
        assert r.retries > 0 and r.breaker.trips >= 1
        assert all(f.rtt <= res.timeout_s for f in finished)
        before = len(r.routed)
        more = [pkg.Request(rid=i, tokens=rng.integers(0, 100, size=8),
                            max_new_tokens=4) for i in range(10, 14)]
        for q in more:
            r.route(q)
        assert all(j == 0 for j in r.routed[before:])
        r.drain()
        return r, reqs + more
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)
    for name in ("fail", "open_until", "tripped"):
        np.testing.assert_array_equal(getattr(port.breaker, name).numpy(),
                                      getattr(ref.breaker, name))


def test_router_exhausted_retries_land_in_timeouts():
    def run(pkg):
        rng = np.random.default_rng(1)
        res = pkg.Resilience(timeout_s=0.5, max_retries=1)
        r = _resilient(pkg, [5.0], res)
        q = pkg.Request(rid=0, tokens=rng.integers(0, 100, size=8),
                        max_new_tokens=4)
        r.route(q)
        assert r.drain() == []
        assert len(r.timeouts) == 1 and r.retries == 1
        return r, [q]
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_timed_out_requests_skip_accuracy_tracker():
    def run(pkg):
        rng = np.random.default_rng(2)
        res = pkg.Resilience(timeout_s=0.5, max_retries=0)
        r = _resilient(pkg, [5.0], res, policy="perf_aware")
        q = pkg.Request(rid=0, tokens=rng.integers(0, 100, size=8),
                        max_new_tokens=4)
        r.route(q)
        r.drain()
        assert r.accuracy.count.sum() == 0
        assert len(r.timeouts) == 1
        return r, [q]
    (ref, rq), (port, pq) = both(run)
    assert_same(ref, port, rq, pq)


def test_router_hedge_resilience_ban():
    for router in (RefRouter, MorpheusRouter):
        with pytest.raises(ValueError):
            router([], hedge_factor=1.5,
                   resilience=Port.Resilience(timeout_s=5.0)
                   if router is MorpheusRouter
                   else RefResilience(timeout_s=5.0))


# ----------------------------------------------------------------------
# tests/test_policy_engine.py::test_router_dispatches_through_engine
class _StubReplica:
    def __init__(self, node, pending, max_batch=2):
        self.node = node
        self.max_batch = max_batch
        self._pending = pending

    def pending(self):
        return self._pending

    def submit(self, req):
        self._pending += 1


@pytest.mark.parametrize("name", ["least_conn", "oracle", "perf_aware",
                                  "random", "round_robin"])
def test_router_dispatches_through_engine(name):
    picks = {}
    for side in ("reference", "port"):
        reps = [_StubReplica(f"n{i}", pending=i % 3) for i in range(4)]
        if side == "reference":
            from repro.core.balancer import make_policy as ref_policy
            router = RefRouter(reps, policy=name, seed=11)
            mirror = ref_policy(name, seed=11)
        else:
            router = MorpheusRouter(reps, policy=name, seed=11, device="cpu")
            mirror = make_policy(name, seed=11, device="cpu")
        for i in range(4):
            router.kb.put("serve", f"n{i}", 0.0, 1.0 + 2.0 * i)
        if name == "oracle":
            with pytest.raises(ValueError):
                router.route(object())
            continue
        got = []
        for step in range(8):
            want = int(mirror.pick(router.cluster_state())[0])
            got.append(router.route(object()))
            assert got[-1] == want, (name, step, got[-1], want)
        picks[side] = got
    assert picks.get("port") == picks.get("reference")


# ----------------------------------------------------------------------
# the port's own rules
def test_router_refuses_replica_on_another_device():
    class _OnCard(_StubReplica):
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="runs on"):
        MorpheusRouter([_OnCard("n0", 0)], policy="round_robin",
                       device="cpu")


def test_router_state_lives_on_its_device():
    router = MorpheusRouter([_StubReplica(f"n{i}", i) for i in range(3)],
                            policy="perf_aware", device="cpu")
    state = router.cluster_state()
    for t in (state.busy_until, state.queue_depth, state.predicted):
        assert t.device.type == "cpu" and t.dtype == torch.float64
    assert router.plane.device.type == "cpu"


# ----------------------------------------------------------------------
# the predictors the router serves
@pytest.mark.parametrize("family", ["lr", "xgb", "fnn", "gru", "cnn"])
def test_serial_predict_matches_reference(family):
    """A reference predictor carried across predicts as the reference's
    serial path does (modeled timings equal), and exports the same
    artifact."""
    ref = ref_trained("serve", ref_make_store(), family, seed=3, node="n3")
    port = predictor_from_reference(ref, make_store(), "cpu")
    assert port.metric_names() == ref.metric_names()
    want, got = ref.predict(), port.predict()
    tol = PRED_TOL if family in ("lr", "xgb") else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.rtt_pred, want.rtt_pred, **tol)
    for k in ("t", "t_state", "t_feature", "t_inference", "basis"):
        assert getattr(got, k) == getattr(want, k), k
    assert port.predictions == [got]
    a, b = port.export_artifact(), ref.export_artifact()
    for k in ("app", "node", "family", "sequential", "metric_names",
              "window_s", "y_lo", "y_hi", "t_inference", "fast_state",
              "version"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("scaler_lo", "scaler_hi", "seq_lo", "seq_hi"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if y is not None:
            np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("family", ["lr", "rnn"])
def test_make_trained_predictor_draws_like_reference(family):
    """The seeded predictor picks the reference's metrics, window scale,
    target range and feature scaler (the same draws); only the model's
    parameters are seeded instead of trained."""
    from repro_torch.testing import make_trained_predictor
    ref = ref_trained("serve", ref_make_store(), family, seed=7)
    port = make_trained_predictor("serve", make_store(), family, seed=7,
                                  device="cpu")
    np.testing.assert_array_equal(port.selected.metric_idx,
                                  ref.selected.metric_idx)
    np.testing.assert_array_equal(port._seq_lo, ref._seq_lo)
    np.testing.assert_array_equal(port._seq_hi, ref._seq_hi)
    assert (port.y_lo, port.y_hi) == (ref.y_lo, ref.y_hi)
    np.testing.assert_allclose(port.scaler_X.lo, ref.scaler_X.lo,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.scaler_X.hi, ref.scaler_X.hi,
                               rtol=1e-5, atol=1e-5)
    rec = port.predict()
    assert np.isfinite(rec.rtt_pred) and rec.basis == "modeled"
    assert port.export_artifact().version == 1
