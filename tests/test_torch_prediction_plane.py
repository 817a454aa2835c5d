"""The port's prediction plane against the JAX package's, replaying
``tests/test_prediction_plane.py``.

Both sides read stores fed the same seeded scrapes (the reference's
``repro.testing.make_store`` and ``repro_torch.testing.make_store``,
which replays its draws), and the port plane registers the reference's
trained predictors through a duck-typed wrapper whose artifact crosses
by ``repro_torch.interop.artifact_from_reference``.  Predictions agree per
key to rel 1e-5 / abs 1e-5 (the reference's own plane-vs-serial bound),
modeled timings and dispatch counts are equal.
"""
import numpy as np
import pytest

from repro.core import zoo as ref_zoo
from repro.core.prediction_plane import PredictionPlane as RefPlane
from repro.testing import K, N_METRICS, WINDOW_S
from repro.testing import make_store as ref_make_store
from repro.testing import make_trained_predictor
from repro_torch.core import zoo
from repro_torch.core.prediction_plane import PredictionPlane, _next_pow2
from repro_torch.core.predictor import FEATURE_DELAY_PER_METRIC
from repro_torch.interop import artifact_from_reference
from repro_torch.testing import make_store, random_artifact

TOL = dict(rel=1e-5, abs=1e-5)


def make_stores(seed=0, n_scrapes=400, capacity_s=120.0,
                n_metrics=N_METRICS):
    """The reference's ``make_store`` and the port's, fed the same
    draws."""
    return (ref_make_store(seed, n_scrapes, capacity_s, n_metrics),
            make_store(seed, n_scrapes, capacity_s, n_metrics))


class Carried:
    """A reference predictor seen by the port plane: the duck-typed
    surface ``register_predictor`` reads, over the port's store."""

    def __init__(self, pred, store):
        self.pred, self.store = pred, store
        self.app, self.node = pred.app, pred.node

    @property
    def artifact_version(self):
        return self.pred.artifact_version

    def export_artifact(self):
        art = self.pred.export_artifact()
        return None if art is None else artifact_from_reference(art, "cpu")


def planes(preds, port_store, **kw):
    ref, port = RefPlane(**kw), PredictionPlane(device="cpu", **kw)
    for p in preds:
        assert ref.register_predictor(p)
        assert port.register_predictor(Carried(p, port_store))
    return ref, port


def assert_records_match(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.rtt_pred == pytest.approx(w.rtt_pred, **TOL), key
        assert (g.basis, g.t_state, g.t_feature, g.t_inference) \
            == (w.basis, w.t_state, w.t_feature, w.t_inference), key


@pytest.fixture(scope="module")
def fleet():
    ref_store, port_store = make_stores()
    preds = {fam: make_trained_predictor(f"app_{fam}", ref_store, fam,
                                         seed=i)
             for i, fam in enumerate(ref_zoo.ALL_MODELS)}
    return ref_store, port_store, preds


def test_stores_replay_the_same_scrapes(fleet):
    ref_store, port_store, _ = fleet
    names = ref_store.names[:K]
    a, _ = ref_store.query_window(names, WINDOW_S, fast=True)
    b, _ = port_store.query_window(names, WINDOW_S, fast=True)
    np.testing.assert_array_equal(a, b)


def test_plane_matches_reference_for_every_family(fleet):
    _, port_store, preds = fleet
    assert set(zoo.ALL_MODELS) == set(ref_zoo.ALL_MODELS) == set(preds)
    ref, port = planes(preds.values(), port_store)
    want, got = ref.predict_all(), port.predict_all()
    assert len(got) == len(preds)
    assert_records_match(got, want)
    for rec in got.values():
        assert rec.basis == "modeled"
        assert rec.t_feature == FEATURE_DELAY_PER_METRIC * K
        assert rec.t_inference == 1e-4
        assert rec.t_wall_feature > 0
    assert port.dispatches == ref.dispatches == len(preds)
    assert port.batched_predictions == ref.batched_predictions


def test_one_dispatch_per_bucket_not_per_predictor(fleet):
    ref_store, port_store, _ = fleet
    fams = ["lr", "xgb", "rnn"]
    preds = [make_trained_predictor(f"bulk{i}", ref_store, fams[i % 3],
                                    seed=i) for i in range(12)]
    ref, port = planes(preds, port_store)
    assert len(port.buckets()) == len(ref.buckets()) == 3
    assert_records_match(port.predict_all(), ref.predict_all())
    assert port.dispatches == ref.dispatches == 3


def test_padding_to_pow2_does_not_change_results(fleet):
    ref_store, port_store, _ = fleet
    assert _next_pow2(5) == 8 and _next_pow2(1) == 1 and _next_pow2(8) == 8
    preds = [make_trained_predictor(f"pad{i}", ref_store, "lr",
                                    seed=100 + i) for i in range(5)]
    ref, port = planes(preds, port_store)
    (bucket,) = port.buckets()
    assert bucket.pad == 3 and bucket.params.shape[0] == 8
    assert_records_match(port.predict_all(), ref.predict_all())


def test_subset_predict_and_reregistration(fleet):
    ref_store, port_store, _ = fleet
    preds = [make_trained_predictor(f"sub{i}", ref_store, "lr",
                                    seed=200 + i) for i in range(4)]
    ref, port = planes(preds, port_store)
    want = [(preds[1].app, preds[1].node), (preds[3].app, preds[3].node),
            ("ghost", "nowhere")]
    got = port.predict_all(want)
    assert set(got) == set(want[:2])
    assert_records_match(got, ref.predict_all(want))
    carried = Carried(preds[0], port_store)
    assert not port.register_predictor(carried)
    preds[0].artifact_version += 1
    assert port.register_predictor(carried)
    assert len(port) == 4 and (preds[0].app, preds[0].node) in port
    port.unregister(preds[0].app, preds[0].node)
    assert port.keys() == [(p.app, p.node) for p in preds[1:]]
    assert (preds[0].app, preds[0].node) not in port


def test_batched_state_retrieval_amortizes_modeled_delay():
    ref_store, port_store = make_stores(seed=3)
    preds = [make_trained_predictor(f"slow{i}", ref_store, "lr",
                                    seed=300 + i, fast_state=False)
             for i in range(4)]
    ref, port = planes(preds, port_store)
    keys = [(p.app, p.node) for p in preds]
    spent_ref, spent_port = ref_store.query_time_spent, \
        port_store.query_time_spent
    want, got = ref.predict_all(keys), port.predict_all(keys)
    assert_records_match(got, want)
    assert port_store.query_time_spent - spent_port == pytest.approx(
        ref_store.query_time_spent - spent_ref)
    serial = 4 * port_store.retrieval.delay(K, WINDOW_S)
    assert port_store.query_time_spent - spent_port == pytest.approx(
        serial - 3 * port_store.retrieval.base)
    assert port_store.clock.now() == pytest.approx(ref_store.clock.now())


def test_mixed_store_capacities_split_buckets():
    big_ref, big_port = make_stores(seed=10)
    small_ref, small_port = make_stores(seed=11, n_scrapes=30,
                                        capacity_s=4.0)
    p_big = make_trained_predictor("cap_big", big_ref, "lr", seed=600)
    p_small = make_trained_predictor("cap_small", small_ref, "lr", seed=601)
    ref, port = RefPlane(), PredictionPlane(device="cpu")
    for p, store, ps in ((p_big, big_ref, big_port),
                         (p_small, small_ref, small_port)):
        ref.register_predictor(p)
        port.register_predictor(Carried(p, ps))
    assert len(port.buckets()) == len(ref.buckets()) == 2
    got = port.predict_all()
    assert_records_match(got, ref.predict_all())
    assert np.isfinite(got[("cap_small", "node-0")].rtt_pred)


def test_plane_refresh_horizon_serves_snapshot(fleet):
    ref_store, port_store, _ = fleet
    p = make_trained_predictor("fresh", ref_store, "lr", seed=400)
    port = PredictionPlane(refresh_s=60.0, device="cpu")
    port.register_predictor(Carried(p, port_store))
    r1 = port.predict_all()
    d0 = port.dispatches
    port_store.clock.advance(1.0)
    assert port.predict_all() is r1            # within horizon: cached
    assert port.dispatches == d0
    assert port.predict_all([("fresh", "node-0")]) \
        == {("fresh", "node-0"): r1[("fresh", "node-0")]}
    port_store.clock.advance(60.0)
    assert port.predict_all() is not r1        # horizon passed
    assert port.dispatches == d0 + 1


def test_prediction_plane_outage_freezes_full_and_subset_calls():
    ref_store, port_store = make_stores(seed=0, n_metrics=6)
    pred = make_trained_predictor("app0", ref_store, "lr", seed=7,
                                  node="n0", n_samples=32)
    port = PredictionPlane(device="cpu")
    now = port_store.clock.now()
    port.add_outage(now + 5.0, now + 50.0)
    assert port.register_predictor(Carried(pred, port_store))
    first = port.predict_all()
    gathers = port.dispatches
    port_store.clock.advance(10.0)             # inside the outage
    assert port.predict_all() is first
    assert port.predict_all([("app0", "n0")]) == first
    assert port.dispatches == gathers
    port_store.clock.advance(60.0)             # past the outage
    fresh = port.predict_all()
    assert fresh is not first and port.dispatches == gathers + 1
    # outside the outage an outage-only plane computes just the keys
    port.predict_all([("app0", "n0")])
    assert port.dispatches == gathers + 2


def test_random_fleet_buckets_by_family_and_pads():
    """The card's stand-in fleet: seeded artifacts of every family over
    one store bucket one per family, pad to powers of two, and predict
    finite RTTs inside their targets' scale."""
    store = make_store(seed=5)
    fams = zoo.ALL_MODELS
    plane = PredictionPlane(device="cpu")
    for i in range(3 * len(fams)):
        names = store.names[i % 7:i % 7 + K]
        plane.register(random_artifact(f"app{i}", f"n{i}", fams[i % 9],
                                       names, seed=i), store)
    buckets = plane.buckets()
    assert sorted(b.family for b in buckets) == sorted(fams)
    assert all(len(b.keys) == 3 and b.pad == 1 for b in buckets)
    recs = plane.predict_all()
    assert len(recs) == 27 and plane.dispatches == 9
    assert all(np.isfinite(r.rtt_pred) for r in recs.values())
