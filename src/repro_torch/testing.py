"""Synthetic stores and predictor artifacts for the port's tests and
card drives (the counterpart of the reference's ``repro/testing.py``).

:func:`make_store` scrapes standard-normal metrics every 200 ms exactly
as the reference's does, draw for draw, so both packages' stores hold
the same samples.  :func:`random_artifact` builds an
:class:`InferenceArtifact` whose scalers are fitted on seeded windows
the way the reference's ``make_trained_predictor`` fits them, and whose
parameters are :func:`random_params`: trained state's shapes, for
machines where the reference cannot train one.
:func:`make_trained_predictor` builds an :class:`RTTPredictor` the same
way, with the reference's draws for its metrics and scalers.
"""
from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import zoo
from repro_torch.core.features import extract_features
from repro_torch.core.predictor import (InferenceArtifact, MinMax,
                                        ModelChoice, RTTPredictor,
                                        SelectedConfig)
from repro_torch.device import DeviceLike
from repro_torch.monitoring.metrics import (SCRAPE_INTERVAL, MetricsStore,
                                            SimClock)

N_METRICS = 10
WINDOW_S = 5.0
K = 4
#: the reference's model sizes (its fit classes' defaults): recurrent
#: hidden width, CNN channels, FNN hidden layers, GBT rounds and bins
HIDDEN = 32
CHANNELS = 32
FNN_HIDDEN = (64, 32)
GBT_ROUNDS = {"xgb": 150, "rf": 80}
GBT_BINS = 32


def make_store(seed: int = 0, n_scrapes: int = 400,
               capacity_s: float = 120.0, n_metrics: int = N_METRICS,
               names: Optional[Sequence[str]] = None) -> MetricsStore:
    """Store scraped with standard-normal metrics every 200 ms (names
    ``m00``, ``m01``, ... unless given)."""
    rng = np.random.default_rng(seed)
    clock = SimClock()
    store = MetricsStore(capacity_s=capacity_s, clock=clock)
    names = list(names) if names is not None \
        else [f"m{i:02d}" for i in range(n_metrics)]
    for _ in range(n_scrapes):
        store.scrape({n: float(v) for n, v in
                      zip(names, rng.standard_normal(len(names)))})
        clock.advance(SCRAPE_INTERVAL)
    return store


def random_params(family: str, k: int, seed: int = 0):
    """Seeded parameters of one model over k metrics, in the reference's
    shapes and dtypes (float32 weights, int32 tree indices): a stand-in
    for trained state where no trained reference exists.  The output
    layer is scaled so that the normalized prediction sits near 0.5, as
    a trained model's does inside its [0, 1] target range; tree edges
    lie in [0, 1], the min-max scaled features' range.  The
    non-sequential families read k * 12 features."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return torch.from_numpy(
            np.asarray(rng.standard_normal(shape) * s, np.float32))

    def half(*shape):
        return torch.full(shape, 0.5)
    d = k * 12
    if family in ("lr", "svm"):
        return torch.cat([n(d, s=0.1 * d ** -0.5), half(1)])
    if family in ("xgb", "rf"):
        T, nb = GBT_ROUNDS[family], GBT_BINS
        edges = np.sort(rng.uniform(0.0, 1.0, (d, nb - 1)), axis=1)
        trees = (torch.from_numpy(rng.integers(0, d, (T, 3), np.int32)),
                 torch.from_numpy(rng.integers(0, nb, (T, 3), np.int32)),
                 n(T, 4, s=0.01))
        return (half(), trees, torch.from_numpy(edges.astype(np.float32)))
    if family == "fnn":
        sizes = (d,) + FNN_HIDDEN
        return [(n(a, b, s=(2.0 / a) ** 0.5), n(b, s=0.1))
                for a, b in zip(sizes[:-1], sizes[1:])] \
            + [(n(sizes[-1], 1, s=0.1 * sizes[-1] ** -0.5), half(1))]
    H = HIDDEN
    head = (n(H, 1, s=0.1 * H ** -0.5), half(1))
    if family == "cnn":
        c = CHANNELS
        return ((n(3, k, c, s=(3 * k) ** -0.5), n(c, s=0.1),
                 n(3, c, c, s=(3 * c) ** -0.5), n(c, s=0.1)), head)
    gates = {"rnn": 1, "gru": 3, "lstm": 4}[family]
    return ((n(k, gates * H, s=H ** -0.5), n(H, gates * H, s=H ** -0.5),
             n(gates * H, s=0.1)), head)


def _fitted_scales(rng, k: int, window_s: float, n_samples: int) -> tuple:
    """The reference ``make_trained_predictor``'s fit, drawn from ``rng``:
    ``n_samples`` standard-normal windows of ``k`` metrics and targets
    in [1, 5] s.  Returns the windows' per-metric (k,) min and max, the
    features' per-column min and max, and the targets' min and max."""
    w_pts = int(round(window_s / SCRAPE_INTERVAL))
    X_raw = rng.standard_normal((n_samples, k, w_pts)).astype(np.float32)
    y = rng.uniform(1.0, 5.0, n_samples).astype(np.float32)
    feats = extract_features(torch.from_numpy(X_raw)).numpy().reshape(
        n_samples, -1)
    return (X_raw.min(axis=(0, 2)), X_raw.max(axis=(0, 2)),
            feats.min(axis=0), feats.max(axis=0),
            float(y.min()), float(y.max()))


def random_artifact(app: str, node: str, family: str,
                    metric_names: Sequence[str], window_s: float = WINDOW_S,
                    seed: int = 0, n_samples: int = 64,
                    fast_state: bool = True) -> InferenceArtifact:
    """A seeded artifact over ``metric_names``: scalers fitted on
    ``n_samples`` standard-normal windows and targets in [1, 5] s, as
    the reference's ``make_trained_predictor`` fits them; parameters
    from :func:`random_params`; on the CPU."""
    k = len(metric_names)
    seq_lo, seq_hi, feat_lo, feat_hi, y_lo, y_hi = _fitted_scales(
        np.random.default_rng(seed), k, window_s, n_samples)
    seq = family in zoo.SEQ_MODELS
    return InferenceArtifact(
        app=app, node=node, family=family, sequential=seq,
        metric_names=tuple(metric_names), window_s=window_s,
        params=random_params(family, k, seed=seed),
        scaler_lo=None if seq else feat_lo,
        scaler_hi=None if seq else feat_hi,
        seq_lo=seq_lo[:, None] if seq else None,
        seq_hi=seq_hi[:, None] if seq else None,
        y_lo=y_lo, y_hi=y_hi, t_inference=1e-4,
        fast_state=fast_state, version=1)


def make_trained_predictor(app: str, store: MetricsStore, family: str,
                           k: int = K, window_s: float = WINDOW_S,
                           seed: int = 0, node: str = "node-0",
                           fast_state: bool = True, n_samples: int = 64,
                           device: DeviceLike = None) -> RTTPredictor:
    """An :class:`RTTPredictor` with injected trained state: ``k`` of
    the store's metrics, the window scale, target range and feature
    scaler drawn and fitted as the reference's
    ``make_trained_predictor`` does (the same draws, so equal up to the
    features' rounding), and :func:`random_params` for the model, held
    by a fit object (``zoo.from_params``).
    ``device=None`` puts it on the CUDA card."""
    rng = np.random.default_rng(seed)
    p = RTTPredictor(app, node, store, fast_state=fast_state, device=device)
    idx = np.sort(rng.choice(len(store.names), size=k, replace=False))
    p.selected = SelectedConfig(window_s, "pearson", idx, total_corr=1.0,
                                t_state=0.0, t_feature=0.0)
    seq_lo, seq_hi, feat_lo, feat_hi, p.y_lo, p.y_hi = _fitted_scales(
        rng, k, window_s, n_samples)
    p._seq_lo, p._seq_hi = seq_lo[None, :, None], seq_hi[None, :, None]
    p.scaler_X = MinMax(feat_lo, feat_hi)
    params = zoo.tree_map(lambda x: x.to(p.device),
                          random_params(family, k, seed=seed))
    p.choice = ModelChoice(family, zoo.from_params(family, params), rmse=0.1,
                           t_inference=1e-4)
    p.artifact_version = 1
    return p


#: the router's card-against-CPU scenarios, one a plane it mirrors
ROUTER_SCENARIOS = ("hedged-perf-aware", "capacity-admission",
                    "resilience-breaker")


def router_scenario(name: str, cfg, params, device: DeviceLike = None
                    ) -> dict:
    """Drive one of :data:`ROUTER_SCENARIOS` through a
    ``MorpheusRouter`` and its engines on ``device`` under a SimClock
    (seeded 8-token prompts, 4 new tokens a request):

    - ``hedged-perf-aware``: perf_aware over three replicas (slowdowns
      0, 0.05, 0.2 s a step) with plane-served predictors (lr, xgb, gru
      over one store), hedge factor 0.5;
    - ``capacity-admission``: least_conn over a predictive pool of three
      one-slot replicas, one active at first, epochs every second and
      admission at 1.5 s of estimated wait;
    - ``resilience-breaker``: round_robin over a fast and a 5 s-a-step
      replica, a 2 s timeout, two retries and a breaker that trips on
      the first timeout.

    Returns what two runs must agree on: the picks, the counts, each
    request's RTT and tokens, the trace rows, the registry and (with a
    pool) the ledger."""
    from repro_torch.core.capacity import CapacityConfig
    from repro_torch.core.resilience import ResilienceConfig
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router import MorpheusRouter

    clock = SimClock()

    def engines(slowdowns, max_batch=2):
        return [ServingEngine(cfg, params, device=device, node=f"n{i}",
                              max_batch=max_batch, max_seq=32, clock=clock,
                              slowdown=s) for i, s in enumerate(slowdowns)]
    rng = np.random.default_rng(ROUTER_SCENARIOS.index(name))

    def reqs(n, start=0):
        return [Request(rid=start + i, tokens=rng.integers(0, 100, size=8),
                        max_new_tokens=4) for i in range(n)]
    sent = []
    if name == "hedged-perf-aware":
        reps = engines((0.0, 0.05, 0.2))
        store = make_store()
        preds = {f"n{i}": make_trained_predictor(
            "serve", store, fam, seed=500 + i, node=f"n{i}", device=device)
            for i, fam in enumerate(("lr", "xgb", "gru"))}
        router = MorpheusRouter(reps, policy="perf_aware", predictors=preds,
                                hedge_factor=0.5, device=device)
        for r in reqs(12):
            router.route(r)
            sent.append(r)
        router.drain()
    elif name == "capacity-admission":
        reps = engines((0.0, 0.1, 0.3), max_batch=1)
        cap = CapacityConfig(autoscaler="predictive", initial_replicas=1,
                             decide_every_s=1.0, admission_limit_s=1.5)
        router = MorpheusRouter(reps, policy="least_conn", capacity=cap,
                                device=device)
        router.pool.note_prediction(0.6)
        for r in reqs(16):
            router.route(r)
            sent.append(r)
            clock.advance(0.25)
        router.drain()
    elif name == "resilience-breaker":
        reps = engines((0.0, 5.0))
        res = ResilienceConfig(timeout_s=2.0, max_retries=2,
                               breaker_threshold=1, breaker_cooldown_s=1e3)
        router = MorpheusRouter(reps, policy="round_robin", resilience=res,
                                device=device)
        for batch in (reqs(4), reqs(4, start=10)):
            for r in batch:
                router.route(r)
                sent.append(r)
            router.drain()
    else:
        raise KeyError(f"unknown router scenario {name!r}; one of "
                       f"{ROUTER_SCENARIOS}")
    return {
        "routed": list(router.routed), "hedged": list(router.hedged),
        "shed": len(router.shed), "fallbacks": router.fallbacks,
        "retries": router.retries, "timeouts": len(router.timeouts),
        "trips": None if router.breaker is None
        else int(router.breaker.trips),
        "rtts": [r.rtt for r in sent],
        "outputs": [None if r.output is None else r.output.tolist()
                    for r in sent],
        "trace": router.trace()["data"],
        "registry": router.registry.collect(),
        "ledger": None if router.pool is None else router.pool.ledger(),
        "scale_events": None if router.pool is None
        else list(router.pool.scale_events),
        "dispatches": router.plane.dispatches,
    }


def assert_router_runs_equal(got: dict, want: dict) -> None:
    """Two :func:`router_scenario` runs agree: picks, counts, RTTs,
    tokens, registry and ledger exactly; trace rows NaN where the other
    has NaN, the ``predicted`` / ``score`` columns (float32 inference
    on two devices) within ``rel=1e-5, abs=1e-5`` and the rest exactly."""
    from repro_torch.core.telemetry import TRACE_IDX
    for key in ("routed", "hedged", "shed", "fallbacks", "retries",
                "timeouts", "trips", "rtts", "outputs", "registry",
                "ledger", "scale_events", "dispatches"):
        assert got[key] == want[key], (key, got[key], want[key])
    a, b = got["trace"], want["trace"]
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    pred = [TRACE_IDX["predicted"], TRACE_IDX["score"]]
    np.testing.assert_allclose(a[..., pred], b[..., pred], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.delete(a, pred, -1),
                                  np.delete(b, pred, -1))


#: the nodes of the reference's benchmark fixture
#: (``benchmarks/fixture.py``): node factors; node i has seed i
NODE_FACTORS = (0.7, 1.0, 1.6)
#: the rtols of :func:`assert_fits_equal` for the families trained by
#: descent, on two devices from the same initial parameters
FIT_RTOL = {"svm": 1e-4, "fnn": 1e-4, "rnn": 1e-3, "gru": 1e-3,
            "lstm": 1e-3, "cnn": 1e-3}


def run_lifecycle(i: int, device: DeviceLike = None,
                  n_noise_metrics: int = 12, n_cycles: int = 4,
                  cycle_s: float = 240.0):
    """Node i of the reference's benchmark fixture (``worker-{i+1}``,
    node factor ``NODE_FACTORS[i]``, seed i, one instance an app) through
    ``PredictionManager(c_max=40, seed=0)`` on ``device``: 120 s of noisy
    load at 3.0, then ``n_cycles`` collection cycles of ``cycle_s``.
    Returns (node, manager, history)."""
    from repro_torch.core.manager import PredictionManager
    from repro_torch.core.workload import NodeWorkload
    node = NodeWorkload(f"worker-{i + 1}", instances_per_app=1,
                        node_factor=NODE_FACTORS[i], seed=i,
                        clock=SimClock(), n_noise_metrics=n_noise_metrics)
    mgr = PredictionManager(c_max=40, seed=0, device=device)
    cb = mgr.attach(node)
    mgr.bootstrap_noise(node, load=3.0, duration_s=120, on_complete=cb)
    history = mgr.run_cycles(node, n_cycles=n_cycles, cycle_s=cycle_s,
                             on_complete=cb)
    return node, mgr, history


def _leaves_np(model) -> list:
    return [np.asarray(x.cpu()) for x in
            zoo.tree_leaves(model.inference_params())]


def assert_fits_equal(got, want, rtol: float = 1e-4) -> None:
    """Two fits of one family on the same data agree: trees by column,
    bin and base exactly, leaves within ``rtol`` (atol 1e-6); the other
    families' parameters within ``rtol`` (atol 1e-5)."""
    assert got.name == want.name
    a, b = _leaves_np(got), _leaves_np(want)
    assert [x.shape for x in a] == [x.shape for x in b]
    if got.name in ("xgb", "rf"):
        for x, y in zip(a[1:3], b[1:3]):          # feats, bins
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
        np.testing.assert_allclose(a[3], b[3], rtol=rtol, atol=1e-6)
        return
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-5)


def assert_lifecycles_equal(got, want, rtol: float = 1e-4) -> int:
    """Two :func:`run_lifecycle` runs agree: the clocks, the datasets
    exactly, the selections (window, method, metric indices), the
    families, the counts of full and re-trainings and the ``rmse_history``
    times; the RMSEs within ``rtol``, the models by
    :func:`assert_fits_equal` and the plane's predictions of every
    trained predictor within ``rtol``.  Returns the number trained."""
    (gnode, gmgr, ghist), (wnode, wmgr, whist) = got, want
    assert gnode.clock.now() == wnode.clock.now()
    assert [(t, a) for t, a, _ in ghist] == [(t, a) for t, a, _ in whist]
    trained = 0
    for key, w in wmgr.predictors.items():
        g = gmgr.predictors[key]
        np.testing.assert_array_equal(g.dataset.rtts, w.dataset.rtts)
        assert (g.selected is None) == (w.selected is None), key
        if w.selected is not None:
            assert (g.selected.window_s, g.selected.method) == \
                (w.selected.window_s, w.selected.method), key
            np.testing.assert_array_equal(g.selected.metric_idx,
                                          w.selected.metric_idx)
        assert (g.full_trainings, g.retrainings) == \
            (w.full_trainings, w.retrainings), key
        assert [t for t, _ in g.rmse_history] == \
            [t for t, _ in w.rmse_history], key
        np.testing.assert_allclose([r for _, r in g.rmse_history],
                                   [r for _, r in w.rmse_history],
                                   rtol=rtol, err_msg=str(key))
        if w.choice is not None:
            trained += 1
            assert_fits_equal(g.choice.model, w.choice.model,
                              FIT_RTOL.get(w.choice.name, rtol))
    keys = sorted(wmgr.plane.keys())
    assert sorted(gmgr.plane.keys()) == keys
    gp, wp = gmgr.plane.predict_all(keys), wmgr.plane.predict_all(keys)
    for key in keys:
        a, b = gp[key].rtt_pred, wp[key].rtt_pred
        assert abs(a - b) <= rtol * abs(b), (key, a, b)
    return trained


def zoo_data(n: int, d: int, k: int, w: int, seed: int = 0):
    """Learnable data in the shape of ``tests/test_zoo.py``'s draws: (n, d)
    features in [0, 1) and a normalized target of three of them, and
    (n, k, w) windows whose target is a mean and a last value; float32.
    Returns (X, y, X_seq, y_seq)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] ** 2
         + 0.05 * rng.standard_normal(n))
    X_seq = rng.uniform(0, 1, (n, k, w)).astype(np.float32)
    y_seq = X_seq[:, 0].mean(-1) + 0.3 * X_seq[:, 1, -1]

    def norm(v):
        return ((v - v.min()) / (v.max() - v.min())).astype(np.float32)
    return X, norm(y), X_seq, norm(y_seq)


def seed_lora(params: dict, cfg, seed: int = 0) -> None:
    """Fill Zamba2's LoRA ``qb`` / ``ib`` (zeros at init, as in the
    reference, so the per-group deltas add exactly 0) in place with
    seeded normal values of std ``lora_rank ** -0.5``, so the deltas are
    as large as the products they add to.  The draws come from a
    generator on the parameters' device."""
    g = torch.Generator(device=params["lora"]["qb"].device).manual_seed(seed)
    for name in ("qb", "ib"):
        x = params["lora"][name]
        x.copy_(torch.randn(x.shape, generator=g, device=x.device)
                * cfg.hybrid.lora_rank ** -0.5)


#: card against CPU in training: each gradient leaf's largest absolute
#: difference over its largest absolute value.  1e-4 (f32 sums in
#: another order); the MoE layer rounds its dispatched tokens' cotangent
#: to bf16, so a leaf upstream of a MoE layer is held to 1e-2; the
#: leaves downstream of every MoE layer (the final norm, the untied LM
#: head, the last layer's expert and router slices) to 1e-4.
TRAIN_GRAD_TOL = 1e-4
MOE_UPSTREAM_TOL = 1e-2
_EXPERT_LEAVES = ("['router']", "['wi']", "['wg']", "['wo']")
_DOWNSTREAM_LEAVES = ("['final_norm']", "['embed']['head']")


def train_batch(cfg, B: int, S: int, seed: int = 0, frames: int = 8) -> dict:
    """A CPU batch for ``train_forward``: tokens and labels from
    :class:`~repro_torch.data.pipeline.SyntheticLMData`, and for ``encdec``
    normal random encoder frames (B, frames, d_model) in the model's
    dtype."""
    from repro_torch.data.pipeline import SyntheticLMData
    b = SyntheticLMData(cfg.vocab_size, seed=seed).sample(
        np.random.default_rng(seed), B, S)
    batch = {k: torch.as_tensor(v) for k, v in b.items()}
    if cfg.family == "encdec":
        g = torch.Generator().manual_seed(seed)
        batch["enc_frames"] = torch.randn((B, frames, cfg.d_model),
                                          generator=g).to(
            getattr(torch, cfg.dtype))
    return batch


def train_grads_drift(cfg, got: dict, want: dict) -> float:
    """Hold ``got``'s gradient tree (any device) to ``want``'s by the
    rules above; returns the worst drift of the leaves held to 1e-4."""
    from repro_torch.tree import keystr, leaves_with_path
    worst = 0.0
    for (p, g), (q, w) in zip(leaves_with_path(got),
                              leaves_with_path(want)):
        assert p == q and g.shape == w.shape, (p, q)
        g, w = g.detach().float().cpu(), w.detach().float().cpu()

        def drift(a, b):
            return float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30))
        k = keystr(p)
        if cfg.moe is None or k.startswith(_DOWNSTREAM_LEAVES):
            e = drift(g, w)
            assert e < TRAIN_GRAD_TOL, (k, e)
        else:
            assert drift(g, w) < MOE_UPSTREAM_TOL, (k, drift(g, w))
            if not (k.startswith("['layers']['ffn']")
                    and any(n in k for n in _EXPERT_LEAVES)):
                continue
            e = drift(g[-1], w[-1])
            assert e < TRAIN_GRAD_TOL, (k, "last layer", e)
        worst = max(worst, e)
    return worst


def train_step_parity(cfg, tcfg, device: DeviceLike, B: int = 2,
                      S: int = 32, seed: int = 0) -> dict:
    """One train step of ``cfg`` on ``device`` against the CPU from the
    same parameters and batch: the loss, the metrics and every gradient
    leaf (:func:`train_grads_drift`), then the step's loss and grad norm.
    Returns the drifts: ``loss``, ``grad_norm`` (relative) and
    ``grads``."""
    from repro_torch.training.train_step import (make_train_state,
                                                 make_train_step,
                                                 value_and_grad)
    from repro_torch.tree import tree_map
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(seed),
                             "cpu")
    batch = train_batch(cfg, B, S, seed)
    # a copy (the step writes the state in place)
    on_dev = tree_map(lambda x: x.to(device, copy=True), state)
    dev_batch = {k: v.to(device) for k, v in batch.items()}
    loss_c, met_c, g_c = value_and_grad(cfg, state["params"], batch)
    loss_d, met_d, g_d = value_and_grad(cfg, on_dev["params"], dev_batch)
    out = {"grads": train_grads_drift(cfg, g_d, g_c)}
    step = make_train_step(cfg, tcfg)
    _, m_c = step(state, batch)
    _, m_d = step(on_dev, dev_batch)
    for k in ("loss", "grad_norm"):
        out[k] = abs(float(m_d[k]) - float(m_c[k])) / abs(float(m_c[k]))
    out["loss"] = max(out["loss"], abs(float(loss_d) - float(loss_c))
                      / abs(float(loss_c)))
    assert float(met_d["tokens"]) == float(met_c["tokens"])
    return out


def tp_grad_parity(cfg, rules, device: DeviceLike, B: int = 2, S: int = 32,
                   seed: int = 0) -> dict:
    """On a one-rank mesh with a ``model`` axis: the loss and gradients
    of ``train_forward`` under ``rules`` (the tensor-parallel path: the
    sequence-split residual, the vocab-parallel loss, the collectives
    over the model axis) against those without rules, from the same
    parameters and batch on ``device`` (Zamba2's LoRA seeded nonzero,
    :func:`seed_lora`); each gradient leaf held by
    :func:`train_grads_drift`.  Returns the drifts: ``loss`` (relative)
    and ``grads``."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import axis_rules
    from repro_torch.training.train_step import value_and_grad
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), device)
    if cfg.family == "hybrid":
        seed_lora(params, cfg, seed)
    batch = {k: v.to(device) for k, v in train_batch(cfg, B, S, seed).items()}
    with axis_rules(rules):
        loss_t, met_t, g_t = value_and_grad(cfg, params, batch)
    loss, met, g = value_and_grad(cfg, params, batch)
    assert float(met_t["tokens"]) == float(met["tokens"])
    return {"grads": train_grads_drift(cfg, g_t, g),
            "loss": abs(float(loss_t) - float(loss)) / abs(float(loss))}


#: the sharded step's master, m and v are held to the single-device
#: step's within this share of each leaf's largest value
STATE_TOL = 1e-6


def _param_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference of params ``a`` from ``b``, over one unit in
    the last place of ``b``'s dtype at each element plus STATE_TOL of
    the leaf's largest value: a param is its master rounded, so a master
    within STATE_TOL puts it within 1 of this."""
    fi = torch.finfo(b.dtype)
    a, b = a.float(), b.float()
    e = torch.frexp(b.abs().clamp_min(fi.tiny)).exponent
    room = torch.ldexp(torch.full_like(b, fi.eps), e - 1) \
        + STATE_TOL * b.abs().max()
    return float(((a - b).abs() / room).max()) if b.numel() else 0.0


def f32_hex(x) -> str:
    """The bits of an f32 scalar (a tensor or a float) as 8 hex digits."""
    return struct.pack(">f", float(x)).hex()


def _state_drift(got: dict, want: dict, shardings: dict) -> tuple:
    """Per kind, the largest difference of ``got``'s train state (this
    rank's shards in ``shardings``' layouts, gathered one leaf at a time
    so no second whole state is held) from ``want``'s: ``master``, ``m``
    and ``v`` over each leaf's largest value, ``params`` as
    :func:`_param_ulps` gives it; whether every leaf is equal bit for
    bit; and the first leaf that is not (its key path), or None."""
    from repro_torch.tree import keystr, leaves, leaves_with_path
    out = {"master": 0.0, "m": 0.0, "v": 0.0, "params": 0.0}
    exact, first = True, None
    for (path, x), s, y in zip(leaves_with_path(got), leaves(shardings),
                               leaves(want)):
        x = s.gather(x)
        same = torch.equal(x, y)
        exact &= same
        if not same and first is None:
            first = keystr(path)
        kind = path[1] if path[0] == "opt" else path[0]
        if kind == "step":
            continue
        if kind == "params":
            e = _param_ulps(x, y)
        elif x.numel():
            x, y = x.float(), y.float()
            e = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
        else:
            e = 0.0
        out[kind] = max(out[kind], e)
    return out, exact, first


def sharded_step_parity(cfg, tcfg, rules, state: dict, batch: dict,
                        steps: int = 2) -> list:
    """``steps`` steps of the sharded step under ``rules`` beside the
    single-device step on the same global ``batch``; every rank of the
    mesh calls it.  The single-device step takes ``state`` (whole leaves)
    itself and writes it in place; the sharded step takes this rank's
    shards of it, so two states are held.

    The gradients are computed once, by the single-device step, and
    handed to the sharded step (on the card the embedding's and the
    kernels' atomic sums make two backward passes differ in their last
    bits): each rank takes its block of a leaf split over the model axis
    and the whole of the others, on the first data-parallel rank (and,
    for a leaf replicated over the model axis, the first model rank)
    only, zeros on the rest, so the step's sums over the ranks give them
    back exactly; a leaf the step gathers layer by layer goes through its
    ``LayerGather.reduce_stack``, the per-layer reduction its backward
    runs.  What differs is the step's own logic: the microbatch
    split, the params' gathers, the optimizer's layout and collectives,
    the norm and the write-back; on one rank each collective is the
    identity, and the state comes out bit for bit (on more, the clip's
    norm sums the shards in another order).  The sharded step's forward
    runs all the same, to compare its loss.  Returns, a dict a step:
    ``drift``, the sharded state's from the single-device one
    (:func:`_state_drift`: ``master``, ``m`` and ``v`` are held to
    STATE_TOL, ``params`` to 1); ``exact``, whether the two states are
    equal bit for bit; ``batch_equal`` and ``params_equal``, whether
    every microbatch the sharded step took (this rank's rows), and the
    params it took them with (this rank's blocks; a layer-gathered
    leaf's shard), equal the
    single-device step's bit for bit; ``loss_equal``, whether its
    forward's loss, summed over the data-parallel ranks, and token counts
    equal the single-device step's bit for bit, and ``loss_drift``, the
    loss's relative difference; ``norms`` and ``clip_scales``, the two
    steps' gradient norms and clip scales (single-device, sharded) as f32
    hex (:func:`f32_hex`); and where the states differ or the norms do,
    ``leaf_sq``, each gradient leaf's f32 sums of squares on both sides
    (``optim.adamw.leaf_square_sums``, the sums the norm adds),
    ``first_sq_leaf``, the first leaf whose sums differ, and
    ``first_state_leaf``, the first state leaf that differs (ROADMAP
    Queue 3 item 30)."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import clip_scale, leaf_square_sums
    from repro_torch.parallel.sharding import (MODEL, axis_index,
                                               axis_size,
                                               current_layer_gather, dp_sum)
    from repro_torch.training.train_step import (make_train_step,
                                                 state_shardings,
                                                 value_and_grad)
    from repro_torch.tree import (keystr, leaves, leaves_with_path,
                                  tree_map, unflatten)
    sh = state_shardings(cfg, rules)
    p_sh, dp_axes = sh["params"], rules.batch_axes
    mesh = rules.mesh
    dp, dp_r = axis_size(mesh, dp_axes), axis_index(mesh, dp_axes)
    tp_r = axis_index(mesh, (MODEL,)) if MODEL in mesh.mesh_dim_names \
        else 0

    def own(x, s):
        y = s.local(x)
        return y.clone() if y is x else y

    def blocks(tree):
        """This rank's blocks of the model-split leaves of ``tree``."""
        return tree_map(lambda x, s: s.without(dp_axes).local(x), tree,
                        p_sh)

    # a model block's layout split over the data-parallel axes alone
    dp_only = tree_map(lambda s: s.without((MODEL,)), p_sh)

    def hand(g, s):
        lead = dp_r == 0 and (MODEL in s.axes() or tp_r == 0)
        g = own(g, s.without(dp_axes))
        return g if lead else torch.zeros_like(g)

    dp_state = tree_map(own, state, sh)
    first = state
    recorded, seen = [], {}

    def record(cfg, params, mb):
        out = value_and_grad(cfg, params, mb)
        # one copy of the params a step: its microbatches share them
        if seen.get("params_of") is not params:
            seen["params_of"] = params
            seen["params_copy"] = tree_map(lambda x: x.clone(), params)
        recorded.append((mb, seen["params_copy"], out))
        return out

    def replay(cfg, params, mb):
        want_mb, want_params, (loss, metrics, grads) = recorded.pop(0)
        lg = current_layer_gather()
        held = [lg is not None and p in lg.leaves
                for p, _ in leaves_with_path(params)]
        per = next(iter(want_mb.values())).shape[0] // dp
        seen["batch"] &= all(torch.equal(
            mb[k], want_mb[k].narrow(0, dp_r * per, per)) for k in mb)
        # a layer-gathered leaf is this rank's shard, the others its
        # model block whole over the data-parallel axes
        seen["params"] &= all(torch.equal(a, s.local(b) if h else b)
                              for a, b, s, h in zip(
                                  leaves(params), leaves(blocks(want_params)),
                                  leaves(dp_only), held))
        xs = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            got, got_metrics = M.train_forward(unflatten(params, xs), cfg, mb)
        got = dp_sum(got.detach())
        seen["loss"] &= torch.equal(got, loss) and torch.equal(
            got_metrics["tokens"], metrics["tokens"])
        seen["loss_drift"] = max(seen["loss_drift"], float(
            (got - loss).abs() / loss.abs().clamp_min(1e-30)))
        del xs, got, got_metrics

        def first_rank(v):
            return v if dp_r == 0 else torch.zeros_like(v)

        handed = []
        for (path, g), s, h in zip(leaves_with_path(grads), leaves(p_sh),
                                   held):
            g = hand(g, s)
            if h:
                # reduced layer by layer, as the backward reduces it
                lg.reduce_stack(path, g)
                g = None
            handed.append(g)
        return (first_rank(loss),
                {k: v if k == "tokens" else first_rank(v)
                 for k, v in metrics.items()},
                unflatten(grads, handed))

    def squares(side):
        def on_grads(grads, shardings):
            seen[side] = leaf_square_sums(grads, shardings)
        return on_grads

    plain = make_train_step(cfg, tcfg, grad_fn=record,
                            on_grads=squares("plain_sq"))
    sharded = make_train_step(cfg, tcfg, rules, grad_fn=replay,
                              on_grads=squares("sharded_sq"))
    names = [keystr(p) for p, _ in leaves_with_path(state["params"])]
    out = []
    for _ in range(steps):
        seen.update(batch=True, params=True, loss=True, loss_drift=0.0)
        first, m_plain = plain(first, batch)
        dp_state, m_sharded = sharded(dp_state, batch)
        assert not recorded
        seen.pop("params_of"), seen.pop("params_copy")
        drift, exact, first_leaf = _state_drift(dp_state, first, sh)
        norms = [m["grad_norm"] for m in (m_plain, m_sharded)]
        row = {"drift": drift, "exact": exact,
               "batch_equal": seen["batch"],
               "params_equal": seen["params"],
               "loss_equal": seen["loss"],
               "loss_drift": seen["loss_drift"],
               "norms": [f32_hex(x) for x in norms],
               "clip_scales": [f32_hex(clip_scale(x, tcfg.grad_clip))
                               for x in norms]}
        sq = [[f32_hex(x) for x in seen.pop(k)]
              for k in ("plain_sq", "sharded_sq")]
        if not exact or row["norms"][0] != row["norms"][1]:
            row["leaf_sq"] = {n: [a, b] for n, a, b in zip(names, *sq)}
            row["first_sq_leaf"] = next(
                (n for n, a, b in zip(names, *sq) if a != b), None)
            row["first_state_leaf"] = first_leaf
        out.append(row)
    return out



def serve_wave(params, cfg, batch: dict, cache_len: int, steps: int,
               from_init: bool = False, mesh=None,
               rows: Optional[int] = None) -> dict:
    """One serving wave: ``prefill`` of ``batch`` into a cache of
    ``cache_len`` rows, then ``steps`` greedy ``decode_step``s.  With
    ``from_init`` an ``init_cache`` of ``rows`` sequences (the batch's
    own rows by default) fed the prompt one token a step takes the
    prefill's place: the start the reference's int8 cache takes.  With a
    ``mesh``, the prefill runs under ``launch.specs.rules_for(cfg, mesh,
    "prefill")`` and the steps under its ``"decode"`` rules (``params``
    and ``batch`` each rank's, ``rows`` the global batch's).  Returns
    ``logits`` (a (B, V_padded) tensor a step, the prefill's or the last
    prompt step's first), ``tokens`` (B, steps + 1) greedy, ``cache`` and
    ``decode_s``, the seconds of the greedy steps (the card waited for at
    the end)."""
    import time
    from repro_torch.launch.specs import rules_for
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import axis_rules
    pre = dec = None
    if mesh is not None:
        pre, dec = (rules_for(cfg, mesh, k) for k in ("prefill", "decode"))
    toks = batch["tokens"]
    if from_init:
        with axis_rules(dec):
            cache = M.init_cache(cfg, rows or toks.shape[0], cache_len,
                                 params["embed"]["tok"].dtype, toks.device)
            for t in range(toks.shape[1]):
                logits, cache = M.decode_step(params, cfg, cache,
                                              toks[:, t:t + 1])
    else:
        with axis_rules(pre):
            logits, cache = M.prefill(params, cfg, batch, cache_len)
    out = [logits]
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    picked = [tok]
    if toks.is_cuda:
        torch.cuda.synchronize(toks.device)
    t0 = time.perf_counter()
    with axis_rules(dec):
        for _ in range(steps):
            logits, cache = M.decode_step(params, cfg, cache, tok)
            out.append(logits)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            picked.append(tok)
    if toks.is_cuda:
        torch.cuda.synchronize(toks.device)
    return {"logits": out, "tokens": torch.cat(picked, 1), "cache": cache,
            "decode_s": time.perf_counter() - t0}


def tp_serve_parity(cfg, mesh, params: dict, batch: dict, cache_len: int,
                    steps: int, from_init: bool = False,
                    rounds: int = 0) -> dict:
    """One wave (:func:`serve_wave`) on the tensor-parallel path over
    ``mesh`` against the single-device path of the same resolved ``cfg``;
    every rank of the mesh calls it with the same whole ``params`` and
    global ``batch``.  The single-device wave takes them as they are,
    without rules; the tensor-parallel one each rank's blocks of the
    params (``launch.specs.serve_param_shardings``) and its rows of the
    batch (an ``encdec`` batch's ``enc_frames`` give the cross cache's
    rows).  Returns ``logits``, the largest difference of this rank's
    logits from the single-device wave's rows over the largest |logit| of
    the real vocabulary; ``logits_exact``, whether they are equal bit for
    bit; ``tokens_equal``; ``cache``, the largest difference of the
    gathered cache from the single-device one over each leaf's largest
    value (``cache_exact``: bit for bit; ``len`` must be equal, or
    ``tokens_equal`` is False), over the floating leaves; for an int8
    cache ``int8_steps``, the largest difference of its rows in
    quantisation steps, and ``int8_off``, how many differ (a last-bit
    difference of a row before it is rounded can move it one step);
    ``cache_shapes``, this rank's cache leaves' shapes by their dotted
    key paths (``k``, ``conv.x``); and with ``rounds``, ``decode_ms``: each path's
    (``tp``, ``single``) milliseconds a greedy step in each of ``rounds``
    more waves, run after the parity waves (which warm both paths up),
    the two paths interleaved and the first of them alternating round by
    round (the host's clock drifts between waves)."""
    from repro_torch.launch.specs import (batch_logical, cache_shardings,
                                          rules_for, serve_param_shardings,
                                          tree_arg_shardings)
    from repro_torch.parallel.sharding import _axes, axis_index, place
    from repro_torch.tree import leaves_with_path
    rules = rules_for(cfg, mesh, "prefill")
    B = batch["tokens"].shape[0]
    b_sh = tree_arg_shardings(batch, {
        k: v for k, v in batch_logical(cfg, "prefill").items()
        if k in batch}, rules)
    mine = (place(params, serve_param_shardings(cfg, rules)),
            place(batch, b_sh))
    waves = {"tp": lambda: serve_wave(mine[0], cfg, mine[1], cache_len,
                                      steps, from_init, mesh, B),
             "single": lambda: serve_wave(params, cfg, batch, cache_len,
                                          steps, from_init)}
    got, single = waves["tp"](), waves["single"]()
    dp_axes = _axes(b_sh["tokens"].spec[0])
    n = got["tokens"].shape[0]
    r0 = axis_index(mesh, dp_axes) * n if dp_axes else 0
    V = cfg.vocab_size
    drift, exact = 0.0, True
    for a, b in zip(got["logits"], single["logits"]):
        b = b[r0:r0 + n]
        exact &= torch.equal(a, b)
        drift = max(drift, float((a[:, :V] - b[:, :V]).abs().max()
                                 / b[:, :V].abs().max()))
    tokens_equal = torch.equal(got["tokens"], single["tokens"][r0:r0 + n])
    frames = batch.get("enc_frames")
    c_sh = cache_shardings(cfg, rules, B, cache_len, enc_len=None
                           if frames is None else frames.shape[1])
    c_drift, c_exact, steps_off, n_off = 0.0, True, 0, 0
    for (path, x), (_, y) in zip(leaves_with_path(got["cache"]),
                                 leaves_with_path(single["cache"])):
        s = c_sh
        for k in path:
            s = s[k]
        x = s.gather(x)
        c_exact &= torch.equal(x, y)
        if path[0] == "len":
            tokens_equal &= torch.equal(x, y)
            continue
        if x.dtype == torch.int8:
            d = (x.int() - y.int()).abs()
            steps_off = max(steps_off, int(d.max()))
            n_off += int(torch.count_nonzero(d))
            continue
        x, y = x.float(), y.float()
        c_drift = max(c_drift, float((x - y).abs().max()
                                     / y.abs().max().clamp_min(1e-30)))
    out = {"logits": drift, "logits_exact": bool(exact),
           "tokens_equal": bool(tokens_equal), "cache": c_drift,
           "cache_exact": bool(c_exact), "int8_steps": steps_off,
           "int8_off": n_off,
           "cache_shapes": {".".join(p): list(v.shape) for p, v in
                            leaves_with_path(got["cache"])}}
    del got, single
    if rounds:
        ms = out["decode_ms"] = {"tp": [], "single": []}
        for r in range(rounds):
            for k in (("tp", "single") if r % 2 == 0 else ("single", "tp")):
                ms[k].append(waves[k]()["decode_s"] / max(steps, 1) * 1e3)
    return out


def blocks_summary(cluster, policy: str, world: int,
                   device: DeviceLike = None) -> dict:
    """The sharded dispatch's pad, block and cut path at ``world`` ranks,
    each rank's block run one after another on one device: the padded
    trials' blocks (``simcore._block_index`` / ``_take_trials``), each
    through the cached loop (its outputs copied before the next block
    replays a captured loop over them), joined in rank order
    (``_join_trials``, what the all-gather gives every rank), cut back
    to T (``_cut_trials``) and summarised.  Returns ``(summary, blocks
    run)``."""
    from repro_torch.core import simcore
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    st, consts, plan = simcore._lowered(cluster, policy, None)
    T = consts["node_of"].shape[0]
    finals = []
    for r in range(world):
        block = simcore._take_trials(st, consts,
                                     simcore._block_index(T, world, r))
        final, _ = simcore._execute(st, block, plan, dev, eager=False)
        finals.append(simcore._map_trials(
            final, lambda v, ax, _: v.copy() if isinstance(v, np.ndarray)
            else v.clone()))
    final = simcore._cut_trials(simcore._join_trials(finals), T)
    return simcore._summarize(cluster, st, final, plan), len(finals)


def step_records(device: DeviceLike = None) -> dict:
    """The step audit's record of every distinct step on ``device`` (None:
    the card) as plain data: label -> {ops, max_scatters, reads, carry,
    missed, findings}, for a card run held against a CPU run."""
    from repro_torch.analysis import step_audit
    out = {}
    for spec in step_audit.step_specs():
        rec = step_audit.record_step(spec, device)
        out[spec.label] = {
            "ops": dict(sorted(rec.ops.items())),
            "max_scatters": rec.max_scatters,
            "reads": {k: list(v) for k, v in sorted(rec.reads.items())},
            "carry": sorted([k, w, j] for (k, w), j in rec.carry.items()),
            "missed": list(rec.missed),
            "findings": sorted(f.key for f in step_audit.audit_record(rec))}
    return out
