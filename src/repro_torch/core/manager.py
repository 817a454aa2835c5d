"""Prediction Manager (paper §3, Fig. 1), a port of the reference's
``core/manager.py``: deploys one RTT predictor per
(application, node) pair, re-enables paused ones, injects controlled noisy
load at bootstrap so predictors see RTT variability (paper §4.4), and runs
the 5-minute data-collection cycles.

Trained predictors publish their state into one shared
:class:`~repro_torch.core.prediction_plane.PredictionPlane`; per-cycle
predictions and the router's per-request sweep both go through the
plane's batched path (DESIGN.md §9) rather than per-predictor serial
``predict()`` calls.

The manager's predictors, plane and routers live on ``device`` (None:
the CUDA card, RuntimeError without one; ``"cpu"``: the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.prediction_plane import PredictionPlane
from repro_torch.core.predictor import COLLECTION_PERIOD_S, RTTPredictor
from repro_torch.core.selection import WINDOWS_S
from repro_torch.core.telemetry import PhaseTimer
from repro_torch.core.workload import NodeWorkload, Task
from repro_torch.device import DeviceLike, resolve_device


class PredictionManager:
    def __init__(self, kb: Optional[KnowledgeBase] = None, c_max: int = 50,
                 fast_state: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.kb = kb or KnowledgeBase()
        self.predictors: Dict[Tuple[str, str], RTTPredictor] = {}
        self.paused: Dict[Tuple[str, str], bool] = {}
        self.plane = PredictionPlane(device=self.device)
        self.c_max = c_max
        self.fast_state = fast_state
        self.seed = seed
        # wall seconds of the lifecycle's steps: "workload" and "plane"
        # here, "collection", "correlations" and "training" in the
        # predictors, which share this timer
        self.timer = PhaseTimer()
        self._next_cycle: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def ensure_predictor(self, app: str, node: NodeWorkload) -> RTTPredictor:
        key = (app, node.node)
        if key in self.predictors:
            self.paused[key] = False          # re-enable
            self.plane.register_predictor(self.predictors[key])
            return self.predictors[key]
        pred = RTTPredictor(app, node.node, node.store, clock=node.clock,
                            c_max=self.c_max, seed=self.seed,
                            fast_state=self.fast_state, device=self.device,
                            timer=self.timer)
        self.predictors[key] = pred
        self.paused[key] = False
        return pred

    def pause(self, app: str, node: str):
        self.paused[(app, node)] = True
        # a paused predictor must not be served by full-fleet plane sweeps
        self.plane.unregister(app, node)

    # ------------------------------------------------------------------
    def router_predictors(self, app: str) -> Dict[str, RTTPredictor]:
        """Active predictors for one app, keyed by node name — the shape
        ``MorpheusRouter`` consumes.  Trained ones are (re)registered into
        the shared plane on the way out, so a router built from this dict
        can serve them all in one batched plane call."""
        out = {}
        for (a, node), p in self.predictors.items():
            if a == app and not self.paused.get((a, node)):
                self.plane.register_predictor(p)
                out[node] = p
        return out

    def make_router(self, replicas, app: str = "serve",
                    policy: str = "perf_aware", **kwargs):
        """Build a MorpheusRouter wired to this manager's knowledge base,
        predictors, and prediction plane; ``policy`` is any name in the
        port's ``core.balancer.POLICIES`` registry."""
        from repro_torch.serving.router import MorpheusRouter
        kwargs.setdefault("device", self.device)
        return MorpheusRouter(replicas, policy=policy, kb=self.kb,
                              predictors=self.router_predictors(app),
                              plane=self.plane, **kwargs)

    def online_adapter(self, retrain_every_s: float = COLLECTION_PERIOD_S,
                       **kwargs):
        """An :class:`~repro_torch.core.online.OnlineAdapter` over this
        manager's active predictors and shared plane: feed it observed
        task RTTs and call ``maybe_retrain`` to hot-swap bumped
        artifacts on the cadence (DESIGN.md §11)."""
        from repro_torch.core.online import OnlineAdapter
        adapter = OnlineAdapter(self.plane, retrain_every_s=retrain_every_s,
                                **kwargs)
        for key, pred in self.predictors.items():
            if not self.paused.get(key):
                adapter.track(pred)
        return adapter

    # ------------------------------------------------------------------
    def attach(self, node: NodeWorkload):
        """Wire task completions on a node into its predictors."""
        for a, _ in node.instances:
            self.ensure_predictor(a.name, node)

        def on_complete(task: Task):
            pred = self.predictors.get((task.app, node.node))
            if pred is None or self.paused.get((task.app, node.node)):
                return
            windows = {}
            for w in WINDOWS_S:
                arr, _ = node.store.query_window(node.store.names, w,
                                                 fast=True)
                windows[w] = arr
            pred.observe_task(task.rtt, windows)

        return on_complete

    def bootstrap_noise(self, node: NodeWorkload, load: float = 4.0,
                        duration_s: float = 60.0, on_complete=None):
        """Noisy server/client injection: temporary controlled load so the
        predictors see diverse RTTs (paper §4.4), then removed."""
        node.extra_load = load
        with self.timer.phase("workload"):
            node.run(duration_s, on_complete=on_complete)
        node.extra_load = 0.0

    # ------------------------------------------------------------------
    def run_cycles(self, node: NodeWorkload, n_cycles: int = 3,
                   cycle_s: float = COLLECTION_PERIOD_S, on_complete=None):
        """Alternate workload simulation and collection/training cycles.

        After each cycle's trainings, every trained predictor on the node
        publishes its artifact to the plane and the cycle's predictions
        run as ONE batched plane call (state retrieval amortized across
        the node's predictors, one jitted dispatch per model bucket)."""
        history = []
        for c in range(n_cycles):
            with self.timer.phase("workload"):
                node.run(cycle_s, on_complete=on_complete)
            cycle_keys = []
            for (app, nname), pred in self.predictors.items():
                if nname != node.node or self.paused.get((app, nname)):
                    continue
                notified = pred.collection_cycle()
                if notified:
                    rmse = pred.train()
                    if rmse is not None:
                        history.append((node.clock.now(), app, rmse))
                    if self.plane.register_predictor(pred) or \
                            (app, nname) in self.plane:
                        cycle_keys.append((app, nname))
                    elif pred.choice is not None:
                        # model without a functional-apply export (e.g. a
                        # test double): fall back to the serial path so
                        # the knowledge base still gets its prediction
                        rec = pred.predict()
                        if rec is not None:
                            self.kb.put(app, nname, rec.t, rec.rtt_pred)
            if cycle_keys:
                with self.timer.phase("plane"):
                    recs = self.plane.predict_all(cycle_keys)
                for (app, nname), rec in recs.items():
                    self.kb.put(app, nname, rec.t, rec.rtt_pred)
                    self.predictors[(app, nname)].predictions.append(rec)
        return history
