"""The Morpheus request router (the paper's Fig. 1 load balancer), a port
of the reference's ``serving/router.py``.

Routes each request to one replica by the configured policy.  The router
has no policy logic of its own: it builds a 1-trial
:class:`~repro_torch.core.balancer.ClusterState` of tensors on its
device from its replicas and dispatches through the ``POLICIES``
engine.  What it observes is host data (queue depths, predictions, the
pool's membership, the breakers' clock), copied to the device in one
host-to-device copy a route; the pick comes back to the host with its
score (and, when hedging, the runner-up and the hedge verdict) in one
read.  Plane-served predictions add the plane's own dispatch, and with
breakers each settled attempt makes one more copy to record its verdict.

For ``perf_aware`` every replica's RTT estimate comes from one
``PredictionPlane.predict_all`` call (replicas without a trained
predictor fall back to the knowledge base, then to a queue-depth
proxy), and a replica's queue wait is estimated as pending waves x
predicted wave RTT.  With ``hedge_factor`` the policy may also queue the
request on the runner-up replica; the earlier completion wins.

It mirrors four planes of the simulation core:

- **fallback**: every routed prediction is reconciled against the
  request's measured RTT at ``drain`` time in a
  :class:`~repro_torch.core.online.RollingAccuracy`; while the fleet's
  rolling accuracy is below ``fallback_threshold`` requests are picked by
  ``least_conn`` (predictions are still computed and reconciled, so a
  recovered fleet wins the route back);
- **capacity**: with a :class:`~repro_torch.core.capacity.CapacityConfig`
  an :class:`~repro_torch.core.capacity.EnginePool` grows and shrinks the
  active set on the simulator's rules, drained engines are masked out of
  the state (they still serve their queues), admission sheds a request
  the active set cannot bound (``route`` returns -1) and
  ``pool.ledger()`` reports (provisioned, busy, waste, shed);
- **resilience**: with a client-side
  :class:`~repro_torch.core.resilience.ResilienceConfig` replicas whose
  breaker is open leave the scoring (half-open probes stay routable), a
  completed attempt whose RTT exceeds ``timeout_s`` is a client timeout
  (the server still did the work), feeds the T = 1
  :class:`~repro_torch.core.resilience.Breakers` on the router's device
  and is retried through ``route`` while attempts remain; a timed-out
  attempt never enters the accuracy tracker;
- **flight recorder**: one trace row per routed attempt, opened at pick
  time with the score, prediction and queue-wait estimate the decision
  saw and closed at ``drain`` / settle time, packaged by
  :func:`~repro_torch.core.telemetry.trace_block`; a Prometheus-style
  :class:`~repro_torch.core.telemetry.MetricsRegistry` counts requests,
  sheds, retries, timeouts, hedges, fallbacks, in-flight attempts and
  RTTs, riding a ``MetricsStore`` when one is given.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.balancer import ClusterState, PerfAware, make_policy
from repro_torch.core.capacity import CapacityConfig, EnginePool
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.online import RollingAccuracy
from repro_torch.core.prediction_plane import PredictionPlane
from repro_torch.core.resilience import Breakers, ResilienceConfig
from repro_torch.core.telemetry import (DISP_SERVED, DISP_SHED, DISP_TIMEOUT,
                                        TRACE_FIELDS, MetricsRegistry,
                                        compose_row, trace_block)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.engine import Request, ServingEngine

_F64 = torch.float64


def _dropped_row(disposition: int) -> np.ndarray:
    """The trace row of an attempt that produced no response."""
    return compose_row(
        rep=-1.0, predicted=np.nan, score=np.nan, queue_wait=np.nan,
        raw=np.nan, base=np.nan, cold_mult=1.0, gray_mult=1.0,
        retry_s=np.nan, hedge_s=np.nan, disposition=disposition,
        response=np.nan)


class MorpheusRouter:
    """``device=None`` scores on the CUDA card (RuntimeError without
    one); ``device="cpu"`` on the CPU.  A replica whose engine runs on
    another device is refused with ``ValueError``."""

    def __init__(self, replicas: Sequence[ServingEngine],
                 policy: str = "perf_aware",
                 kb: Optional[KnowledgeBase] = None,
                 predictors: Optional[dict] = None,
                 plane: Optional[PredictionPlane] = None,
                 hedge_factor: Optional[float] = None, seed: int = 0,
                 fallback_threshold: float = 0.0,
                 accuracy_window: int = 40,
                 capacity: Optional[CapacityConfig] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 metrics_store=None, device: DeviceLike = None):
        if hedge_factor is not None and resilience is not None \
                and resilience.client_side:
            raise ValueError("hedging and client-side resilience (timeout/"
                             "retry) are mutually exclusive, as in the "
                             "simulator")
        self.device = resolve_device(device)
        for rep in replicas:
            dev = getattr(rep, "device", None)
            if dev is not None and (dev.type, dev.index or 0) != \
                    (self.device.type, self.device.index or 0):
                raise ValueError(f"replica {rep.node} runs on {dev}, the "
                                 f"router on {self.device}")
        self.replicas = list(replicas)
        self.policy_name = policy
        self.policy = make_policy(policy, seed=seed, hedge_factor=hedge_factor,
                                  device=self.device)
        self.kb = kb or KnowledgeBase()
        self.predictors = predictors or {}
        self.plane = plane or PredictionPlane(device=self.device)
        self.hedge_factor = hedge_factor
        self.routed: List[int] = []
        self.hedged: List[int] = []
        self._hedge_pairs: List[tuple] = []   # (primary, duplicate) requests
        # per-replica rolling prediction accuracy + the fallback policy
        # served while predictions are not viable
        self.fallback_threshold = float(fallback_threshold)
        self.accuracy = RollingAccuracy(accuracy_window, n=len(self.replicas))
        self.fallbacks = 0
        self._fallback_policy = make_policy("least_conn", seed=seed,
                                            device=self.device)
        self._inflight: List[Tuple[Request, int, float]] = []
        # capacity plane: elastic engine pool + admission
        self.pool = None if capacity is None \
            else EnginePool(self.replicas, capacity)
        self.shed: List[Request] = []
        # resilience plane: T = 1 breakers + the timeout / retry ledger
        # drained by _settle_resilience()
        self.resilience = resilience
        self.breaker = None
        if resilience is not None and resilience.breaker_threshold is not None:
            self.breaker = Breakers(
                1, len(self.replicas), resilience.breaker_threshold,
                resilience.breaker_cooldown_s, resilience.timeout_s,
                device=self.device)
        self.timeouts: List[Request] = []     # exhausted every attempt
        self.retries = 0                      # re-entries through route()
        self._attempt: Dict[int, int] = {}    # rid -> retries already issued
        self._res_pending: List[Tuple[Request, int]] = []
        self._timeout_ids: set = set()        # attempt objects that timed out
        # flight recorder: rows opened at pick time, closed at drain /
        # settle time; the registry rides the MetricsStore when given
        self._trace_open: Dict[int, dict] = {}     # id(req) -> open row
        self._trace_done: List[Tuple[int, np.ndarray]] = []
        self._trace_seq = 0
        self._hedge_saved: Dict[int, float] = {}   # id(primary) -> saved s
        self.registry = MetricsRegistry(store=metrics_store)
        self.m_requests = self.registry.counter("router_requests_total")
        self.m_shed = self.registry.counter("router_shed_total")
        self.m_retries = self.registry.counter("router_retries_total")
        self.m_timeouts = self.registry.counter("router_timeouts_total")
        self.m_hedges = self.registry.counter("router_hedges_total")
        self.m_fallbacks = self.registry.counter("router_fallbacks_total")
        self.m_inflight = self.registry.gauge("router_inflight")
        self.m_rtt = self.registry.histogram("router_rtt_seconds")

    # ------------------------------------------------------------------
    def _predicted_rtts(self) -> np.ndarray:
        """(R,) predicted RTTs from one plane sweep across the replicas.

        Predictors are (re-)registered first (a version check, no-op when
        unchanged), then the whole fleet is served by one
        ``PredictionPlane.predict_all``.  Replicas without a plane-served
        predictor fall back to its serial ``predict``, then to the
        knowledge base, then to a queue-depth proxy."""
        key_of = {}
        for i, rep in enumerate(self.replicas):
            p = self.predictors.get(rep.node)
            if p is not None:
                self.plane.register_predictor(p)
                key_of[(p.app, p.node)] = i
        recs = self.plane.predict_all(list(key_of)) if key_of else {}
        preds = np.full(len(self.replicas), np.inf)
        for key, rec in recs.items():
            i = key_of[key]
            self.kb.put("serve", self.replicas[i].node, rec.t, rec.rtt_pred)
            self.predictors[self.replicas[i].node].predictions.append(rec)
            preds[i] = rec.rtt_pred
        for i, rep in enumerate(self.replicas):
            if np.isfinite(preds[i]):
                continue
            p = self.predictors.get(rep.node)
            if p is not None and p.choice is not None:
                rec = p.predict()
                if rec is not None:
                    self.kb.put("serve", rep.node, rec.t, rec.rtt_pred)
                    preds[i] = rec.rtt_pred
                    continue
            v = self.kb.latest("serve", rep.node)
            preds[i] = v if v is not None else 1.0 + rep.pending()
        return preds

    def _queue_proxy(self) -> np.ndarray:
        return np.array([r.pending() for r in self.replicas], float)

    def predictions_viable(self) -> bool:
        """The fallback rule: serve perf_aware only while the mean
        rolling accuracy of the replicas with enough evidence stays at
        or above ``fallback_threshold``."""
        if self.fallback_threshold <= 0:
            return True
        tracked = self.accuracy.count >= self.accuracy.min_count
        if not tracked.any():
            return True            # no evidence of non-viability yet
        return float(self.accuracy.accuracy()[tracked].mean()) \
            >= self.fallback_threshold

    def _observe(self, needs_pred: bool):
        """What the router observes, on the host: (queue depths,
        predicted RTTs or None, queue-wait estimates, active mask or
        None)."""
        queue = self._queue_proxy()
        predicted = None
        wait_est = np.zeros(len(self.replicas))
        if needs_pred:
            predicted = self._predicted_rtts()
            waves = np.ceil(queue
                            / np.array([r.max_batch for r in self.replicas]))
            wait_est = predicted * waves
            if self.pool is not None and np.isfinite(predicted).any():
                self.pool.note_prediction(
                    float(predicted[np.isfinite(predicted)].mean()))
        active = None if self.pool is None else self.pool.active_mask()
        return queue, predicted, wait_est, active

    def _state(self, queue, predicted, wait_est, active,
               now: Optional[float] = None) -> ClusterState:
        """The observation as a 1-trial state on the router's device, in
        one host-to-device copy: the wait estimates, the queue depths,
        then the predictions, the pool's active mask and the breakers'
        clock where there are any.  With ``now``, replicas whose breaker
        is open at ``now`` leave the active set (half-open probes stay
        routable; when every breaker is open the request routes
        anyway)."""
        rows = [wait_est, queue] + [r for r in (predicted, active)
                                    if r is not None]
        if now is not None:
            rows.append(np.full(len(queue), now))
        obs = torch.as_tensor(np.stack(rows)[:, None, :], dtype=_F64,
                              device=self.device)
        extra = iter(obs[2:])
        pred = None if predicted is None else next(extra)
        act = None if active is None else next(extra) != 0
        if now is not None:
            open_m = self.breaker.open_mask(next(extra)[:, 0])
            closed = ~open_m | open_m.all(dim=1, keepdim=True)
            act = closed if act is None else act & closed
        return ClusterState(now=0.0, busy_until=obs[0], queue_depth=obs[1],
                            predicted=pred, active=act)

    def cluster_state(self, needs_pred: Optional[bool] = None
                      ) -> ClusterState:
        """The router's observable state as a 1-trial ClusterState.

        Queue wait is estimated as pending waves x predicted wave RTT
        when predictions are needed; reactive policies see zero wait
        plus the raw queue depths (classic least-connections / RR)."""
        if needs_pred is None:
            needs_pred = isinstance(self.policy, PerfAware)
        return self._state(*self._observe(needs_pred))

    def route(self, req: Request) -> int:
        """Route one request; returns the replica index, or -1 when the
        capacity plane's admission control sheds it (the request is
        recorded in ``self.shed`` and not enqueued anywhere)."""
        if self.pool is not None:
            # capacity epoch: scale decisions ride the request clock,
            # wake from zero, then gate admission
            now = self.pool.clock.now()
            self.pool.on_request(now)
            if not self.pool.admit(now):
                self.shed.append(req)
                self.m_requests.inc()
                self.m_shed.inc()
                self._trace_done.append((self._trace_seq,
                                         _dropped_row(DISP_SHED)))
                self._trace_seq += 1
                return -1
        use_pred = isinstance(self.policy, PerfAware)
        fell_back = use_pred and not self.predictions_viable()
        # predictions are still computed and reconciled while fallen
        # back, so the tracker can see a retrained fleet recover
        queue, predicted, wait_est, active = self._observe(use_pred)
        # open breakers leave the scoring (see _state)
        now = None
        if self.breaker is not None:
            now = self.replicas[0].clock.now() if self.replicas else 0.0
        state = self._state(queue, predicted, wait_est, active, now)
        # pick == argmin(mask_inactive(score)) + update, spelled out so
        # the flight recorder sees the scores the decision was made on
        if fell_back:
            self.fallbacks += 1
            self.m_fallbacks.inc()
            reactive = ClusterState(
                now=0.0, busy_until=torch.zeros_like(state.busy_until),
                queue_depth=state.queue_depth, active=state.active)
            scores = self._fallback_policy.score(reactive)
            picks = torch.argmin(reactive.mask_inactive(scores), dim=1)
            self._fallback_policy.update(reactive, picks)
        else:
            scores = self.policy.score(state)
            picks = torch.argmin(state.mask_inactive(scores), dim=1)
            self.policy.update(state, picks)
        # the pick, its score and the hedge plan come to the host in one
        # read
        hedging = self.hedge_factor is not None and use_pred \
            and not fell_back and predicted is not None
        read = [picks[0].to(_F64), scores[0, picks[0]]]
        if hedging:
            second, mask = self.policy.hedge_plan(state, picks)
            read += [second[0].to(_F64), mask[0].to(_F64)]
        read = torch.stack(read).tolist()
        i, score = int(read[0]), read[1]
        self.replicas[i].submit(req)
        self.routed.append(i)
        self.m_requests.inc()
        self.m_inflight.inc()
        self._trace_open[id(req)] = {
            "seq": self._trace_seq, "req": req, "rep": i,
            "predicted": (float(predicted[i]) if predicted is not None
                          else np.nan),
            "score": score,
            "queue_wait": float(wait_est[i]),
        }
        self._trace_seq += 1
        if self.resilience is not None and self.resilience.client_side:
            self._attempt.setdefault(req.rid, 0)
            self._res_pending.append((req, i))
        if use_pred and predicted is not None and np.isfinite(predicted[i]):
            # predicted completion (queue-wait estimate + service RTT),
            # reconciled at drain against the measured enqueue -> done
            self._inflight.append(
                (req, i, float(predicted[i] + wait_est[i])))
        if hedging and read[3]:
            # a duplicate object, not the same request: both engines
            # stamp t_done / output, and drain() keeps the earlier
            j = int(read[2])
            dup = Request(rid=req.rid, tokens=req.tokens,
                          max_new_tokens=req.max_new_tokens)
            self.replicas[j].submit(dup)
            self._hedge_pairs.append((req, dup))
            self.hedged.append(j)
            self.m_hedges.inc()
        return i

    # ------------------------------------------------------------------
    def drain(self) -> List[Request]:
        """Serve every queued request to completion (rounds over the
        replicas).

        Hedged duplicates are reconciled here: the primary takes the
        earlier of the two completions and the duplicate is dropped from
        the finished list.  Completed requests settle the accuracy
        tracker.  With a client-side resilience plane each serve round
        is followed by a settlement pass that retries timed-out attempts
        through ``route``, until no retry was issued; timed-out attempts
        are dropped from the finished list."""
        finished: List[Request] = []
        while True:
            progress = True
            while progress:
                progress = False
                for rep in self.replicas:
                    out = rep.step_wave()
                    if out:
                        finished.extend(out)
                        progress = True
            if not self._settle_resilience():
                break
        dup_ids = {id(d) for _, d in self._hedge_pairs}
        for primary, dup in self._hedge_pairs:
            if dup.t_done is not None and (
                    primary.t_done is None or dup.t_done < primary.t_done):
                if primary.t_done is not None:
                    # the time the winning duplicate saved: the row's
                    # hedge_s
                    self._hedge_saved[id(primary)] = \
                        primary.t_done - dup.t_done
                primary.t_done = dup.t_done
                primary.output = dup.output
        finished = [r for r in finished if id(r) not in dup_ids
                    and id(r) not in self._timeout_ids]
        self._hedge_pairs.clear()
        # close the served rows (after the hedge reconciliation, so the
        # response is the winning completion).  The router cannot see an
        # engine's queue / service split: the pick-time wait estimate,
        # clamped to the response, stands in for queue_wait and
        # service_base takes the rest, so qw + base - hedge_s == response
        for rid in [k for k, v in self._trace_open.items()
                    if v["req"].t_done is not None]:
            row = self._trace_open.pop(rid)
            resp = float(row["req"].rtt)
            hs = float(self._hedge_saved.pop(rid, 0.0))
            qw = min(row["queue_wait"], resp)
            self.m_inflight.dec()
            self.m_rtt.observe(resp)
            self._trace_done.append((row["seq"], compose_row(
                rep=float(row["rep"]), predicted=row["predicted"],
                score=row["score"], queue_wait=qw,
                raw=resp - qw + hs, base=resp - qw + hs,
                cold_mult=1.0, gray_mult=1.0, retry_s=0.0, hedge_s=hs,
                disposition=DISP_SERVED, response=resp)))
        still_inflight = []
        for req, i, pred in self._inflight:
            rtt = req.rtt
            if rtt is None:
                still_inflight.append((req, i, pred))
                continue
            if id(req) in self._timeout_ids:
                # the client gave up on this attempt: its RTT says nothing
                # about the prediction's quality
                continue
            err = np.zeros(len(self.replicas))
            mask = np.zeros(len(self.replicas), bool)
            err[i] = abs(pred - rtt) / max(rtt, 1e-9)
            mask[i] = True
            self.accuracy.update(err, mask)
        self._inflight = still_inflight
        self._timeout_ids.clear()
        return finished

    def _settle_resilience(self) -> bool:
        """Classify completed attempts: an RTT above ``timeout_s`` is a
        client timeout (the server did the work).  Each verdict feeds the
        breakers at the attempt's dispatch time, and a timed-out request
        re-enters ``route`` while attempts remain.  True when a retry
        was issued (the drain loop serves another round)."""
        res = self.resilience
        if res is None or not res.client_side:
            return False
        still: List[Tuple[Request, int]] = []
        retried = False
        for req, i in self._res_pending:
            if req.t_done is None:
                still.append((req, i))
                continue
            timed_out = bool(req.rtt > res.timeout_s)
            if self.breaker is not None:
                # the attempt's verdict in one host-to-device copy
                att = torch.tensor([[req.t_enqueue], [i], [not timed_out],
                                    [timed_out]], dtype=_F64,
                                   device=self.device)
                self.breaker.record(att[0], att[1].long(), att[2] != 0,
                                    att[3] != 0)
            if not timed_out:
                continue
            self._timeout_ids.add(id(req))
            row = self._trace_open.pop(id(req), None)
            if row is not None:
                # the attempt's row closes as a client timeout; a retry
                # opens its own row through route()
                self.m_inflight.dec()
                self._trace_done.append((row["seq"],
                                         _dropped_row(DISP_TIMEOUT)))
            attempt = self._attempt.get(req.rid, 0)
            if attempt < res.max_retries:
                self._attempt[req.rid] = attempt + 1
                self.retries += 1
                self.m_retries.inc()
                retry = Request(rid=req.rid, tokens=req.tokens,
                                max_new_tokens=req.max_new_tokens)
                if self.route(retry) >= 0:
                    retried = True
            else:
                self.timeouts.append(req)
                self.m_timeouts.inc()
        self._res_pending = still
        return retried

    # ------------------------------------------------------------------
    def trace(self) -> Dict:
        """Closed trace rows in route order, as the simulators' ``trace``
        block (T = 1, ``sample_every = 1``); attempts still in flight
        are left out until a ``drain`` settles them."""
        rows = [r for _, r in sorted(self._trace_done,
                                     key=lambda kv: kv[0])]
        data = (np.stack(rows)[:, None, :] if rows
                else np.empty((0, 1, len(TRACE_FIELDS))))
        return trace_block(data, len(rows), 1)
