"""Batched simulation core: the §6 request loop over dense per-trial state.

A port of the reference's ``core/simcore.py``.  The reference lowers the
serial stepper's per-request update to one ``lax.scan``; here the loop
over requests is a Python loop and every step is a handful of PyTorch
operations over dense ``(T, K)`` / ``(T, R)`` state on one device:

* replica occupancy ``busy_until`` as a dense ``(T, R)`` tensor (never
  decreases per replica);
* for the policies that score every candidate (perf_aware, oracle), an
  incremental per-(node, app) busy-count carry ``(A, T, N)`` int32 with
  its ``(T, R)`` ``counted`` mask: dispatches add to it, and each step
  pops the replicas whose work has finished in one scatter
  (``_expire``);
* the from-scratch rebuild of those counts (``recount``) at the churn
  step and at every snapshot refresh without a live carry — the one
  place a hand-written kernel runs, the per-row segment sum
  (``repro_torch.kernels.segment_sum``);
* Eq. 12 predictions from the pre-drawn ``z_pred`` noise, held on the
  device and gathered per step, with the bare app-mean basis before
  ``cold_start_s``; pick-only co-location draws for the reactive
  policies from a static mates table; hedging; the stale / outage
  snapshot; the churn busy-bump;
* workload drift: from ``t_drift`` on, the post-drift interference
  rows, node speeds and app means replace the pre-drift ones;
* the closed loop (``repro_torch.core.online``): predictions from
  per-(trial, app) ridge predictors retrained on the run's own observed
  RTTs, with the rolling-accuracy fallback to least_conn;
* the capacity plane (``repro_torch.core.capacity.ElasticSet``): the
  membership walk (autoscaler epochs, spot preemption, churn) before
  each request, scale-from-zero wakes, admission (a shed request gets a
  NaN response and ``chosen = -1``), cold replicas, drained candidates
  masked out of every policy's score, the autoscaler's service-time
  estimate and the provisioning ledger;
* the resilience plane's gray failure (the true RTT of one node per
  trial slowed inside a window, the prediction basis kept healthy),
  correlated node-group outage (the group's busy bump in the membership
  walk, then a count resync) and staleness storm (one more outage
  window of the snapshot);
* client-side resilience: a statically unrolled attempt loop per
  request (a per-attempt timeout, ``max_retries`` retries after
  exponential backoff with pre-drawn jitter, per-replica breakers from
  ``repro_torch.core.resilience.Breakers``), every dispatched attempt
  occupying its server whether or not the client still waits;
* the flight recorder: every ``sample_every``-th request's decision and
  additive RTT decomposition, a row of a ``(ceil(J / k), T, F)`` buffer
  on the device (``repro_torch.core.telemetry``).

The host knows each request's app, arrival time and every per-step flag
(snapshot refresh, membership events, drift regime, cold start, gray
window, retrain, trace sample) before the loop starts, so a step
specialises on the flags in Python.  The step itself reads its request
(app, time), the app's candidate block and its noise from device
tensors at a device step counter, which it advances; the count carry's
expiry is one scatter over the whole mask.  So the step reads nothing
back from the device: the one host sync left is the capacity plane's
completion fold (its round count, once per autoscaler epoch of a pass
without predictions).  The attempt loop runs every attempt with its
per-trial masks on the device, never stopping early.  Scalars go into
tensors by ``scatter_`` / ``fill_``, which take them as kernel
arguments: ``t[idx] = True`` on a CUDA tensor copies a CPU scalar to
the card and waits for it.

**Compiled mode.**  On the card a configuration whose step holds no
host-side state (:func:`_graphable`: baseline with every policy, the
client plane without breakers, the fleet mode) is captured once, a
block of steps in a CUDA graph (and the tail in a second one), and
replayed; the captured loops sit in an LRU cache like the reference's
(:func:`cache_stats`).  :func:`prepare_compiled` returns a closure that
reruns a loop on resident inputs, and :func:`fleet_throughput` runs the
fleet-scale mode with its noise drawn on the device.  Every other
configuration, and every CPU run, steps the same step eagerly.

**Serial-reference contract**: the reference's serial stepper is the
semantics; the port agrees with it to <= 1e-5 relative on every summary
stat for every supported config.  All float state is float64 and counts
are int32; the noise is the reference's own, drawn by numpy on the host,
so the only divergence is rounding (sums reassociated, libm ulps).  The
fleet mode draws its own noise and makes no parity claim.

The reference's multi-device ``shard_map`` dispatch has no counterpart
here yet.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.balancer import BUSY_PENALTY, POLICIES
from repro_torch.core.capacity import (CapacityConfig, ElasticSet,
                                       arrival_rates, membership_timeline)
from repro_torch.core.online import OnlineFleet, obs_window, retrain_schedule
from repro_torch.core.resilience import (Breakers, ResilienceConfig,
                                         backoff_delay)
from repro_torch.core.rng import rng_from_key, rng_seed, rng_stream
from repro_torch.core.simulator import (APPS, SimConfig, _build_cluster,
                                        _Cluster, _Metrics, unlowered)
from repro_torch.core.telemetry import (DISP_FAIL_FAST, DISP_SERVED,
                                        DISP_SHED, DISP_TIMEOUT,
                                        TRACE_FIELDS, trace_block, trace_row)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.monitoring.metrics import PeriodicRefresh

__all__ = ["supports", "run_compiled", "run_sim_compiled",
           "prepare_compiled", "fleet_throughput", "cache_stats"]


@dataclass(frozen=True)
class _Static:
    """Everything the step branches on for one (config, policy)."""
    policy: str
    n_apps: int
    k: int                       # replicas per app (candidate count)
    n_nodes: int
    hedge: Optional[float]
    accuracy: float
    reactive: bool               # policy reads neither predicted nor actual
    needs_pred: bool             # Eq. 12 / fleet predictions consumed
    closed_loop: bool            # OnlineFleet active (needs_pred implied)
    snapshot: bool               # stale/outage occupancy snapshot carried
    cold_start: bool
    churn: Optional[Tuple[float, float]]
    drift: bool
    capacity: Optional[CapacityConfig]
    resilience: Optional[ResilienceConfig]
    fallback_threshold: float
    obs_window: int              # fleet observation ring length (Wn)
    acc_window: int              # rolling-accuracy ring length (Wa)
    trace_every: int             # flight-recorder sampling stride; 0 off
    native_noise: bool = False   # noise drawn on the device (fleet mode)

    @property
    def hedging(self) -> bool:
        return self.hedge is not None and self.k >= 2

    @property
    def fallback(self) -> bool:
        return self.closed_loop and self.fallback_threshold > 0

    @property
    def admission(self) -> bool:
        return self.capacity is not None \
            and self.capacity.admission_limit_s is not None

    @property
    def pending(self) -> bool:
        """The autoscaler learns from completions (no predictions)."""
        return self.capacity is not None and not self.needs_pred

    @property
    def gray(self) -> Optional[Tuple[float, float, float]]:
        return None if self.resilience is None else self.resilience.gray

    @property
    def group(self) -> Optional[Tuple[float, float, int]]:
        """The correlated outage's (t_start_s, duration_s, n_nodes)."""
        return None if self.resilience is None \
            else self.resilience.outage_group

    @property
    def res_client(self) -> bool:
        """The timeout / retry / breaker plane is armed: the step runs
        the attempt loop."""
        return self.resilience is not None and self.resilience.client_side

    @property
    def res_breaker(self) -> bool:
        return self.resilience is not None \
            and self.resilience.breaker_threshold is not None


def supports(cfg: SimConfig, policy: str) -> Optional[str]:
    """None when :func:`run_compiled` reproduces the serial stepper for
    this (config, policy); otherwise the reason it cannot."""
    spec = POLICIES.get(policy)
    if spec is None:
        return f"unknown policy {policy!r}"
    if not spec.scan_lowered:
        return f"policy {policy!r} has no lowering in the batched step"
    return unlowered(cfg)


def _static_for(cfg: SimConfig, policy: str) -> _Static:
    spec = POLICIES[policy]
    hedge = cfg.hedge_factor if policy in ("perf_aware", "oracle") else None
    hedging = hedge is not None
    needs_pred = hedging or "predicted" in spec.requires
    closed = bool(cfg.closed_loop and needs_pred)
    snapshot = (cfg.prediction_lag_s > 0 or bool(_outages(cfg))) \
        and needs_pred
    return _Static(
        policy=policy, n_apps=len(cfg.apps), k=cfg.n_replicas_per_app,
        n_nodes=cfg.n_nodes, hedge=hedge, accuracy=cfg.accuracy,
        reactive=not hedging and not spec.requires, needs_pred=needs_pred,
        closed_loop=closed, snapshot=snapshot,
        cold_start=cfg.cold_start_s > 0, churn=cfg.churn,
        drift=cfg.t_drift is not None, capacity=cfg.capacity,
        resilience=cfg.resilience,
        fallback_threshold=cfg.fallback_threshold if closed else 0.0,
        obs_window=obs_window(cfg),
        acc_window=max(1, int(cfg.accuracy_window)),
        trace_every=0 if cfg.trace is None
        else int(cfg.trace.sample_every))


def _count_flags(st: _Static) -> Tuple[bool, bool, bool]:
    """(full_actual, need_live, need_snap): whether the step draws the
    full-K true RTT from the count carry, and which incremental count
    carries exist (``need_live`` tracks the live occupancy, ``need_snap``
    the stale snapshot).  The closed loop reads the live counts for its
    features when there is no snapshot, even where perf_aware draws no
    full-K true RTT.  The attempt loop needs the full-K row for every
    policy; without a live carry it draws it from the mates table."""
    if st.reactive:
        return False, False, False
    full_actual = st.policy != "perf_aware" \
        or (not st.closed_loop and not st.snapshot)
    need_live = full_actual or (st.closed_loop and not st.snapshot)
    return full_actual, need_live, st.snapshot


def _needs_plan(st: _Static) -> bool:
    """True when the step rebuilds counts from scratch: the resync of the
    live carry after a busy bump (churn, the correlated outage), or a
    snapshot refresh with no live carry to copy from."""
    _, need_live, need_snap = _count_flags(st)
    return (need_live and (st.churn is not None or st.group is not None)) \
        or (need_snap and not need_live)


# ----------------------------------------------------------------------
# host-side schedules (data-independent per-step flags)
def _outages(cfg: SimConfig) -> Tuple[Tuple[float, float], ...]:
    """The snapshot's frozen windows: the metric outage, and a
    resilience staleness storm as one more window."""
    out = ()
    if cfg.outage is not None:
        t0, duration = cfg.outage
        out = ((t0, t0 + duration),)
    res = cfg.resilience
    if res is not None and res.staleness is not None:
        s0, sdur = res.staleness
        out = out + ((s0, s0 + sdur),)
    return out


def _refresh_schedule(cfg: SimConfig, req_t: np.ndarray,
                      call_mask: np.ndarray) -> np.ndarray:
    """(J,) bool: steps where the snapshot recomputes.  Drives the real
    :class:`PeriodicRefresh` with the serial call pattern, so cadence and
    outage-freeze semantics cannot drift from the reference."""
    pr = PeriodicRefresh(cfg.prediction_lag_s, _outages(cfg))
    out = np.zeros(len(req_t), bool)
    for j, now in enumerate(req_t):
        if not call_mask[j]:
            continue
        token = object()
        out[j] = pr.get(float(now), lambda: token) is token
    return out


def _policy_draws(J: int, T: int, K: int, seed: int,
                  seed_blocks) -> np.ndarray:
    """(J, T, K) RandomChoice draws, bit-identical to J sequential
    ``rng.random((T, K))`` calls (PCG64 fills row-major)."""
    if seed_blocks is None:
        return rng_from_key(seed).random((J, T, K))
    parts = [rng_from_key(s).random((J, int(n), K))
             for s, n in seed_blocks]
    return np.concatenate(parts, axis=1)


def _mates_plan(node_of: np.ndarray, n_nodes: int):
    """Static co-location table: ``idx[t, n, :]`` lists the replicas
    placed on node ``n`` in trial ``t`` (padded to the fattest node,
    ``pad`` marks the padding)."""
    T, R = node_of.shape
    trial = np.arange(T)[:, None]
    counts = np.zeros((T, n_nodes), np.int64)
    np.add.at(counts, (trial, node_of), 1)
    B = max(int(counts.max()), 1)
    order = np.argsort(node_of, axis=1, kind="stable")   # (T, R)
    sorted_nodes = np.take_along_axis(node_of, order, axis=1)
    starts = np.cumsum(counts, axis=1) - counts          # (T, n_nodes)
    slot = np.arange(R)[None, :] \
        - np.take_along_axis(starts, sorted_nodes, axis=1)
    idx = np.zeros((T, n_nodes, B), np.int64)
    pad = np.ones((T, n_nodes, B), bool)
    idx[trial, sorted_nodes, slot] = order
    pad[trial, sorted_nodes, slot] = False
    return idx, pad


# ----------------------------------------------------------------------
# lowering: cluster -> (static, device inputs, host plan)
def _core_consts(st: _Static, node_of: np.ndarray, app_of: np.ndarray,
                 req_app: np.ndarray, req_t: np.ndarray, irow: np.ndarray,
                 speed: np.ndarray, cand_node: np.ndarray,
                 mean_rtt: np.ndarray) -> Dict[str, np.ndarray]:
    """The inputs every step reads: the placement, the per-app imat rows
    (A, T, A), candidate speeds (A, T, K) and nodes, the mates table,
    the app means and their logs, the request stream the step reads at
    its device counter (``app``, ``t``), and, with a count carry, its
    flat indices (:func:`_count_index`)."""
    A, K, N = st.n_apps, st.k, st.n_nodes
    mate_idx, mate_pad = _mates_plan(node_of, N)
    mean_rtt = np.asarray(mean_rtt, float)
    consts = {"node_of": node_of, "imat": irow, "speed": speed,
              "cand_node": cand_node, "mate_idx": mate_idx,
              "mate_app": app_of[mate_idx].astype(np.int64),
              "mate_pad": mate_pad, "app": req_app, "t": req_t,
              "log_rbar": np.log(mean_rtt), "mean_rtt": mean_rtt}
    _, need_live, need_snap = _count_flags(st)
    if need_live or need_snap:
        consts["exp_idx"], consts["cnt_base"] = _count_index(node_of, A, K,
                                                             N)
    return consts


def _plan(req_app: np.ndarray, req_t: np.ndarray, mean_rtt) -> Dict:
    """The host's copy of the request stream and the per-step flags, all
    off (``_lower`` sets the ones a configuration has)."""
    J = len(req_t)
    return {
        "req_app": req_app,
        "req_t": req_t,
        "mean_rtt": [float(m) for m in mean_rtt],
        "bump": np.zeros(J, bool),
        "refresh": np.zeros(J, bool),
        "drift": np.zeros(J, bool),
        "cold": np.zeros(J, bool),
        "gray": np.zeros(J, bool),
        "retrain": np.zeros(J, bool),
        # step -> [(kind, t, event index)]: the membership events that
        # pop before the step's request routes, in the serial heap order
        "events": {},
    }


def _lower(cluster: _Cluster, policy: str, seed_blocks=None):
    cfg = cluster.cfg
    st = _static_for(cfg, policy)
    T, J = cfg.n_trials, cfg.n_requests
    A, K, N = st.n_apps, st.k, st.n_nodes
    if not np.array_equal(cluster.app_of, np.repeat(np.arange(A), K)):
        raise ValueError("simcore requires the contiguous app layout "
                         "_build_cluster produces (app_of = repeat)")
    node_of = np.asarray(cluster.node_of, np.int64)
    req_t = np.asarray(cluster.req_t, float)
    req_app = np.asarray(cluster.req_app, np.int64)
    trial = np.arange(T)
    cand_node = np.stack([node_of[:, a * K:(a + 1) * K] for a in range(A)])

    def regime(imat, accel):
        """Per-app imat rows (A, T, A) and candidate speeds (A, T, K) of
        one interference / speed regime."""
        imat = np.asarray(imat, float)
        irow = np.stack([imat[:, a, :] if imat.ndim == 3
                         else np.broadcast_to(imat[a], (T, A))
                         for a in range(A)])
        speed = 1.0 + np.asarray(accel)[trial[None, :, None], cand_node]
        return irow, speed

    irow, speed = regime(cluster.imat, cluster.accel)
    consts = _core_consts(st, node_of, cluster.app_of, req_app, req_t, irow,
                          speed, cand_node, cluster.mean_rtt)
    consts["z"] = np.ascontiguousarray(cluster.z_rtt.T)          # (J, T)
    if st.needs_pred and not st.closed_loop:
        # (T, J, R), read a step at its (J·A)-row of app blocks
        consts["z_pred"] = np.ascontiguousarray(cluster.z_pred, float)
        consts["zp_row"] = np.arange(J) * A + req_app
    if st.policy == "random":
        consts["draw"] = _policy_draws(J, T, K, rng_seed(cfg.seed, "policy"),
                                       seed_blocks)
    if _needs_plan(st):
        consts["na_key"] = (node_of * A + cluster.app_of[None, :]
                            ).astype(np.int32)
    plan = _plan(req_app, req_t, cluster.mean_rtt)
    cap = st.capacity
    events = membership_timeline(float(req_t[-1]), churn=cfg.churn,
                                 capacity=cap, preempt=cfg.preempt,
                                 outage_group=st.group)
    ev_t = [ev.t for ev in events]
    # an event pops at the first request with now >= t
    for i, (ev, jj) in enumerate(zip(
            events, np.searchsorted(req_t, ev_t, side="left"))):
        plan["events"].setdefault(int(jj), []).append((ev.kind, ev.t, i))
        plan["bump"][jj] |= ev.kind in ("churn", "group_down")
    if st.churn is not None:
        consts["down"] = node_of == np.asarray(cluster.failed_node)[:, None]
    if st.group is not None:
        consts["gdown"] = np.asarray(cluster.group_rep, bool)
    if st.res_client and st.resilience.max_retries > 0:
        consts["zj"] = np.ascontiguousarray(
            np.asarray(cluster.z_jitter, float).transpose(1, 0, 2))
    if cap is not None:
        consts["ev_rate"] = arrival_rates(cap, req_t, req_app, A, ev_t)
        if cfg.preempt is not None:
            consts["hit"] = node_of \
                == np.asarray(cluster.preempted_node)[:, None]
    if st.gray is not None:
        g0, gdur, _ = st.gray
        consts["gray_rep"] = np.asarray(cluster.gray_rep, bool)
        plan["gray"] = (req_t >= g0) & (req_t < g0 + gdur)
    if st.drift:
        def post(name):
            v = getattr(cluster, f"{name}_post")
            return getattr(cluster, name) if v is None else v
        irow_p, speed_p = regime(post("imat"), post("accel"))
        consts.update(imat_post=irow_p, speed_post=speed_p,
                      log_rbar_post=np.log(np.asarray(post("mean_rtt"),
                                                      float)))
        plan["drift"] = req_t >= cfg.t_drift
    if st.cold_start:
        plan["cold"] = req_t < cfg.cold_start_s
    if st.snapshot:
        # the Eq. 12 path consults the snapshot only past cold start;
        # the closed loop at every step
        call = np.ones(J, bool) if st.closed_loop else ~plan["cold"]
        plan["refresh"] = _refresh_schedule(cfg, req_t, call)
    if st.closed_loop:
        plan["retrain"] = retrain_schedule(cfg, req_t)
    return st, consts, plan


def _lognormal(inter, log_rbar, z):
    """Log-normal moment matching with s = rbar * (0.1 + inter)."""
    v = 0.1 + inter
    u = torch.log1p(v * v)
    return torch.exp(log_rbar - 0.5 * u + torch.sqrt(u) * z)


def _pick(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """m[trial, idx[trial]] for (T, K) m and (T,) idx."""
    return m.gather(1, idx[:, None])[:, 0]


def _count_index(node_of: np.ndarray, A: int, K: int, N: int):
    """Flat indices into an (A, T, N) count carry: ``idx`` (T, R) is each
    replica's (app, trial, node) cell under the contiguous app layout,
    ``base`` (A, T) the first cell of each (app, trial) row."""
    T, R = node_of.shape
    base = (np.arange(A)[:, None] * T + np.arange(T)[None, :]) * N
    idx = base[np.arange(R) // K].T + np.asarray(node_of, np.int64)
    return np.ascontiguousarray(idx), base


def _expire(cnt: torch.Tensor, counted: torch.Tensor,
            busy_src: torch.Tensor, now, idx: torch.Tensor) -> None:
    """Pop every counted replica whose work finished by ``now``, in
    place: -1 at each one's flat count index ``idx`` (T, R)
    (:func:`_count_index`) in one scatter, then its ``counted`` bit
    cleared.  Integer adds give the same counts in any order, so one
    pass over the whole mask does what the reference's rounds (two pops
    an app block a round, behind a loop on the rest) do, and reads
    nothing back."""
    R = busy_src.shape[1]
    ex = (busy_src <= now) & counted[:, :R]
    cnt.view(-1).scatter_add_(0, idx.view(-1),
                              ex.view(-1).to(cnt.dtype).neg_())
    counted[:, :R].bitwise_xor_(ex)


def _graphable(st: _Static) -> bool:
    """True when every step of the loop is the same device work with no
    host read, so that a block of steps can be captured in a CUDA graph
    and replayed.  Excluded, each because its step reads the host:

    * the capacity plane (``ElasticSet``): the membership walk runs on
      host-known steps, wakes and the autoscaler's folds take the
      request's app and time from the host, and a pass without
      predictions reads the completion fold's round count;
    * the closed loop (``OnlineFleet``): its folds and retrains run on
      host-known steps and index by the host's app;
    * membership events (churn, the correlated outage): a host-known
      step bumps ``busy`` and rebuilds the counts;
    * breakers: their open mask and verdicts take the app's replica
      block as a host slice;
    * the snapshot (stale predictions, outages, a staleness storm): it
      refreshes on host-known steps;
    * drift, cold start and the gray window: a host-known per-step flag
      picks the step's branch, and a graph replays one branch for every
      step;
    * the flight recorder: it writes a row on host-known sampled steps.

    Baseline with each policy (hedging included), the client plane
    without breakers, and the fleet mode are graphable."""
    return (st.capacity is None and not st.closed_loop
            and st.churn is None and st.group is None
            and not st.res_breaker and not st.snapshot and not st.drift
            and not st.cold_start and st.gray is None
            and not st.trace_every)


def _blocks(J: int, G: int):
    """(first step, length) of each block of the loop: J // G blocks of
    G steps, then the J mod G tail."""
    out = [(j0, G) for j0 in range(0, J - J % G, G)]
    if J % G:
        out.append((J - J % G, J % G))
    return out


def _new_carry(st: _Static, T: int, J: int, dev) -> Dict:
    """The loop's state, each tensor written in place by the step (a
    captured graph replays fixed addresses): the device step counter
    ``step``, ``busy`` (T, R), the round-robin ``cursor``, the live count
    carry ``cnt`` (A, T, N) with its (T, R + 1) ``counted`` mask (the
    spare column absorbs masked-out dispatches), the fallback routings
    ``fallback`` (T,) and the (J, T) outputs ``ys``."""
    A, K = st.n_apps, st.k
    f64 = dict(dtype=torch.float64, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    s = {"step": torch.zeros(1, dtype=torch.int64, device=dev),
         "busy": torch.zeros((T, A * K), **f64),
         "fallback": torch.zeros(T, dtype=torch.int64, device=dev)}
    if st.policy == "round_robin":
        s["cursor"] = torch.zeros(T, dtype=torch.int64, device=dev)
    if _count_flags(st)[1]:
        s["cnt"] = torch.zeros((A, T, st.n_nodes), dtype=torch.int32,
                               device=dev)
        s["counted"] = torch.zeros((T, A * K + 1), **b)
    ys = {"resp": torch.zeros((J, T), **f64),
          "rtt": torch.zeros((J, T), **f64),
          "rep": torch.zeros((J, T), dtype=torch.int64, device=dev),
          "shed": torch.zeros((J, T), **b),
          "hmask": torch.zeros((J, T), **b),
          "rtt2": torch.zeros((J, T), **f64)}
    if st.res_client:
        # every attempt timed out; dispatched attempts; their service
        # time (the work the servers did, answered or not)
        ys.update(tout=torch.zeros((J, T), **b),
                  att=torch.zeros((J, T), **f64),
                  bwork=torch.zeros((J, T), **f64))
    s["ys"] = ys
    return s


def _reset(s: Dict) -> None:
    for v in list(s.values()) + list(s["ys"].values()):
        if isinstance(v, torch.Tensor):
            v.zero_()


# ----------------------------------------------------------------------
# the request loop
def _step_fn(st: _Static, c: Dict[str, torch.Tensor], plan, s: Dict,
             gen: Optional[torch.Generator] = None):
    """The request loop's step over the carry ``s``.  Returns ``(block,
    finish)``: ``block(j0, n)`` runs the ``n`` steps from step ``j0`` —
    ``j0`` None while a CUDA graph captures them, when the step reads no
    host schedule (a ``_graphable`` configuration has none) — and
    ``finish()`` the final state: ``busy`` (T, R), the outputs ``ys``,
    ``syncs`` (the completion folds' host reads), ``fallback`` (T,)
    (routings by the least_conn fallback), in the closed loop the
    ``fleet``, with a capacity plane the ``elastic`` replica set, with
    breakers the ``breakers`` and with the flight recorder the ``trace``
    buffer.

    One step body serves the eager loop and the graph: it reads its
    request (app, time), the app's candidate block and its noise from
    device tensors at the device counter ``s["step"]``, which it
    advances.  Only the host-driven planes and the host-known per-step
    flags read the host's copy of the step.  With ``st.native_noise``
    each block draws its noise from ``gen`` on the device."""
    dev = c["node_of"].device
    f64, i32 = torch.float64, torch.int32
    A, K, N = st.n_apps, st.k, st.n_nodes
    R = A * K
    T = c["node_of"].shape[0]
    J = len(plan["req_t"])
    full_actual, need_live, need_snap = _count_flags(st)
    res = st.resilience
    trial = torch.arange(T, device=dev)
    colK = torch.arange(K, device=dev)[None, :]
    ctr, busy, ys = s["step"], s["busy"], s["ys"]
    busy3 = busy.view(T, A, K)
    cnt, counted = s.get("cnt"), s.get("counted")
    cursor, fallback = s.get("cursor"), s["fallback"]
    # (imat rows, candidate speeds, log mean RTTs) before and after drift
    pre = (c["imat"], c["speed"], c["log_rbar"])
    post = (c["imat_post"], c["speed_post"], c["log_rbar_post"]) \
        if st.drift else pre
    zp = c["z_pred"].view(T, -1, K) if "z_pred" in c else None
    snap = s_cnt = s_cted = None       # until the snapshot first refreshes
    fleet = OnlineFleet(N, A, T, J, plan["mean_rtt"],
                        obs_window=st.obs_window, acc_window=st.acc_window,
                        device=dev) \
        if st.closed_loop else None
    elastic = ElasticSet(st.capacity, A, K, T, plan["mean_rtt"],
                         rates=c["ev_rate"], hit=c.get("hit"),
                         req_app=c["app"] if st.pending else None,
                         n_requests=J, device=dev) \
        if st.capacity is not None else None
    breakers = Breakers(T, R, res.breaker_threshold, res.breaker_cooldown_s,
                        res.timeout_s, device=dev) \
        if st.res_breaker else None
    k_tr = st.trace_every
    trace = torch.full((-(-J // k_tr), T, len(TRACE_FIELDS)), float("nan"),
                       dtype=f64, device=dev) if k_tr else None

    def at(name, j):
        """Step ``j``'s host-known flag ``name`` (none while capturing)."""
        return j is not None and bool(plan[name][j])

    def put(name, v):
        """Write the (T,) output ``name`` at the device counter's row."""
        ys[name].index_copy_(0, ctr, v[None])

    def recount(busy_src, now):
        """From-scratch (A, T, N) busy counts and the (T, R + 1)
        counted mask (its spare column absorbs masked-out pops)."""
        busyb = busy_src > now
        flat = segment_sum(busyb.to(f64), c["na_key"], N * A)  # (T, N·A)
        new_cnt = flat.view(T, N, A).permute(2, 0, 1).to(i32).contiguous()
        new_cted = torch.zeros((T, R + 1), dtype=torch.bool, device=dev)
        new_cted[:, :R] = busyb
        return new_cnt, new_cted

    def rtt_full(sel, counts, z):
        """True RTT over the app's whole candidate row (T, K) from the
        per-(node, app) counts contracted with the app's imat row."""
        iw = sel["imat"]                                   # (T, A)
        w_cnt = counts[0] * iw[:, 0:1]                     # (T, N)
        for a_ in range(1, A):
            w_cnt = w_cnt + counts[a_] * iw[:, a_:a_ + 1]
        inter = w_cnt.gather(1, sel["cand"])
        return _lognormal(inter, sel["lr"], z[:, None]) * sel["speed"]

    def rtt_at(sel, busy_src, now, z, cand):
        """True RTT at candidate slots ``cand`` (T, Kq), summing the
        busy co-located replicas from the static mates table."""
        nodes = sel["cand"].gather(1, cand)                # (T, Kq)
        sp = sel["speed"].gather(1, cand)
        t_ = trial[:, None]
        mi = c["mate_idx"][t_, nodes]                      # (T, Kq, B)
        ma = c["mate_app"][t_, nodes]
        mp = c["mate_pad"][t_, nodes]
        w = sel["imat"].gather(1, ma.reshape(T, -1)).view(ma.shape)
        bg = busy_src.gather(1, mi.reshape(T, -1)).view(mi.shape)
        inter = torch.where((bg > now) & ~mp, w, 0.0).sum(-1)
        return _lognormal(inter, sel["lr"], z[:, None]) * sp

    def served_at(sel, busy_src, now, z, idx, coldm, graym):
        """(raw, served) true RTT of the replica at slot ``idx`` (T,): the
        pick-only draw, and the same after the cold and gray
        multipliers."""
        raw = rtt_at(sel, busy_src, now, z, idx[:, None])[:, 0]
        rtt = raw
        if coldm is not None:
            rtt = rtt * _pick(coldm, idx)
        if graym is not None:
            rtt = rtt * _pick(graym, idx)
        return raw, rtt

    def base_at(sel, z, idx):
        """The trace's service base: the zero-interference draw on the
        tier of slot ``idx`` (T,)."""
        return _lognormal(torch.zeros_like(z), sel["lr"], z) \
            * _pick(sel["speed"], idx)

    def count_dispatch(sel, r, idx, sent):
        """+1 on the live count carry per newly busy replica ``r`` (T,),
        the app's slot ``idx``, where ``sent`` (None: every trial).  A
        replica with queued work is already counted."""
        add = ~_pick(counted, r)
        if sent is not None:
            add &= sent
            r = torch.where(sent, r, R)
        cnt.view(-1).scatter_add_(0, sel["cbase"] + _pick(sel["cand"], idx),
                                  add.to(i32))
        counted.scatter_(1, r[:, None], True)

    def picked(m, idx, default):
        return default if m is None else _pick(m, idx)

    def score(busy_c, t, sig, draw):
        """The policy's score of the app's candidates at time ``t`` (the
        request's ``now``, or each trial's attempt time as (T, 1)):
        queue wait + ``sig``, or without a signal the reactive rules."""
        if sig is not None:
            return (busy_c - t).clamp(min=0.0) + sig
        if st.policy == "least_conn":
            return busy_c - t
        alt = torch.remainder(colK - cursor[:, None], K).to(f64) \
            if st.policy == "round_robin" else draw
        return torch.where(busy_c <= t, alt,
                           BUSY_PENALTY + (busy_c - t).clamp(min=0.0))

    def step(j, i, noise):
        nonlocal snap, s_cnt, s_cted
        a1 = c["app"].index_select(0, ctr)                # (1,)
        now = c["t"].index_select(0, ctr)                 # (1,)
        a0 = a1 * K
        if j is not None:
            # the host's copy of the request, for the host-driven planes
            a_h, now_h = int(plan["req_app"][j]), float(plan["req_t"][j])
        reg = post if at("drift", j) else pre
        tracing = bool(k_tr) and j is not None and j % k_tr == 0
        # membership events, in heap order: a later epoch sees the busy
        # bump of an earlier churn or group outage in the same walk
        for kind, t_ev, ev in (plan["events"].get(j, ()) if j is not None
                               else ()):
            if kind == "churn":
                # the failed node's replicas stay busy until it is back
                t_up = st.churn[0] + st.churn[1]
                busy.copy_(torch.where(c["down"], busy.clamp(min=t_up),
                                       busy))
            elif kind == "group_down":
                # the correlated outage: churn's bump, group-wide
                g0, gdur, _ = st.group
                busy.copy_(torch.where(c["gdown"],
                                       busy.clamp(min=g0 + gdur), busy))
            elif kind == "scale":
                elastic.decide(t_ev, ev, busy, j)
            elif kind == "preempt_down":
                elastic.preempt(t_ev, busy)
            else:                                          # preempt_up
                elastic.restore()
        # the request's app: its candidate block and per-app rows
        busy_c = busy3.index_select(1, a1)[:, 0]
        sel = {"imat": reg[0].index_select(0, a1)[0],
               "speed": reg[1].index_select(0, a1)[0],
               "lr": reg[2].index_select(0, a1),
               "cand": c["cand_node"].index_select(0, a1)[0]}
        if need_live:
            sel["cbase"] = c["cnt_base"].index_select(0, a1)[0]
        act_c = coldm = served = None
        if elastic is not None:
            act_c = elastic.wake(a_h, now_h)
            if st.admission:
                # shed where even the best active queue wait is too long
                best = torch.where(act_c, (busy_c - now).clamp(min=0.0),
                                   float("inf")).amin(1)
                served = best <= st.capacity.admission_limit_s
                put("shed", ~served)
            coldm = elastic.cold_mult(a_h, now_h)
        # gray failure: the true RTT only; predictions keep the healthy
        # view the replica still advertises
        graym = torch.where(
            c["gray_rep"].view(T, A, K).index_select(1, a1)[:, 0],
            st.gray[2], 1.0) if at("gray", j) else None

        if need_live:
            if at("bump", j):
                new_cnt, new_cted = recount(busy, now)
                cnt.copy_(new_cnt)
                counted.copy_(new_cted)
            _expire(cnt, counted, busy, now, c["exp_idx"])
        if need_snap:
            if at("refresh", j):
                snap = busy.clone()
                if need_live:
                    # at a refresh snap == busy: copy the live carry
                    s_cnt, s_cted = cnt.clone(), counted.clone()
                else:
                    s_cnt, s_cted = recount(busy, now)
            if snap is not None:
                _expire(s_cnt, s_cted, snap, now, c["exp_idx"])
        z = c["z"].index_select(0, ctr)[0] if noise is None \
            else noise["z"][i]
        draw = None
        if st.policy == "random":
            draw = c["draw"].index_select(0, ctr)[0] if noise is None \
                else noise["draw"][i]

        hmask = predicted = None
        if st.reactive and not st.res_client:
            sc = score(busy_c, now, None, draw)
            sc_m = sc if act_c is None \
                else torch.where(act_c, sc, float("inf"))
            picks = torch.argmin(sc_m, dim=1)
            if st.policy == "round_robin":
                cursor.copy_((picks + 1) % K)
            raw_pick, rtt_pick = served_at(sel, busy, now, z, picks,
                                           coldm, graym)
        else:
            actual = actual_raw = None
            if full_actual or st.res_client:
                # the attempt loop reads the full row for every policy:
                # from the count carry where one exists, else from the
                # mates table (the same sum, reassociated)
                actual_raw = rtt_full(sel, cnt, z) if need_live \
                    else rtt_at(sel, busy, now, z, colK.expand(T, K))
                actual = actual_raw if coldm is None \
                    else actual_raw * coldm
            if st.closed_loop:
                # the serial order: fold the completed predictions into
                # the trackers, retrain, then predict from the features
                prev = float(plan["req_t"][j - 1]) if j else -np.inf
                fleet.fold_pending(j, now_h, prev, c["app"])
                if at("retrain", j):
                    fleet.retrain(now_h)
                counts_src = s_cnt if st.snapshot else cnt
                if st.res_client and not st.snapshot:
                    # the attempts' dispatches move the live counts; the
                    # fleet observes the features the request saw
                    counts_src = cnt.clone()
                fleet_pred = fleet.predict(a_h, counts_src, sel["cand"])
                predicted = fleet_pred
                if st.fallback:
                    # a non-viable trial scores by queue wait alone
                    ok = fleet.viable(a_h, st.fallback_threshold)
                    predicted = torch.where(ok[:, None], fleet_pred, 0.0)
                    fallback.add_(~ok)
            elif st.needs_pred:
                if at("cold", j) or st.snapshot:
                    if at("cold", j):
                        # no predictor has trained yet: the app-mean RTT
                        basis = c["mean_rtt"].index_select(0, a1) \
                            .expand(T, K)
                    else:
                        basis = rtt_full(sel, s_cnt, z)
                    if coldm is not None:
                        # the predictor knows which replicas are cold
                        basis = basis * coldm
                else:
                    basis = actual
                eps = (1.0 - st.accuracy) * basis
                zc = zp.index_select(1, c["zp_row"].index_select(0, ctr)
                                     )[:, 0] if noise is None \
                    else noise["zc"][i]
                predicted = basis + eps * zc
            if graym is not None and actual is not None:
                actual = actual * graym
            sig = predicted if st.policy == "perf_aware" else actual
            if not st.res_client:
                sc = score(busy_c, now, sig, draw)
                sc_m = sc if act_c is None \
                    else torch.where(act_c, sc, float("inf"))
                picks = torch.argmin(sc_m, dim=1)
                if full_actual:
                    raw_pick, rtt_pick = _pick(actual_raw, picks), \
                        _pick(actual, picks)
                else:
                    raw_pick, rtt_pick = served_at(sel, busy, now, z, picks,
                                                   coldm, graym)
                if st.hedging:
                    # runner-up by score; hedge when the pick's signal
                    # exceeds hedge x the best busy replica's completion
                    second = torch.argmin(
                        sc_m.scatter(1, picks[:, None], float("inf")), dim=1)
                    busy_sc = torch.where(busy_c > now, sc, float("inf"))
                    if act_c is not None:
                        # a drained replica can neither take the
                        # duplicate nor be waited on
                        busy_sc = torch.where(act_c, busy_sc, float("inf"))
                    hmask = _pick(sig, picks) > st.hedge * busy_sc.amin(1)
                    if act_c is not None:
                        hmask &= _pick(act_c, second)
                    if served is not None:
                        hmask &= served

        if st.res_client:
            # the attempt loop, unrolled: each attempt rescores at its
            # per-trial attempt time ``t_att`` over the request's one
            # true-RTT row; a dispatched attempt occupies its server for
            # its whole service time whether or not the client waits
            timeout = res.timeout_s
            live = served if served is not None \
                else torch.ones(T, dtype=torch.bool, device=dev)
            success = torch.zeros(T, dtype=torch.bool, device=dev)
            t_att = now.expand(T).clone()
            picks = torch.zeros(T, dtype=torch.int64, device=dev)
            rtt_pick = torch.zeros(T, dtype=f64, device=dev)
            finish = torch.zeros_like(rtt_pick)
            work = torch.zeros_like(rtt_pick)
            n_att = torch.zeros_like(rtt_pick)
            if res.max_retries > 0:
                zj = c["zj"].index_select(0, ctr)[0]      # (T, retries)
            if tracing:
                # the successful attempt's score, start and queue wait
                sc_ok, t_ok, qw_ok = (torch.zeros_like(rtt_pick)
                                      for _ in range(3))
            for att in range(1 + res.max_retries):
                mask = act_c
                if breakers is not None:
                    # an open breaker is unroutable; half-open probes go
                    shut = breakers.open_mask(t_att,
                                              slice(a_h * K, a_h * K + K))
                    mask = ~shut if mask is None else mask & ~shut
                dispatch = live & ~success
                if mask is not None:
                    dispatch &= mask.any(1)
                sc = score(busy_c, t_att[:, None],
                           None if st.reactive else sig, draw)
                p_i = torch.argmin(sc if mask is None else torch.where(
                    mask, sc, float("inf")), dim=1)
                rtt_i = _pick(actual, p_i)
                b_pick = _pick(busy_c, p_i)
                qwait = (b_pick - t_att).clamp(min=0.0)
                resp_i = qwait + rtt_i
                ok = dispatch & (resp_i <= timeout)
                hit = (colK == p_i[:, None]) & dispatch[:, None]
                busy_c = torch.where(hit, (torch.maximum(t_att, b_pick)
                                           + rtt_i)[:, None], busy_c)
                work = work + torch.where(dispatch, rtt_i, 0.0)
                n_att = n_att + dispatch
                if st.policy == "round_robin":
                    cursor.copy_(torch.where(dispatch, (p_i + 1) % K,
                                             cursor))
                if need_live:
                    count_dispatch(sel, a0 + p_i, p_i, dispatch)
                if breakers is not None:
                    breakers.record(t_att, a0 + p_i, ok, dispatch & ~ok)
                picks = torch.where(ok, p_i, picks)
                rtt_pick = torch.where(ok, rtt_i, rtt_pick)
                finish = torch.where(ok, t_att + resp_i, finish)
                if tracing:
                    sc_ok = torch.where(ok, _pick(sc, p_i), sc_ok)
                    t_ok = torch.where(ok, t_att, t_ok)
                    qw_ok = torch.where(ok, qwait, qw_ok)
                success = success | ok
                if att < res.max_retries:
                    delay = backoff_delay(res, att, zj[:, att])
                    # a dispatched attempt fails only at its timeout; a
                    # fail-fast one (no routable candidate) backs off at
                    # once, which is how breakers arrest a retry storm
                    t_att = torch.where(dispatch, t_att + timeout + delay,
                                        t_att + delay)
            busy3.index_copy_(1, a1, busy_c[:, None])
            timed_out = live & ~success
            resp = torch.where(success, finish - now, float("nan"))
            served = success         # only completed requests are observed
            put("tout", timed_out)
            put("att", n_att)
            put("bwork", work)
            if tracing:
                disp = torch.where(timed_out, torch.where(
                    n_att == 0, DISP_FAIL_FAST, DISP_TIMEOUT), DISP_SERVED)
                disp = torch.where(live, disp, DISP_SHED)
                row = dict(predicted=picked(predicted, picks, float("nan")),
                           score=sc_ok, queue_wait=qw_ok,
                           raw=_pick(actual_raw, picks), retry_s=t_ok - now,
                           hedge_s=0.0)
        else:
            # commit: only the app's K-column block changes
            b_pick = _pick(busy_c, picks)
            finish = torch.maximum(b_pick, now) + rtt_pick
            take = colK == picks[:, None]
            if served is not None:
                take &= served[:, None]
            new_c = torch.where(take, finish[:, None], busy_c)
            hedge_s = 0.0
            if hmask is not None:
                rtt2 = _pick(actual, second) if full_actual \
                    else served_at(sel, busy, now, z, second, coldm,
                                   graym)[1]
                finish2 = torch.maximum(_pick(busy_c, second), now) + rtt2
                first = torch.where(hmask, torch.minimum(finish, finish2),
                                    finish)
                resp = first - now
                hedge_s = torch.where(hmask, finish - first, 0.0)
                new_c = torch.where((colK == second[:, None])
                                    & hmask[:, None], finish2[:, None], new_c)
                put("hmask", hmask)
                put("rtt2", rtt2)
            else:
                resp = finish - now
            disp = DISP_SERVED
            if served is not None:
                resp = torch.where(served, resp, float("nan"))
                disp = torch.where(served, DISP_SERVED, DISP_SHED)
            busy3.index_copy_(1, a1, new_c[:, None])
            if tracing:
                row = dict(predicted=picked(predicted, picks, float("nan")),
                           score=_pick(sc, picks),
                           queue_wait=(b_pick - now).clamp(min=0.0),
                           raw=raw_pick, retry_s=0.0, hedge_s=hedge_s)
        rep = a0 + picks
        if st.closed_loop:
            # the routed request trains the fleet: the pick's features
            # (counts before this dispatch), true RTT and completion
            fleet.observe(j, a_h, counts_src, _pick(sel["cand"], picks),
                          rtt_pick, finish, _pick(fleet_pred, picks), served)
        if elastic is not None:
            # the autoscaler's signal: the routed prediction (the fleet's
            # raw one in the closed loop), else the observed completion
            elastic.check_routed(rep, served)
            if st.needs_pred:
                src = fleet_pred if st.closed_loop else predicted
                elastic.note_prediction(a_h, _pick(src, picks), served)
            else:
                elastic.note_completion(j, rtt_pick, finish, served)
        if need_live and not st.res_client:
            # after the fleet has read the counts before the dispatch; a
            # shed request dispatches nothing
            count_dispatch(sel, rep, picks, served)
            if hmask is not None:
                count_dispatch(sel, a0 + second, second, hmask)
        if tracing:
            trace[j // k_tr] = trace_row(
                rep=rep, base=base_at(sel, z, picks),
                cold_mult=picked(coldm, picks, 1.0),
                gray_mult=picked(graym, picks, 1.0), disposition=disp,
                response=resp, **row)
        put("resp", resp)
        put("rtt", rtt_pick)
        put("rep", rep)
        ctr.add_(1)

    def block(j0: Optional[int], n: int) -> None:
        noise = None
        if st.native_noise:
            # the block's noise, drawn on the device in three calls
            kw = dict(generator=gen, dtype=f64, device=dev)
            noise = {"z": torch.randn((n, T), **kw)}
            if st.needs_pred:
                noise["zc"] = torch.randn((n, T, K), **kw)
            if st.policy == "random":
                noise["draw"] = torch.rand((n, T, K), **kw)
        for i in range(n):
            step(None if j0 is None else j0 + i, i, noise)

    def finish():
        if st.closed_loop:
            # everything has completed: the serial run's final fold
            fleet.fold_pending(J, np.inf, float(plan["req_t"][-1]),
                               c["app"])
        return {"busy": busy, "ys": ys, "fallback": fallback,
                "syncs": 0 if elastic is None else elastic.syncs,
                "fleet": fleet, "elastic": elastic, "trace": trace,
                "breakers": breakers}

    return block, finish


# ----------------------------------------------------------------------
# compiled loops: captured on the card, cached
#: steps in one captured block; the J mod _BLOCK tail is a second graph
_BLOCK = 64
#: LRU-bounded cache of compiled loops, as the reference's: one entry per
#: (_Static, graph or eager, device, input shapes)
_FN_CACHE_MAX = 128
_FN_CACHE: "OrderedDict[Tuple, _Loop]" = OrderedDict()
_FN_STATS = {"hits": 0, "misses": 0, "evictions": 0}


class _Loop:
    """A compiled request loop: the step of one ``_Static`` at one set of
    input shapes.  On the card, for a ``_graphable`` configuration, it
    holds static copies of the inputs, the carry and the outputs, and
    CUDA graphs of a block of ``G`` steps and of the J mod G tail,
    captured on its first run and replayed on every later run.  Every
    other configuration, and every CPU run, steps eagerly."""

    def __init__(self, st: _Static, J: int, G: int, graph: bool):
        self.st, self.J, self.G, self.graph = st, J, G, graph
        self.graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        self.c = self.s = self.gen = self.block = self.finish = None

    def run(self, c: Dict[str, torch.Tensor], plan, noise_seed: int,
            adopt: bool):
        """One pass over the inputs ``c``: (final state, loop seconds,
        capture seconds).  A graph's first run captures it, taking ``c``
        as its static inputs where ``adopt`` (nothing else holds them);
        every later run copies ``c`` into them and replays."""
        st = self.st
        dev = c["node_of"].device
        capture_s = 0.0
        if not self.graph:
            s = _new_carry(st, c["node_of"].shape[0], self.J, dev)
            gen = torch.Generator(device=dev).manual_seed(noise_seed) \
                if st.native_noise else None
            block, finish = _step_fn(st, c, plan, s, gen)
            t0 = time.perf_counter()
            for j0, n in _blocks(self.J, self.G):
                block(j0, n)
        else:
            if not self.graphs:
                t1 = time.perf_counter()
                self._capture(c, plan, adopt)
                capture_s = time.perf_counter() - t1
            else:
                for k, v in c.items():
                    self.c[k].copy_(v)
            _reset(self.s)
            if self.gen is not None:
                self.gen.manual_seed(noise_seed)
            finish = self.finish
            t0 = time.perf_counter()
            for _, n in _blocks(self.J, self.G):
                self.graphs[n].replay()
        final = finish()
        final["busy"] = final["busy"].cpu().numpy()     # waits for the device
        return final, time.perf_counter() - t0, capture_s

    def _capture(self, c, plan, adopt: bool) -> None:
        """Capture the block and the tail into graphs over static copies
        of the inputs and a static carry.  A capture that fails raises:
        there is no eager fallback."""
        st = self.st
        dev = c["node_of"].device
        self.c = c if adopt else {k: v.clone() for k, v in c.items()}
        self.s = _new_carry(st, c["node_of"].shape[0], self.J, dev)
        if st.native_noise:
            self.gen = torch.Generator(device=dev)
        # the loop keeps the step's closure: the graphs read the tensors
        # it holds (index ranges, views), which must not be freed
        self.block, self.finish = _step_fn(st, self.c, plan, self.s,
                                           self.gen)
        block = self.block
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        # one warm-up step loads every kernel before the capture
        side.wait_stream(main)
        with torch.cuda.stream(side):
            block(None, 1)
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for n in sorted({n for _, n in _blocks(self.J, self.G)}):
            g = torch.cuda.CUDAGraph()
            if self.gen is not None:
                # each replay advances the generator's Philox offset
                g.register_generator_state(self.gen)
            with torch.cuda.stream(side):
                g.capture_begin(pool=pool)
                try:
                    block(None, n)
                except BaseException:
                    try:
                        g.capture_end()
                    except RuntimeError:
                        pass                  # the capture's own error
                    raise
                g.capture_end()
            main.wait_stream(side)
            graphs[n] = g
        self.graphs = graphs


def _get_loop(st: _Static, c: Dict[str, torch.Tensor], J: int,
              graph: bool) -> _Loop:
    """The cached loop of this specialisation and these input shapes,
    built on a miss (LRU, ``_FN_CACHE_MAX`` entries)."""
    G = min(J, _BLOCK)
    key = (st, graph, str(c["node_of"].device), J, G,
           tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in c.items())))
    loop = _FN_CACHE.get(key)
    if loop is not None:
        _FN_STATS["hits"] += 1
        _FN_CACHE.move_to_end(key)
        return loop
    _FN_STATS["misses"] += 1
    loop = _FN_CACHE[key] = _Loop(st, J, G, graph)
    while len(_FN_CACHE) > _FN_CACHE_MAX:
        _FN_CACHE.popitem(last=False)
        _FN_STATS["evictions"] += 1
    return loop


def cache_stats() -> Dict[str, int]:
    """Loop-cache telemetry: current size, bound, hit / miss / eviction
    counters (cumulative over the process)."""
    return {"size": len(_FN_CACHE), "max": _FN_CACHE_MAX, **_FN_STATS}


def clear_cache() -> None:
    """Drop every cached loop, and with it the card memory its graphs,
    static inputs and carry hold; the counters stay."""
    _FN_CACHE.clear()


# ----------------------------------------------------------------------
# host-side summary (the reference's _Metrics summary)
def _summarize(cluster: _Cluster, st: _Static, final,
               plan) -> Dict[str, np.ndarray]:
    m = _Metrics(cluster.cfg)
    ys = {k: v.cpu().numpy() for k, v in final["ys"].items()}
    resp = ys["resp"].T                              # (T, J)
    rtt = ys["rtt"].T
    shed = ys["shed"].T
    hmask = ys["hmask"].T
    rtt2 = ys["rtt2"].T
    served = ~shed
    cpu_a = cluster.cpu_req[cluster.req_app][None, :]     # (1, J)
    mem_a = cluster.mem_req[cluster.req_app][None, :]
    m.rtts = resp
    m.chosen = np.where(shed, -1, ys["rep"].T)
    m.shed = shed
    m.busy_s = (np.where(served, rtt, 0.0) + hmask * rtt2).sum(axis=1)
    m.cpu_s = (np.where(served, cpu_a * rtt, 0.0)
               + hmask * cpu_a * rtt2).sum(axis=1)
    m.mem_s = (np.where(served, mem_a * rtt, 0.0)
               + hmask * mem_a * rtt2).sum(axis=1)
    with np.errstate(invalid="ignore"):
        over = np.maximum(resp - m.slo, 0.0)
    m.slo_violation_s = np.where(served, over, 0.0).sum(axis=1)
    if st.res_client:
        # every dispatched attempt's service time is busy, cpu and mem
        # time; what no client waited for is wasted
        tout, att, bwork = ys["tout"].T, ys["att"].T, ys["bwork"].T
        ok = served & ~tout
        m.timeout = tout
        m.fail_fast = tout & (att == 0)
        m.chosen = np.where(ok, ys["rep"].T, -1)
        m.busy_s = bwork.sum(axis=1)
        m.cpu_s = (cpu_a * bwork).sum(axis=1)
        m.mem_s = (mem_a * bwork).sum(axis=1)
        m.wasted_s = (bwork - np.where(ok, rtt, 0.0)).sum(axis=1)
        m.attempts = att.sum(axis=1)
        m.slo_violation_s = np.where(ok, over, 0.0).sum(axis=1)
    m.n_hedged = int(hmask.sum())
    m.hedged = hmask.sum(axis=1).astype(np.int64)
    m.fallback = final["fallback"].cpu().numpy()
    summary = m.summary(cluster, busy_until=final["busy"],
                        capacity=final["elastic"])
    if final["fleet"] is not None:
        summary["online"] = final["fleet"].stats(
            plan["req_app"], plan["req_t"], plan["retrain"])
    br = final["breakers"]
    summary["breaker_trips_per_trial"] = \
        np.zeros(len(m.fallback), np.int64) if br is None \
        else br.trip_count.sum(1).cpu().numpy().astype(np.int64)
    if final["trace"] is not None:
        summary["trace"] = trace_block(final["trace"].cpu().numpy(),
                                       cluster.cfg.n_requests,
                                       st.trace_every)
    return summary


# ----------------------------------------------------------------------
# public entry points
def _compile(cluster: _Cluster, policy: str, seed_blocks, device,
             eager: bool):
    """Lower once, move the inputs to the device once and look the loop
    up in the cache."""
    dev = resolve_device(device)
    reason = supports(cluster.cfg, policy)
    if reason is not None:
        raise NotImplementedError(f"the port cannot run this config: "
                                  f"{reason}")
    st, consts, plan = _lower(cluster, policy, seed_blocks)
    c = {k: torch.as_tensor(v, device=dev) for k, v in consts.items()}
    graph = dev.type == "cuda" and _graphable(st) and not eager
    return st, c, plan, _get_loop(st, c, cluster.cfg.n_requests, graph)


def _run(cluster, st, c, plan, loop, adopt: bool) -> Dict[str, np.ndarray]:
    final, loop_s, capture_s = loop.run(c, plan, 0, adopt)
    summary = _summarize(cluster, st, final, plan)
    summary.update(device=str(c["node_of"].device), loop_s=loop_s,
                   capture_s=capture_s, host_syncs=final["syncs"],
                   backend="graph" if loop.graph else "eager")
    return summary


def run_compiled(cluster: _Cluster, policy: str, *, seed_blocks=None,
                 device: DeviceLike = None,
                 eager: bool = False) -> Dict[str, np.ndarray]:
    """Run one (cluster, policy) pass through the batched core.

    Drop-in for the reference's ``SimStepper(cluster, make_policy(...))
    .run()`` on supported configs; raises NotImplementedError naming the
    feature on an unsupported one.  Besides the reference's summary keys
    it reports ``loop_s`` (wall seconds of the request loop, device work
    included), ``capture_s`` (seconds spent capturing its graphs; 0 when
    a cached capture replays), ``backend`` (``"graph"``: a ``_graphable``
    configuration on the card, replayed from CUDA graphs; else
    ``"eager"``), ``host_syncs`` (the completion folds' host reads),
    ``fallback_per_trial``, ``timeouts_per_trial`` and
    ``breaker_trips_per_trial`` (the breakers' trip events); a closed-loop
    pass adds the fleet's ``online`` stats, a traced one the ``trace``
    block.  ``seed_blocks`` mirrors RandomChoice's campaign blocks.
    ``device=None`` runs on the CUDA card (RuntimeError without one);
    ``device="cpu"`` on the CPU.  ``eager`` steps a graphable
    configuration eagerly on the card too (to compare the two).
    """
    st, c, plan, loop = _compile(cluster, policy, seed_blocks, device,
                                 eager)
    return _run(cluster, st, c, plan, loop, adopt=True)


def prepare_compiled(cluster: _Cluster, policy: str, *, seed_blocks=None,
                     device: DeviceLike = None, eager: bool = False):
    """Lower once, move the inputs to the device once, and return a
    zero-argument callable that reruns the loop on them.

    Each call resets the carry, copies its inputs into the cached loop's
    static buffers (two callables may share one cached graph), replays
    the loop (on the card, a ``_graphable`` configuration's CUDA graphs,
    captured by the first call that needs them) and returns the same
    summary as :func:`run_compiled`.  ``device`` and ``eager`` as
    there."""
    st, c, plan, loop = _compile(cluster, policy, seed_blocks, device,
                                 eager)

    def run() -> Dict[str, np.ndarray]:
        return _run(cluster, st, c, plan, loop, adopt=False)

    return run


def run_sim_compiled(cfg: SimConfig, policy: str = "perf_aware",
                     device: DeviceLike = None):
    """Build ``cfg``'s cluster and run it through :func:`run_compiled`."""
    return run_compiled(_build_cluster(cfg), policy, device=device)


def _fleet_inputs(st: _Static, seed: int, n_requests: int, T: int,
                  arrival_rate: float, mean_rtt: np.ndarray):
    """The fleet mode's cluster, drawn from ``rng_stream(seed,
    "fleet-demo")`` in the reference's order (imat, node_of, accel,
    req_app, req_t), as the loop's inputs and host plan."""
    A, K, N = st.n_apps, st.k, st.n_nodes
    rng = rng_stream(seed, "fleet-demo")
    imat = 0.5 * rng.uniform(0.05, 0.35, size=(A, A))
    node_of = rng.integers(0, N, size=(T, A * K)).astype(np.int64)
    accel = np.clip(rng.normal(0.0, 0.3, size=(T, N)), -0.8, 2.0)
    req_app = rng.integers(0, A, size=n_requests).astype(np.int64)
    req_t = np.cumsum(rng.exponential(1.0 / arrival_rate,
                                      size=n_requests))
    app_of = np.repeat(np.arange(A), K)
    cand_node = np.stack([node_of[:, a * K:(a + 1) * K] for a in range(A)])
    speed = 1.0 + accel[np.arange(T)[None, :, None], cand_node]
    irow = np.broadcast_to(imat[:, None, :], (A, T, A)).copy()
    consts = _core_consts(st, node_of, app_of, req_app, req_t, irow, speed,
                          cand_node, mean_rtt)
    plan = _plan(req_app, req_t, mean_rtt)
    return consts, plan


def fleet_throughput(n_requests: int = 1_000_000, n_nodes: int = 250,
                     n_replicas_per_app: int = 200, n_apps: int = 5,
                     n_trials: int = 4, policy: str = "perf_aware",
                     seed: int = 0, arrival_rate: float = 2000.0, *,
                     device: DeviceLike = None):
    """Fleet-scale mode: million-request x thousand-replica runs with the
    noise drawn on the device (no (J, T) or (T, J, R) host tensors, no
    serial-parity claim: the same model with another random stream).

    The cluster comes from ``rng_stream(seed, "fleet-demo")`` in the
    reference's draw order; the noise from a device ``torch.Generator``
    seeded from ``rng_stream(seed, "fleet-demo-noise")``, each block's
    ``z`` (T,), ``zc`` (T, K) and, for random, ``draw`` (T, K) a step
    drawn inside the captured graph.  Returns ``(events_per_s, stats)``
    with the reference's keys (``mean_rtt``, ``p99_rtt``, ``n_requests``,
    ``n_replicas``, ``n_trials``, ``wall_s`` (inputs to the device, the
    capture and the loop, the outputs back), ``backend``,
    ``events_per_s``) and ``loop_s`` and ``capture_s``.
    ``device=None`` runs on the CUDA card, ``device="cpu"`` on the CPU.
    """
    noise_seed = int(rng_stream(seed, "fleet-demo-noise").integers(2 ** 62))
    stats, _ = _fleet(n_requests, n_nodes, n_replicas_per_app, n_apps,
                      n_trials, policy, seed, arrival_rate, noise_seed,
                      device)
    return stats["events_per_s"], stats


def _fleet(n_requests: int, n_nodes: int, n_replicas_per_app: int,
           n_apps: int, n_trials: int, policy: str, seed: int,
           arrival_rate: float, noise_seed: int, device: DeviceLike,
           eager: bool = False):
    """:func:`fleet_throughput`'s run with the noise generator seeded by
    ``noise_seed`` (``eager`` steps it eagerly on the card too): (stats,
    the (J, T) responses)."""
    dev = resolve_device(device)
    apps = tuple(APPS)[:n_apps]
    cfg = SimConfig(n_nodes=n_nodes, n_replicas_per_app=n_replicas_per_app,
                    apps=apps, n_requests=n_requests, n_trials=n_trials,
                    seed=seed, arrival_rate=arrival_rate)
    st = replace(_static_for(cfg, policy), native_noise=True)
    mean_rtt = np.array([APPS[a][0] for a in apps])
    consts, plan = _fleet_inputs(st, seed, n_requests, n_trials,
                                 arrival_rate, mean_rtt)
    t0 = time.perf_counter()
    c = {k: torch.as_tensor(v, device=dev) for k, v in consts.items()}
    loop = _get_loop(st, c, n_requests,
                     dev.type == "cuda" and _graphable(st) and not eager)
    final, loop_s, capture_s = loop.run(c, plan, noise_seed, adopt=True)
    resp = final["ys"]["resp"].cpu().numpy()
    wall = time.perf_counter() - t0
    stats = {"mean_rtt": float(resp.mean()),
             "p99_rtt": float(np.percentile(resp, 99)),
             "n_requests": n_requests,
             "n_replicas": n_apps * n_replicas_per_app,
             "n_trials": n_trials, "wall_s": wall,
             "backend": "graph" if loop.graph else "eager",
             "events_per_s": n_requests * n_trials / wall,
             "loop_s": loop_s, "capture_s": capture_s}
    return stats, resp
