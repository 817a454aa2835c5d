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
  pops the replicas whose work has finished in rounds (``expire``);
* the from-scratch rebuild of those counts (``recount``) at the churn
  step and at every snapshot refresh without a live carry — the one
  place a hand-written kernel runs, the per-row segment sum
  (``repro_torch.kernels.segment_sum``);
* Eq. 12 predictions from the pre-drawn ``z_pred`` noise, held on the
  device and sliced per step, with the bare app-mean basis before
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
specialises on them in Python; the only host syncs are the expiry
rounds' ``any()`` checks (one per ``expire`` call, plus one per extra
round) and the completion fold's round count (one per autoscaler epoch
of a pass without predictions).  The attempt loop runs every attempt
with its per-trial masks on the device, never stopping early.  Scalars
go into tensors by ``scatter_`` / ``fill_``, which take them as kernel
arguments: ``t[idx] = True`` on a CUDA tensor copies a CPU scalar to
the card and waits for it.

**Serial-reference contract**: the reference's serial stepper is the
semantics; the port agrees with it to <= 1e-5 relative on every summary
stat for every supported config.  All float state is float64 and counts
are int32; the noise is the reference's own, drawn by numpy on the host,
so the only divergence is rounding (sums reassociated, libm ulps).

The reference's in-kernel-noise ``fleet_throughput`` mode and its
multi-device ``shard_map`` dispatch have no counterpart here yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.balancer import BUSY_PENALTY, POLICIES
from repro_torch.core.capacity import (CapacityConfig, ElasticSet,
                                       arrival_rates, membership_timeline)
from repro_torch.core.online import OnlineFleet, obs_window, retrain_schedule
from repro_torch.core.resilience import (Breakers, ResilienceConfig,
                                         backoff_delay)
from repro_torch.core.rng import rng_from_key, rng_seed
from repro_torch.core.simulator import (SimConfig, _build_cluster, _Cluster,
                                        _Metrics, unlowered)
from repro_torch.core.telemetry import (DISP_FAIL_FAST, DISP_SERVED,
                                        DISP_SHED, DISP_TIMEOUT,
                                        TRACE_FIELDS, trace_block, trace_row)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.monitoring.metrics import PeriodicRefresh

__all__ = ["supports", "run_compiled", "run_sim_compiled"]


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

    def regime(imat, accel, mean_rtt):
        """Per-app imat rows (A, T, A), candidate speeds (A, T, K) and
        log mean RTTs of one interference / speed / mean regime."""
        imat = np.asarray(imat, float)
        irow = np.stack([imat[:, a, :] if imat.ndim == 3
                         else np.broadcast_to(imat[a], (T, A))
                         for a in range(A)])
        speed = 1.0 + np.asarray(accel)[trial[None, :, None], cand_node]
        return irow, speed, [float(np.log(m)) for m in mean_rtt]

    irow, speed, log_rbar = regime(cluster.imat, cluster.accel,
                                   cluster.mean_rtt)
    mate_idx, mate_pad = _mates_plan(node_of, N)
    consts: Dict[str, np.ndarray] = {
        "node_of": node_of, "imat": irow, "speed": speed,
        "cand_node": cand_node, "mate_idx": mate_idx,
        "mate_app": cluster.app_of[mate_idx].astype(np.int64),
        "mate_pad": mate_pad,
        "z": np.ascontiguousarray(cluster.z_rtt.T),          # (J, T)
    }
    if st.needs_pred and not st.closed_loop:
        consts["z_pred"] = np.asarray(cluster.z_pred, float)  # (T, J, R)
    if st.policy == "random":
        consts["draw"] = _policy_draws(J, T, K, rng_seed(cfg.seed, "policy"),
                                       seed_blocks)
    if _needs_plan(st):
        consts["na_key"] = (node_of * A + cluster.app_of[None, :]
                            ).astype(np.int32)
    plan = {
        "req_app": req_app,
        "req_t": req_t,
        "log_rbar": log_rbar,
        "mean_rtt": [float(m) for m in cluster.mean_rtt],
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
        if st.pending:
            consts["req_app"] = req_app
    if st.gray is not None:
        g0, gdur, _ = st.gray
        consts["gray_rep"] = np.asarray(cluster.gray_rep, bool)
        plan["gray"] = (req_t >= g0) & (req_t < g0 + gdur)
    if st.drift:
        def post(name):
            v = getattr(cluster, f"{name}_post")
            return getattr(cluster, name) if v is None else v
        irow_p, speed_p, plan["log_rbar_post"] = regime(
            post("imat"), post("accel"), post("mean_rtt"))
        consts.update(imat_post=irow_p, speed_post=speed_p)
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
        consts["req_app"] = req_app
    return st, consts, plan


def _lognormal(inter, log_rbar: float, z):
    """Log-normal moment matching with s = rbar * (0.1 + inter)."""
    v = 0.1 + inter
    u = torch.log1p(v * v)
    return torch.exp(log_rbar - 0.5 * u + torch.sqrt(u) * z)


def _pick(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """m[trial, idx[trial]] for (T, K) m and (T,) idx."""
    return m.gather(1, idx[:, None])[:, 0]


def _pop_round(cnt: torch.Tensor, counted: torch.Tensor, ex: torch.Tensor,
               node_of: torch.Tensor, K: int) -> None:
    """One expiry round, in place: pop the first and the last replica
    marked in ``ex`` (T, R) of every app block of every trial — up to
    2·A pops per trial — from the (A, T, N) counts and the (T, R + 1)
    ``counted`` mask.  Two pops of one round can hit one (a, t, n) (two
    replicas of one app on one node), so the count update accumulates;
    a masked-out pop lands in ``counted``'s spare column R."""
    T, R = ex.shape
    A = R // K
    dev = ex.device
    kio = torch.arange(K, device=dev)[None, None, :]
    exv = ex.view(T, A, K)
    k1 = torch.where(exv, kio, K).amin(2)                  # first hit
    k2 = torch.where(exv, kio, -1).amax(2)                 # last hit
    hasb = k2 >= 0                                         # (T, A)
    k1 = torch.where(hasb, k1, 0)
    has2 = hasb & (k2 != k1)                               # 2nd pop
    k2 = torch.where(hasb, k2, 0)
    blk = (torch.arange(A, device=dev) * K)[None, :]
    i1, i2 = blk + k1, blk + k2                            # replica ids
    nn = torch.cat([node_of.gather(1, i1), node_of.gather(1, i2)], 1)
    dec = torch.cat([hasb, has2], 1)
    app2 = torch.arange(A, device=dev).repeat(2)[None, :].expand(T, 2 * A)
    trial2 = torch.arange(T, device=dev)[:, None].expand(T, 2 * A)
    cnt.index_put_((app2, trial2, nn), -dec.to(cnt.dtype), accumulate=True)
    ii = torch.cat([torch.where(hasb, i1, R), torch.where(has2, i2, R)], 1)
    counted.scatter_(1, ii, False)


def _expire(cnt: torch.Tensor, counted: torch.Tensor,
            busy_src: torch.Tensor, now: float, node_of: torch.Tensor,
            K: int) -> int:
    """Pop every counted replica whose work finished by ``now``, in
    place.  The first round runs unconditionally (almost every step has
    an expiry somewhere); further rounds run while any remain, each
    behind one host sync.  Returns the number of host syncs."""
    R = busy_src.shape[1]
    expm = busy_src <= now
    _pop_round(cnt, counted, expm & counted[:, :R], node_of, K)
    syncs = 0
    while True:
        ex = expm & counted[:, :R]
        syncs += 1
        if not bool(ex.any()):
            return syncs
        _pop_round(cnt, counted, ex, node_of, K)


# ----------------------------------------------------------------------
# the request loop
def _simulate(st: _Static, c: Dict[str, torch.Tensor], plan):
    """Run every request; returns the final state: ``busy`` (T, R), the
    per-step outputs ``ys``, ``syncs`` (the host syncs: expiry rounds and
    completion folds), ``fallback`` (T,) (routings by the least_conn
    fallback), in the closed loop the ``fleet``, with a capacity plane
    the ``elastic`` replica set and with the flight recorder the
    ``trace`` buffer."""
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
    syncs = 0
    # (imat rows, candidate speeds, log mean RTTs) before and after drift
    pre = (c["imat"], c["speed"], plan["log_rbar"])
    post = (c["imat_post"], c["speed_post"], plan["log_rbar_post"]) \
        if st.drift else pre

    def recount(busy_src, now):
        """From-scratch (A, T, N) busy counts and the (T, R + 1)
        counted mask (its spare column absorbs masked-out pops)."""
        busyb = busy_src > now
        flat = segment_sum(busyb.to(f64), c["na_key"], N * A)  # (T, N·A)
        cnt = flat.view(T, N, A).permute(2, 0, 1).to(i32).contiguous()
        counted = torch.zeros((T, R + 1), dtype=torch.bool, device=dev)
        counted[:, :R] = busyb
        return cnt, counted

    def rtt_full(a, reg, counts, z):
        """True RTT over the app's whole candidate row (T, K) from the
        per-(node, app) counts contracted with the app's imat row."""
        imat, speed, lr = reg
        iw = imat[a]                                       # (T, A)
        w_cnt = counts[0] * iw[:, 0:1]                     # (T, N)
        for a_ in range(1, A):
            w_cnt = w_cnt + counts[a_] * iw[:, a_:a_ + 1]
        inter = w_cnt.gather(1, c["cand_node"][a])
        return _lognormal(inter, lr[a], z[:, None]) * speed[a]

    def rtt_at(a, reg, busy_src, now, z, cand):
        """True RTT at candidate slots ``cand`` (T, Kq), summing the
        busy co-located replicas from the static mates table."""
        imat, speed, lr = reg
        nodes = c["cand_node"][a].gather(1, cand)          # (T, Kq)
        sp = speed[a].gather(1, cand)
        t_ = trial[:, None]
        mi = c["mate_idx"][t_, nodes]                      # (T, Kq, B)
        ma = c["mate_app"][t_, nodes]
        mp = c["mate_pad"][t_, nodes]
        w = imat[a].gather(1, ma.reshape(T, -1)).view(ma.shape)
        bg = busy_src.gather(1, mi.reshape(T, -1)).view(mi.shape)
        inter = torch.where((bg > now) & ~mp, w, 0.0).sum(-1)
        return _lognormal(inter, lr[a], z[:, None]) * sp

    def served_at(a, reg, busy_src, now, z, idx, coldm, graym):
        """(raw, served) true RTT of the replica at slot ``idx`` (T,): the
        pick-only draw, and the same after the cold and gray
        multipliers."""
        raw = rtt_at(a, reg, busy_src, now, z, idx[:, None])[:, 0]
        rtt = raw
        if coldm is not None:
            rtt = rtt * _pick(coldm, idx)
        if graym is not None:
            rtt = rtt * _pick(graym, idx)
        return raw, rtt

    def base_at(a, reg, z, idx):
        """The trace's service base: the zero-interference draw on the
        tier of slot ``idx`` (T,)."""
        _, speed, lr = reg
        return _lognormal(torch.zeros_like(z), lr[a], z) \
            * _pick(speed[a], idx)

    def count_dispatch(a, idx, sent):
        """+1 on the live count carry per newly busy replica: app ``a``'s
        slot ``idx`` (T,) where ``sent`` (None: every trial).  A replica
        with queued work is already counted."""
        r = a * K + idx
        add = ~_pick(counted, r)
        if sent is not None:
            add &= sent
            r = torch.where(sent, r, R)
        cnt[a].index_put_((trial, _pick(c["cand_node"][a], idx)),
                          add.to(i32), accumulate=True)
        counted.scatter_(1, r[:, None], True)

    def picked(m, idx, default):
        return default if m is None else _pick(m, idx)

    def score(busy_c, t, sig, j):
        """The policy's score of the app's candidates at time ``t`` (the
        request's ``now``, or each trial's attempt time as (T, 1)):
        queue wait + ``sig``, or without a signal the reactive rules."""
        if sig is not None:
            return (busy_c - t).clamp(min=0.0) + sig
        if st.policy == "least_conn":
            return busy_c - t
        alt = torch.remainder(colK - cursor[:, None], K).to(f64) \
            if st.policy == "round_robin" else c["draw"][j]
        return torch.where(busy_c <= t, alt,
                           BUSY_PENALTY + (busy_c - t).clamp(min=0.0))

    busy = torch.zeros((T, R), dtype=f64, device=dev)
    if st.policy == "round_robin":
        cursor = torch.zeros(T, dtype=torch.int64, device=dev)
    if need_live:
        cnt = torch.zeros((A, T, N), dtype=i32, device=dev)
        counted = torch.zeros((T, R + 1), dtype=torch.bool, device=dev)
    snap = None                        # until the snapshot first refreshes
    fleet = OnlineFleet(N, A, T, J, plan["mean_rtt"],
                        obs_window=st.obs_window, acc_window=st.acc_window,
                        device=dev) \
        if st.closed_loop else None
    elastic = ElasticSet(st.capacity, A, K, T, plan["mean_rtt"],
                         rates=c["ev_rate"], hit=c.get("hit"),
                         req_app=c["req_app"] if st.pending else None,
                         n_requests=J, device=dev) \
        if st.capacity is not None else None
    breakers = Breakers(T, R, res.breaker_threshold, res.breaker_cooldown_s,
                        res.timeout_s, device=dev) \
        if st.res_breaker else None
    k_tr = st.trace_every
    trace = torch.full((-(-J // k_tr), T, len(TRACE_FIELDS)), float("nan"),
                       dtype=f64, device=dev) if k_tr else None
    fallback = torch.zeros(T, dtype=torch.int64, device=dev)
    ys = {"resp": torch.empty((J, T), dtype=f64, device=dev),
          "rtt": torch.empty((J, T), dtype=f64, device=dev),
          "rep": torch.empty((J, T), dtype=torch.int64, device=dev),
          "shed": torch.zeros((J, T), dtype=torch.bool, device=dev),
          "hmask": torch.zeros((J, T), dtype=torch.bool, device=dev),
          "rtt2": torch.zeros((J, T), dtype=f64, device=dev)}
    if st.res_client:
        # every attempt timed out; dispatched attempts; their service
        # time (the work the servers did, answered or not)
        ys.update(tout=torch.zeros((J, T), dtype=torch.bool, device=dev),
                  att=torch.zeros((J, T), dtype=f64, device=dev),
                  bwork=torch.zeros((J, T), dtype=f64, device=dev))

    for j in range(J):
        a = int(plan["req_app"][j])
        now = float(plan["req_t"][j])
        a0 = a * K
        reg = post if plan["drift"][j] else pre
        tracing = bool(k_tr) and j % k_tr == 0
        # membership events, in heap order: a later epoch sees the busy
        # bump of an earlier churn or group outage in the same walk
        for kind, t_ev, i in plan["events"].get(j, ()):
            if kind == "churn":
                # the failed node's replicas stay busy until it is back
                t_up = st.churn[0] + st.churn[1]
                busy = torch.where(c["down"], busy.clamp(min=t_up), busy)
            elif kind == "group_down":
                # the correlated outage: churn's bump, group-wide
                g0, gdur, _ = st.group
                busy = torch.where(c["gdown"], busy.clamp(min=g0 + gdur),
                                   busy)
            elif kind == "scale":
                elastic.decide(t_ev, i, busy, j)
            elif kind == "preempt_down":
                elastic.preempt(t_ev, busy)
            else:                                          # preempt_up
                elastic.restore()
        busy_c = busy[:, a0:a0 + K]
        act_c = coldm = served = None
        if elastic is not None:
            act_c = elastic.wake(a, now)
            if st.admission:
                # shed where even the best active queue wait is too long
                best = torch.where(act_c, (busy_c - now).clamp(min=0.0),
                                   float("inf")).amin(1)
                served = best <= st.capacity.admission_limit_s
                ys["shed"][j] = ~served
            coldm = elastic.cold_mult(a, now)
        # gray failure: the true RTT only; predictions keep the healthy
        # view the replica still advertises
        graym = torch.where(c["gray_rep"][:, a0:a0 + K], st.gray[2], 1.0) \
            if plan["gray"][j] else None

        if need_live:
            if plan["bump"][j]:
                cnt, counted = recount(busy, now)
            syncs += _expire(cnt, counted, busy, now, c["node_of"], K)
        if need_snap:
            if plan["refresh"][j]:
                snap = busy.clone()
                if need_live:
                    # at a refresh snap == busy: copy the live carry
                    s_cnt, s_cted = cnt.clone(), counted.clone()
                else:
                    s_cnt, s_cted = recount(busy, now)
            if snap is not None:
                syncs += _expire(s_cnt, s_cted, snap, now, c["node_of"], K)
        z = c["z"][j]

        hmask = predicted = None
        if st.reactive and not st.res_client:
            sc = score(busy_c, now, None, j)
            sc_m = sc if act_c is None \
                else torch.where(act_c, sc, float("inf"))
            picks = torch.argmin(sc_m, dim=1)
            if st.policy == "round_robin":
                cursor = (picks + 1) % K
            raw_pick, rtt_pick = served_at(a, reg, busy, now, z, picks,
                                           coldm, graym)
        else:
            actual = actual_raw = None
            if full_actual or st.res_client:
                # the attempt loop reads the full row for every policy:
                # from the count carry where one exists, else from the
                # mates table (the same sum, reassociated)
                actual_raw = rtt_full(a, reg, cnt, z) if need_live \
                    else rtt_at(a, reg, busy, now, z, colK.expand(T, K))
                actual = actual_raw if coldm is None \
                    else actual_raw * coldm
            if st.closed_loop:
                # the serial order: fold the completed predictions into
                # the trackers, retrain, then predict from the features
                prev = float(plan["req_t"][j - 1]) if j else -np.inf
                fleet.fold_pending(j, now, prev, c["req_app"])
                if plan["retrain"][j]:
                    fleet.retrain(now)
                counts_src = s_cnt if st.snapshot else cnt
                if st.res_client and not st.snapshot:
                    # the attempts' dispatches move the live counts; the
                    # fleet observes the features the request saw
                    counts_src = cnt.clone()
                fleet_pred = fleet.predict(a, counts_src, c["cand_node"][a])
                predicted = fleet_pred
                if st.fallback:
                    # a non-viable trial scores by queue wait alone
                    ok = fleet.viable(a, st.fallback_threshold)
                    predicted = torch.where(ok[:, None], fleet_pred, 0.0)
                    fallback += ~ok
            elif st.needs_pred:
                if plan["cold"][j] or st.snapshot:
                    if plan["cold"][j]:
                        # no predictor has trained yet: the app-mean RTT
                        basis = torch.full((T, K), plan["mean_rtt"][a],
                                           dtype=f64, device=dev)
                    else:
                        basis = rtt_full(a, reg, s_cnt, z)
                    if coldm is not None:
                        # the predictor knows which replicas are cold
                        basis = basis * coldm
                else:
                    basis = actual
                eps = (1.0 - st.accuracy) * basis
                predicted = basis + eps * c["z_pred"][:, j, a0:a0 + K]
            if graym is not None and actual is not None:
                actual = actual * graym
            sig = predicted if st.policy == "perf_aware" else actual
            if not st.res_client:
                sc = score(busy_c, now, sig, j)
                sc_m = sc if act_c is None \
                    else torch.where(act_c, sc, float("inf"))
                picks = torch.argmin(sc_m, dim=1)
                if full_actual:
                    raw_pick, rtt_pick = _pick(actual_raw, picks), \
                        _pick(actual, picks)
                else:
                    raw_pick, rtt_pick = served_at(a, reg, busy, now, z,
                                                   picks, coldm, graym)
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
            t_att = torch.full((T,), now, dtype=f64, device=dev)
            picks = torch.zeros(T, dtype=torch.int64, device=dev)
            rtt_pick = torch.zeros(T, dtype=f64, device=dev)
            finish = torch.zeros_like(rtt_pick)
            work = torch.zeros_like(rtt_pick)
            n_att = torch.zeros_like(rtt_pick)
            if tracing:
                # the successful attempt's score, start and queue wait
                sc_ok, t_ok, qw_ok = (torch.zeros_like(rtt_pick)
                                      for _ in range(3))
            for i in range(1 + res.max_retries):
                mask = act_c
                if breakers is not None:
                    # an open breaker is unroutable; half-open probes go
                    shut = breakers.open_mask(t_att, slice(a0, a0 + K))
                    mask = ~shut if mask is None else mask & ~shut
                dispatch = live & ~success
                if mask is not None:
                    dispatch &= mask.any(1)
                sc = score(busy_c, t_att[:, None],
                           None if st.reactive else sig, j)
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
                    cursor = torch.where(dispatch, (p_i + 1) % K, cursor)
                if need_live:
                    count_dispatch(a, p_i, dispatch)
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
                if i < res.max_retries:
                    delay = backoff_delay(res, i, c["zj"][j, :, i])
                    # a dispatched attempt fails only at its timeout; a
                    # fail-fast one (no routable candidate) backs off at
                    # once, which is how breakers arrest a retry storm
                    t_att = torch.where(dispatch, t_att + timeout + delay,
                                        t_att + delay)
            busy[:, a0:a0 + K] = busy_c
            timed_out = live & ~success
            resp = torch.where(success, finish - now, float("nan"))
            served = success         # only completed requests are observed
            ys["tout"][j] = timed_out
            ys["att"][j] = n_att
            ys["bwork"][j] = work
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
            finish = b_pick.clamp(min=now) + rtt_pick
            take = colK == picks[:, None]
            if served is not None:
                take &= served[:, None]
            new_c = torch.where(take, finish[:, None], busy_c)
            hedge_s = 0.0
            if hmask is not None:
                rtt2 = _pick(actual, second) if full_actual \
                    else served_at(a, reg, busy, now, z, second, coldm,
                                   graym)[1]
                finish2 = _pick(busy_c, second).clamp(min=now) + rtt2
                first = torch.where(hmask, torch.minimum(finish, finish2),
                                    finish)
                resp = first - now
                hedge_s = torch.where(hmask, finish - first, 0.0)
                new_c = torch.where((colK == second[:, None])
                                    & hmask[:, None], finish2[:, None], new_c)
                ys["hmask"][j] = hmask
                ys["rtt2"][j] = rtt2
            else:
                resp = finish - now
            disp = DISP_SERVED
            if served is not None:
                resp = torch.where(served, resp, float("nan"))
                disp = torch.where(served, DISP_SERVED, DISP_SHED)
            busy[:, a0:a0 + K] = new_c
            if tracing:
                row = dict(predicted=picked(predicted, picks, float("nan")),
                           score=_pick(sc, picks),
                           queue_wait=(b_pick - now).clamp(min=0.0),
                           raw=raw_pick, retry_s=0.0, hedge_s=hedge_s)
        if st.closed_loop:
            # the routed request trains the fleet: the pick's features
            # (counts before this dispatch), true RTT and completion
            fleet.observe(j, a, counts_src, _pick(c["cand_node"][a], picks),
                          rtt_pick, finish, _pick(fleet_pred, picks), served)
        if elastic is not None:
            # the autoscaler's signal: the routed prediction (the fleet's
            # raw one in the closed loop), else the observed completion
            elastic.check_routed(a0 + picks, served)
            if st.needs_pred:
                src = fleet_pred if st.closed_loop else predicted
                elastic.note_prediction(a, _pick(src, picks), served)
            else:
                elastic.note_completion(j, rtt_pick, finish, served)
        if need_live and not st.res_client:
            # after the fleet has read the counts before the dispatch; a
            # shed request dispatches nothing
            count_dispatch(a, picks, served)
            if hmask is not None:
                count_dispatch(a, second, hmask)
        if tracing:
            trace[j // k_tr] = trace_row(
                rep=a0 + picks, base=base_at(a, reg, z, picks),
                cold_mult=picked(coldm, picks, 1.0),
                gray_mult=picked(graym, picks, 1.0), disposition=disp,
                response=resp, **row)
        ys["resp"][j] = resp
        ys["rtt"][j] = rtt_pick
        ys["rep"][j] = a0 + picks
    if st.closed_loop:
        # everything has completed: the serial run's final fold
        fleet.fold_pending(J, np.inf, float(plan["req_t"][-1]),
                           c["req_app"])
    if elastic is not None:
        syncs += elastic.syncs
    return {"busy": busy, "ys": ys, "syncs": syncs, "fallback": fallback,
            "fleet": fleet, "elastic": elastic, "trace": trace,
            "breakers": breakers}


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
def run_compiled(cluster: _Cluster, policy: str, *, seed_blocks=None,
                 device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Run one (cluster, policy) pass through the batched core.

    Drop-in for the reference's ``SimStepper(cluster, make_policy(...))
    .run()`` on supported configs; raises NotImplementedError naming the
    feature on an unsupported one.  Besides the reference's summary keys
    it reports ``loop_s`` (wall seconds of the request loop, device work
    included), ``host_syncs`` (the expiry rounds' host syncs),
    ``fallback_per_trial``, ``timeouts_per_trial`` and
    ``breaker_trips_per_trial`` (the breakers' trip events); a closed-loop
    pass adds the fleet's ``online`` stats, a traced one the ``trace``
    block.  ``seed_blocks`` mirrors RandomChoice's campaign
    blocks.  ``device=None`` runs on the CUDA card (RuntimeError without
    one); ``device="cpu"`` on the CPU.
    """
    dev = resolve_device(device)
    reason = supports(cluster.cfg, policy)
    if reason is not None:
        raise NotImplementedError(f"the port cannot run this config: "
                                  f"{reason}")
    st, consts, plan = _lower(cluster, policy, seed_blocks)
    c = {k: torch.as_tensor(v, device=dev) for k, v in consts.items()}
    t0 = time.perf_counter()
    final = _simulate(st, c, plan)
    final["busy"] = final["busy"].cpu().numpy()     # waits for the device
    loop_s = time.perf_counter() - t0
    summary = _summarize(cluster, st, final, plan)
    summary.update(device=str(dev), loop_s=loop_s,
                   host_syncs=final["syncs"])
    return summary


def run_sim_compiled(cfg: SimConfig, policy: str = "perf_aware",
                     device: DeviceLike = None):
    """Build ``cfg``'s cluster and run it through :func:`run_compiled`."""
    return run_compiled(_build_cluster(cfg), policy, device=device)
