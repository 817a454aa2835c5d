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
  RTTs, with the rolling-accuracy fallback to least_conn.

The host knows each request's app, arrival time and every per-step flag
(snapshot refresh, churn edge, drift regime, cold start, retrain) before
the loop starts, so a step specialises on them in Python; the only host
syncs are the expiry rounds' ``any()`` checks (one per ``expire`` call,
plus one per extra round).  Scalars go into tensors by ``scatter_`` /
``fill_``, which take them as kernel arguments: ``t[idx] = True`` on a
CUDA tensor copies a CPU scalar to the card and waits for it.

**Serial-reference contract**: the reference's serial stepper is the
semantics; the port agrees with it to <= 1e-5 relative on every summary
stat for every supported config.  All float state is float64 and counts
are int32; the noise is the reference's own, drawn by numpy on the host,
so the only divergence is rounding (sums reassociated, libm ulps).

Not lowered yet (``supports`` names the feature, the entry points raise
``NotImplementedError``): the capacity plane, spot preemption,
resilience, the trace.  The reference's in-kernel-noise
``fleet_throughput`` mode and its multi-device ``shard_map`` dispatch
have no counterpart here yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.balancer import BUSY_PENALTY, POLICIES
from repro_torch.core.online import OnlineFleet, obs_window, retrain_schedule
from repro_torch.core.rng import rng_from_key, rng_seed
from repro_torch.core.simulator import (SimConfig, _build_cluster, _Cluster,
                                        _Metrics, unlowered)
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
    fallback_threshold: float
    obs_window: int              # fleet observation ring length (Wn)
    acc_window: int              # rolling-accuracy ring length (Wa)

    @property
    def hedging(self) -> bool:
        return self.hedge is not None and self.k >= 2

    @property
    def fallback(self) -> bool:
        return self.closed_loop and self.fallback_threshold > 0


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
    snapshot = (cfg.prediction_lag_s > 0 or cfg.outage is not None) \
        and needs_pred
    return _Static(
        policy=policy, n_apps=len(cfg.apps), k=cfg.n_replicas_per_app,
        n_nodes=cfg.n_nodes, hedge=hedge, accuracy=cfg.accuracy,
        reactive=not hedging and not spec.requires, needs_pred=needs_pred,
        closed_loop=closed, snapshot=snapshot,
        cold_start=cfg.cold_start_s > 0, churn=cfg.churn,
        drift=cfg.t_drift is not None,
        fallback_threshold=cfg.fallback_threshold if closed else 0.0,
        obs_window=obs_window(cfg),
        acc_window=max(1, int(cfg.accuracy_window)))


def _count_flags(st: _Static) -> Tuple[bool, bool, bool]:
    """(full_actual, need_live, need_snap): whether the step draws the
    full-K true RTT, and which incremental count carries exist
    (``need_live`` tracks the live occupancy, ``need_snap`` the stale
    snapshot).  The closed loop reads the live counts for its features
    when there is no snapshot, even where perf_aware draws no full-K
    true RTT."""
    if st.reactive:
        return False, False, False
    full_actual = st.policy != "perf_aware" \
        or (not st.closed_loop and not st.snapshot)
    need_live = full_actual or (st.closed_loop and not st.snapshot)
    return full_actual, need_live, st.snapshot


def _needs_plan(st: _Static) -> bool:
    """True when the step rebuilds counts from scratch: the churn resync
    of the live carry, or a snapshot refresh with no live carry to copy
    from."""
    _, need_live, need_snap = _count_flags(st)
    return (need_live and st.churn is not None) \
        or (need_snap and not need_live)


# ----------------------------------------------------------------------
# host-side schedules (data-independent per-step flags)
def _refresh_schedule(cfg: SimConfig, req_t: np.ndarray,
                      call_mask: np.ndarray) -> np.ndarray:
    """(J,) bool: steps where the snapshot recomputes.  Drives the real
    :class:`PeriodicRefresh` with the serial call pattern, so cadence and
    outage-freeze semantics cannot drift from the reference."""
    outages = ()
    if cfg.outage is not None:
        t0, duration = cfg.outage
        outages = ((t0, t0 + duration),)
    pr = PeriodicRefresh(cfg.prediction_lag_s, outages)
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


def _first_true(mask: np.ndarray) -> np.ndarray:
    """One-hot of the first True of a monotone (J,) flag."""
    edge = mask.copy()
    edge[1:] &= ~mask[:-1]
    return edge


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
        "retrain": np.zeros(J, bool),
    }
    if st.churn is not None:
        consts["down"] = node_of == np.asarray(cluster.failed_node)[:, None]
        plan["bump"] = _first_true(req_t >= st.churn[0])
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
    per-step outputs ``ys``, ``syncs`` (the expiry rounds' host syncs),
    ``fallback`` (T,) (routings by the least_conn fallback) and, in the
    closed loop, the ``fleet``."""
    dev = c["node_of"].device
    f64, i32 = torch.float64, torch.int32
    A, K, N = st.n_apps, st.k, st.n_nodes
    R = A * K
    T = c["node_of"].shape[0]
    J = len(plan["req_t"])
    full_actual, need_live, need_snap = _count_flags(st)
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
    fallback = torch.zeros(T, dtype=torch.int64, device=dev)
    ys = {"resp": torch.empty((J, T), dtype=f64, device=dev),
          "rtt": torch.empty((J, T), dtype=f64, device=dev),
          "rep": torch.empty((J, T), dtype=torch.int64, device=dev),
          "hmask": torch.zeros((J, T), dtype=torch.bool, device=dev),
          "rtt2": torch.zeros((J, T), dtype=f64, device=dev)}

    for j in range(J):
        a = int(plan["req_app"][j])
        now = float(plan["req_t"][j])
        a0 = a * K
        reg = post if plan["drift"][j] else pre
        if plan["bump"][j]:
            # churn: the failed node's replicas stay busy until it is
            # back; applied once, at the first request past t_fail
            t_up = st.churn[0] + st.churn[1]
            busy = torch.where(c["down"], busy.clamp(min=t_up), busy)
        busy_c = busy[:, a0:a0 + K]
        wait_c = (busy_c - now).clamp(min=0.0)

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

        hmask = None
        if st.reactive:
            idle = busy_c <= now
            if st.policy == "round_robin":
                dist = torch.remainder(colK - cursor[:, None], K).to(f64)
                sc = torch.where(idle, dist, BUSY_PENALTY + wait_c)
            elif st.policy == "random":
                sc = torch.where(idle, c["draw"][j], BUSY_PENALTY + wait_c)
            else:                                          # least_conn
                sc = busy_c - now
            picks = torch.argmin(sc, dim=1)
            if st.policy == "round_robin":
                cursor = (picks + 1) % K
            rtt_pick = rtt_at(a, reg, busy, now, z, picks[:, None])[:, 0]
        else:
            actual = rtt_full(a, reg, cnt, z) if full_actual else None
            if st.closed_loop:
                # the serial order: fold the completed predictions into
                # the trackers, retrain, then predict from the features
                prev = float(plan["req_t"][j - 1]) if j else -np.inf
                fleet.fold_pending(j, now, prev, c["req_app"])
                if plan["retrain"][j]:
                    fleet.retrain(now)
                counts_src = s_cnt if st.snapshot else cnt
                fleet_pred = fleet.predict(a, counts_src, c["cand_node"][a])
                predicted = fleet_pred
                if st.fallback:
                    # a non-viable trial scores by queue wait alone
                    ok = fleet.viable(a, st.fallback_threshold)
                    predicted = torch.where(ok[:, None], fleet_pred, 0.0)
                    fallback += ~ok
            elif st.needs_pred:
                if plan["cold"][j]:
                    # no predictor has trained yet: the app-mean RTT
                    basis = torch.full((T, K), plan["mean_rtt"][a],
                                       dtype=f64, device=dev)
                elif st.snapshot:
                    basis = rtt_full(a, reg, s_cnt, z)
                else:
                    basis = actual
                eps = (1.0 - st.accuracy) * basis
                predicted = basis + eps * c["z_pred"][:, j, a0:a0 + K]
            sig = predicted if st.policy == "perf_aware" else actual
            sc = wait_c + sig
            picks = torch.argmin(sc, dim=1)
            rtt_pick = _pick(actual, picks) if full_actual \
                else rtt_at(a, reg, busy, now, z, picks[:, None])[:, 0]
            if st.hedging:
                # runner-up by score; hedge when the pick's signal
                # exceeds hedge x the best busy replica's completion
                second = torch.argmin(
                    sc.scatter(1, picks[:, None], float("inf")), dim=1)
                ref = torch.where(busy_c > now, sc, float("inf")).amin(1)
                hmask = _pick(sig, picks) > st.hedge * ref

        # commit: only the app's K-column block changes
        b_pick = _pick(busy_c, picks)
        finish = b_pick.clamp(min=now) + rtt_pick
        new_c = torch.where(colK == picks[:, None], finish[:, None], busy_c)
        if hmask is not None:
            rtt2 = _pick(actual, second) if full_actual \
                else rtt_at(a, reg, busy, now, z, second[:, None])[:, 0]
            finish2 = _pick(busy_c, second).clamp(min=now) + rtt2
            resp = torch.where(hmask, torch.minimum(finish, finish2),
                               finish) - now
            new_c = torch.where((colK == second[:, None]) & hmask[:, None],
                                finish2[:, None], new_c)
            ys["hmask"][j] = hmask
            ys["rtt2"][j] = rtt2
        else:
            resp = finish - now
        busy[:, a0:a0 + K] = new_c
        if st.closed_loop:
            # the routed request trains the fleet: the pick's features
            # (counts before this dispatch), true RTT and completion
            fleet.observe(j, a, counts_src, _pick(c["cand_node"][a], picks),
                          rtt_pick, finish, _pick(fleet_pred, picks))
        if need_live:
            # +1 per newly busy replica (a pick with queued work is
            # already counted)
            nodes_row = c["cand_node"][a]
            r1 = a0 + picks
            add1 = ~_pick(counted, r1)
            cnt[a].index_put_((trial, _pick(nodes_row, picks)),
                              add1.to(i32), accumulate=True)
            counted.scatter_(1, r1[:, None], True)
            if hmask is not None:
                r2 = a0 + second
                add2 = hmask & ~_pick(counted, r2)
                cnt[a].index_put_((trial, _pick(nodes_row, second)),
                                  add2.to(i32), accumulate=True)
                counted.scatter_(1, torch.where(hmask, r2, R)[:, None], True)
        ys["resp"][j] = resp
        ys["rtt"][j] = rtt_pick
        ys["rep"][j] = a0 + picks
    if st.closed_loop:
        # everything has completed: the serial run's final fold
        fleet.fold_pending(J, np.inf, float(plan["req_t"][-1]),
                           c["req_app"])
    return {"busy": busy, "ys": ys, "syncs": syncs, "fallback": fallback,
            "fleet": fleet}


# ----------------------------------------------------------------------
# host-side summary (the reference's _Metrics summary)
def _summarize(cluster: _Cluster, final, plan) -> Dict[str, np.ndarray]:
    m = _Metrics(cluster.cfg)
    ys = {k: v.cpu().numpy() for k, v in final["ys"].items()}
    resp = ys["resp"].T                              # (T, J)
    rtt = ys["rtt"].T
    hmask = ys["hmask"].T
    rtt2 = ys["rtt2"].T
    cpu_a = cluster.cpu_req[cluster.req_app][None, :]     # (1, J)
    mem_a = cluster.mem_req[cluster.req_app][None, :]
    m.rtts = resp
    m.chosen = ys["rep"].T
    m.busy_s = (rtt + hmask * rtt2).sum(axis=1)
    m.cpu_s = (cpu_a * rtt + hmask * cpu_a * rtt2).sum(axis=1)
    m.mem_s = (mem_a * rtt + hmask * mem_a * rtt2).sum(axis=1)
    m.slo_violation_s = np.maximum(resp - m.slo, 0.0).sum(axis=1)
    m.n_hedged = int(hmask.sum())
    m.hedged = hmask.sum(axis=1).astype(np.int64)
    m.fallback = final["fallback"].cpu().numpy()
    summary = m.summary(cluster, busy_until=final["busy"])
    if final["fleet"] is not None:
        summary["online"] = final["fleet"].stats(
            plan["req_app"], plan["req_t"], plan["retrain"])
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
    included), ``host_syncs`` (the expiry rounds' host syncs) and
    ``fallback_per_trial``; a closed-loop pass adds the fleet's
    ``online`` stats.  ``seed_blocks`` mirrors RandomChoice's campaign
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
    summary = _summarize(cluster, final, plan)
    summary.update(device=str(dev), loop_s=loop_s,
                   host_syncs=final["syncs"])
    return summary


def run_sim_compiled(cfg: SimConfig, policy: str = "perf_aware",
                     device: DeviceLike = None):
    """Build ``cfg``'s cluster and run it through :func:`run_compiled`."""
    return run_compiled(_build_cluster(cfg), policy, device=device)
