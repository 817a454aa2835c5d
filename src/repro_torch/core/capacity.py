"""Capacity plane: the configuration, the membership timeline, the
host-side schedules and the elastic replica set of the batched core (a
port of the reference's ``core/capacity.py``).

* :class:`CapacityConfig` — the reference's knobs and validation;
* :func:`membership_timeline` — the exact pop order of the serial
  stepper's membership-event heap (node churn, autoscaler epochs, the
  spot-preemption window, the correlated node-group outage);
* :func:`arrival_rates` — the trailing per-app arrival rate at each
  event, with the serial controller's float operations;
* :func:`take_lowest` / :func:`take_highest` — the activation and drain
  orders on masks whose last axis is the candidate axis;
* :class:`ElasticSet` — the serial ``CapacityController`` as tensors on
  the core's device: active and allowed masks, warm-up, drain tails,
  the provisioning ledger, the autoscalers and the service-time
  estimate they read;
* :class:`EnginePool` — the serving router's mirror: the same rules over
  a pool of serving engines, with the admission hook and the ledger.

Event times, the request each event pops before, and the rates depend
only on the config and the shared arrival stream, so the core computes
them before the request loop starts.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AUTOSCALERS", "CapacityConfig", "ElasticSet", "EnginePool",
           "MembershipEvent", "membership_timeline", "arrival_rates",
           "take_lowest", "take_highest"]

AUTOSCALERS = ("predictive", "reactive", "fixed")


@dataclass(frozen=True)
class CapacityConfig:
    """Capacity-plane knobs (the reference's fields, defaults and
    validation); frozen so SimConfig equality (the campaign's stacking
    precondition) keeps working."""
    autoscaler: str = "predictive"      # predictive | reactive | fixed
    min_replicas: int = 1               # per app (0 enables scale-to-zero)
    max_replicas: Optional[int] = None  # per app; None -> the full pool
    initial_replicas: Optional[int] = None  # None -> max(min_replicas, 1)
    decide_every_s: float = 5.0         # autoscaler decision cadence
    # scale-up warm-up: a just-activated replica serves at
    # cold_rtt_factor x RTT until warmup_s after activation
    warmup_s: float = 10.0
    cold_rtt_factor: float = 2.0
    # predictive autoscaler (Little's law provisioning)
    slo_target_s: float = 30.0          # p95 target; accounting SLO
    rho_target: float = 0.7             # target busy fraction
    rate_window_s: float = 20.0         # trailing arrival-rate window
    ewma_alpha: float = 0.1             # service-time EWMA step
    # reactive threshold baseline
    hi_util: float = 0.8
    lo_util: float = 0.3
    cooldown_s: float = 10.0            # min seconds between +-1 steps
    # admission control: shed when the best queue wait exceeds the limit
    admission_limit_s: Optional[float] = None

    def __post_init__(self):
        if self.autoscaler not in AUTOSCALERS:
            raise ValueError(f"unknown autoscaler {self.autoscaler!r}; "
                             f"one of {AUTOSCALERS}")
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if not 0.0 < self.rho_target <= 1.0:
            raise ValueError("rho_target must be in (0, 1]")

    @property
    def initial(self) -> int:
        return self.initial_replicas if self.initial_replicas is not None \
            else max(self.min_replicas, 1)


@dataclass(order=True)
class MembershipEvent:
    """One timed membership change; ``seq`` orders same-instant events
    deterministically."""
    t: float
    seq: int
    #: churn | group_down | preempt_down | preempt_up | scale
    kind: str = field(compare=False)


def membership_timeline(horizon_s: float, *,
                        churn: Optional[Tuple[float, float]] = None,
                        capacity: Optional[CapacityConfig] = None,
                        preempt: Optional[Tuple[float, float]] = None,
                        outage_group: Optional[Tuple[float, float, int]]
                        = None) -> List[MembershipEvent]:
    """The serial stepper's membership events over ``[0, horizon_s]`` in
    heap pop order: node churn, autoscaler epochs (self-rescheduling
    every ``decide_every_s``), the preemption window and the correlated
    group outage, merged by ``(t, seq)``.  Events after the horizon can
    never pop and are left out."""
    heap: List[MembershipEvent] = []
    seq = 0

    def push(t: float, kind: str):
        nonlocal seq
        heapq.heappush(heap, MembershipEvent(float(t), seq, kind))
        seq += 1

    if churn is not None:
        push(churn[0], "churn")
    if outage_group is not None:
        push(outage_group[0], "group_down")
    if capacity is not None:
        push(capacity.decide_every_s, "scale")
        if preempt is not None:
            push(preempt[0], "preempt_down")
            push(preempt[0] + preempt[1], "preempt_up")
    out: List[MembershipEvent] = []
    while heap and heap[0].t <= horizon_s:
        ev = heapq.heappop(heap)
        out.append(ev)
        if ev.kind == "scale":
            push(ev.t + capacity.decide_every_s, "scale")
    return out


def arrival_rates(cap: CapacityConfig, req_t: np.ndarray,
                  req_app: np.ndarray, n_apps: int,
                  times) -> np.ndarray:
    """(E, A) trailing per-app arrival rate over ``rate_window_s`` at
    each of ``times``, with the serial controller's float operations
    (a cumulative count table and two ``searchsorted``)."""
    req_t = np.asarray(req_t, float)
    J = len(req_t)
    cum = np.zeros((J + 1, n_apps))
    np.add.at(cum, (np.arange(J) + 1, np.asarray(req_app)), 1.0)
    cum = np.cumsum(cum, axis=0)
    out = np.zeros((len(times), n_apps))
    for i, t in enumerate(times):
        win = min(cap.rate_window_s, max(t, 1e-9))
        hi = np.searchsorted(req_t, t, side="right")
        lo = np.searchsorted(req_t, t - win, side="right")
        out[i] = (cum[hi] - cum[lo]) / win
    return out


def take_lowest(eligible: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The first ``k[...]`` eligible entries along the last axis of a
    (..., C) bool mask — the activation order."""
    return eligible & (eligible.cumsum(-1) <= k[..., None])


def take_highest(eligible: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The last ``k[...]`` eligible entries along the last axis of a
    (..., C) bool mask — the drain order."""
    rev = eligible.flip(-1).cumsum(-1).flip(-1)
    return eligible & (rev <= k[..., None])


class ElasticSet:
    """The elastic replica set of every trial on one device: the serial
    ``CapacityController`` as tensors with a leading trial axis.

    ``active`` / ``allowed`` are (T, R) masks over the contiguous app
    blocks of K replicas; ``warm`` the time each replica is warm from,
    ``paid`` the end of its paid drain tail; ``prov`` (T,) the ledger,
    accrued up to the 0-d ``last_t``; ``s_hat`` (T, A) the service-time
    estimate the predictive autoscaler provisions from.  Every value
    that depends on the data stays on the device: the only host read is
    the completion fold's round count (one per autoscaler epoch of a
    pass without predictions, counted in ``syncs``).
    """

    def __init__(self, cap: CapacityConfig, n_apps: int, k: int,
                 n_trials: int, mean_rtt, *, rates: torch.Tensor,
                 hit: Optional[torch.Tensor] = None,
                 req_app: Optional[torch.Tensor] = None,
                 n_requests: int = 0, device=None):
        self.cap = cap
        self.A, self.K, T = int(n_apps), int(k), int(n_trials)
        R = self.A * self.K
        f64 = dict(dtype=torch.float64, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.rates = rates                       # (E, A) per event
        self.hit = hit                           # (T, R) preempted replicas
        self.req_app = req_app                   # (J,) for the fold
        col = torch.arange(self.K, device=device)
        self.active = (col < min(cap.initial, self.K)).repeat(self.A) \
            .expand(T, R).clone()
        self.allowed = torch.ones((T, R), dtype=torch.bool, device=device)
        self.warm = torch.full((T, R), -np.inf, **f64)
        self.paid = torch.zeros((T, R), **f64)
        self.prov = torch.zeros(T, **f64)
        self.last_t = torch.zeros((), **f64)
        self.s_hat = torch.as_tensor(np.asarray(mean_rtt, float), **f64) \
            .expand(T, self.A).clone()
        self.last_scale = torch.full((T, self.A), -np.inf, **f64)
        self.util_sum = torch.zeros(T, **f64)
        self.scale_ups = torch.zeros(T, **i64)
        self.scale_downs = torch.zeros(T, **i64)
        self.wakeups = torch.zeros(T, **i64)
        self.routed_inactive = torch.zeros((), **i64)
        self.decisions = 0
        self.syncs = 0
        if req_app is not None:
            # routed RTTs and completion times awaiting the fold (inf:
            # shed, or already folded)
            self.pend_rtt = torch.zeros((n_requests, T), **f64)
            self.pend_fin = torch.full((n_requests, T), np.inf, **f64)
        self._apps = torch.arange(self.A, device=device)

    def _blocks(self, m: torch.Tensor) -> torch.Tensor:
        return m.view(m.shape[0], self.A, self.K)

    def _accrue(self, t: float, when=None) -> None:
        """Charge the active replicas up to ``t``; ``when`` (a 0-d bool
        tensor) gates it on the device."""
        add = self.active.sum(1) * (t - self.last_t).clamp(min=0.0)
        last = self.last_t.clamp(min=t)
        if when is not None:
            add = torch.where(when, add, 0.0)
            last = torch.where(when, last, self.last_t)
        self.prov = self.prov + add
        self.last_t = last

    def _activate(self, grow: torch.Tensor, t: float) -> None:
        """Turn on the (T, R) ``grow`` replicas at ``t``, cold, refunding
        any still-paid drain tail."""
        overlap = torch.where(grow, (self.paid - t).clamp(min=0.0), 0.0)
        self.prov = self.prov - overlap.sum(1)
        self.active = self.active | grow
        self.warm = torch.where(grow, t + self.cap.warmup_s, self.warm)

    def _deactivate(self, drop: torch.Tensor, t: float,
                    busy: torch.Tensor) -> None:
        """Turn off the (T, R) ``drop`` replicas at ``t``; busy ones
        drain, and their remaining service time is paid once."""
        tail = torch.where(drop, (busy - t).clamp(min=0.0), 0.0)
        self.prov = self.prov + tail.sum(1)
        self.paid = torch.where(drop, t + tail, self.paid)
        self.active = self.active & ~drop

    # ------------------------------------------------------------------
    # membership events
    def decide(self, t: float, event: int, busy: torch.Tensor,
               j: int) -> None:
        """One autoscaler epoch at ``t`` before request ``j`` routes:
        fold the completions, accrue, targets from the active set before
        any change, then activate the lowest standby replicas and drain
        the highest idle ones first (busy ones only for the rest)."""
        cap, T = self.cap, busy.shape[0]
        if self.req_app is not None:
            self._fold(t, j)
        self._accrue(t)
        act = self._blocks(self.active)                       # (T, A, K)
        cur = act.sum(2)
        busy_b = (self._blocks(busy) > t) & act
        n_busy = busy_b.sum(2)
        util = torch.where(cur > 0, n_busy.double()
                           / cur.clamp(min=1).double(), 0.0)  # (T, A)
        if cap.autoscaler == "predictive":
            # Little's law: demand x predicted service time at rho_target
            need = torch.ceil(self.rates[event] * self.s_hat
                              / cap.rho_target).long()
        elif cap.autoscaler == "reactive":
            cooled = t - self.last_scale >= cap.cooldown_s
            need = cur + torch.where(
                cooled & (util > cap.hi_util), 1,
                torch.where(cooled & (util < cap.lo_util), -1, 0))
        else:                                                 # fixed
            need = torch.full_like(cur, cap.initial)
        hi0 = self.K if cap.max_replicas is None \
            else min(cap.max_replicas, self.K)
        hi = self._blocks(self.allowed).sum(2).clamp(max=hi0)
        # np.clip's order: the upper bound wins when the two collide
        want = torch.minimum(need.clamp(min=cap.min_replicas), hi)
        k_up = (want - cur).clamp(min=0)
        k_dn = (cur - want).clamp(min=0)
        grow = take_lowest(~act & self._blocks(self.allowed), k_up)
        idle = act & ~busy_b
        drop = take_highest(idle, k_dn)
        rem = k_dn - drop.sum(2)
        drop = drop | take_highest(act & busy_b & ~drop, rem)
        self._activate(grow.view(T, -1), t)
        self._deactivate(drop.view(T, -1), t, busy)
        self.scale_ups += grow.sum((1, 2))
        self.scale_downs += drop.sum((1, 2))
        self.last_scale = torch.where((k_up > 0) | (k_dn > 0), t,
                                      self.last_scale)
        self.util_sum = self.util_sum + util.sum(1) / max(self.A, 1)
        self.decisions += 1

    def preempt(self, t: float, busy: torch.Tensor) -> None:
        """Spot preemption: the hit replicas leave the pool (not
        activatable) and drain."""
        self._accrue(t)
        self.allowed = self.allowed & ~self.hit
        self._deactivate(self.hit & self.active, t, busy)

    def restore(self) -> None:
        """The preemption window is over: the hit replicas can be
        activated again (by an epoch or a wake, cold)."""
        self.allowed = self.allowed | self.hit

    # ------------------------------------------------------------------
    # per request
    def wake(self, a: int, now: float) -> torch.Tensor:
        """Scale-from-zero: in every trial where app ``a`` has no active
        replica, activate its first allowed candidate (any, when the
        whole pool is preempted), cold.  Returns app ``a``'s (T, K)
        active mask after the wake."""
        s = slice(a * self.K, (a + 1) * self.K)
        empty = ~self.active[:, s].any(1)
        # the serial controller accrues only when some trial wakes
        self._accrue(now, when=empty.any())
        first = take_lowest(self.allowed[:, s], empty.long())
        none = ~first.any(1) & empty
        first = first | take_lowest(torch.ones_like(first), none.long())
        overlap = torch.where(first, (self.paid[:, s] - now).clamp(min=0.0),
                              0.0)
        self.prov = self.prov - overlap.sum(1)
        self.active[:, s] |= first
        self.warm[:, s] = torch.where(first, now + self.cap.warmup_s,
                                      self.warm[:, s])
        self.wakeups += empty
        return self.active[:, s]

    def cold_mult(self, a: int, now: float) -> torch.Tensor:
        """(T, K) RTT multiplier of app ``a``'s candidates: a replica
        serves at ``cold_rtt_factor`` until it is warm."""
        warm = self.warm[:, a * self.K:(a + 1) * self.K]
        return torch.where(now < warm, self.cap.cold_rtt_factor, 1.0)

    def check_routed(self, rep: torch.Tensor,
                     served: Optional[torch.Tensor]) -> None:
        """Count served requests that landed on a drained replica (the
        invariant is that none does)."""
        ok = self.active.gather(1, rep[:, None])[:, 0]
        if served is not None:
            ok = ok | ~served
        self.routed_inactive += (~ok).sum()

    def note_prediction(self, a: int, pred: torch.Tensor,
                        served: Optional[torch.Tensor]) -> None:
        """EWMA-fold the routed request's predicted RTT into app ``a``'s
        service-time estimate."""
        al = self.cap.ewma_alpha
        cur = self.s_hat[:, a]
        new = (1.0 - al) * cur + al * pred
        self.s_hat[:, a] = new if served is None \
            else torch.where(served, new, cur)

    def note_completion(self, j: int, rtt: torch.Tensor,
                        finish: torch.Tensor,
                        served: Optional[torch.Tensor]) -> None:
        """Queue request ``j``'s observed RTT; it folds into the estimate
        at the first epoch after it completes (never clairvoyantly)."""
        self.pend_rtt[j] = rtt
        self.pend_fin[j] = finish if served is None \
            else torch.where(served, finish, np.inf)

    def _fold(self, t: float, j: int) -> None:
        """Fold every request before ``j`` that completed by ``t`` into
        its app's estimate, per (trial, app) in request order as the
        serial fold does: round r folds each (app, trial)'s r-th newly
        completed request.  The round count is the one host read."""
        if j == 0:
            return
        fin = self.pend_fin[:j]
        new = fin <= t                                        # (j, T)
        fin.masked_fill_(new, np.inf)
        hit = new[None] & (self.req_app[None, :j, None]
                           == self._apps[:, None, None])      # (A, j, T)
        rank = hit.cumsum(1)
        n = rank[:, -1]                                       # (A, T)
        rounds = int(n.max())
        self.syncs += 1
        al = self.cap.ewma_alpha
        for r in range(1, rounds + 1):
            val = torch.where(hit & (rank == r), self.pend_rtt[None, :j],
                              0.0).sum(1)                     # (A, T)
            upd = (1.0 - al) * self.s_hat + al * val.T
            self.s_hat = torch.where((n >= r).T, upd, self.s_hat)

    # ------------------------------------------------------------------
    # the summary's reads (on the host; they wait for the device)
    def finalize(self, t_end) -> np.ndarray:
        """(T,) replica-seconds provisioned, the active set charged up to
        the per-trial horizon ``t_end``."""
        dt = np.maximum(np.asarray(t_end, float) - float(self.last_t), 0.0)
        return self.prov.cpu().numpy() \
            + self.active.sum(1).cpu().numpy() * dt

    def telemetry(self) -> Dict[str, object]:
        return {"decisions": self.decisions,
                "scale_ups": self.scale_ups.cpu().numpy(),
                "scale_downs": self.scale_downs.cpu().numpy(),
                "wakeups": self.wakeups.cpu().numpy(),
                "routed_inactive": int(self.routed_inactive),
                "mean_util": self.util_sum.cpu().numpy()
                / max(self.decisions, 1),
                "active_final": self.active.sum(1).cpu().numpy()}


class EnginePool:
    """Serving-side mirror of the capacity plane: grow / shrink a pool of
    :class:`~repro_torch.serving.engine.ServingEngine` replicas and gate
    admission, on the same decision rules as the simulator's controller
    (one app, one "trial").  Host logic over the engines (a copy of the
    reference's).

    The router calls :meth:`on_request` per arrival (scale epochs ride
    the request clock, as in the simulator), :meth:`admit` before
    submitting, and reads :meth:`active_mask` into its ClusterState so
    the policy can never pick a drained engine.  ``ledger()`` reports
    the same (provisioned, busy, waste) triple the simulator pins.
    """

    def __init__(self, engines: Sequence, cap: CapacityConfig):
        self.engines = list(engines)
        self.cap = cap
        n = len(self.engines)
        n0 = min(cap.initial, n)
        for i, e in enumerate(self.engines):
            e.active = i < n0
        self.clock = self.engines[0].clock
        self._t0 = self.clock.now()
        self._last_t = self._t0
        self._next_decide = self._t0 + cap.decide_every_s
        self._last_scale = -np.inf
        self.prov_s = 0.0
        self.shed = 0
        self.scale_events: List[Tuple[float, int]] = []
        self._arrivals: List[float] = []
        self._s_hat: Optional[float] = None
        self._busy_seen = [float(getattr(e, "busy_s", 0.0))
                           for e in self.engines]

    # ------------------------------------------------------------------
    def active_mask(self) -> np.ndarray:
        return np.array([e.active for e in self.engines], bool)

    def _accrue(self, now: float) -> None:
        dt = now - self._last_t
        if dt > 0:
            self.prov_s += int(self.active_mask().sum()) * dt
            self._last_t = now
        # drain tails: serving time an INACTIVE engine spent emptying
        # its queue since the last accrual is still paid for — the
        # serving mirror of the controller's _deactivate tail, keeping
        # busy_s <= prov_s (waste in [0, 1]) through scale-downs
        for i, e in enumerate(self.engines):
            busy = float(getattr(e, "busy_s", 0.0))
            if not e.active:
                self.prov_s += max(busy - self._busy_seen[i], 0.0)
            self._busy_seen[i] = busy

    def note_prediction(self, pred: float) -> None:
        al = self.cap.ewma_alpha
        self._s_hat = pred if self._s_hat is None \
            else (1.0 - al) * self._s_hat + al * pred

    def on_request(self, now: float) -> None:
        """Record the arrival; run the latest due autoscaler epoch; wake
        the pool when everything is drained (scale-from-zero).  After an
        idle gap only the MOST RECENT due epoch runs — replaying stale
        epochs would score them against arrivals from after their time
        (the simulator controller never has this problem: its epochs
        ride the membership timeline request by request)."""
        self._arrivals.append(now)
        # only the trailing rate window (plus one epoch of slack for a
        # decision made at t < now) can matter: prune so a long-lived
        # router stays O(window), not O(lifetime)
        lo = now - self.cap.rate_window_s - self.cap.decide_every_s
        if self._arrivals[0] < lo:
            keep = np.searchsorted(np.asarray(self._arrivals), lo,
                                   side="right")
            del self._arrivals[:keep]
        if self._next_decide <= now:
            missed = int((now - self._next_decide)
                         // self.cap.decide_every_s)
            t = self._next_decide + missed * self.cap.decide_every_s
            self._decide(t)
            self._next_decide = t + self.cap.decide_every_s
        if not any(e.active for e in self.engines):
            self._accrue(now)
            self.engines[0].active = True
            self.scale_events.append((now, +1))

    def _rate(self, now: float) -> float:
        win = min(self.cap.rate_window_s, max(now - self._t0, 1e-9))
        lo = now - win
        return sum(1 for t in self._arrivals if lo < t <= now) / win

    def _decide(self, now: float) -> None:
        cap = self.cap
        act = [e for e in self.engines if e.active]
        cur = len(act)
        if cap.autoscaler == "predictive":
            s = self._s_hat if self._s_hat is not None else 1.0
            need = int(np.ceil(self._rate(now) * s / cap.rho_target))
        elif cap.autoscaler == "reactive":
            util = (sum(1 for e in act if e.pending() > 0)
                    / max(cur, 1)) if cur else 0.0
            cooled = now - self._last_scale >= cap.cooldown_s
            need = cur + (1 if cooled and util > cap.hi_util else
                          -1 if cooled and util < cap.lo_util else 0)
        else:
            need = cap.initial
        hi = len(self.engines) if cap.max_replicas is None \
            else min(cap.max_replicas, len(self.engines))
        want = int(np.clip(need, cap.min_replicas, hi))
        if want == cur:
            return
        self._accrue(now)
        self._last_scale = now
        if want > cur:
            for e in self.engines:
                if not e.active and want > cur:
                    e.active = True
                    cur += 1
            self.scale_events.append((now, +1))
        else:
            # drain idle engines first, highest index first
            for e in reversed(self.engines):
                if cur <= want:
                    break
                if e.active and e.pending() == 0:
                    e.active = False
                    cur -= 1
            for e in reversed(self.engines):
                if cur <= want:
                    break
                if e.active:
                    e.active = False
                    cur -= 1
            self.scale_events.append((now, -1))

    # ------------------------------------------------------------------
    def admit(self, now: float) -> bool:
        """Admission hook: False sheds the request (queues on the active
        set already exceed the wait limit)."""
        if self.cap.admission_limit_s is None:
            return True
        waits = [e.pending() * (self._s_hat or 1.0) / max(e.max_batch, 1)
                 for e in self.engines if e.active]
        if not waits:
            return True
        if min(waits) > self.cap.admission_limit_s:
            self.shed += 1
            return False
        return True

    def ledger(self) -> Dict[str, float]:
        """(provisioned, busy, waste, shed) — the serving-side triple."""
        now = self.clock.now()
        self._accrue(now)
        busy = float(sum(getattr(e, "busy_s", 0.0) for e in self.engines))
        prov = max(self.prov_s, 1e-9)
        return {"provisioned_s": self.prov_s, "busy_s": busy,
                "waste": float(np.clip(1.0 - busy / prov, 0.0, 1.0)),
                "shed": self.shed}
