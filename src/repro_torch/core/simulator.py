"""§6 load-balancing simulation: configuration, cluster build, summary.

A copy of the parts of the reference's ``core/simulator.py`` that the
port's batched core reads: the app profiles, :class:`SimConfig`, the
topology / request-stream / noise draws of :func:`_build_cluster` (same
field names, same RNG streams in the same order, so both sides draw the
same cluster bit for bit), and the summary half of :class:`_Metrics`.
The serial stepper is not ported: the reference's stays the semantics
the port is tested against.

Fields of features the port does not lower yet (capacity plane, spot
preemption, resilience, trace) stay on :class:`SimConfig` as optional
values so configurations carry over unchanged; :func:`unlowered` names
the first one a config sets.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rng import rng_stream

# SPA app profiles: (mean RTT s, cpu cores/req, mem GB/req) — scaled from
# the paper's app set (upload / MotionCor2 / FFT mock / gCTF / ctffind4).
APPS = {
    "upload": (20.0, 0.5, 1.0),
    "motioncor2": (5.0, 2.0, 4.0),
    "fft_mock": (10.0, 1.0, 2.0),
    "gctf": (5.0, 2.0, 3.0),
    "ctffind4": (3.0, 1.0, 1.0),
}

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal", "flash_crowd", "ramp")

#: accounting SLO when no capacity plane sets one
DEFAULT_SLO_S = 30.0


@dataclass
class SimConfig:
    n_nodes: int = 10
    n_replicas_per_app: int = 4
    apps: Tuple[str, ...] = tuple(APPS)
    n_requests: int = 400           # per trial (all apps interleaved)
    n_trials: int = 200
    accuracy: float = 0.8           # p in Eq. 12
    heterogeneity: float = 0.3      # std of node acceleration factors
    interference_strength: float = 0.5
    arrival_rate: float = 2.0       # requests/s entering the cluster
    seed: int = 0
    hedge_factor: Optional[float] = None    # PerfAware hedging threshold
    prediction_lag_s: float = 0.0           # stale-prediction refresh lag
    churn: Optional[Tuple[float, float]] = None  # (t_fail_s, downtime_s)
    #: separate RNG stream for the request arrivals, shared across seeds
    stream_seed: Optional[int] = None
    arrival_process: str = "poisson"
    arrival_params: Tuple[float, ...] = ()
    node_tiers: Optional[Tuple[float, ...]] = None
    interference_profile: str = "uniform"   # or "hotspot"
    cold_start_s: float = 0.0               # untrained-predictor window
    outage: Optional[Tuple[float, float]] = None  # (t_start_s, duration_s)
    # -- closed-loop online prediction (core/online.py) ------------------
    closed_loop: bool = False
    online_warmup_s: float = 20.0     # observe-only window before 1st train
    retrain_every_s: float = 0.0      # 0 -> train once at warmup, frozen
    online_window: int = 400          # rolling observation window (requests)
    fallback_threshold: float = 0.0   # accuracy floor; 0 disables fallback
    accuracy_window: int = 40         # rolling accuracy tracker length
    # -- mid-run workload drift ----------------------------------------
    t_drift: Optional[float] = None               # drift onset (s)
    drift_interference: Optional[float] = None    # redraw imat, new strength
    drift_rtt_factor: Optional[Tuple[float, ...]] = None  # per-app factors
    drift_tier_shuffle: bool = False              # permute node speeds
    # -- not lowered in the port yet: carried so configs stay whole ----
    capacity: Optional[Any] = None
    preempt: Optional[Tuple[float, float]] = None
    resilience: Optional[Any] = None
    trace: Optional[Any] = None


def unlowered(cfg: SimConfig) -> Optional[str]:
    """The first feature ``cfg`` sets that the port does not lower yet,
    as a human-readable reason; None when the port runs it whole."""
    checks = (
        (cfg.capacity is not None, "the capacity plane (capacity)"),
        (cfg.preempt is not None, "spot preemption (preempt)"),
        (cfg.resilience is not None, "the resilience plane (resilience)"),
        (cfg.trace is not None, "the flight-recorder trace (trace)"),
    )
    for hit, what in checks:
        if hit:
            return f"{what} is not lowered in the port yet"
    return None


def _interference_matrix(apps: Sequence[str], strength: float,
                         rng) -> np.ndarray:
    """I[a, b]: relative RTT-std increase on app a per co-located busy b."""
    n = len(apps)
    base = rng.uniform(0.05, 0.35, size=(n, n))
    return strength * (base + base.T) / 2.0


def _apply_interference_profile(imat: np.ndarray, profile: str,
                                n_apps: int) -> np.ndarray:
    """Shape the raw interference draw: ``hotspot`` amplifies one heavy
    interferer's row AND column (the paper's MotionCor2-style app)."""
    if profile == "hotspot":
        h = min(1, n_apps - 1)
        imat = imat.copy()
        imat[h, :] *= 3.0
        imat[:, h] *= 3.0
    elif profile != "uniform":
        raise ValueError(f"unknown interference_profile {profile!r}")
    return imat


def _rate_factor(cfg: SimConfig, t: float) -> float:
    """Instantaneous arrival-rate multiplier at time t."""
    kind, p = cfg.arrival_process, cfg.arrival_params
    if kind == "bursty":
        factor, on_s, off_s = p or (6.0, 10.0, 30.0)
        return factor if (t % (on_s + off_s)) < on_s else 1.0
    if kind == "diurnal":
        period_s, amplitude = p or (240.0, 0.8)
        return 1.0 + amplitude * np.sin(2.0 * np.pi * t / period_s)
    if kind == "flash_crowd":
        t_start, duration, factor = p or (60.0, 30.0, 8.0)
        return factor if t_start <= t < t_start + duration else 1.0
    if kind == "ramp":
        t0, tp, t1, peak = p or (30.0, 80.0, 140.0, 5.0)
        if t <= t0 or t >= t1:
            return 1.0
        if t <= tp:
            return 1.0 + (peak - 1.0) * (t - t0) / max(tp - t0, 1e-9)
        return 1.0 + (peak - 1.0) * (t1 - t) / max(t1 - tp, 1e-9)
    raise ValueError(f"unknown arrival_process {kind!r}; "
                     f"one of {ARRIVAL_PROCESSES}")


def _arrival_times(cfg: SimConfig, rng) -> np.ndarray:
    """Request arrival times.  Poisson keeps the seed's exact draw; the
    modulated processes rescale unit-exponential gaps by the local rate
    (time-rescaling construction of an inhomogeneous Poisson process)."""
    if cfg.arrival_process == "poisson":
        return np.cumsum(rng.exponential(1.0 / cfg.arrival_rate,
                                         size=cfg.n_requests))
    gaps = rng.exponential(1.0, size=cfg.n_requests)
    out = np.empty(cfg.n_requests)
    t = 0.0
    for i, e in enumerate(gaps):
        t += e / max(cfg.arrival_rate * _rate_factor(cfg, t), 1e-9)
        out[i] = t
    return out


@dataclass
class _Cluster:
    """Static per-run arrays: topology, request stream, pre-drawn noise.

    ``imat`` is (A, A) for a single-seed cluster and (T, A, A) for the
    campaign's stacked clusters (each seed drew its own mix).  The
    ``*_post`` arrays are the post-drift regime (active once ``now >=
    cfg.t_drift``): a None field keeps its pre-drift counterpart.  The
    other optional fields belong to features the port does not lower
    yet; they are kept so a reference cluster carries over whole
    (``repro_torch.interop.cluster_from_reference``).
    """
    cfg: SimConfig
    app_of: np.ndarray        # (R,) app index per replica
    mean_rtt: np.ndarray      # (A,)
    cpu_req: np.ndarray       # (A,)
    mem_req: np.ndarray       # (A,)
    imat: np.ndarray          # (A, A) or (T, A, A) interference matrix
    node_of: np.ndarray       # (T, R) node per replica per trial
    accel: np.ndarray         # (T, N) node acceleration factors
    req_app: np.ndarray       # (J,) app index per request
    req_t: np.ndarray         # (J,) arrival time per request
    z_rtt: np.ndarray         # (T, J) RTT noise
    z_pred: np.ndarray        # (T, J, R) prediction noise
    failed_node: Optional[np.ndarray] = None   # (T,) churn target
    imat_post: Optional[np.ndarray] = None
    accel_post: Optional[np.ndarray] = None
    mean_rtt_post: Optional[np.ndarray] = None
    preempted_node: Optional[np.ndarray] = None
    gray_rep: Optional[np.ndarray] = None
    group_rep: Optional[np.ndarray] = None
    z_jitter: Optional[np.ndarray] = None


def _build_cluster(cfg: SimConfig) -> _Cluster:
    """Topology + request stream + noise + the post-drift regime, in the
    reference's RNG order.

    Raises NotImplementedError for configs whose extra draws
    (preemption, faults) belong to features the port does not lower."""
    reason = unlowered(cfg)
    if reason is not None:
        raise NotImplementedError(reason)
    rng = rng_stream(cfg.seed, "topology")
    T = cfg.n_trials
    A = len(cfg.apps)
    R = A * cfg.n_replicas_per_app
    imat = _apply_interference_profile(
        _interference_matrix(cfg.apps, cfg.interference_strength, rng),
        cfg.interference_profile, A)
    # per-trial random placement (isolate policy effect, as in the paper)
    node_of = rng.integers(0, cfg.n_nodes, size=(T, R))
    accel = np.clip(rng.normal(0.0, cfg.heterogeneity, size=(T, cfg.n_nodes)),
                    -0.8, 2.0)
    if cfg.node_tiers is not None:
        tiers = np.asarray(cfg.node_tiers, float)
        tier_of = np.arange(cfg.n_nodes) % len(tiers)
        accel = np.clip(tiers[tier_of][None, :] + accel, -0.8, 4.0)
    # with stream_seed set, arrivals come from their own generator so
    # configs differing only in `seed` share one stream (campaign lockstep)
    if cfg.stream_seed is None:
        stream_rng = noise_rng = rng_stream(cfg.seed, "noise")
    else:
        stream_rng = rng_stream(cfg.stream_seed, "arrival")
        noise_rng = rng_stream(cfg.seed, "noise_streamed")
    req_app = stream_rng.integers(0, A, size=cfg.n_requests)
    req_t = _arrival_times(cfg, stream_rng)
    z_rtt = noise_rng.standard_normal((T, cfg.n_requests))
    z_pred = noise_rng.standard_normal((T, cfg.n_requests, R))
    failed_node = None
    if cfg.churn is not None:
        failed_node = rng_stream(cfg.seed, "churn").integers(
            0, cfg.n_nodes, size=T)
    mean_rtt = np.array([APPS[a][0] for a in cfg.apps])
    # post-drift regime: redrawn interference mix, reshuffled node
    # speeds, rescaled app means, from the drift stream in this order
    imat_post = accel_post = mean_rtt_post = None
    if cfg.t_drift is not None:
        drift_rng = rng_stream(cfg.seed, "drift")
        if cfg.drift_interference is not None:
            imat_post = _apply_interference_profile(
                _interference_matrix(cfg.apps, cfg.drift_interference,
                                     drift_rng),
                cfg.interference_profile, A)
        if cfg.drift_tier_shuffle:
            perm = np.argsort(drift_rng.random((T, cfg.n_nodes)), axis=1)
            accel_post = np.take_along_axis(accel, perm, axis=1)
        if cfg.drift_rtt_factor is not None:
            factor = np.broadcast_to(
                np.asarray(cfg.drift_rtt_factor, float), (A,))
            mean_rtt_post = mean_rtt * factor
    return _Cluster(
        cfg=cfg,
        app_of=np.repeat(np.arange(A), cfg.n_replicas_per_app),
        mean_rtt=mean_rtt,
        cpu_req=np.array([APPS[a][1] for a in cfg.apps]),
        mem_req=np.array([APPS[a][2] for a in cfg.apps]),
        imat=imat, node_of=node_of, accel=accel,
        req_app=req_app, req_t=req_t, z_rtt=z_rtt, z_pred=z_pred,
        failed_node=failed_node, imat_post=imat_post,
        accel_post=accel_post, mean_rtt_post=mean_rtt_post)


class _Metrics:
    """Per-trial results of one run and their summary: the full RTT
    matrix (tail percentiles, per-app breakdown), resource-seconds,
    assignments.  The accumulation side lives in the core's step; this
    is the summary half of the reference's ``_Metrics``."""

    def __init__(self, cfg: SimConfig):
        T, J = cfg.n_trials, cfg.n_requests
        self.cfg = cfg
        self.rtts = np.zeros((T, J))
        self.cpu_s = np.zeros(T)
        self.mem_s = np.zeros(T)
        self.chosen = np.zeros((T, J), dtype=np.int64)
        self.n_hedged = 0
        self.hedged = np.zeros(T, dtype=np.int64)   # per-trial hedge count
        #: least_conn-fallback routings of the closed loop, per trial
        self.fallback = np.zeros(T, dtype=np.int64)
        self.slo = DEFAULT_SLO_S
        self.busy_s = np.zeros(T)           # replica-seconds of service
        self.slo_violation_s = np.zeros(T)  # response time above the SLO
        # the slice drops no request: no shed, no timeout (the keys stay
        # so summaries line up with the reference's)
        self.shed = np.zeros((T, J), bool)
        self.timeout = np.zeros((T, J), bool)

    def summary(self, cluster: _Cluster,
                busy_until: Optional[np.ndarray] = None
                ) -> Dict[str, np.ndarray]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            p50, p95, p99 = np.percentile(self.rtts, [50, 95, 99], axis=1)
            per_app = {}
            for i, name in enumerate(self.cfg.apps):
                mask = cluster.req_app == i
                if mask.any():
                    per_app[name] = np.mean(self.rtts[:, mask], axis=1)
            mean_rtt = np.mean(self.rtts, axis=1)
        # replica-seconds provisioned: the full pool over the per-trial
        # horizon (which covers every completion, so waste stays in [0, 1])
        t_end = float(cluster.req_t[-1])
        if busy_until is not None:
            t_end = np.maximum(t_end, busy_until.max(axis=1))
        provisioned = len(cluster.app_of) * np.asarray(t_end, float) \
            * np.ones(len(self.rtts))
        waste = np.clip(1.0 - self.busy_s / np.maximum(provisioned, 1e-9),
                        0.0, 1.0)
        return {"mean_rtt": mean_rtt,
                "p50_rtt": p50, "p95_rtt": p95, "p99_rtt": p99,
                "per_app": per_app,
                "cpu_s": self.cpu_s, "mem_s": self.mem_s,
                "chosen": self.chosen, "n_hedged": self.n_hedged,
                "hedged_per_trial": self.hedged,
                "n_fallback": int(self.fallback.sum()),
                "fallback_per_trial": self.fallback,
                "provisioned_s": provisioned, "busy_s": self.busy_s,
                "waste": waste,
                "shed_rate": self.shed.mean(axis=1),
                "slo_violation_s": self.slo_violation_s,
                "goodput": 1.0 - (self.shed | self.timeout).mean(axis=1),
                "timeout_rate": self.timeout.mean(axis=1),
                "rtts": self.rtts, "req_t": cluster.req_t}
