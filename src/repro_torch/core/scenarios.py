"""Declarative co-location scenarios (a copy of the reference's
``core/scenarios.py`` restricted to what the port lowers).

A :class:`ScenarioSpec` names one regime and compiles to the
:class:`~repro_torch.core.simulator.SimConfig` the core runs.  The field
set is the reference's, so a spec carries over whole; the registry holds
the reference's twenty-four scenarios in its order: the nine of the
standing matrix, cold start, the four closed-loop drift scenarios, the
four capacity-plane scenarios, the resilience plane's five (gray
failure, the staleness storm, the correlated outage and the retry-storm
pair) and the mixed fleet.

Seed discipline: ``compile(seed=s)`` varies topology/noise with ``s``
but pins the arrival stream to a per-scenario ``stream_seed`` (crc32 of
the name), so configs differing only in seed see identical request
sequences — the precondition for the campaign's one-pass seed batching.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, fields, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.capacity import CapacityConfig
from repro_torch.core.resilience import ResilienceConfig
from repro_torch.core.simulator import APPS, ARRIVAL_PROCESSES, SimConfig


@dataclass(frozen=True)
class ScenarioSpec:
    """One named co-location regime; every field maps onto SimConfig."""
    name: str
    description: str = ""
    # workload
    arrival_process: str = "poisson"
    arrival_params: Tuple[float, ...] = ()
    arrival_rate: float = 2.0
    apps: Tuple[str, ...] = tuple(APPS)
    n_requests: int = 200
    n_trials: int = 8
    # cluster hardware
    n_nodes: int = 10
    n_replicas_per_app: int = 4
    heterogeneity: float = 0.3
    node_tiers: Optional[Tuple[float, ...]] = None
    # co-location interference
    interference_strength: float = 0.5
    interference_profile: str = "uniform"
    # failures
    churn: Optional[Tuple[float, float]] = None
    # prediction quality
    accuracy: float = 0.8
    prediction_lag_s: float = 0.0
    cold_start_s: float = 0.0
    outage: Optional[Tuple[float, float]] = None
    hedge_factor: Optional[float] = None
    # closed-loop online prediction (core/online.py)
    closed_loop: bool = False
    online_warmup_s: float = 20.0
    retrain_every_s: float = 0.0
    online_window: int = 400
    fallback_threshold: float = 0.0
    accuracy_window: int = 40
    # mid-run workload drift
    t_drift: Optional[float] = None
    drift_interference: Optional[float] = None
    drift_rtt_factor: Optional[Tuple[float, ...]] = None
    drift_tier_shuffle: bool = False
    # capacity plane (core/capacity.py)
    capacity: Optional[CapacityConfig] = None
    preempt: Optional[Tuple[float, float]] = None
    # resilience plane (core/resilience.py)
    resilience: Optional[ResilienceConfig] = None

    def __post_init__(self):
        if self.arrival_process not in ARRIVAL_PROCESSES:
            raise ValueError(f"{self.name}: unknown arrival_process "
                             f"{self.arrival_process!r}")
        unknown = [a for a in self.apps if a not in APPS]
        if unknown:
            raise ValueError(f"{self.name}: unknown apps {unknown}")
        drifts = (self.drift_interference is not None
                  or self.drift_rtt_factor is not None
                  or self.drift_tier_shuffle)
        if self.t_drift is None and drifts:
            raise ValueError(f"{self.name}: drift knobs set without t_drift")
        if self.t_drift is not None and not drifts:
            raise ValueError(f"{self.name}: t_drift set but no drift knob")
        if self.drift_rtt_factor is not None \
                and len(self.drift_rtt_factor) not in (1, len(self.apps)):
            raise ValueError(
                f"{self.name}: drift_rtt_factor needs 1 or "
                f"{len(self.apps)} entries, got "
                f"{len(self.drift_rtt_factor)}")
        if self.preempt is not None and self.capacity is None:
            raise ValueError(f"{self.name}: preempt requires a capacity "
                             "config (the elastic replica set handles "
                             "the takeback)")
        if self.resilience is not None and self.resilience.client_side \
                and self.hedge_factor is not None:
            raise ValueError(
                f"{self.name}: hedge_factor and resilience timeouts are "
                "mutually exclusive (a hedged duplicate has no attempt "
                "identity for the timeout/breaker state machine)")

    @property
    def stream_seed(self) -> int:
        """Deterministic per-scenario arrival-stream seed."""
        return zlib.crc32(self.name.encode()) % 1_000_000

    def compile(self, seed: int = 0, **overrides) -> SimConfig:
        """Materialise the SimConfig this scenario runs under ``seed``;
        ``overrides`` patch the result (tests shrink sizes)."""
        sim_fields = {f.name for f in fields(SimConfig)}
        kwargs = {f.name: getattr(self, f.name) for f in fields(self)
                  if f.name in sim_fields}
        cfg = SimConfig(seed=seed, stream_seed=self.stream_seed, **kwargs)
        return replace(cfg, **overrides) if overrides else cfg


# closed-loop drift scenarios: predictions come from per-(trial, app)
# predictors trained on observed RTTs; at t_drift the regime shifts and a
# frozen fleet degrades while periodic retraining recovers.  They keep
# interference low and always include a structural (node-speed) shift.
_DRIFT_APPS = ("motioncor2", "fft_mock", "gctf", "ctffind4")
_DRIFT = dict(apps=_DRIFT_APPS, n_requests=560, arrival_rate=1.0,
              heterogeneity=0.05, node_tiers=(-0.6, 0.0, 1.8),
              closed_loop=True, online_warmup_s=40.0,
              retrain_every_s=12.0, online_window=120, t_drift=80.0)

# capacity-plane scenarios: a predictive autoscaler provisions replicas
# from Little's law (trailing demand x the service-time forecast /
# rho_target), admission control sheds what the active set cannot bound,
# and every cell reports the (RTT, waste, shed) triple.  The apps are the
# three light stages (means 5/5/3 s), so the overload peaks need ~8-10 of
# the 12 replicas per app.
_CAP_APPS = ("motioncor2", "gctf", "ctffind4")
_CAP = dict(apps=_CAP_APPS, n_nodes=12, n_replicas_per_app=12,
            heterogeneity=0.2, interference_strength=0.4, accuracy=0.85,
            n_trials=8)
_CAP_CFG = CapacityConfig(min_replicas=2, decide_every_s=5.0,
                          warmup_s=8.0, cold_rtt_factor=2.0,
                          slo_target_s=15.0, rho_target=0.75,
                          rate_window_s=15.0, cooldown_s=10.0,
                          admission_limit_s=45.0)

# resilience-plane scenarios with client semantics: a per-attempt
# timeout, bounded retries with backoff and jitter, per-replica breakers.
# The retry-storm pair is the metastable-collapse study: with m retries a
# timed-out request dispatches up to 1 + m attempts, each occupying its
# server for its whole service time, so at the 10x ramp's peak the
# amplified load crosses the fleet's capacity and keeps the queues past
# the 25 s deadline after the offered load recedes.  The calibration
# (baseline p99 just under the timeout, the heavy "upload" app seeding
# the collapse) holds at this size: do not scale it.
_RETRY_STORM = dict(
    n_nodes=6, n_replicas_per_app=6, heterogeneity=0.15,
    interference_strength=0.15, accuracy=0.85, n_trials=8,
    arrival_process="ramp", arrival_params=(30.0, 80.0, 130.0, 10.0),
    arrival_rate=0.6, n_requests=450)

#: the registry
SCENARIOS: Dict[str, ScenarioSpec] = {s.name: s for s in (
    ScenarioSpec(
        name="baseline",
        description="The paper's Fig. 11 setting: Poisson arrivals, "
                    "moderate heterogeneity, moderate interference, 80% "
                    "accuracy."),
    ScenarioSpec(
        name="colocation-surge",
        description="Dense co-location with a hotspot interferer.",
        n_nodes=5, interference_strength=1.2,
        interference_profile="hotspot", arrival_rate=3.0),
    ScenarioSpec(
        name="hetero-tiers",
        description="Three discrete hardware generations plus mild "
                    "per-node jitter.",
        node_tiers=(-0.4, 0.0, 1.0), heterogeneity=0.1),
    ScenarioSpec(
        name="diurnal",
        description="Sinusoidal day/night arrival modulation.",
        arrival_process="diurnal", arrival_params=(240.0, 0.8)),
    ScenarioSpec(
        name="flash-crowd",
        description="An 8x arrival spike 60s in, 30s long.",
        arrival_process="flash_crowd", arrival_params=(60.0, 30.0, 8.0)),
    ScenarioSpec(
        name="bursty",
        description="On/off bursts: 10s at 6x rate, 30s quiet.",
        arrival_process="bursty", arrival_params=(6.0, 10.0, 30.0)),
    ScenarioSpec(
        name="churn",
        description="One node per trial fails at t=30s for 60s.",
        churn=(30.0, 60.0)),
    ScenarioSpec(
        name="stale-predictions",
        description="Predictors only see occupancy every 20s.",
        prediction_lag_s=20.0),
    ScenarioSpec(
        name="cold-start",
        description="No trained predictors for the first 40s: predictions "
                    "carry only app-mean RTTs until the knowledge base "
                    "warms.",
        cold_start_s=40.0),
    ScenarioSpec(
        name="metric-outage",
        description="The metric source blacks out from t=30s for 40s.",
        prediction_lag_s=5.0, outage=(30.0, 40.0)),
    ScenarioSpec(
        name="tier-drift",
        description="Hardware reshuffle under a trained fleet: at t=80s "
                    "node speeds are permuted (a live migration / refresh "
                    "epoch) — frozen predictors now prefer the "
                    "previously-fast nodes.",
        interference_strength=0.2, drift_tier_shuffle=True, **_DRIFT),
    ScenarioSpec(
        name="app-drift",
        description="A release changes app profiles (per-app mean-RTT "
                    "factors) while the scheduler rebalances placements "
                    "(tier reshuffle): both the scale and the structure a "
                    "trained predictor learned are stale after t=80s.",
        interference_strength=0.3, drift_tier_shuffle=True,
        drift_rtt_factor=(1.8, 0.6, 1.5, 0.7), **_DRIFT),
    ScenarioSpec(
        name="colocation-drift",
        description="Tenancy epoch change: the interference matrix is "
                    "redrawn, node speeds reshuffle, and app means shift — "
                    "every signal the fleet learned moves at once.",
        **{**_DRIFT, "arrival_rate": 0.9}, interference_strength=0.4,
        drift_interference=0.6, drift_tier_shuffle=True,
        drift_rtt_factor=(1.4, 0.8, 1.2, 0.9)),
    ScenarioSpec(
        name="drift-fallback",
        description="tier-drift with the viability rule armed: trials "
                    "whose rolling prediction accuracy drops below 0.55 "
                    "fall back to least_conn until retraining restores the "
                    "predictor.",
        interference_strength=0.2, drift_tier_shuffle=True,
        fallback_threshold=0.55, **_DRIFT),
    ScenarioSpec(
        name="overload-ramp",
        description="Arrivals ramp 1x -> 5x over [30s, 90s] and recede by "
                    "150s: the autoscaler must grow ahead of the ramp (or "
                    "p95 explodes) and release capacity behind it (or "
                    "waste does).",
        arrival_process="ramp", arrival_params=(30.0, 90.0, 150.0, 5.0),
        arrival_rate=0.9, n_requests=480, capacity=_CAP_CFG, **_CAP),
    ScenarioSpec(
        name="flash-crowd-autoscale",
        description="A 6x flash crowd 50s in, 40s long, over a minimally-"
                    "provisioned pool: the +1-per-cooldown reactive rule "
                    "cannot reach the required size inside the spike, the "
                    "Little's-law predictive rule jumps straight there.",
        arrival_process="flash_crowd", arrival_params=(50.0, 40.0, 6.0),
        arrival_rate=0.8, n_requests=420, capacity=_CAP_CFG, **_CAP),
    ScenarioSpec(
        name="scale-to-zero-idle",
        description="Long idle valleys between short bursts (20s on at 6x, "
                    "70s off) with min_replicas=0: the pool drains to zero "
                    "when demand stops and pays a cold-start penalty on "
                    "the first arrival of the next burst.",
        arrival_process="bursty", arrival_params=(6.0, 20.0, 70.0),
        arrival_rate=0.5, n_requests=360,
        capacity=CapacityConfig(min_replicas=0, initial_replicas=1,
                                decide_every_s=5.0, warmup_s=6.0,
                                cold_rtt_factor=2.0, slo_target_s=15.0,
                                rho_target=0.75, rate_window_s=12.0,
                                cooldown_s=10.0, admission_limit_s=60.0),
        **_CAP),
    ScenarioSpec(
        name="spot-preemption",
        description="A spot node is reclaimed at t=50s for 60s under "
                    "steady load: its replicas drain out of the pool and "
                    "the autoscaler back-fills from standby capacity "
                    "(which comes up cold).",
        arrival_rate=1.2, n_requests=420, preempt=(50.0, 60.0),
        capacity=CapacityConfig(min_replicas=2, decide_every_s=5.0,
                                warmup_s=8.0, cold_rtt_factor=2.0,
                                slo_target_s=15.0, rho_target=0.7,
                                rate_window_s=15.0, cooldown_s=10.0,
                                admission_limit_s=45.0),
        **_CAP),
    ScenarioSpec(
        name="gray-failure",
        description="One node per trial serves every RTT at 4x from t=40s "
                    "for 60s while its advertised metrics stay healthy: "
                    "the predictor keeps routing onto it (the paper's "
                    "signals cannot see a fail-slow fault), only the "
                    "oracle avoids it.",
        n_requests=300,
        resilience=ResilienceConfig(gray=(40.0, 60.0, 4.0))),
    ScenarioSpec(
        name="staleness-storm",
        description="The metric pipeline stalls from t=40s for 50s under "
                    "heavy interference: the occupancy snapshot freezes "
                    "(a staleness storm on the PeriodicRefresh hook) and "
                    "predictions route on a dead view of the cluster.",
        interference_strength=0.9, arrival_rate=2.5, n_requests=300,
        prediction_lag_s=2.0,
        resilience=ResilienceConfig(staleness=(40.0, 50.0))),
    ScenarioSpec(
        name="correlated-outage",
        description="A contiguous 2-node group drops at t=40s for 30s: "
                    "clients ride timeouts + 2 retries with breakers, and "
                    "the load concentrates on the surviving nodes.",
        **_RETRY_STORM | dict(arrival_process="poisson", arrival_params=(),
                              arrival_rate=0.8, n_requests=300),
        resilience=ResilienceConfig(
            timeout_s=25.0, max_retries=2, backoff_base_s=0.5,
            breaker_threshold=3, breaker_cooldown_s=10.0,
            outage_group=(40.0, 30.0, 2))),
    ScenarioSpec(
        name="retry-storm",
        description="Naive clients (25s timeout, 3 retries, no breaker) "
                    "over the 10x overload ramp: retry amplification keeps "
                    "the fleet saturated after the offered load recedes — "
                    "goodput stays collapsed at a load the fleet handled "
                    "comfortably before the peak (metastable failure).",
        **_RETRY_STORM,
        resilience=ResilienceConfig(timeout_s=25.0, max_retries=3,
                                    backoff_base_s=0.5, backoff_mult=2.0,
                                    backoff_jitter=0.5)),
    ScenarioSpec(
        name="breaker-saves-retry-storm",
        description="The same storm with per-replica circuit breakers and "
                    "admission control over a fixed full-size pool: "
                    "breakers fail fast instead of dispatching doomed "
                    "attempts, admission sheds the excess, and the fleet "
                    "recovers as the load recedes.",
        **_RETRY_STORM,
        capacity=CapacityConfig(autoscaler="fixed", min_replicas=6,
                                decide_every_s=5.0, warmup_s=0.0,
                                slo_target_s=15.0, admission_limit_s=25.0),
        resilience=ResilienceConfig(timeout_s=25.0, max_retries=3,
                                    backoff_base_s=0.5, backoff_mult=2.0,
                                    backoff_jitter=0.5, breaker_threshold=3,
                                    breaker_cooldown_s=10.0)),
    ScenarioSpec(
        name="mixed-app-fleet",
        description="Everything at once: bursty arrivals over tiered "
                    "hardware with hotspot interference and imperfect "
                    "predictions — the closest to a production fleet.",
        arrival_process="bursty", arrival_params=(4.0, 15.0, 25.0),
        node_tiers=(-0.3, 0.0, 0.6), heterogeneity=0.15,
        interference_strength=0.9, interference_profile="hotspot",
        accuracy=0.7),
)}


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(SCENARIOS)}") from None


def scenario_names() -> List[str]:
    return list(SCENARIOS)
