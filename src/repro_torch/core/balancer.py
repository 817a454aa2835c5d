"""The load-balancing policy engine (a port of the reference's
``core/balancer.py``).

One policy is one class, and every layer dispatches through the one
``POLICIES`` registry: the batched simulation core reads each class's
``requires`` and ``scan_lowered`` (its scores are written out in
``repro_torch.core.simcore``), and the serving router
(``repro_torch.serving.router.MorpheusRouter``) builds a 1-trial
:class:`ClusterState` and calls the classes' ``score`` / ``pick``.

A :class:`ClusterState` holds (T, C) float64 tensors on one device (T
trials, C candidate replicas); scores are (T, C) float64 tensors on the
same device, in the reference's float operations, so they are equal to
the reference's bit for bit.  Scores are "estimated completion seconds,
lower is better" for the latency-aware policies and synthetic orderings
(rotation distance, uniform draws) for the reactive ones; reactive
policies prefer idle replicas and fall back to the least-loaded busy one
through a large additive penalty.  The round-robin cursor is a device
tensor; :class:`RandomChoice` draws on the host from the same numpy
generator as the reference (``rng_from_key``), so its draws replay bit
for bit, and copies them to the device.

``perf_aware`` may hedge: if the chosen replica's predicted RTT exceeds
``hedge_factor`` x the best busy replica's predicted completion (its
wait plus its predicted RTT), the request is also queued on the
runner-up and the earlier completion wins.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.core.rng import rng_from_key
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["BUSY_PENALTY", "Replica", "ClusterState", "Policy", "RoundRobin",
           "RandomChoice", "LeastConnections", "PerfAware", "Oracle",
           "POLICIES", "make_policy"]

#: score added to busy replicas by the idle-first policies, so an idle
#: replica always beats a busy one
BUSY_PENALTY = 1e9

_F64 = torch.float64


@dataclass
class Replica:
    idx: int
    app: str
    node: str
    busy_until: float = 0.0
    queue_depth: float = 0.0

    def idle(self, now: float) -> bool:
        return self.busy_until <= now


def _tensor(x, dtype, device) -> torch.Tensor:
    """``x`` as an at-least-2-d tensor of ``dtype`` on ``device``."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.reshape(1, -1) if t.dim() < 2 else t


@dataclass
class ClusterState:
    """Snapshot of ``T`` parallel clusters with ``C`` candidate replicas.

    ``busy_until`` / ``queue_depth`` are what a real router can observe;
    ``predicted`` is the knowledge-base signal; ``actual`` the true RTT,
    which only a simulation has (the oracle's signal); ``active`` the
    capacity plane's membership mask (False: never picked; None: all
    routable).  Arrays are taken as (T, C) float64 tensors (``active``
    bool) on ``busy_until``'s device when it is a tensor, else on
    ``device`` (None: the CUDA card)."""
    now: float
    busy_until: torch.Tensor
    queue_depth: Optional[torch.Tensor] = None
    predicted: Optional[torch.Tensor] = None
    actual: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None
    device: DeviceLike = None

    def __post_init__(self):
        dev = self.busy_until.device \
            if isinstance(self.busy_until, torch.Tensor) \
            else resolve_device(self.device)
        self.device = dev
        self.busy_until = _tensor(self.busy_until, _F64, dev)
        for name in ("queue_depth", "predicted", "actual"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, _tensor(v, _F64, dev))
        if self.queue_depth is None:
            self.queue_depth = torch.zeros_like(self.busy_until)
        if self.active is not None:
            self.active = _tensor(self.active, torch.bool, dev)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.busy_until.shape)

    def wait(self) -> torch.Tensor:
        """Remaining queue wait per candidate, clamped at 0."""
        return (self.busy_until - self.now).clamp(min=0.0)

    def mask_inactive(self, scores: torch.Tensor) -> torch.Tensor:
        """Scores with inactive candidates forced to +inf."""
        if self.active is None:
            return scores
        return torch.where(self.active, scores, torch.inf)

    def idle(self) -> torch.Tensor:
        return self.busy_until <= self.now

    @classmethod
    def from_replicas(cls, replicas: Sequence[Replica], now: float,
                      predicted: Optional[Sequence[float]] = None,
                      actual: Optional[Sequence[float]] = None,
                      device: DeviceLike = None) -> "ClusterState":
        """1-trial state for the scalar path."""
        busy = np.array([[r.busy_until for r in replicas]], float)
        queue = np.array([[getattr(r, "queue_depth", 0.0)
                           for r in replicas]], float)
        pred = None if predicted is None else \
            np.asarray(predicted, float)[None, :]
        act = None if actual is None else np.asarray(actual, float)[None, :]
        return cls(now=now, busy_until=busy, queue_depth=queue,
                   predicted=pred, actual=act, device=device)


class Policy:
    """Base policy: implement ``score``; everything else is shared."""
    name = "base"
    #: signals the policy reads from the state
    requires: Tuple[str, ...] = ()
    #: the batched simulation step carries a lowering of ``score``
    scan_lowered: bool = True

    def __init__(self, seed: int = 0, device: DeviceLike = None):
        self.seed = seed
        #: where the scalar path builds its states
        self.device = device

    def score(self, state: ClusterState) -> torch.Tensor:
        """(T, C) scores, lower is better.  Must not mutate ``state``."""
        raise NotImplementedError

    def pick(self, state: ClusterState) -> torch.Tensor:
        """argmin over candidates per trial (inactive ones masked out),
        then advance the policy's state.  (T,) int64 on the device."""
        picks = torch.argmin(state.mask_inactive(self.score(state)), dim=1)
        self.update(state, picks)
        return picks

    def update(self, state: ClusterState, picks: torch.Tensor):
        """Post-pick hook for stateful policies (the RR cursor)."""

    def choose(self, replicas: Sequence[Replica], now: float,
               predicted: Optional[Sequence[float]] = None,
               actual: Optional[Sequence[float]] = None) -> Optional[int]:
        """Pick one replica index; the same code path as :meth:`pick`."""
        if not replicas:
            return None
        state = ClusterState.from_replicas(replicas, now, predicted=predicted,
                                           actual=actual, device=self.device)
        return int(self.pick(state)[0])


class RoundRobin(Policy):
    """First idle replica at or after the rotating cursor; least wait
    when everything is busy."""
    name = "round_robin"

    def __init__(self, seed: int = 0, device: DeviceLike = None):
        super().__init__(seed, device)
        self._cursor: Optional[torch.Tensor] = None   # (T,) int64

    def _ensure(self, T: int, dev: torch.device):
        if self._cursor is None or len(self._cursor) != T:
            self._cursor = torch.zeros(T, dtype=torch.int64, device=dev)

    def score(self, state):
        T, C = state.shape
        self._ensure(T, state.device)
        cols = torch.arange(C, device=state.device)
        dist = (cols[None, :] - self._cursor[:, None]) % C
        return torch.where(state.idle(), dist.to(_F64),
                           BUSY_PENALTY + state.wait())

    def update(self, state, picks):
        self._cursor = (picks + 1) % state.shape[1]


class RandomChoice(Policy):
    """Uniform over idle replicas; least wait when everything is busy.

    ``seed_blocks`` (``[(seed, n_trials), ...]``) partitions the trial
    axis into consecutive blocks, each drawing from its own generator,
    as a serial per-seed run with that seed would."""
    name = "random"

    def __init__(self, seed: int = 0,
                 seed_blocks: Optional[Sequence[Tuple[int, int]]] = None,
                 device: DeviceLike = None):
        super().__init__(seed, device)
        self.rng = rng_from_key(seed)
        self._blocks = None if seed_blocks is None else \
            [(rng_from_key(s), int(n)) for s, n in seed_blocks]

    def score(self, state):
        T, C = state.shape
        if self._blocks is not None:
            if sum(n for _, n in self._blocks) != T:
                raise ValueError(
                    f"seed_blocks cover {sum(n for _, n in self._blocks)} "
                    f"trials, state has {T}")
            draws = np.concatenate(
                [rng.random((n, C)) for rng, n in self._blocks], axis=0)
        else:
            draws = self.rng.random((T, C))
        draws = torch.as_tensor(draws, dtype=_F64, device=state.device)
        return torch.where(state.idle(), draws, BUSY_PENALTY + state.wait())


class LeastConnections(Policy):
    """Lowest (busy_until - now) + queue depth: the earliest-free replica
    in the simulation, classic least-connections in the router."""
    name = "least_conn"

    def score(self, state):
        return (state.busy_until - state.now) + state.queue_depth


class PerfAware(Policy):
    """Minimize queue wait + predicted RTT (paper §6), with optional
    prediction-guided hedging."""
    name = "perf_aware"
    requires = ("predicted",)

    def __init__(self, seed: int = 0, hedge_factor: Optional[float] = None,
                 device: DeviceLike = None):
        super().__init__(seed, device)
        self.hedge_factor = hedge_factor

    def signal(self, state: ClusterState) -> torch.Tensor:
        if state.predicted is None:
            raise ValueError(f"{self.name} policy needs state.predicted")
        return state.predicted

    def score(self, state):
        return state.wait() + self.signal(state)

    def hedge_plan(self, state: ClusterState, picks: torch.Tensor,
                   scores: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(second, mask)`` for already-made ``picks``: the runner-up
        per trial and the trials that hedge, where the pick's predicted
        RTT exceeds ``hedge_factor`` x the best busy replica's predicted
        completion (wait + predicted).  ``scores`` may pass the scores
        already computed for ``picks``."""
        T, C = state.shape
        trial = torch.arange(T, device=state.device)
        second = picks.clone()
        mask = torch.zeros(T, dtype=torch.bool, device=state.device)
        if self.hedge_factor is None or C < 2:
            return second, mask
        sig = self.signal(state)
        completion = state.wait() + sig
        # runner-up by score, excluding the pick and inactive candidates
        s = state.mask_inactive(
            self.score(state) if scores is None else scores).clone()
        s[trial, picks] = torch.inf
        second = torch.argmin(s, dim=1)
        # best busy completion (inf when no replica is busy: no hedge);
        # an inactive replica can neither take the duplicate nor be
        # waited on
        busy_completion = state.mask_inactive(
            torch.where(~state.idle(), completion, torch.inf))
        ref = busy_completion.min(dim=1).values
        mask = sig[trial, picks] > self.hedge_factor * ref
        if state.active is not None:
            mask &= state.active[trial, second]
        return second, mask

    def hedge_candidates(self, replicas: Sequence[Replica], now: float,
                         predicted: Sequence[float]) -> List[int]:
        """``[pick]`` or ``[pick, runner-up]``: a 1-trial wrapper over
        ``score`` + :meth:`hedge_plan`, as ``choose`` wraps ``pick``."""
        if not replicas:
            return []
        state = ClusterState.from_replicas(replicas, now, predicted=predicted,
                                           device=self.device)
        scores = self.score(state)
        picks = torch.argmin(scores, dim=1)
        second, mask = self.hedge_plan(state, picks, scores)
        if bool(mask[0]):
            return [int(picks[0]), int(second[0])]
        return [int(picks[0])]


class Oracle(PerfAware):
    """Perfect knowledge of the true RTT (the ideal baseline)."""
    name = "oracle"
    requires = ("actual",)

    def signal(self, state):
        # no silent fallback: an oracle scored on predictions would be a
        # mislabeled perf_aware run
        if state.actual is None:
            raise ValueError("oracle policy needs state.actual (true RTTs "
                             "exist only in simulation)")
        return state.actual


_POLICY_CLASSES: Tuple[Type[Policy], ...] = (
    RoundRobin, RandomChoice, LeastConnections, PerfAware, Oracle)

#: the one registry every layer dispatches through
POLICIES: Dict[str, Type[Policy]] = {p.name: p for p in _POLICY_CLASSES}


def make_policy(name: str, **kwargs) -> Policy:
    """Instantiate a registered policy, dropping the kwargs it does not
    take (so callers can pass seed / hedge_factor / device uniformly)."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; registered: {sorted(POLICIES)}")
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in params})
