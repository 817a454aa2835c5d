"""Resilience plane: the configuration (a copy of the reference's
``ResilienceConfig``, every field, the validation and the two
properties), the backoff rule and the per-replica circuit breakers.

The batched core lowers the whole plane: the fault timeline's gray
failure (a multiplier on the true RTT of one node per trial inside a
window, while the prediction basis keeps the healthy view), correlated
node-group outage (a busy bump of the group in the membership walk) and
staleness storm (one more outage window on the snapshot's refresh
schedule), and the client-side semantics: a per-attempt timeout,
bounded retries with exponential backoff and jitter
(:func:`backoff_delay`), and per-replica breakers (:class:`Breakers`).
A timed-out attempt still occupies its server for its whole service
time, which is what lets retries amplify an overload.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = ["ResilienceConfig", "backoff_delay", "Breakers"]


@dataclass(frozen=True)
class ResilienceConfig:
    """Client-side request semantics + the fault timeline; frozen so it
    rides SimConfig equality."""
    # -- client semantics ----------------------------------------------
    #: per-request attempt timeout; None disables the client plane
    timeout_s: Optional[float] = None
    #: additional attempts after the first (0 = timeout only)
    max_retries: int = 0
    backoff_base_s: float = 1.0
    backoff_mult: float = 2.0
    #: multiplicative jitter: backoff_i *= 1 + jitter * U[0,1)
    backoff_jitter: float = 0.5
    #: per-replica circuit breaker: trips after this many consecutive
    #: timeouts (None disables the breaker)
    breaker_threshold: Optional[int] = None
    #: open -> half-open probe delay
    breaker_cooldown_s: float = 10.0
    # -- fault timeline ------------------------------------------------
    #: gray failure: (t_start_s, duration_s, slow_factor) — one node per
    #: trial serves every RTT at slow_factor x inside the window
    gray: Optional[Tuple[float, float, float]] = None
    #: correlated outage: (t_start_s, duration_s, n_nodes) — a
    #: contiguous node group goes down for the window
    outage_group: Optional[Tuple[float, float, int]] = None
    #: metric-staleness storm: (t_start_s, duration_s) — the prediction
    #: snapshot freezes for the window
    staleness: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError("timeout_s must be positive")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.timeout_s is None and self.max_retries > 0:
            raise ValueError("retries need a timeout_s (an attempt only "
                             "fails by timing out)")
        if self.breaker_threshold is not None:
            if self.timeout_s is None:
                raise ValueError("a breaker needs a timeout_s (it trips "
                                 "on consecutive timeouts)")
            if self.breaker_threshold < 1:
                raise ValueError("breaker_threshold must be >= 1")
        if min(self.backoff_base_s, self.backoff_mult,
               self.backoff_jitter, self.breaker_cooldown_s) < 0:
            raise ValueError("backoff/cooldown knobs must be >= 0")
        if self.gray is not None and (len(self.gray) != 3
                                      or self.gray[1] <= 0
                                      or self.gray[2] < 1.0):
            raise ValueError("gray = (t_start_s, duration_s>0, "
                             "slow_factor>=1)")
        if self.outage_group is not None \
                and (len(self.outage_group) != 3
                     or self.outage_group[1] <= 0
                     or int(self.outage_group[2]) < 1):
            raise ValueError("outage_group = (t_start_s, duration_s>0, "
                             "n_nodes>=1)")
        if self.staleness is not None and (len(self.staleness) != 2
                                           or self.staleness[1] <= 0):
            raise ValueError("staleness = (t_start_s, duration_s>0)")

    @property
    def client_side(self) -> bool:
        """True when the timeout/retry/breaker plane is armed."""
        return self.timeout_s is not None

    @property
    def has_faults(self) -> bool:
        return (self.gray is not None or self.outage_group is not None
                or self.staleness is not None)


def backoff_delay(res: ResilienceConfig, attempt: int, u):
    """Backoff before retry ``attempt`` (0-based index of the attempt
    that just failed): ``base * mult^attempt * (1 + jitter * u)`` with
    ``u ~ U[0, 1)`` pre-drawn from the fault stream (a tensor or an
    array)."""
    return (res.backoff_base_s * res.backoff_mult ** attempt
            * (1.0 + res.backoff_jitter * u))


class Breakers:
    """Per-replica circuit breakers of every trial as (T, R) tensors on
    the core's device: the reference's ``BreakerBoard``.

    A replica is *open* (unroutable) while ``tripped`` and ``t <
    open_until``; once the cooldown has passed it is *half-open* and
    routable again as a probe.  A success resets the consecutive-timeout
    count and closes the breaker; a timeout adds one and trips it at
    ``threshold``, or at once on a half-open probe.  The client learns
    of a timeout at ``t_dispatch + timeout_s``, so a trip opens the
    breaker until ``t_dispatch + timeout_s + cooldown_s``.
    ``trip_count`` (T, R) counts each replica's trip events (one in-place
    add an attempt); ``trips`` is their total."""

    def __init__(self, n_trials: int, n_replicas: int, threshold: int,
                 cooldown_s: float, timeout_s: float, device=None):
        self.thr = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.timeout_s = float(timeout_s)
        shape = (int(n_trials), int(n_replicas))
        self.fail = torch.zeros(shape, dtype=torch.int32, device=device)
        self.open_until = torch.zeros(shape, dtype=torch.float64,
                                      device=device)
        self.tripped = torch.zeros(shape, dtype=torch.bool, device=device)
        self.trip_count = torch.zeros(shape, dtype=torch.int32,
                                      device=device)

    @property
    def trips(self) -> torch.Tensor:
        """Trip events of every trial and replica (0-d)."""
        return self.trip_count.sum()

    def open_mask(self, t: torch.Tensor, cols: slice = slice(None)
                  ) -> torch.Tensor:
        """(T, C) True where the breaker of a replica in ``cols`` is open
        at the per-trial time ``t`` (T,)."""
        return self.tripped[:, cols] & (t[:, None] < self.open_until[:, cols])

    def record(self, t: torch.Tensor, rep: torch.Tensor, ok: torch.Tensor,
               timeout: torch.Tensor) -> None:
        """Commit one attempt per trial: dispatched at ``t`` (T,) to
        replica ``rep`` (T,), answered in time where ``ok``, timed out
        where ``timeout`` (both False where nothing was dispatched)."""
        cols = torch.arange(self.fail.shape[1], device=rep.device)
        sel = cols[None, :] == rep[:, None]
        okm = sel & ok[:, None]
        tm = sel & timeout[:, None]
        # the state before this attempt decides whether it was a probe
        was_half = self.tripped & (t[:, None] >= self.open_until)
        self.fail = torch.where(okm, 0, self.fail + tm.int())
        trip = tm & ((self.fail >= self.thr) | was_half)
        self.tripped = torch.where(okm, False, self.tripped | trip)
        self.open_until = torch.where(
            trip, t[:, None] + self.timeout_s + self.cooldown_s,
            self.open_until)
        self.trip_count += trip
