"""Resilience plane configuration (a copy of the reference's
``ResilienceConfig``, every field, the validation and the two
properties).

The batched core lowers the fault timeline's gray failure (a
multiplier on the true RTT of one node per trial inside a window, while
the prediction basis keeps the healthy view) and the staleness storm
(one more outage window on the snapshot's refresh schedule).  The
client-side semantics (timeouts, retries with backoff and jitter,
per-replica breakers) and the correlated node-group outage are not
lowered yet: ``simulator.unlowered`` names them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ResilienceConfig"]


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
