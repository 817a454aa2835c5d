"""Periodic-collection cadence (a copy of the reference's
``monitoring/metrics.py::PeriodicRefresh``)."""
from __future__ import annotations

import numpy as np


class PeriodicRefresh:
    """A value recomputed only every ``lag_s`` of its owner's clock.

    Models the paper §4 periodic collection cadence: consumers between
    refreshes see the last snapshot, not live state.  During an outage
    window the snapshot is frozen, except when there is none yet.
    """

    def __init__(self, lag_s: float, outages=()):
        self.lag_s = lag_s
        #: (start_s, end_s) windows where the metric source is unreachable
        self.outages = tuple(outages)
        self._t_last = -np.inf
        self._value = None

    def in_outage(self, now: float) -> bool:
        return any(a <= now < b for a, b in self.outages)

    def get(self, now: float, compute):
        """Return the cached value, recomputing via ``compute()`` when the
        snapshot is older than ``lag_s`` (always on first call)."""
        if self.in_outage(now) and self._value is not None:
            return self._value
        if now - self._t_last >= self.lag_s:
            self._value = compute()
            self._t_last = now
        return self._value
