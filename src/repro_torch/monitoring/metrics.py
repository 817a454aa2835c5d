"""Monitoring of the port: copies of the reference's
``monitoring/metrics.py`` (numpy only).

- :class:`SimClock`: a simulated clock (benchmarks) or the wall clock
  (serving);
- :class:`PeriodicRefresh`: the paper's periodic-collection cadence, which
  the simulation core drives;
- :class:`RetrievalModel` and :class:`MetricsStore`: the Prometheus
  stand-in, a columnar ring buffer at 200 ms resolution with a modeled
  range-query latency, which the serving engine scrapes into.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SCRAPE_INTERVAL = 0.2     # 200 ms, as in the paper


class SimClock:
    """Deterministic simulated clock (benchmarks) or wall clock (serving)."""

    def __init__(self, simulated: bool = True, t0: float = 0.0):
        self.simulated = simulated
        self._t = t0

    def now(self) -> float:
        return self._t if self.simulated else time.time()

    def advance(self, dt: float):
        if self.simulated:
            self._t += dt
        else:  # pragma: no cover - wall clock
            time.sleep(dt)


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


@dataclass
class RetrievalModel:
    """t_state(k, w) latency model, calibrated so that with a mean RTT of
    10 s: (w=5s, k=100) -> <20% RTT and (w=60s, k=100) -> ~35% RTT (paper
    Fig. 10), linear in k and in k*w like a range query."""
    base: float = 0.15            # fixed HTTP/TSDB round trip (s)
    per_metric: float = 0.012     # per-series overhead (s)
    per_point: float = 3.9e-5     # per returned sample (s)

    def delay(self, k: int, window_s: float) -> float:
        points = k * window_s / SCRAPE_INTERVAL
        return self.base + self.per_metric * k + self.per_point * points

    def delay_batch(self, ks: Sequence[int],
                    windows_s: Sequence[float]) -> np.ndarray:
        """Per-request delays for a batch issued as ONE range query.

        The fixed HTTP round trip (``base``) is paid once and spread evenly
        over the batch; per-series and per-sample costs stay per request.
        A batch of one is therefore exactly ``delay(k, w)``.
        """
        ks = np.asarray(ks, np.float64)
        ws = np.asarray(windows_s, np.float64)
        if ks.size == 0:
            return np.zeros(0)
        points = ks * ws / SCRAPE_INTERVAL
        return (self.base / ks.size + self.per_metric * ks
                + self.per_point * points)


class MetricsStore:
    """Columnar ring buffer: one (n_metrics, capacity) array at 200 ms
    resolution, rows in registration order, one column per scrape."""

    def __init__(self, capacity_s: float = 600.0, clock: Optional[SimClock] = None,
                 retrieval: Optional[RetrievalModel] = None):
        self.capacity = int(capacity_s / SCRAPE_INTERVAL)
        self.clock = clock or SimClock()
        self.retrieval = retrieval or RetrievalModel()
        self._data = np.zeros((0, self.capacity), np.float32)
        self._index: Dict[str, int] = {}        # name -> row
        self._row_names: List[str] = []         # row -> name
        self._head = 0            # global write index (same for all metrics)
        self._t_head = 0.0
        self.query_time_spent = 0.0   # accumulated modeled retrieval delay
        self._scrape_cache: Dict[Tuple[str, ...], np.ndarray] = {}

    def register(self, names: Sequence[str]):
        new = [n for n in names if n not in self._index]
        if new:
            for n in new:
                self._index[n] = len(self._row_names)
                self._row_names.append(n)
            self._data = np.concatenate(
                [self._data, np.zeros((len(new), self.capacity), np.float32)])
            self._scrape_cache.clear()

    @property
    def names(self) -> List[str]:
        return sorted(self._index)

    def _rows_for(self, names: Tuple[str, ...]) -> np.ndarray:
        rows = self._scrape_cache.get(names)
        if rows is None:
            rows = np.array([self._index[n] for n in names], np.int64)
            self._scrape_cache[names] = rows
        return rows

    def scrape(self, values: Dict[str, float], t: Optional[float] = None):
        """Record one 200 ms scrape of all metrics (one column write).

        Metrics registered but absent from ``values`` carry their previous
        sample forward (Prometheus staleness semantics)."""
        self.register(list(values))
        i = self._head % self.capacity
        col = self._data[:, (i - 1) % self.capacity].copy()
        rows = self._rows_for(tuple(values))
        col[rows] = np.fromiter(values.values(), np.float32, count=len(rows))
        self._data[:, i] = col
        self._head += 1
        self._t_head = self.clock.now() if t is None else t

    # ------------------------------------------------------------------
    def _w_points(self, window_s: float) -> int:
        return min(max(1, int(round(window_s / SCRAPE_INTERVAL))),
                   self.capacity)

    def query_windows(self, requests: Sequence[Tuple], fast: bool = False):
        """Batched range query: many ``(names, window_s[, end_t])``
        requests at once.

        Gathers every requested (row, column) sample in ONE fancy-indexing
        pass over the columnar ring (wraparound included, pre-history
        zero-padded) and accounts the modeled retrieval delay for the whole
        batch as a single range query (``RetrievalModel.delay_batch``: the
        fixed round trip amortized across the batch).  The per-sample cost
        is charged on the CLIPPED point count — a window longer than the
        ring's capacity can only ever return ``capacity`` samples, so the
        model must not bill for samples the gather never serves.

        An optional third element ``end_t`` ends the window at that
        historical timestamp instead of the write head (the retraining
        path gathers the pre-submission window of a long-completed task).
        Samples already overwritten by the ring are zero-padded, exactly
        like pre-history; ``end_t`` beyond the head clips to the head.

        Returns ``(arrays, delays)``: one (k, w_points) float32 array and
        one modeled-delay float per request.
        """
        flat_rows: List[np.ndarray] = []
        flat_cols: List[np.ndarray] = []
        shapes: List[Tuple[int, int, int, int]] = []  # (k, w_pts, avail, off)
        masks: List[np.ndarray] = []                  # valid-row masks
        for req in requests:
            names, window_s = req[0], req[1]
            end_t = req[2] if len(req) > 2 else None
            w_points = self._w_points(window_s)
            if end_t is None:
                end = self._head
            else:
                shift = int(round((self._t_head - end_t) / SCRAPE_INTERVAL))
                end = self._head - max(shift, 0)
            start = end - w_points
            # samples before the ring's oldest survivor (or before any
            # history at all) are zero-padded
            lo = max(start, self._head - self.capacity, 0)
            hi = max(end, lo)
            avail = hi - lo
            rows = np.array([self._index.get(n, -1) for n in names], np.int64)
            masks.append(rows >= 0)
            if avail > 0:
                cols = np.arange(lo, hi) % self.capacity
                flat_rows.append(
                    np.repeat(np.where(rows >= 0, rows, 0), avail))
                flat_cols.append(np.tile(cols, len(names)))
            shapes.append((len(names), w_points, avail, lo - start))
        out: List[np.ndarray] = []
        if flat_rows:
            gathered = self._data[np.concatenate(flat_rows),
                                  np.concatenate(flat_cols)]
        else:
            gathered = np.zeros(0, np.float32)
        off = 0
        for (k, w_points, avail, pos), mask in zip(shapes, masks):
            arr = np.zeros((k, w_points), np.float32)
            if avail > 0:
                block = gathered[off:off + k * avail].reshape(k, avail)
                arr[:, pos:pos + avail] = np.where(mask[:, None], block, 0.0)
                off += k * avail
            out.append(arr)
        if fast:
            delays = np.zeros(len(out))
        else:
            # clipped point counts: w_points (not the raw window) is what
            # the gather actually returns per series
            delays = self.retrieval.delay_batch(
                [s[0] for s in shapes],
                [s[1] * SCRAPE_INTERVAL for s in shapes])
        total = float(delays.sum())
        self.query_time_spent += total
        if total:
            self.clock.advance(total)
        return out, delays

    def query_window(self, names: Sequence[str], window_s: float,
                     end_t: Optional[float] = None, fast: bool = False):
        """Return (k, w_points) array for the window ending at end_t
        (default: the write head).

        fast=False models the Prometheus range-query latency (added to the
        sim clock and accounted in query_time_spent); fast=True is the
        zero-copy in-process path (beyond-paper).
        Returns (array, modeled_delay_seconds).  A single query is a batch
        of one through :meth:`query_windows` (identical modeled delay to
        the pre-columnar per-name path).
        """
        arrays, delays = self.query_windows([(names, window_s, end_t)],
                                            fast=fast)
        return arrays[0], float(delays[0])
