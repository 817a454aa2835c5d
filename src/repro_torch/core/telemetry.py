"""Flight recorder and serving telemetry (a port of the reference's
``core/telemetry.py``).

Every traced request carries one fixed-width row (:data:`TRACE_FIELDS`)
recording the routing decision (chosen replica, score at pick time,
predicted RTT) and an additive decomposition of the response time::

    queue_wait + service_base + interference_s + cold_s + gray_s
        + retry_s - hedge_s  ==  response        (served requests)

``service_base`` is the chosen replica's service draw at zero
interference, ``interference_s`` the co-location inflation of it,
``cold_s`` / ``gray_s`` the cold-start and gray-failure surcharges,
``retry_s`` the time spent on failed attempts and backoff before the
successful one, ``hedge_s`` the time a winning hedge duplicate saved.
A dropped request keeps ``rep = -1``, its disposition code and NaN
components.

The core records every ``sample_every``-th request into a
``(ceil(J / k), T, F)`` buffer on its device (:func:`trace_row` builds
one row from tensors, as :func:`compose_row` does from numpy arrays);
:func:`trace_block` packages it for the summary, and
:func:`tail_attribution` reads a block's response tails by component.
The serving router (T = 1, always on) builds its rows with
:func:`compose_row` and packages them with :func:`trace_block` too.
It also exports a Prometheus-style :class:`MetricsRegistry` of
:class:`Counter`, :class:`Gauge` and :class:`Histogram` metrics whose
scrape lands in the columnar ``MetricsStore``.  :class:`PhaseTimer`
times the campaign runner's phases.
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["TRACE_FIELDS", "TRACE_IDX", "COMPONENTS", "DISP_SERVED",
           "DISP_SHED", "DISP_TIMEOUT", "DISP_FAIL_FAST", "DISPOSITIONS",
           "TraceConfig", "trace_block", "compose_row", "trace_row",
           "tail_attribution", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "PhaseTimer"]

#: column order of every trace row; the seven middle columns are the
#: additive decomposition
TRACE_FIELDS = (
    "rep", "predicted", "score",
    "queue_wait", "service_base", "interference_s", "cold_s", "gray_s",
    "retry_s", "hedge_s",
    "disposition", "response",
)

#: field name -> column index
TRACE_IDX = {name: i for i, name in enumerate(TRACE_FIELDS)}

#: decomposition components (their signed sum is the response)
COMPONENTS = ("queue_wait", "service_base", "interference_s", "cold_s",
              "gray_s", "retry_s", "hedge_s")

DISP_SERVED = 0        #: request completed
DISP_SHED = 1          #: dropped by admission control
DISP_TIMEOUT = 2       #: client-side timeout after >= 1 dispatched attempt
DISP_FAIL_FAST = 3     #: breaker / drain failed fast: 0 attempts dispatched

DISPOSITIONS = {
    DISP_SERVED: "served",
    DISP_SHED: "shed",
    DISP_TIMEOUT: "client_timeout",
    DISP_FAIL_FAST: "fail_fast",
}


@dataclass(frozen=True)
class TraceConfig:
    """Flight-recorder knob on ``SimConfig``: ``sample_every = k``
    records requests ``0, k, 2k, ...``; 1 records every request."""
    sample_every: int = 16


def trace_block(data, n_requests: int, sample_every: int) -> Dict:
    """Package a ``(J_s, T, F)`` slot-major buffer as the summary's
    ``"trace"`` block (trial-major ``(T, J_s, F)``)."""
    data = np.asarray(data)
    return {
        "fields": list(TRACE_FIELDS),
        "sample_every": int(sample_every),
        "requests": np.arange(0, int(n_requests), int(sample_every)),
        "data": np.transpose(data, (1, 0, 2)),
    }


def compose_row(*, rep, predicted, score, queue_wait, raw, base,
                cold_mult, gray_mult, retry_s, hedge_s, disposition,
                response) -> np.ndarray:
    """One (T, F) trace row from pick-time quantities (numpy).

    ``raw`` is the service draw on the chosen replica before the cold /
    gray multipliers, ``base`` the zero-interference draw on the same
    tier; ``cold_s = raw * (cm - 1)`` and ``gray_s = raw * cm * (gm - 1)``
    so that ``base + interference + cold_s + gray_s == raw * cm * gm``.
    Rows whose disposition is not served are NaN with ``rep = -1``."""
    rep = np.asarray(rep, np.float64)
    disposition = np.asarray(disposition, np.float64)
    dropped = disposition != DISP_SERVED
    raw = np.asarray(raw, np.float64)
    cm = np.asarray(cold_mult, np.float64)
    gm = np.asarray(gray_mult, np.float64)
    cols = {
        "rep": np.where(dropped, -1.0, rep),
        "predicted": np.asarray(predicted, np.float64),
        "score": np.asarray(score, np.float64),
        "queue_wait": np.asarray(queue_wait, np.float64),
        "service_base": np.asarray(base, np.float64),
        "interference_s": raw - base,
        "cold_s": raw * (cm - 1.0),
        "gray_s": raw * cm * (gm - 1.0),
        "retry_s": np.asarray(retry_s, np.float64),
        "hedge_s": np.asarray(hedge_s, np.float64),
        "disposition": disposition,
        "response": np.asarray(response, np.float64),
    }
    out = np.empty(rep.shape + (len(TRACE_FIELDS),), np.float64)
    for name, i in TRACE_IDX.items():
        col = np.broadcast_to(cols[name], rep.shape)
        if name not in ("rep", "disposition"):
            col = np.where(dropped, np.nan, col)
        out[..., i] = col
    return out


def trace_row(*, rep: torch.Tensor, predicted, score, queue_wait, raw,
              base, cold_mult, gray_mult, retry_s, hedge_s, disposition,
              response) -> torch.Tensor:
    """:func:`compose_row` on the core's device: a (T, F) float64 row
    from (T,) tensors or Python scalars, in the same float operations.
    A scalar becomes a filled tensor (a fill takes it as a kernel
    argument; a host-to-device copy would wait for the device)."""
    dev, f64 = rep.device, torch.float64

    def col(v):
        if isinstance(v, torch.Tensor):
            return v.to(f64).expand(rep.shape)
        return torch.full(rep.shape, float(v), dtype=f64, device=dev)
    disp = col(disposition)
    dropped = disp != DISP_SERVED
    raw, cm, gm = col(raw), col(cold_mult), col(gray_mult)
    base = col(base)
    parts = [col(predicted), col(score), col(queue_wait), base, raw - base,
             raw * (cm - 1.0), raw * cm * (gm - 1.0), col(retry_s),
             col(hedge_s)]
    nan = torch.full_like(disp, float("nan"))
    cols = [torch.where(dropped, -1.0, col(rep))] \
        + [torch.where(dropped, nan, p) for p in parts] \
        + [disp, torch.where(dropped, nan, col(response))]
    return torch.stack(cols, dim=-1)


def tail_attribution(trace: Dict,
                     quantiles: Sequence[float] = (0.99, 0.999)) -> Dict:
    """Attribute response-time tails to decomposition components.

    For each quantile q, selects the served rows at or above the q-th
    response percentile (across all trials) and reports the mean of
    each component over those rows plus its share of the mean tail
    response (``hedge_s`` enters negatively, so shares sum to ~1).
    """
    data = np.asarray(trace["data"], np.float64).reshape(
        -1, len(TRACE_FIELDS))
    resp = data[:, TRACE_IDX["response"]]
    disp = data[:, TRACE_IDX["disposition"]]
    served = (disp == DISP_SERVED) & np.isfinite(resp)
    out: Dict[str, Dict] = {
        "n_rows": int(data.shape[0]),
        "n_served": int(served.sum()),
        "dispositions": {
            name: int(np.sum(disp == code))
            for code, name in DISPOSITIONS.items()},
    }
    rows = data[served]
    rr = rows[:, TRACE_IDX["response"]] if rows.size else np.empty(0)
    for q in quantiles:
        key = "p" + ("%g" % (100 * q)).replace(".", "_")
        if rr.size == 0:
            out[key] = None
            continue
        cut = np.quantile(rr, q)
        tail = rows[rr >= cut]
        tresp = float(tail[:, TRACE_IDX["response"]].mean())
        comp = {}
        for name in COMPONENTS:
            v = float(tail[:, TRACE_IDX[name]].mean())
            signed = -v if name == "hedge_s" else v
            comp[name] = {
                "mean_s": v,
                "share": signed / tresp if tresp else 0.0,
            }
        out[key] = {
            "cut_s": float(cut),
            "n_tail": int(tail.shape[0]),
            "mean_response_s": tresp,
            "components": comp,
        }
    return out


class Counter:
    """Monotone counter (exported as a single cumulative series)."""

    def __init__(self, name: str):
        self.name, self.value = name, 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def export(self) -> Dict[str, float]:
        return {self.name: self.value}


class Gauge:
    """Set-to-current-value metric."""

    def __init__(self, name: str):
        self.name, self.value = name, 0.0

    def set(self, value: float):
        self.value = float(value)

    def inc(self, amount: float = 1.0):
        self.value += amount

    def dec(self, amount: float = 1.0):
        self.value -= amount

    def export(self) -> Dict[str, float]:
        return {self.name: self.value}


class Histogram:
    """Fixed-bucket cumulative histogram, Prometheus ``le`` semantics:
    one series per bucket plus ``_sum`` and ``_count``."""

    DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.counts = np.zeros(len(self.buckets) + 1, np.int64)
        self.sum = 0.0

    def observe(self, value: float):
        self.counts[np.searchsorted(self.buckets, value, side="left")] += 1
        self.sum += float(value)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (inf bucket clamps to top le)."""
        total = self.count
        if total == 0:
            return math.nan
        target = q * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        if i >= len(self.buckets):
            return self.buckets[-1]
        lo = 0.0 if i == 0 else self.buckets[i - 1]
        lo_cum = 0 if i == 0 else cum[i - 1]
        frac = (target - lo_cum) / max(self.counts[i], 1)
        return lo + (self.buckets[i] - lo) * min(max(frac, 0.0), 1.0)

    def export(self) -> Dict[str, float]:
        out = {}
        cum = 0
        for le, c in zip(self.buckets, self.counts[:-1]):
            cum += int(c)
            out[f"{self.name}_bucket_le_{le:g}"] = float(cum)
        out[f"{self.name}_bucket_le_inf"] = float(self.count)
        out[f"{self.name}_sum"] = self.sum
        out[f"{self.name}_count"] = float(self.count)
        return out


class MetricsRegistry:
    """Counter / gauge / histogram registry whose scrape lands in the
    columnar ``MetricsStore`` (one 200 ms column per scrape), the same
    storage and retrieval model as the prediction plane's signals."""

    def __init__(self, store=None):
        self.store = store
        self._metrics: Dict[str, object] = {}

    def _add(self, metric):
        if metric.name in self._metrics:
            raise ValueError(f"duplicate metric {metric.name}")
        self._metrics[metric.name] = metric
        if self.store is not None:
            self.store.register(list(metric.export()))
        return metric

    def counter(self, name: str) -> Counter:
        return self._add(Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._add(Gauge(name))

    def histogram(self, name: str, buckets=Histogram.DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._add(Histogram(name, buckets))

    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            out.update(m.export())
        return out

    def scrape(self, t: Optional[float] = None):
        """Write one column of current values into the store."""
        if self.store is not None:
            self.store.scrape(self.collect(), t=t)


class PhaseTimer:
    """Named wall-time accumulator.  Each phase is also a
    ``torch.profiler.record_function`` range, so campaign phases show up
    in a torch profiler trace around the kernels they launched."""

    def __init__(self):
        self.wall: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.wall[name] = self.wall.get(name, 0.0) + (
            time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.wall.items()))
