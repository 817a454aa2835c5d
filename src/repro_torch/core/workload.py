"""Synthetic cluster workload: the experimental-setup stand-in (paper §4).
A copy of the reference's ``core/workload.py`` (host numpy): it draws
from the same named stream in the same order, so both packages' nodes
scrape identical stores and complete identical tasks.

Simulates co-located SPA-style applications on heterogeneous nodes, driven
at the paper's 200 ms scrape interval.  Each app instance submits a task,
waits for completion, then sleeps U(0, t_max) (paper §4.4).  A task's RTT
depends on the node factor, the co-location load in the window before
submission, and log-normal noise — so monitoring metrics in the observation
window genuinely predict RTT (what Morpheus learns).

The store receives both informative metrics (cpu/gpu/mem/queue and per-app
activity, plus EMA variants) and pure-noise metrics, mimicking the paper's
~294-metric Prometheus surface at a configurable count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.rng import rng_stream
from repro_torch.monitoring.metrics import (SCRAPE_INTERVAL, MetricsStore,
                                            SimClock)


@dataclass
class AppSpec:
    name: str
    mean_rtt: float          # seconds on the reference node
    t_max_wait: float        # client wait U(0, t_max) between tasks
    cpu: float               # cores consumed while active
    sensitivity: float       # RTT multiplier per unit of co-location load
    gpu: float = 0.0


# scaled-down versions of the paper's five SPA apps (§4.1, §4.4 waits)
DEFAULT_APPS = (
    AppSpec("upload", 8.0, 40.0, 0.5, 0.5),
    AppSpec("ctffind4", 2.0, 6.0, 1.0, 0.9),
    AppSpec("fft_mock", 4.0, 20.0, 1.0, 0.7),
    AppSpec("gctf", 3.0, 10.0, 2.0, 0.8, gpu=1.0),
    AppSpec("motioncor2", 5.0, 10.0, 2.0, 0.6, gpu=1.0),
)


@dataclass
class Task:
    app: str
    t_submit: float
    rtt: float

    @property
    def t_end(self):
        return self.t_submit + self.rtt


class NodeWorkload:
    """One worker node with co-located app instances."""

    def __init__(self, node: str, apps=DEFAULT_APPS, instances_per_app: int = 1,
                 node_factor: float = 1.0, n_noise_metrics: int = 24,
                 seed: int = 0, store: Optional[MetricsStore] = None,
                 clock: Optional[SimClock] = None):
        self.node = node
        self.apps = list(apps)
        self.node_factor = node_factor
        self.clock = clock or SimClock()
        self.store = store or MetricsStore(clock=self.clock)
        self.rng = rng_stream(seed, "node-workload")
        self.n_noise = n_noise_metrics
        # per app-instance state
        self.instances: List[Tuple[AppSpec, dict]] = []
        for a in self.apps:
            for i in range(instances_per_app):
                self.instances.append(
                    (a, {"state": "wait",
                         "until": self.rng.uniform(0, a.t_max_wait),
                         "task": None}))
        self._ema: Dict[str, float] = {}
        self._noise_state = self.rng.standard_normal(n_noise_metrics)
        self.extra_load = 0.0           # noisy-server injection (manager)
        self.completed: List[Task] = []

    # ------------------------------------------------------------------
    def _active_load(self) -> Tuple[float, float, int]:
        cpu = gpu = 0.0
        n = 0
        for a, st in self.instances:
            if st["state"] == "run":
                cpu += a.cpu
                gpu += a.gpu
                n += 1
        return cpu + self.extra_load, gpu, n

    def _rtt_for(self, a: AppSpec) -> float:
        cpu, gpu, n = self._active_load()
        load = 0.12 * cpu + 0.2 * gpu + 0.05 * n
        rbar = a.mean_rtt * self.node_factor * (1.0 + a.sensitivity * load)
        sigma = 0.18
        return float(rbar * self.rng.lognormal(-0.5 * sigma ** 2, sigma))

    def _scrape(self):
        t = self.clock.now()
        cpu, gpu, n_act = self._active_load()
        vals = {
            "node_cpu_util": cpu + 0.08 * self.rng.standard_normal(),
            "node_gpu_util": gpu + 0.05 * self.rng.standard_normal(),
            "node_mem_util": 0.4 + 0.05 * n_act
            + 0.02 * self.rng.standard_normal(),
            "node_active_tasks": float(n_act),
            "node_net_mbps": 0.5 * cpu + 0.3 * self.rng.standard_normal(),
            "node_disk_iops": 10 * n_act + 2 * self.rng.standard_normal(),
            "node_extra_load": self.extra_load,
        }
        for a, st in self.instances:
            vals[f"app_{a.name}_running"] = 1.0 if st["state"] == "run" else 0.0
        # EMA variants (correlated metrics the redundancy filter should drop)
        for k in ("node_cpu_util", "node_gpu_util", "node_active_tasks"):
            e = self._ema.get(k, vals[k])
            e = 0.9 * e + 0.1 * vals[k]
            self._ema[k] = e
            vals[k + "_ema"] = e
        # random-walk noise metrics
        self._noise_state += 0.1 * self.rng.standard_normal(self.n_noise)
        for i, v in enumerate(self._noise_state):
            vals[f"noise_{i:02d}"] = float(v)
        self.store.scrape(vals, t=t)

    # ------------------------------------------------------------------
    def run(self, duration_s: float,
            on_complete: Optional[Callable[[Task], None]] = None):
        """Advance the node by duration_s in 200 ms ticks."""
        steps = int(duration_s / SCRAPE_INTERVAL)
        for _ in range(steps):
            t = self.clock.now()
            for a, st in self.instances:
                if st["state"] == "wait" and t >= st["until"]:
                    task = Task(a.name, t, self._rtt_for(a))
                    st["state"] = "run"
                    st["task"] = task
                elif st["state"] == "run" and t >= st["task"].t_end:
                    task = st["task"]
                    self.completed.append(task)
                    if on_complete:
                        on_complete(task)
                    st["state"] = "wait"
                    st["until"] = t + self.rng.uniform(0, a.t_max_wait)
                    st["task"] = None
            self._scrape()
            self.clock.advance(SCRAPE_INTERVAL)
