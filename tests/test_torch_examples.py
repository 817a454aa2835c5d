"""The port's example scripts run end to end on the CPU at tiny sizes."""
import functools
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "examples", "lb_simulation_torch.py")
SERVE = os.path.join(ROOT, "examples", "serve_cluster_torch.py")
QUICKSTART = os.path.join(ROOT, "examples", "quickstart_torch.py")


def _run(*args, script=SCRIPT, **env_extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env_extra)
    return subprocess.run([sys.executable, script, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_lb_simulation_torch_smoke_on_the_cpu():
    out = _run("--smoke", "--device", "cpu", "--trials", "2")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "smoke OK"
    for pol in ("perf_aware", "least_conn", "round_robin", "random",
                "oracle"):
        assert any(line.split()[:1] == [pol] for line in lines), pol
    # the mini-campaign covers every registered scenario
    from repro_torch.core.scenarios import scenario_names
    for name in scenario_names():
        assert any(line.split()[:1] == [name] for line in lines), name


def test_lb_simulation_torch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    out = _run("--smoke", "--trials", "2")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


_ROW = re.compile(r"^(\w+)\s+mean RTT=\s*([\d.]+)s\s+p95=\s*([\d.]+)s\s+"
                  r"routing=\[fast ([\d.]+), med ([\d.]+), slow ([\d.]+)\]$")


def _reference_rows():
    """The JAX package's ``examples/serve_cluster.py`` ``run_policy`` for
    each policy, its rows formatted as the port's example prints them
    (its engines share one jitted prefill / decode, which the example
    would compile once an engine)."""
    import jax
    from repro.configs.base import get_config
    from repro.models import model as JM
    spec = importlib.util.spec_from_file_location(
        "serve_cluster_reference", os.path.join(ROOT, "examples",
                                                "serve_cluster.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = get_config("deepseek-67b", smoke=True).resolve(tp=1)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)

    @functools.lru_cache(maxsize=None)
    def fns(max_seq):
        return (jax.jit(lambda p, b: JM.prefill(p, cfg, b,
                                                cache_len=max_seq)),
                jax.jit(lambda p, c, t: JM.decode_step(p, cfg, c, t)))

    class Shared(mod.ServingEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self._prefill, self._decode = fns(self.max_seq)
    mod.ServingEngine = Shared
    rows = {}
    for policy in ("round_robin", "random", "least_conn", "perf_aware"):
        rtts, routed = mod.run_policy(policy, cfg, params, 24)
        share = [routed.count(i) / len(routed) for i in range(3)]
        rows[policy] = (f"{rtts.mean():.3f}",
                        f"{np.percentile(rtts, 95):.3f}",
                        *(f"{x:.2f}" for x in share))
    return rows


def test_serve_cluster_torch_smoke_matches_the_reference_example():
    """Under a simulated clock the port's example routes as the JAX
    package's does: per policy, the same routing shares, mean and p95
    RTT on the same seed; perf_aware sends the least to the slow
    replica."""
    out = _run("--smoke", "--device", "cpu", script=SERVE)
    assert out.returncode == 0, out.stderr
    got = {}
    for line in out.stdout.splitlines():
        m = _ROW.match(line)
        if m:
            got[m.group(1)] = m.groups()[1:]
    want = _reference_rows()
    assert got == want
    fast, med, slow = (float(x) for x in got["perf_aware"][2:])
    assert slow < min(fast, med)


def test_serve_cluster_torch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    out = _run("--smoke", script=SERVE)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_quickstart_torch_trains_and_serves_on_the_cpu():
    """The predictor pipeline at a reduced size (4 noise metrics, 4
    cycles of 240 s): at least one predictor trained, and the plane's
    batched sweep serves every trained one."""
    out = _run("--device", "cpu", "--cycles", "4", "--cycle-s", "240",
               "--noise-metrics", "4", script=QUICKSTART, OMP_NUM_THREADS="1")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "device cpu, 5 apps, 4 noise metrics"
    trained = [ln for ln in lines if "model=" in ln]
    assert len(trained) >= 1
    i = lines.index("== fleet prediction plane: one batched sweep "
                    "(DESIGN.md §9) ==")
    m = re.match(r"^  (\d+) predictors, (\d+) model bucket", lines[i + 1])
    assert m and int(m.group(1)) == len(trained)
    served = [ln for ln in lines[i + 3:] if "predicted RTT=" in ln]
    assert len(served) == len(trained)
    for ln in served:
        assert float(re.search(r"RTT=([\d.]+)s", ln).group(1)) > 0


def test_quickstart_torch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    out = _run("--cycles", "1", script=QUICKSTART)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
