"""The port's example scripts run end to end on the CPU at tiny sizes."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "examples", "lb_simulation_torch.py")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, SCRIPT, *args], env=env,
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
