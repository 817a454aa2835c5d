"""Import hygiene and device rules of the PyTorch port (``repro_torch``).

The port imports torch and numpy, never jax and nothing of the JAX
package; its entry points run on the CUDA card unless the caller asks
for the CPU, and without a card they raise instead of moving to the CPU.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PKG = os.path.join(SRC, "repro_torch")


def _modules():
    out = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), SRC)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(_modules())


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:[.\s,]|$)")


def test_the_multi_device_layer_is_checked():
    """The parallel and launch modules are among those the import checks
    walk."""
    for m in ("repro_torch.parallel.sharding", "repro_torch.parallel.pipeline",
              "repro_torch.optim.compression", "repro_torch.launch.mesh",
              "repro_torch.launch.specs", "repro_torch.launch.train",
              "repro_torch.launch.serve", "repro_torch.launch.elastic"):
        assert m in _modules(), m


@pytest.mark.parametrize("module", _modules())
def test_source_names_no_jax_or_reference_import(module):
    path = os.path.join(SRC, *module.split("."))
    path = path + ".py" if os.path.exists(path + ".py") \
        else os.path.join(path, "__init__.py")
    with open(path) as fh:
        bad = [line for line in fh if _IMPORT.match(line)]
    assert not bad, f"{module}: {bad}"


def _entry_points():
    from repro_torch.core import campaign, simcore
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.simulator import _build_cluster
    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.interop import params_from_reference
    from repro_torch.models import hybrid, model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.router import MorpheusRouter
    from repro_torch.core.balancer import ClusterState
    from repro_torch.core.predictor import RTTPredictor
    from repro_torch.testing import make_store, make_trained_predictor
    from repro_torch.core import zoo
    from repro_torch.core.correlate import correlate_all
    from repro_torch.core.manager import PredictionManager
    from repro_torch.core.selection import select_model
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
    from repro_torch.interop import train_state_from_reference
    from repro_torch.training.train_step import make_train_state
    from repro_torch.launch import elastic as launch_elastic
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    import numpy as np
    small = dict(n_trials=2, n_requests=10)
    cfg = get_scenario("baseline").compile(seed=0, **small)
    arch = get_config("qwen2-vl-7b", smoke=True).resolve(tp=1)
    mamba = get_config("mamba2-1.3b", smoke=True).resolve(tp=1)
    moe = get_config("qwen3-moe-30b-a3b", smoke=True).resolve(tp=1)
    gen = torch.Generator().manual_seed(0)
    return {
        "resolve_device": lambda: resolve_device(),
        "run_compiled": lambda: simcore.run_compiled(_build_cluster(cfg),
                                                     "perf_aware"),
        "run_sim_compiled": lambda: simcore.run_sim_compiled(cfg),
        "run_scenario": lambda: campaign.run_scenario("baseline",
                                                      seeds=(0,), **small),
        "init_params": lambda: model.init_params(arch, gen),
        "init_cache": lambda: model.init_cache(arch, 1, 8),
        "params_from_reference": lambda: params_from_reference(
            {"w": [1.0]}, None),
        "ServingEngine": lambda: ServingEngine(arch, {}),
        "init_params_ssm": lambda: model.init_params(mamba, gen),
        "init_cache_ssm": lambda: model.init_cache(mamba, 1, 8),
        "hybrid.init_params": lambda: hybrid.init_params(mamba, gen),
        "hybrid.init_cache": lambda: hybrid.init_cache(mamba, 1, 8),
        "ServingEngine_ssm": lambda: ServingEngine(mamba, {}),
        "init_params_moe": lambda: model.init_params(moe, gen),
        "init_cache_moe": lambda: model.init_cache(moe, 1, 8),
        "ServingEngine_moe": lambda: ServingEngine(moe, {}),
        "MorpheusRouter": lambda: MorpheusRouter([]),
        "ClusterState": lambda: ClusterState(now=0.0, busy_until=[[0.0]]),
        "RTTPredictor": lambda: RTTPredictor("a", "n", make_store()),
        "make_trained_predictor": lambda: make_trained_predictor(
            "a", make_store(), "lr"),
        "PredictionManager": lambda: PredictionManager(),
        "correlate_all": lambda: correlate_all(np.ones((2, 8)), np.ones(8)),
        "select_model": lambda: select_model(["lr"], np.ones((8, 2)), None,
                                             np.ones(8), 1.0),
        "zoo.GBT": lambda: zoo.GBT(),
        "make_train_state": lambda: make_train_state(arch, TrainConfig(),
                                                     gen),
        "make_batch_iterator": lambda: make_batch_iterator(
            SyntheticLMData(32), 2, 4),
        "train_state_from_reference": lambda: train_state_from_reference(
            {"params": {"w": [1.0]}, "opt": {"step": 0}}, None),
        "launch.train.run": lambda: launch_train.run(
            mamba, TrainConfig(), batch=2, seq=8, ckpt_dir=os.devnull),
        "launch.train.main": lambda: launch_train.main(
            ["--arch", "mamba2-1.3b", "--smoke", "--mesh", "2x1"]),
        "launch.serve.main": lambda: launch_serve.main(
            ["--arch", "qwen2-vl-7b", "--smoke"]),
        "launch.elastic.main": lambda: launch_elastic.main(
            ["--arch", "mamba2-1.3b", "--smoke", "--ckpt-dir", os.devnull,
             "--mesh", "1x1"]),
        "make_mesh": lambda: make_mesh((1, 1), ("data", "model")),
    }


@pytest.mark.parametrize("name", ["resolve_device", "run_compiled",
                                  "run_sim_compiled", "run_scenario",
                                  "init_params", "init_cache",
                                  "params_from_reference", "ServingEngine",
                                  "init_params_ssm", "init_cache_ssm",
                                  "hybrid.init_params", "hybrid.init_cache",
                                  "ServingEngine_ssm", "init_params_moe",
                                  "init_cache_moe", "ServingEngine_moe",
                                  "MorpheusRouter", "ClusterState",
                                  "RTTPredictor", "make_trained_predictor",
                                  "PredictionManager", "correlate_all",
                                  "select_model", "zoo.GBT",
                                  "make_train_state", "make_batch_iterator",
                                  "train_state_from_reference",
                                  "launch.train.run", "launch.train.main",
                                  "launch.serve.main", "launch.elastic.main",
                                  "make_mesh"])
def test_entry_point_without_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_entry_point_runs_on_cpu_when_asked(monkeypatch):
    from repro_torch.core.campaign import run_scenario
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = run_scenario("baseline", seeds=(0,), n_trials=2, n_requests=10,
                       device="cpu")
    assert set(res) == {"perf_aware", "least_conn", "round_robin", "random",
                        "oracle"}


def test_explicit_cuda_without_card_raises(monkeypatch):
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
