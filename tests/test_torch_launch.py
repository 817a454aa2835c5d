"""The port's launchers on the CPU: ``launch.train`` (checkpoints,
auto-resume, SIGTERM preemption, a two-rank ``--mesh 2x1`` run on gloo,
a two-rank tensor-parallel ``--mesh 1x2`` run),
``launch.elastic`` (a checkpoint restored onto another mesh) and
``launch.serve`` (its line equals the reference launcher's).

Multi-rank runs start one process a rank with ``RANK`` / ``WORLD_SIZE``
and ``--dist-init file://...`` (what ``torchrun`` sets up with
``env://``), so no test opens a TCP port.
"""
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.tree import leaves_with_path

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMOKE = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
         "--batch", "4", "--seq", "16"]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _module(mod, args, **env):
    return subprocess.Popen([sys.executable, "-m", mod, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(**env), cwd=ROOT)


def _ranks(mod, args, n, store):
    """``n`` ranks of ``mod`` joined through a file store; their
    (returncode, stdout, stderr)."""
    procs = [_module(mod, [*args, "--dist-init", f"file://{store}"],
                     RANK=r, WORLD_SIZE=n, LOCAL_RANK=r) for r in range(n)]
    outs = [p.communicate(timeout=240) for p in procs]
    return [(p.returncode, *o) for p, o in zip(procs, outs)]


@pytest.fixture(scope="module", autouse=True)
def reference_serve():
    """The reference launcher, started before the first test (jax
    compiles for a while) and read by the serve test."""
    p = _module("repro.launch.serve", ["--arch", "qwen2-vl-7b", "--smoke"])
    yield p
    if p.poll() is None:
        p.kill()
        p.communicate()


@pytest.fixture
def reference_serve_line(reference_serve):
    out, err = reference_serve.communicate(timeout=300)
    assert reference_serve.returncode == 0, err[-3000:]
    return out.strip().splitlines()[-1]


def test_train_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert ttrain.main([*SMOKE, "--steps", "4", "--ckpt-every", "2",
                        "--ckpt-dir", ck]) == 0
    out = capsys.readouterr().out
    assert "[train] done at step 4" in out and "resumed" not in out
    assert sorted(os.listdir(ck)) == ["step_0000000002", "step_0000000004"]
    cfg = get_config("mamba2-1.3b", smoke=True).resolve(tp=1)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=6)
    first = ttrain.run(cfg, tcfg, batch=4, seq=16, ckpt_dir=str(
        tmp_path / "again"), ckpt_every=2, steps=4, device="cpu")
    saved = {p: x.clone() for p, x in leaves_with_path(first["state"])}
    seen = []
    res = ttrain.run(cfg, tcfg, batch=4, seq=16, ckpt_dir=str(
        tmp_path / "again"), ckpt_every=2, device="cpu",
        on_restore=lambda s, st: seen.append(
            (s, all(torch.equal(x, saved[p])
                    for p, x in leaves_with_path(st)))))
    assert seen == [(4, True)]
    assert res["start"] == 4 and res["step"] == 6
    out = capsys.readouterr().out
    assert "[train] resumed at step 4" in out
    assert "[train] done at step 6" in out


def test_sigterm_checkpoints_and_exits_cleanly(tmp_path):
    ck = str(tmp_path / "ck")
    p = _module("repro_torch.launch.train",
                [*SMOKE, "--steps", "100000", "--ckpt-every", "100000",
                 "--ckpt-dir", ck])
    line = ""
    deadline = time.time() + 120
    while "[train] step 10 " not in line and time.time() < deadline:
        line = p.stdout.readline()
        assert line or p.poll() is None, p.stderr.read()[-3000:]
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err[-3000:]
    m = re.search(r"\[train\] preempted -> checkpointed step (\d+)", out)
    assert m, out
    step = int(m.group(1))
    assert step >= 10 and os.listdir(ck) == [f"step_{step:010d}"]
    q = _module("repro_torch.launch.train",
                [*SMOKE, "--steps", str(step + 2), "--ckpt-dir", ck])
    out, err = q.communicate(timeout=120)
    assert q.returncode == 0, err[-3000:]
    assert f"[train] resumed at step {step}" in out
    assert f"[train] done at step {step + 2}" in out


def test_two_rank_train_and_elastic_restore(tmp_path):
    """``--mesh 2x1`` on two gloo ranks trains, checkpoints (whole
    leaves, rank 0) and resumes; ``launch.elastic`` restores it onto two
    ranks and onto one, printing the reference's line."""
    ck = str(tmp_path / "ck")
    args = [*SMOKE, "--mesh", "2x1", "--microbatches", "2", "--ckpt-dir",
            ck, "--ckpt-every", "2"]
    runs = _ranks("repro_torch.launch.train", [*args, "--steps", "4"], 2,
                  tmp_path / "s1")
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
    assert "[train] done at step 4" in runs[0][1]
    assert runs[1][1] == ""                      # rank 0 prints
    assert sorted(os.listdir(ck))[-1] == "step_0000000004"
    runs = _ranks("repro_torch.launch.train", [*args, "--steps", "6"], 2,
                  tmp_path / "s2")
    assert all(rc == 0 for rc, _, _ in runs), runs[0][2][-3000:]
    assert "[train] resumed at step 4" in runs[0][1]
    cfg = get_config("mamba2-1.3b", smoke=True)
    n = sum(x.numel() for _, x in leaves_with_path(
        ttrain.make_train_state(cfg.resolve(tp=1), TrainConfig(),
                                torch.Generator(), "meta")["params"]))
    want = (f"[elastic] restored step 6 of {cfg.name} onto mesh {{}}; "
            f"params resharded ({n} elements)")
    el = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
          "--ckpt-dir", ck]
    runs = _ranks("repro_torch.launch.elastic", [*el, "--mesh", "2x1"], 2,
                  tmp_path / "s3")
    assert all(rc == 0 for rc, _, _ in runs), runs[0][2][-3000:]
    assert want.format("2x1") in runs[0][1].splitlines()
    p = _module("repro_torch.launch.elastic", [*el, "--mesh", "1x1"])
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err[-3000:]
    assert want.format("1x1") in out.splitlines()


def test_two_rank_tensor_parallel_train(tmp_path):
    """``--mesh 1x2`` on two gloo ranks: deepseek-67b's smoke config,
    resolved for tp 2, trains with its heads, MLP and vocabulary split
    over the model axis and checkpoints whole leaves; mamba2-1.3b trains
    with its ``ssm_inner`` channels and heads split; seamless-m4t-medium
    (``encdec``) trains with its encoder and cross-attention on local
    heads, and a sequence that does not split over the model axis is
    refused with ValueError naming both sizes."""
    ck = str(tmp_path / "ck")
    args = ["--arch", "deepseek-67b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--mesh", "1x2", "--ckpt-dir",
            ck, "--ckpt-every", "2", "--steps", "4"]
    runs = _ranks("repro_torch.launch.train", args, 2, tmp_path / "s1")
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
    assert "[train] done at step 4" in runs[0][1]
    assert sorted(os.listdir(ck))[-1] == "step_0000000004"
    runs = _ranks("repro_torch.launch.train",
                  [*SMOKE, "--mesh", "1x2", "--steps", "2", "--ckpt-dir",
                   str(tmp_path / "ck2")], 2, tmp_path / "s2")
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
    assert "[train] done at step 2" in runs[0][1]
    enc = ["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu",
           "--batch", "4", "--mesh", "1x2", "--steps", "2"]
    runs = _ranks("repro_torch.launch.train",
                  [*enc, "--seq", "16", "--ckpt-dir", str(tmp_path / "ck3")],
                  2, tmp_path / "s3")
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
    assert "[train] done at step 2" in runs[0][1]
    runs = _ranks("repro_torch.launch.train",
                  [*enc, "--seq", "15", "--ckpt-dir", str(tmp_path / "ck4")],
                  2, tmp_path / "s4")
    for rc, out, err in runs:
        assert rc != 0 and "ValueError" in err and ("a sequence of 15 "
                                                    "tokens does not split "
                                                    "over 2") in err, \
            err[-3000:]


def test_serve_line_equals_reference_launcher(reference_serve_line,
                                              capsys):
    """Under the simulated clock a request's RTT depends on its route and
    the slowdowns only, so the port's line is the reference's: the same
    routes, mean and p95."""
    assert tserve.main(["--arch", "qwen2-vl-7b", "--smoke",
                        "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == reference_serve_line
    assert lines[0].startswith("[serve] qwen2-vl-7b-smoke policy=perf_aware")
    shares = [float(x) for x in lines[1].split()[2:]]
    assert len(shares) == 3 and abs(sum(shares) - 1) < 0.02
    assert shares[2] < min(shares[:2])      # the slow replica gets least


def test_launchers_need_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen2-vl-7b", "--smoke"])
