"""The port's train step (``repro_torch.training.train_step``) against the
reference's ``make_train_step`` on the CPU, and the training loop's own
behaviour: microbatch accumulation, a tiny LM that learns, the
refusals, and ``examples/train_lm_torch.py`` with a resume.

The state starts from the reference's ``make_train_state`` carried
across by ``interop.train_state_from_reference``; the batches come from
the same ``SyntheticLMData`` draws on both sides.  Tolerances:

- the ssm (mamba2-1.3b) and hybrid (zamba2-2.7b) archs go through the
  SSD autograd function's plain backward.  Zamba2's LoRA ``qb`` / ``ib``
  start at zeros, so ``qa`` / ``ia`` get no gradient at the first step
  and are not compared (the non-vacuity check exempts leaves whose
  reference gradient is exactly zero).  A leaf that starts at zeros (the
  conv biases, ``qb`` / ``ib``) holds only Adam's steps, each ~lr
  whatever the gradient, so after the first step 1e-5 of its largest
  value would hold Adam's m / sqrt(v) to 1e-5: such leaves are held to
  1e-4 after it (Zamba2 measured 2.3e-5, its loss and grad norm 5e-7);
- loss, grad norm and lr each step: 1e-5 relative (f32 smoke configs;
  the parameters drift apart by the last bits each step).  For the MoE
  arch the gradient inherits the bf16 rounding of the dispatched tokens'
  cotangent (``tests/_torch_train.py``): its norm is held to 1e-2, and
  the loss of the later steps, whose parameters moved by those
  gradients (Adam moves an element of tiny gradient by about lr whatever
  its size, and a flipped sign by 2 lr), to 1e-3;
- parameters after each step, on the elements whose gradient has been
  above 1e-3 of its leaf's largest at every step so far: 1e-5 of the
  leaf's largest value.  Adam's first steps move an element by about
  ``lr * sign(g)``, so where g is near 0 a sign that differs in the last
  bit moves it by 2 lr, and the moments remember it: those elements are
  not compared.  The MoE arch after its first step: the leaves
  downstream of every MoE layer (final norm, LM head, the last layer's
  expert and router slices) at 1e-5, the others at 1e-4 (their clipped
  gradients, 1e-2 apart, meet Adam's eps on the small elements;
  measured 2.3e-5); after the later steps every leaf at 5e-3, since the
  forward then runs on parameters 2 lr apart where signs flipped
  (measured 2.1e-3);
- microbatches 2 against 1: the first leaf within 5e-3, as the
  reference's ``tests/test_system.py`` holds its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs
from _torch_train import DOWNSTREAM_LEAVES, EXPERT_LEAVES, MOE_UPSTREAM_TOL
from repro.data.pipeline import SyntheticLMData as ReferenceData
from repro.configs.base import TrainConfig as ReferenceTrainConfig
from repro.models import model as JM
from repro.training.train_step import make_train_state as ref_state
from repro.training.train_step import make_train_step as ref_step
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.interop import train_state_from_reference
from repro_torch.tree import leaves, leaves_with_path, keystr
from repro_torch.training.train_step import make_train_state, make_train_step

RTOL = 1e-5
#: the MoE arch's parameters after its first step (leaves upstream of a
#: MoE layer) and after the later ones (every leaf)
MOE_FIRST_PARAM_TOL = 1e-4
MOE_LATER_PARAM_TOL = 5e-3
#: leaves that start at zeros (conv biases, Zamba2's LoRA ``qb`` / ``ib``)
#: after the first step: their values are Adam's steps alone
ZERO_INIT_LATER_TOL = 1e-4


def _train_cfgs(**kw):
    kw = dict(dict(learning_rate=1e-3, warmup_steps=1, total_steps=10), **kw)
    return ReferenceTrainConfig(**kw), TrainConfig(**kw)


def _held(moe: bool, step: int, key: str, zero_init: bool) -> list:
    """(slice, tolerance) pairs a parameter leaf is held to after
    ``step`` (the module docstring's rules)."""
    if zero_init and step > 0:
        return [(slice(None), ZERO_INIT_LATER_TOL)]
    if not moe:
        return [(slice(None), RTOL)]
    if step > 0:
        return [(slice(None), MOE_LATER_PARAM_TOL)]
    if key.startswith(DOWNSTREAM_LEAVES):
        return [(slice(None), RTOL)]
    held = [(slice(None), MOE_FIRST_PARAM_TOL)]
    if key.startswith("['layers']['ffn']") and \
            any(f"['{n}']" in key for n in EXPERT_LEAVES):
        held.append((-1, RTOL))
    return held


@pytest.mark.parametrize("arch", ["deepseek-67b", "qwen3-moe-30b-a3b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_three_steps_match_reference(arch):
    jcfg, tcfg = configs(arch, "float32")
    moe = tcfg.moe is not None
    jt, tt = _train_cfgs()
    jstate = ref_state(jax.random.PRNGKey(0), jcfg, jt)
    zero_init = [not np.any(x) for x in jax.tree.leaves(jstate["params"])]
    tstate = train_state_from_reference(jax.tree.map(np.asarray, jstate),
                                        "cpu")
    jstep = jax.jit(ref_step(jcfg, jt))
    tstep = make_train_step(tcfg, tt)
    grad = jax.jit(jax.grad(lambda p, b: JM.train_forward(p, jcfg, b)[0]))
    data = ReferenceData(tcfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    keep = None       # per leaf: |g| above 1e-3 of its largest so far
    for step in range(3):
        rtol = {k: RTOL for k in ("loss", "total_loss", "grad_norm", "lr",
                                  "aux_loss", "tokens")}
        if moe:
            rtol["grad_norm"] = MOE_UPSTREAM_TOL
            if step > 0:
                rtol.update(loss=1e-3, total_loss=1e-3, aux_loss=1e-3)
        b = data.sample(rng, 2, 16)
        jb = jax.tree.map(jnp.asarray, b)
        g = jax.tree.map(np.asarray, grad(jstate["params"], jb))
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        for k, tol in rtol.items():
            assert tm[k].dtype == torch.float32 and tm[k].shape == (), k
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       atol=1e-9, err_msg=f"step {step} {k}")
        assert int(tstate["opt"]["step"]) == step + 1
        big = [np.abs(x) > 1e-3 * np.abs(x).max() for x in
               jax.tree.leaves(g)]
        keep = big if keep is None else [a & b for a, b in zip(keep, big)]
        if step == 0:     # Zamba2's LoRA qa / ia: qb, ib start at zeros
            dead = sum(not x.any() for x in jax.tree.leaves(g))
        # the embedding's gradient lives on each batch's tokens only: its
        # rows seen at every step may be none
        assert sum(x.any() for x in keep) >= len(keep) - 1 - dead
        for (p, got), want, sel, zero in zip(
                leaves_with_path(tstate["params"]),
                jax.tree.leaves(jstate["params"]), keep, zero_init):
            want = np.asarray(want)
            scale = np.abs(want).max()
            for part, tol in _held(moe, step, keystr(p), zero):
                m = sel[part]
                if not m.any():
                    continue
                err = np.abs(got.numpy()[part][m] - want[part][m]).max()
                assert err < tol * scale, (step, keystr(p), part, err / scale)


def test_microbatch_equivalence():
    """Gradient accumulation over 2 microbatches ~ one full batch."""
    cfg = get_config("deepseek-67b", smoke=True).resolve(tp=1)
    data = SyntheticLMData(cfg.vocab_size, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in
             data.sample(np.random.default_rng(0), 8, 16).items()}
    out = []
    for n in (1, 2):
        tt = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                         microbatches=n)
        state = make_train_state(cfg, tt, torch.Generator().manual_seed(0),
                                 "cpu")
        state, m = make_train_step(cfg, tt)(state, batch)
        out.append((leaves(state["params"])[0].float(), m))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               atol=5e-3)
    assert float(out[1][1]["total_loss"]) == pytest.approx(
        float(out[0][1]["total_loss"]), rel=1e-2)


def test_microbatches_match_reference():
    """microbatches = 2 on both sides: loss and grad norm."""
    jcfg, tcfg = configs("deepseek-67b", "float32")
    jt, tt = _train_cfgs(microbatches=2)
    jstate = ref_state(jax.random.PRNGKey(1), jcfg, jt)
    tstate = train_state_from_reference(jax.tree.map(np.asarray, jstate),
                                        "cpu")
    b = ReferenceData(tcfg.vocab_size, seed=1).sample(
        np.random.default_rng(1), 4, 16)
    _, jm = jax.jit(ref_step(jcfg, jt))(jstate, jax.tree.map(jnp.asarray, b))
    _, tm = make_train_step(tcfg, tt)(
        tstate, {k: torch.as_tensor(v) for k, v in b.items()})
    for k in ("total_loss", "loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)


def test_tiny_lm_training_loss_decreases():
    """The reference's ``test_tiny_lm_training_loss_decreases`` on the
    port (deepseek-67b smoke, its bf16 dtype, 30 steps)."""
    cfg = get_config("deepseek-67b", smoke=True).resolve(tp=1)
    tt = TrainConfig(learning_rate=1e-2, warmup_steps=5, total_steps=60,
                     microbatches=1)
    state = make_train_state(cfg, tt, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, tt, rules=None)
    data = SyntheticLMData(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(30):
        batch = {k: torch.as_tensor(v)
                 for k, v in data.sample(rng, 8, 32).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)
    assert leaves(state["params"])[0].dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["grad_compression"])
def test_make_train_step_refuses_multi_card_options(case):
    """``grad_compression`` is read by no train step, the reference's
    included: the port refuses the flag rather than ignore it (the rules
    path is tested in ``tests/test_torch_distributed.py``)."""
    cfg = get_config("deepseek-67b", smoke=True).resolve(tp=1)
    tt = TrainConfig(grad_compression=case == "grad_compression")
    with pytest.raises(NotImplementedError, match="refuses the flag"):
        make_train_step(cfg, tt)


def test_train_example_runs_and_resumes(tmp_path, capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    args = ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "10", "--batch", "4", "--seq", "32"]
    state, metrics = ex.main(args + ["--steps", "20"])
    assert int(state["opt"]["step"]) == 20
    first = capsys.readouterr().out
    assert "step   20 loss=" in first and "resumed" not in first
    state, metrics = ex.main(args + ["--steps", "30"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 20" in out
    assert int(state["opt"]["step"]) == 30
    assert np.isfinite(float(metrics["loss"]))
