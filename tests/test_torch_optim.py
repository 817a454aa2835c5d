"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw`` on the CPU: ``adamw_update`` on identical numpy
parameters and gradients (f32 master or not, f32 or bf16 moments), the
decay mask on every leaf of every arch, ``lr_schedule`` at every step of
a run and ``global_norm``.

Tolerance 1e-6 relative (rtol and atol over each leaf's largest value):
both sides run the same f32 arithmetic in the same order; the bias
corrections' powers may round differently in the last bit.  bf16 leaves
are compared after that rounding, where such a bit can move a value by
one bf16 ulp: those are held to one ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as ReferenceTrainConfig
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch.configs.base import TrainConfig, available_archs, get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.tree import keystr, leaves_with_path

TOL = 1e-6
BF16_ULP = 2.0 ** -8


def _tree(seed: int):
    """A parameter-like tree whose names cross the decay mask."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": {"tok": (16, 8)},
              "layers": {"attn": {"wq": (2, 8, 4), "bq": (2, 4)},
                         "ln1": {"scale": (2, 8)},
                         "mixer": {"A_log": (2, 3), "dt_bias": (2, 3),
                                   "Dskip": (2, 3), "in_x": (2, 8, 6)}},
              "final_norm": {"scale": (8,)}}

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return rng.standard_normal(t).astype(np.float32)
    return draw(shapes)


def _as(tree, dtype):
    return jax.tree.map(lambda x: np.asarray(x).astype(dtype), tree)


def _check(got, want, what):
    for (p, g), (_, w) in zip(leaves_with_path(got), leaves_with_path(want)):
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        tol = BF16_ULP if _leaf(got, p).dtype == torch.bfloat16 else TOL
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {keystr(p)}")


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("master_fp32", [True, False])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(master_fp32, moment_dtype):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, grad_clip=0.5, master_fp32=master_fp32,
              moment_dtype=moment_dtype)
    jt, tt = ReferenceTrainConfig(**kw), TrainConfig(**kw)
    params = _as(_tree(0), jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = JA.adamw_init(jp, master_fp32, moment_dtype)
    tp = params_from_reference(params, "cpu")
    topt = TA.adamw_init(tp, master_fp32, moment_dtype)
    for step in range(3):
        grads = _tree(10 + step)
        jp, jopt, jm = JA.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                       jopt, jt)
        tp, topt, tm = TA.adamw_update(
            tp, params_from_reference(grads, "cpu"), topt, tt)
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        assert topt["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL)
        _check(tp, jax.tree.map(np.asarray, jp), f"step {step} params")
        for name in ("master", "m", "v"):
            _check(topt[name], jax.tree.map(lambda x: np.asarray(x, np.float32),
                                            jopt[name]),
                   f"step {step} {name}")
            want_dt = (torch.float32 if master_fp32 else torch.bfloat16) \
                if name == "master" else getattr(torch, moment_dtype)
            assert all(x.dtype == want_dt for _, x in
                       leaves_with_path(topt[name])), name


def test_adamw_update_writes_in_place_and_clips():
    tt = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=5,
                     grad_clip=1e-3)
    tp = params_from_reference(_tree(0), "cpu")
    opt = TA.adamw_init(tp, True, "float32")
    ptr = tp["embed"]["tok"].data_ptr()
    grads = params_from_reference(_tree(1), "cpu")
    new_p, new_opt, m = TA.adamw_update(tp, grads, opt, tt)
    assert new_p is tp and new_opt is opt
    assert new_p["embed"]["tok"].data_ptr() == ptr
    assert float(m["grad_norm"]) > 1.0            # clipped to 1e-3


@pytest.mark.parametrize("arch", available_archs())
def test_decay_mask_on_every_leaf(arch):
    jcfg = get_config(arch, smoke=True).resolve(tp=1)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): JA._decay_mask(jax.tree_util.keystr(p))
            for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tparams = TM.init_params(jcfg, torch.Generator().manual_seed(0), "cpu")
    got = {keystr(p): TA._decay_mask(keystr(p))
           for p, _ in leaves_with_path(tparams)}
    assert list(got) == list(want)
    assert got == want
    assert any(got.values()) and not all(got.values())


def test_lr_schedule_every_step():
    kw = dict(learning_rate=3e-4, warmup_steps=7, total_steps=40)
    jfn = JA.lr_schedule(ReferenceTrainConfig(**kw))
    tfn = TA.lr_schedule(TrainConfig(**kw))
    steps = np.arange(0, 46, dtype=np.int32)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(steps)))
    got = np.array([float(tfn(torch.tensor(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-12)
    assert got[0] == 0.0 and got[-1] == 0.0


def test_lr_schedule_without_warmup():
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=5)
    steps = np.arange(0, 7, dtype=np.int32)
    want = np.asarray(jax.vmap(JA.lr_schedule(ReferenceTrainConfig(**kw)))(
        jnp.asarray(steps)))
    got = TA.lr_schedule(TrainConfig(**kw))(torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_global_norm_matches_reference():
    tree = _tree(4)
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = TA.global_norm(params_from_reference(tree, "cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=TOL)


def test_train_config_matches_reference():
    want = {f.name: f.default for f in dataclasses.fields(
        ReferenceTrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert got == want
