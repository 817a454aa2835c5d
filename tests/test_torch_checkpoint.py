"""The port's checkpointer (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint`` on the CPU: a checkpoint written by
either side restores on the other (bf16 leaves bit for bit), the
reference's own checkpoint tests replayed on the port, a full train
state's round trip and a training restart that continues with the same
losses."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as ReferenceCheckpointer
from repro_torch.checkpoint import Checkpointer, install_sigterm_handler
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.interop import params_from_reference
from repro_torch.tree import leaves, leaves_with_path, tree_map
from repro_torch.training.train_step import make_train_state, make_train_step


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b": torch.randn((8,), generator=g).bfloat16()},
            "opt": {"m": torch.ones((4, 8)),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "layers": [torch.arange(3, dtype=torch.int64),
                       torch.randn((2, 2), generator=g).double()]}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _assert_same(a, b):
    for (p, x), (q, y) in zip(leaves_with_path(a), leaves_with_path(b)):
        assert p == q and x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x, y), p


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, use_async=False)
    t = _tree()
    ck.save(3, t, blocking=True)
    _assert_same(ck.restore(_zeros_like(t)), t)


def test_layout_is_the_reference_s(tmp_path):
    ck = Checkpointer(str(tmp_path), use_async=False)
    ck.save(12, _tree(), blocking=True)
    d = tmp_path / "step_0000000012"
    assert sorted(os.listdir(d)) == ["MANIFEST.json", "arrays.npz"]
    man = json.loads((d / "MANIFEST.json").read_text())
    assert man["step"] == 12
    assert man["leaves"]["params::b"] == {"shape": [8], "dtype": "bfloat16"}
    assert man["leaves"]["layers::0"]["dtype"] == "int64"
    with np.load(d / "arrays.npz") as z:
        assert z["params::b"].dtype == np.uint16
        assert set(z.files) == set(man["leaves"])


def test_keep_k_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, use_async=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), blocking=True)
    assert ck.steps() == [3, 4]


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3, use_async=True)
    ck.save(1, _tree())
    ck.wait()
    assert ck.latest_step() == 1


def test_crash_tmp_dir_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3, use_async=False)
    ck.save(1, _tree(), blocking=True)
    os.makedirs(tmp_path / "step_0000000002.tmp")
    assert ck.latest_step() == 1


def test_restore_dtype_and_shape_coercion(tmp_path):
    ck = Checkpointer(str(tmp_path), use_async=False)
    ck.save(0, {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            blocking=True)
    r = ck.restore({"w": torch.zeros((3, 4), dtype=torch.bfloat16)})
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"].float(),
                       torch.arange(12, dtype=torch.float32).reshape(3, 4))


def test_missing_leaf_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), use_async=False)
    ck.save(0, {"a": torch.zeros(2)}, blocking=True)
    with pytest.raises(KeyError):
        ck.restore({"a": torch.zeros(2), "b": torch.zeros(3)})


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path), use_async=False).restore({})


def _reference_tree():
    k = jax.random.PRNGKey(3)
    return {"params": {"w": jax.random.normal(k, (4, 8)),
                       "b": jax.random.normal(k, (8,)).astype(jnp.bfloat16)},
            "opt": {"m": jnp.ones((4, 8)), "step": jnp.int32(7)}}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _reference_tree()
    ReferenceCheckpointer(str(tmp_path), use_async=False).save(
        5, ref, blocking=True)
    want = params_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    got = Checkpointer(str(tmp_path), use_async=False).restore(
        _zeros_like(want))
    _assert_same(got, want)
    assert got["params"]["b"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref = _reference_tree()
    port = params_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    Checkpointer(str(tmp_path), use_async=False).save(9, port, blocking=True)
    rck = ReferenceCheckpointer(str(tmp_path), use_async=False)
    assert rck.latest_step() == 9
    got = rck.restore(jax.tree.map(jnp.zeros_like, ref))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.uint16), b.view(np.uint16)
        np.testing.assert_array_equal(a, b)


def test_train_state_round_trip(tmp_path):
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).resolve(tp=1)
    tcfg = TrainConfig()
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             "cpu")
    ck = Checkpointer(str(tmp_path), use_async=True)
    ck.save(0, state)
    ck.wait()
    _assert_same(ck.restore(_zeros_like(state)), state)
    assert leaves(state["params"])[0].dtype == torch.bfloat16


def test_async_save_holds_the_state_of_its_step(tmp_path):
    """An async save of a CPU train state, with the next step run before
    the write: the checkpoint holds the saved step's state, although the
    step updates params, master and moments in place."""
    import threading
    cfg = get_config("qwen2-vl-7b", smoke=True).resolve(tp=1)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, tcfg)
    data = SyntheticLMData(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(v) for k, v in
                data.sample(rng, 2, 16).items()} for _ in range(2)]
    state, _ = step(state, batches[0])
    saved = tree_map(lambda x: x.clone(), state)
    ck = Checkpointer(str(tmp_path), keep=2, use_async=True)
    go = threading.Event()
    write = ck._write
    ck._write = lambda *a: (go.wait(), write(*a))
    ck.save(1, state)
    state, _ = step(state, batches[1])
    assert not torch.equal(leaves(state["params"])[-1],
                           leaves(saved["params"])[-1])
    go.set()
    ck.wait()
    _assert_same(ck.restore(_zeros_like(saved)), saved)


def test_checkpoint_restart_continuity(tmp_path):
    """The reference's ``test_checkpoint_restart_continuity``: train 3
    steps, checkpoint, train 3 more; restore and train the same 3: the
    same loss."""
    cfg = get_config("mamba2-1.3b", smoke=True).resolve(tp=1)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, tcfg)
    data = SyntheticLMData(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(v) for k, v in
                data.sample(rng, 4, 32).items()} for _ in range(6)]
    for b in batches[:3]:
        state, _ = step(state, b)
    ck = Checkpointer(str(tmp_path), use_async=False)
    ck.save(3, state, blocking=True)
    restored = ck.restore(_zeros_like(state))
    for b in batches[3:]:
        state, m_direct = step(state, b)
    for b in batches[3:]:
        restored, m_rest = step(restored, b)
    assert float(m_direct["loss"]) == float(m_rest["loss"])
    _assert_same(restored, state)


def test_sigterm_handler_saves_and_exits():
    import signal
    saved = []
    old = signal.getsignal(signal.SIGTERM)
    try:
        handler = install_sigterm_handler(lambda: saved.append(1))
        with pytest.raises(SystemExit) as exc:
            handler(signal.SIGTERM, None)
        assert exc.value.code == 0 and saved == [1]
    finally:
        signal.signal(signal.SIGTERM, old)
