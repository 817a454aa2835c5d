"""The port's decoder-only model and serving engine against the JAX
package, at qwen2-vl-7b's smoke config on the CPU.

Both sides get the reference's parameters (``params_from_reference``): the
port cannot replay jax PRNG draws.  Prompts are made with numpy from a
seed.  Tolerances, as the largest absolute difference over the largest
absolute reference value:

- f32: 1e-4.  The math is the same; only the order of sums differs (the
  reference's blockwise online softmax against the plain full softmax).
- bf16: 5e-2.  bf16 rounds at other places in the two frameworks, and the
  port's attention keeps P in f32 where the reference's XLA path casts it
  to bf16 before P.V (the Pallas kernels keep f32, as the port does).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as reference_config
from repro.models import model as JM
from repro.monitoring.metrics import SimClock as ReferenceClock
from repro.serving.engine import Request as ReferenceRequest
from repro.serving.engine import ServingEngine as ReferenceEngine
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import model as TM
from repro_torch.monitoring.metrics import SimClock
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "qwen2-vl-7b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
CACHE_LEN = 32


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jcfg = dataclasses.replace(reference_config(ARCH, smoke=True),
                               dtype=dtype).resolve(tp=1)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=dtype).resolve(tp=1)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return dtype, jcfg, tcfg, jparams, tparams


@pytest.fixture(params=list(TOL))
def setup(request):
    return _models(request.param)


@pytest.fixture
def f32():
    return _models("float32")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


def test_config_is_the_reference_config():
    for smoke in (True, False):
        ours = get_config(ARCH, smoke=smoke).resolve(tp=1)
        theirs = reference_config(ARCH, smoke=smoke).resolve(tp=1)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert get_config(ARCH).param_count() == 7_615_483_904


def test_init_params_has_the_reference_tree(setup):
    dtype, jcfg, tcfg, jparams, _ = setup
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    flat_ref = {jax.tree_util.keystr(p): x for p, x in
                jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat_ours = {jax.tree_util.keystr(p): x for p, x in
                 jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert set(flat_ours) == set(flat_ref)
    for name, x in flat_ref.items():
        assert tuple(flat_ours[name].shape) == x.shape, name
        assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name
    wq = flat_ours["['layers']['attn']['wq']"].float()
    std = tcfg.d_model ** -0.5
    assert wq.abs().max() <= 2 * std * (1 + 1e-2)     # truncated at 2 sigma
    assert 0.7 * std < wq.std() < 1.0 * std


def test_prefill_and_decode_match_reference(setup):
    dtype, jcfg, tcfg, jparams, tparams = setup
    tol = TOL[dtype]
    toks = _tokens(0, 3, 13, tcfg.vocab_size)
    nft = tcfg.num_frontend_tokens
    jbatch = {"tokens": jnp.asarray(toks),
              "vision_embeds": jnp.zeros((3, nft, tcfg.d_model),
                                         jnp.bfloat16)}
    tbatch = {"tokens": torch.as_tensor(toks),
              "vision_embeds": torch.zeros((3, nft, tcfg.d_model),
                                           dtype=torch.bfloat16)}
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b,
                                             cache_len=CACHE_LEN))(jparams,
                                                                   jbatch)
    tl, tc = TM.prefill(tparams, tcfg, tbatch, cache_len=CACHE_LEN)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert _rel(tl.numpy(), jl) < tol
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert _rel(tc[key].float().numpy(), jc[key]) < tol
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))

    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    V = tcfg.vocab_size
    tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
    for _ in range(4):
        jl, jc = decode(jparams, jc, jnp.asarray(tok[:, None]))
        tl, tc = TM.decode_step(tparams, tcfg, tc, torch.tensor(
            tok[:, None]))
        assert _rel(tl.numpy(), jl) < tol
        assert _rel(tc["k"].float().numpy(), jc["k"]) < tol
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
        tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
    assert np.all(tl[:, V:].numpy() == -1e30)


LENGTHS, NEW = (9, 13, 11), (4, 3, 4)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in LENGTHS]


def test_engine_matches_reference_engine_f32(f32):
    dtype, jcfg, tcfg, jparams, tparams = f32
    prompts = _prompts(tcfg.vocab_size)
    ref_eng = ReferenceEngine(jcfg, jparams, max_batch=3, max_seq=CACHE_LEN,
                              clock=ReferenceClock())
    eng = ServingEngine(tcfg, tparams, device="cpu", max_batch=3,
                        max_seq=CACHE_LEN, clock=SimClock())
    seen = []

    def record(fn):
        def wrapped(*args):
            logits, cache = fn(*args)
            seen.append(logits[:, :tcfg.vocab_size].clone())
            return logits, cache
        return wrapped

    eng._prefill, eng._decode = record(eng._prefill), record(eng._decode)
    for i, (p, n) in enumerate(zip(prompts, NEW)):
        ref_eng.submit(ReferenceRequest(rid=i, tokens=p, max_new_tokens=n))
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=n))
    want = ref_eng.step_wave()
    got = eng.step_wave()
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
        assert len(g.output) == g.max_new_tokens
        assert g.rtt is not None and g.rtt >= 0
    assert len(seen) == max(NEW)
    # no near tie: the top-2 margin of every greedy pick is far above the
    # logits' tolerance, so the identical tokens are not luck
    for logits in seen:
        top2 = logits.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > 2 * TOL[dtype] * float(logits.abs().max())
    assert eng.pending() == 0
    assert {"queue_depth", "token_rate"} <= set(eng.store.names)


def _engine(tcfg, tparams, **kw):
    kw.setdefault("max_seq", CACHE_LEN)
    return ServingEngine(tcfg, tparams, device="cpu", max_batch=3,
                         clock=SimClock(), **kw)


def test_wave_shorter_than_vision_stub_raises(f32):
    _, _, tcfg, _, tparams = f32
    eng = _engine(tcfg, tparams)
    short = tcfg.num_frontend_tokens - 1
    eng.submit(Request(rid=0, tokens=np.ones(short, np.int32)))
    with pytest.raises(ValueError, match="vision"):
        eng.step_wave()
    assert eng.pending() == 1


def test_wave_longer_than_max_seq_raises(f32):
    _, _, tcfg, _, tparams = f32
    eng = _engine(tcfg, tparams)
    eng.submit(Request(rid=0, tokens=np.ones(20, np.int32),
                       max_new_tokens=CACHE_LEN - 20 + 2))
    with pytest.raises(ValueError, match="max_seq"):
        eng.step_wave()
    assert eng.pending() == 1
    eng.queue[0].max_new_tokens = CACHE_LEN - 20 + 1    # fills max_seq
    (done,) = eng.step_wave()
    assert len(done.output) == CACHE_LEN - 20 + 1


def test_engine_without_card_raises(f32, monkeypatch):
    _, _, tcfg, _, tparams = f32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg, tparams)


def test_family_outside_the_catalogue_raises():
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              family="diffusion").resolve(tp=1)
    with pytest.raises(NotImplementedError, match="catalogue"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="catalogue"):
        TM.init_cache(cfg, 1, 8, device="cpu")
