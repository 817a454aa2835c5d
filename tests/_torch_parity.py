"""Shared parity helpers of the port's model tests: one model on both
sides (the reference's parameters carried across), prefill plus greedy
decode steps side by side, and one serving-engine wave on both engines.

Tolerance of the logits and caches: the largest absolute difference over
the largest absolute reference value, 1e-4 in f32 (only the order of
sums differs) and 5e-2 in bf16 (bf16 rounds at other places in the two
frameworks).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
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

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def configs(arch: str, dtype: str = "float32", smoke: bool = True, **changes):
    """The reference's and the port's config of ``arch``, resolved."""
    return tuple(dataclasses.replace(get(arch, smoke=smoke), dtype=dtype,
                                     **changes).resolve(tp=1)
                 for get in (reference_config, get_config))


@functools.lru_cache(maxsize=None)
def _models(arch, dtype, changes, seed):
    jcfg, tcfg = configs(arch, dtype, **dict(changes))
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams


def models(arch: str, dtype: str = "float32", seed: int = 0, edit=None,
           **changes):
    """(jcfg, tcfg, jparams, tparams): the reference's parameters from
    ``init_params(PRNGKey(seed))``, after ``edit(numpy tree)`` when one is
    given, on both sides."""
    jcfg, tcfg, jparams = _models(arch, dtype, tuple(sorted(changes.items())),
                                  seed)
    tree = jax.tree.map(np.array, jparams)
    if edit is not None:
        edit(tree)
        jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_reference(tree, "cpu")


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def tokens(seed: int, B: int, S: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def batches(toks: np.ndarray, dtype: str = "float32", **extra):
    """The reference's and the port's batch: ``tokens`` and each extra
    numpy array under its name, rounded to ``dtype`` on each side."""
    j = {"tokens": jnp.asarray(toks),
         **{k: jnp.asarray(v).astype(dtype) for k, v in extra.items()}}
    t = {"tokens": torch.as_tensor(toks),
         **{k: torch.as_tensor(v).to(getattr(torch, dtype))
            for k, v in extra.items()}}
    return j, t


def run_side_by_side(m, jbatch, tbatch, *, cache_len=None, steps=4,
                     on_step=None):
    """Prefill both sides, then ``steps`` greedy decode steps, both on the
    reference's tokens.  Checks each step's logits within the dtype's
    tolerance, equal greedy tokens in f32 (bf16 rounding can swap a near
    tie), equal ``len`` and the padded vocab at -1e30; ``on_step(tcache,
    jcache)`` checks the caches.  Returns the largest logit drift."""
    jcfg, tcfg, jparams, tparams = m
    tol, V = TOL[tcfg.dtype], tcfg.vocab_size
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, cache_len=cache_len)
                     )(jparams, jbatch)
    tl, tc = TM.prefill(tparams, tcfg, tbatch, cache_len=cache_len)
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    worst = 0.0
    for step in range(steps + 1):
        if step:
            jl, jc = decode(jparams, jc, jnp.asarray(tok[:, None]))
            tl, tc = TM.decode_step(tparams, tcfg, tc,
                                    torch.tensor(tok[:, None]))
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        worst = max(worst, rel(tl.numpy(), jl))
        assert worst < tol, (step, worst)
        tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
        if tcfg.dtype == "float32":
            np.testing.assert_array_equal(tl[:, :V].argmax(-1).numpy(), tok)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        if on_step is not None:
            on_step(tc, jc)
    assert np.all(tl[:, V:].numpy() == -1e30)
    return worst


def engine_parity(m, prompts, new, max_seq: int):
    """One wave of ``prompts`` (``new`` tokens each) on the reference's
    and the port's engines (CPU): identical outputs, and every greedy pick
    clear of a near tie (its top-2 margin far above the logits'
    tolerance).  Returns the port's finished requests."""
    jcfg, tcfg, jparams, tparams = m
    ref_eng = ReferenceEngine(jcfg, jparams, max_batch=len(prompts),
                              max_seq=max_seq, clock=ReferenceClock())
    eng = ServingEngine(tcfg, tparams, device="cpu", max_batch=len(prompts),
                        max_seq=max_seq, clock=SimClock())
    seen = []

    def record(fn):
        def wrapped(*args):
            logits, cache = fn(*args)
            seen.append(logits[:, :tcfg.vocab_size].clone())
            return logits, cache
        return wrapped

    eng._prefill, eng._decode = record(eng._prefill), record(eng._decode)
    for i, (p, n) in enumerate(zip(prompts, new)):
        ref_eng.submit(ReferenceRequest(rid=i, tokens=p, max_new_tokens=n))
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=n))
    want = ref_eng.step_wave()
    got = eng.step_wave()
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
        assert len(g.output) == g.max_new_tokens
        assert g.rtt is not None and g.rtt >= 0
    assert len(seen) == max(new)
    for logits in seen:
        top2 = logits.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > 2 * TOL[tcfg.dtype] * float(logits.abs().max())
    assert eng.pending() == 0
    return got


def prompts(seed: int, lengths, vocab: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]
