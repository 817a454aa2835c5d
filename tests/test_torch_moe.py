"""The port's MoE slice against the JAX package, on the CPU: the ``gmm``
kernel's plain version, the MoE layer, the ``moe`` model and the serving
engine at qwen3-moe-30b-a3b's smoke config.

Inputs are made with numpy from a seed and handed to both sides; the
layer and model comparisons hand both sides the reference's parameters
(``params_from_reference``).  Tolerances:

- ``gmm``, against the Pallas kernel in interpret mode and
  ``ref.gmm_ref``: 2e-5 in f32 and 2e-2 in bf16, rtol and atol
  (``tests/test_kernels.py``'s: sums in another order, bf16 outputs
  rounded once).
- The MoE layer and the model's logits, as the largest absolute
  difference over the largest absolute reference value: 1e-4 in f32
  (the same routing; only the order of sums differs) and 2e-2 for the
  layer in bf16 (bf16 rounds at other places in the two frameworks).
  Both sides get the same inputs, so they route the same tokens to the
  same experts; the dropping case checks that some assignment is
  dropped, so the capacity priority is what is compared.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as reference_config
from repro.kernels import ref
from repro.kernels.moe_gmm import gmm as pallas_gmm
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.monitoring.metrics import SimClock as ReferenceClock
from repro.serving.engine import Request as ReferenceRequest
from repro.serving.engine import ServingEngine as ReferenceEngine
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels.gmm import _variant as gmm_variant
from repro_torch.kernels.gmm import gmm, gmm_plain
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.monitoring.metrics import SimClock
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "qwen3-moe-30b-a3b"
GMM_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_LEN = 32

# (E, C, D, F, block_c, block_f, block_d): tests/test_kernels.py's sweep,
# then ragged C (1, 5, 100) for the plain version against the oracle
GMM_CASES = [(2, 64, 32, 48, 32, 16, 16), (4, 128, 64, 64, 64, 64, 32),
             (1, 32, 16, 128, 32, 64, 16)]
RAGGED_C = [(3, 1, 32, 48), (2, 5, 64, 16), (4, 100, 48, 80)]


def _gmm_inputs(E, C, D, F, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    jdt, tdt, _ = GMM_DTYPES[dtype]
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
@pytest.mark.parametrize("E,C,D,F,bc,bf,bd", GMM_CASES)
@pytest.mark.parametrize("dtype", list(GMM_DTYPES))
def test_gmm_plain_matches_reference(dtype, E, C, D, F, bc, bf, bd, oracle):
    (jx, jw), (tx, tw) = _gmm_inputs(E, C, D, F, dtype)
    got = gmm_plain(tx, tw)
    assert got.shape == (E, C, F) and got.dtype == tx.dtype
    want = (pallas_gmm(jx, jw, block_c=bc, block_f=bf, block_d=bd,
                       interpret=True) if oracle == "pallas"
            else ref.gmm_ref(jx, jw))
    _close(got, want, GMM_DTYPES[dtype][2])


@pytest.mark.parametrize("E,C,D,F", RAGGED_C)
@pytest.mark.parametrize("dtype", list(GMM_DTYPES))
def test_gmm_plain_ragged_c_matches_ref(dtype, E, C, D, F):
    (jx, jw), (tx, tw) = _gmm_inputs(E, C, D, F, dtype, seed=1)
    _close(gmm_plain(tx, tw), ref.gmm_ref(jx, jw), GMM_DTYPES[dtype][2])


def test_gmm_wrapper_runs_the_plain_version_on_cpu():
    _, (tx, tw) = _gmm_inputs(2, 5, 32, 48, "bfloat16")
    launches, plain = gmm.launches, gmm.plain_calls
    got = gmm(tx, tw)
    assert gmm.launches == launches and gmm.plain_calls == plain + 1
    assert torch.equal(got, gmm_plain(tx, tw))


@pytest.mark.parametrize("case", ["mixed_dtypes", "non_contiguous",
                                  "d_not_16", "f_not_16", "shapes",
                                  "float16"])
def test_gmm_wrapper_refuses(case):
    x = torch.zeros((2, 4, 32), dtype=torch.bfloat16)
    w = torch.zeros((2, 32, 48), dtype=torch.bfloat16)
    x, w, err = {
        "mixed_dtypes": (x, w.float(), TypeError),
        "non_contiguous": (x, w.transpose(1, 2).contiguous().transpose(1, 2),
                           ValueError),
        "d_not_16": (x[..., :24].contiguous(), w[:, :24].contiguous(),
                     ValueError),
        "f_not_16": (x, w[..., :40].contiguous(), ValueError),
        "shapes": (x, w[:1].contiguous(), ValueError),
        "float16": (x.half(), w.half(), TypeError)}[case]
    with pytest.raises(err):
        gmm(x, w)


@pytest.mark.parametrize("C,D,F", [(1, 2048, 768), (4, 2048, 768),
                                   (16, 768, 2048), (17, 768, 2048),
                                   (624, 2048, 768), (5, 16, 16)])
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "fma")])
def test_gmm_variant_rule(dtype, want, C, D, F):
    """bf16 takes the wgmma kernel at every shape the wrapper accepts
    (decode's C <= 16 included: the kernel swaps its operands there); f32
    the FMA kernel, whose f32 sums keep the 2e-5 tolerance."""
    assert gmm_variant(dtype, C, D, F) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_cpu_calls_count_neither_variant(dtype):
    """On the CPU the wrapper runs the plain version: ``plain_calls``
    moves, no launch counter does."""
    _, (tx, tw) = _gmm_inputs(2, 5, 32, 48, dtype)
    counters = ("plain_calls", "launches", "wgmma_launches", "fma_launches")
    before = [getattr(gmm, c) for c in counters]
    gmm(tx, tw)
    assert [getattr(gmm, c) - b for c, b in zip(counters, before)] == \
        [1, 0, 0, 0]


def test_config_is_the_reference_config():
    for smoke in (True, False):
        ours = get_config(ARCH, smoke=smoke).resolve(tp=1)
        theirs = reference_config(ARCH, smoke=smoke).resolve(tp=1)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert get_config(ARCH).param_count() == \
        reference_config(ARCH).param_count() == 30_532_108_288


# ----------------------------------------------------------------------
# the MoE layer
def _cfgs(dtype, capacity_factor=None):
    jcfg = dataclasses.replace(reference_config(ARCH, smoke=True),
                               dtype=dtype).resolve(tp=1)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=dtype).resolve(tp=1)
    out = []
    for cfg in (jcfg, tcfg):
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_drops(p, cfg, x: torch.Tensor) -> int:
    """Assignments over capacity in the port's routing of x."""
    m = cfg.moe
    B, S, D = x.shape
    G = TMoE.dispatch_groups(B * S, m.num_groups)
    probs = torch.softmax(x.reshape(G, -1, D).float() @ p["router"], -1)
    ids = probs.topk(m.top_k, dim=-1).indices
    cap = TMoE.capacity(B * S // G, m.top_k, m.num_experts,
                        m.capacity_factor)
    return sum(int((torch.bincount(ids[g].flatten(),
                                   minlength=m.num_experts) - cap)
                   .clamp_min(0).sum()) for g in range(G))


# (capacity_factor, B, S): the smoke config (drop-free), the same with
# capacity 1.0 (some assignments dropped), and T = 2600 > 2048 tokens in
# one layer's input (G = 2 dispatch groups)
MOE_CASES = {"drop_free": (None, 2, 16), "dropping": (1.0, 2, 16),
             "two_groups": (None, 1, 2600)}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("dtype", list(TOL))
def test_moe_ffn_matches_reference(dtype, case):
    cf, B, S = MOE_CASES[case]
    jcfg, tcfg = _cfgs(dtype, cf)
    jp, _ = JMoE.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_y, want_aux = JMoE.moe_ffn(jp, jcfg, jx)
    calls = gmm.plain_calls
    y, aux = TMoE.moe_ffn(tp, tcfg, tx)
    assert gmm.plain_calls == calls + 3
    assert y.shape == (B, S, jcfg.d_model) and y.dtype == tx.dtype
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert _rel(y.float().numpy(), want_y) < TOL[dtype]
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    drops = _port_drops(tp, tcfg, tx)
    if case == "dropping":
        assert drops > 0
        free, _ = JMoE.moe_ffn(jp, _cfgs(dtype, 4.0)[0], jx)
        assert _rel(free, want_y) > 10 * TOL[dtype]   # the drops matter
    else:
        assert drops == 0
    if case == "two_groups":
        assert TMoE.dispatch_groups(B * S, tcfg.moe.num_groups) == 2


def test_init_moe_tree_and_scales():
    _, tcfg = _cfgs("bfloat16")
    p = TMoE.init_moe(tcfg, torch.Generator().manual_seed(0))
    E, D, Fd = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((D, E), torch.float32), "wi": ((E, D, Fd), torch.bfloat16),
        "wg": ((E, D, Fd), torch.bfloat16), "wo": ((E, Fd, D), torch.bfloat16)}
    for name, std in (("router", D ** -0.5), ("wi", D ** -0.5),
                      ("wo", Fd ** -0.5)):
        leaf = p[name].float()
        assert leaf.abs().max() <= 2 * std * (1 + 1e-2)   # truncated at 2σ
        assert 0.7 * std < leaf.std() < 1.0 * std


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_params_from_reference_keeps_the_router_f32():
    _, tcfg, jparams, tparams = _models("bfloat16")
    ffn = tparams["layers"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert all(ffn[k].dtype == torch.bfloat16 for k in ("wi", "wg", "wo"))
    assert tparams["layers"]["attn"]["wq"].dtype == torch.bfloat16
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    flat = {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(ours)[0]}
    for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        name = jax.tree_util.keystr(p)
        assert tuple(flat[name].shape) == x.shape, name
        assert str(flat[name].dtype)[6:] == str(x.dtype), name


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


def test_prefill_and_decode_match_reference():
    jcfg, tcfg, jparams, tparams = _models("float32")
    toks = _tokens(0, 3, 13, tcfg.vocab_size)
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b,
                                             cache_len=CACHE_LEN))(
        jparams, {"tokens": jnp.asarray(toks)})
    calls = gmm.plain_calls
    tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.as_tensor(toks)},
                        cache_len=CACHE_LEN)
    assert gmm.plain_calls == calls + 3 * tcfg.num_layers
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert _rel(tl.numpy(), jl) < TOL["float32"]
    for key in ("k", "v"):
        assert _rel(tc[key].numpy(), jc[key]) < TOL["float32"]
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    V = tcfg.vocab_size
    tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
    for _ in range(4):
        assert np.array_equal(tl[:, :V].argmax(-1).numpy(), tok)
        jl, jc = decode(jparams, jc, jnp.asarray(tok[:, None]))
        tl, tc = TM.decode_step(tparams, tcfg, tc,
                                torch.tensor(tok[:, None]))
        assert _rel(tl.numpy(), jl) < TOL["float32"]
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
        tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
    assert np.array_equal(tl[:, :V].argmax(-1).numpy(), tok)


LENGTHS, NEW = (9, 16, 5, 12), (4, 3, 5, 4)


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
def test_engine_matches_reference_engine_f32(capacity_factor, monkeypatch):
    """A left-padded wave of mixed lengths: the pads route and take
    capacity as in the reference (at capacity 1.0 prefill drops some
    assignments), and the greedy tokens are identical."""
    jcfg, tcfg = _cfgs("float32", capacity_factor)
    _, _, jparams, tparams = _models("float32")
    drops = []

    def counted(p, cfg, x):
        drops.append(_port_drops(p, cfg, x))
        return TMoE.moe_ffn(p, cfg, x)

    monkeypatch.setattr(TM, "moe_ffn", counted)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tcfg.vocab_size, size=n).astype(np.int32)
               for n in LENGTHS]
    ref_eng = ReferenceEngine(jcfg, jparams, max_batch=4, max_seq=CACHE_LEN,
                              clock=ReferenceClock())
    eng = ServingEngine(tcfg, tparams, device="cpu", max_batch=4,
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
    assert len(seen) == max(NEW)
    assert len(drops) == tcfg.num_layers * max(NEW)
    prefill_drops = sum(drops[:tcfg.num_layers])
    assert (prefill_drops > 0) == (capacity_factor is not None)
    # no near tie: the identical tokens are not luck
    for logits in seen:
        top2 = logits.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > 2 * TOL["float32"] * float(logits.abs().max())
    assert eng.pending() == 0
