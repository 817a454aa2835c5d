"""The port's Mamba2 slice against the JAX package, on the CPU: the SSD
kernel's plain version, the ``ssm`` model and the serving engine at
mamba2-1.3b's smoke config.

Inputs are made with numpy from a seed and handed to both sides; the
model comparisons hand both sides the reference's parameters
(``params_from_reference``).  Tolerances:

- SSD, against the Pallas kernel in interpret mode, ``ref.ssd_ref`` (the
  sequential recurrence) and the reference model's ``ssd_chunked``:
  2e-4 in f32 and 4e-2 with bf16 x, B and C, rtol and atol
  (``tests/test_kernels.py``'s: the prefix sums and products run in
  another order, and the chunked form differs from the recurrence by
  rounding).
- Model logits, conv tails and SSD states, as the largest absolute
  difference over the largest absolute reference value: 1e-4 in f32 (only
  the order of sums differs) and 5e-2 in bf16 (bf16 rounds at other
  places in the two frameworks).
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
from repro.kernels.ssd import ssd as pallas_ssd
from repro.models import model as JM
from repro.models.ssm import ssd_chunked
from repro.monitoring.metrics import SimClock as ReferenceClock
from repro.serving.engine import Request as ReferenceRequest
from repro.serving.engine import ServingEngine as ReferenceEngine
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels.ssd import _variant, ssd, ssd_plain
from repro_torch.models import model as TM
from repro_torch.monitoring.metrics import SimClock
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "mamba2-1.3b"
SSD_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}

# (B, L, H, P, G, N, chunk, decay): tests/test_kernels.py's sweep, then one
# partial chunk (L < chunk), G = 2 over three chunks, and the strong decay
# (A = -16, dt = 0.1: dA = -1.6 per step, exp of the upper triangle
# overflows)
SSD_CASES = [
    (1, 64, 2, 8, 1, 4, 16, "random"),
    (2, 128, 4, 16, 2, 8, 32, "random"),
    (1, 256, 8, 32, 1, 16, 64, "random"),
    (2, 40, 4, 16, 1, 16, 256, "random"),
    (2, 96, 8, 16, 2, 16, 32, "random"),
    (1, 128, 4, 32, 1, 16, 64, "strong"),
]
SSD_IDS = [f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-G{c[4]}-N{c[5]}-Q{c[6]}-{c[7]}"
           for c in SSD_CASES]


def _ssd_inputs(B, L, H, P, G, N, decay, dtype, seed=0):
    """numpy inputs (f32) for both sides: x, B and C rounded to ``dtype``
    on each side, dt and A in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    if decay == "strong":
        dt = np.full((B, L, H), 0.1, np.float32)
        A = np.full((H,), -16.0, np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(
            np.float32)
        A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    jdt, tdt, _ = SSD_DTYPES[dtype]
    jax_in = (jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
              jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt))
    torch_in = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
                torch.from_numpy(Cm).to(tdt))
    return jax_in, torch_in


def _ssd_oracle(name, jax_in, chunk):
    if name == "pallas":
        return pallas_ssd(*jax_in, chunk=chunk, interpret=True)
    if name == "ref":
        return ref.ssd_ref(*jax_in)
    return ssd_chunked(*jax_in, chunk)


@pytest.mark.parametrize("oracle", ["pallas", "ref", "chunked"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk,decay", SSD_CASES, ids=SSD_IDS)
@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
def test_ssd_plain_matches_reference(dtype, B, L, H, P, G, N, chunk, decay,
                                     oracle):
    jax_in, torch_in = _ssd_inputs(B, L, H, P, G, N, decay, dtype)
    y, state = ssd_plain(*torch_in, chunk=chunk)
    assert y.shape == (B, L, H, P) and y.dtype == torch.float32
    assert state.shape == (B, H, P, N) and state.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want_y, want_state = _ssd_oracle(oracle, jax_in, chunk)
    tol = SSD_DTYPES[dtype][2]
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               rtol=tol, atol=tol)


def test_ssd_wrapper_runs_the_plain_version_on_cpu():
    _, torch_in = _ssd_inputs(2, 64, 4, 16, 2, 8, "random", "float32")
    launches, plain = ssd.launches, ssd.plain_calls
    y, state = ssd(*torch_in, chunk=32)
    assert ssd.launches == launches and ssd.plain_calls == plain + 1
    want_y, want_state = ssd_plain(*torch_in, chunk=32)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


@pytest.mark.parametrize("change,error", [
    (dict(L=48, chunk=32), ValueError),      # 48 % 32: a ragged last chunk
    (dict(P=65), ValueError),                # beyond the kernel's head dim
    (dict(N=129), ValueError),               # beyond the kernel's state dim
    (dict(H=3, G=2), ValueError),            # heads not a multiple of groups
    (dict(bc_dtype=torch.bfloat16), TypeError),  # x and B/C types differ
])
def test_ssd_refuses_what_the_kernel_does_not_take(change, error):
    kw = dict(B=1, L=64, H=4, P=16, G=1, N=8, chunk=32)
    bc_dtype = change.pop("bc_dtype", torch.float32)
    kw.update(change)
    rng = np.random.default_rng(0)
    B, L, H, P, G, N = (kw[k] for k in "BLHPGN")

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    with pytest.raises(error):
        ssd(t(B, L, H, P), t(B, L, H).abs(), -t(H).abs(),
            t(B, L, G, N).to(bc_dtype), t(B, L, G, N).to(bc_dtype),
            chunk=kw["chunk"])


# (dtype, L, Q, P, N, strides, ptrs) -> the kernel a CUDA call takes
SSD_VARIANTS = [
    (torch.bfloat16, 1024, 256, 64, 128, (), (), "tc"),   # mamba2-1.3b
    (torch.bfloat16, 1024, 256, 64, 64, (), (), "tc"),    # zamba2-2.7b
    (torch.bfloat16, 64, 32, 16, 16, (), (), "tc"),       # the smoke configs
    (torch.bfloat16, 200, 100, 64, 128, (), (), "tc"),    # ragged tiles
    (torch.bfloat16, 40, 40, 16, 16, (), (), "tc"),       # one partial chunk
    (torch.bfloat16, 8192, 256, 8, 8, (), (), "tc"),      # many windows
    (torch.float32, 1024, 256, 64, 128, (), (), "fma"),   # f32: 2e-4
    (torch.float32, 64, 32, 16, 16, (), (), "fma"),
    (torch.bfloat16, 64, 16, 8, 4, (), (), "fma"),        # N not 8k
    (torch.bfloat16, 64, 16, 12, 16, (), (), "fma"),      # P not 8k
    (torch.bfloat16, 512, 512, 64, 128, (), (), "fma"),   # chunk past 256
    (torch.bfloat16, 1024, 256, 64, 128, (4096, 64, 4), (), "fma"),
    (torch.bfloat16, 1024, 256, 64, 128, (), (16, 2), "fma"),
    (torch.bfloat16, 1024, 256, 64, 128, (524288, 4096, 64), (256, 512),
     "tc"),
]


@pytest.mark.parametrize("dtype,L,Q,P,N,strides,ptrs,want", SSD_VARIANTS)
def test_ssd_variant_rule(dtype, L, Q, P, N, strides, ptrs, want):
    assert _variant(dtype, L, Q, P, N, strides, ptrs) == want


def test_ssd_cpu_calls_count_neither_variant():
    _, torch_in = _ssd_inputs(1, 64, 2, 16, 1, 16, "random", "bfloat16")
    before = (ssd.launches, ssd.tc_launches, ssd.fma_launches)
    ssd(*torch_in, chunk=32)
    assert (ssd.launches, ssd.tc_launches, ssd.fma_launches) == before


def _split(t, pair=True):
    """t as a bf16 hi + lo pair (or one bf16), each part as f32."""
    hi = t.to(torch.bfloat16).float()
    return (hi, (t - hi).to(torch.bfloat16).float()) if pair else (hi,)


def _ssd_tc_emulated(x, dt, A, Bm, Cm, chunk, single=None):
    """The tensor-core kernel's arithmetic in plain f32 PyTorch: bf16
    operands exactly where it rounds them (S~ = S exp(cum_q - cum_k) dt_k,
    the carried state and x * w, each as a hi + lo pair), f32 sums.
    ``single`` ("scores", "state" or "xw") rounds that operand to one
    bf16 instead of a pair."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    x, dt = x.float(), dt.float()
    Bh = Bm.float().repeat_interleave(H // G, dim=2)
    Ch = Cm.float().repeat_interleave(H // G, dim=2)
    dA = dt * A.float()
    upper = ~torch.ones((Q, Q), dtype=torch.bool).tril()
    state = torch.zeros((Bsz, H, P, N))
    ys = []
    for c in range(L // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq, dq = x[:, sl], Bh[:, sl], Ch[:, sl], dt[:, sl]
        cum = dA[:, sl].cumsum(dim=1)                          # (B, Q, H)
        seg = cum[:, :, None] - cum[:, None]                   # (B, Q, K, H)
        decay = seg.masked_fill(upper[None, :, :, None], float("-inf")).exp()
        s = torch.einsum("bqhn,bkhn->bqkh", Cq, Bq) * decay * dq[:, None]
        y = sum(torch.einsum("bhpn,bqhn->bqhp", part, Cq)
                for part in _split(state, single != "state")) \
            * cum.exp()[..., None]
        y = y + sum(torch.einsum("bqkh,bkhp->bqhp", part, xq)
                    for part in _split(s, single != "scores"))
        tot = cum[:, -1]
        xw = xq * (dq * (tot[:, None] - cum).exp())[..., None]
        state = state * tot.exp()[..., None, None] + sum(
            torch.einsum("bqhp,bqhn->bhpn", part, Bq)
            for part in _split(xw, single != "xw"))
        ys.append(y)
    return torch.cat(ys, dim=1), state


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,decay", [
    (2, 1024, 8, 64, 1, 128, 256, "random"),
    (2, 1024, 8, 64, 1, 128, 256, "strong"),
    (2, 512, 8, 64, 2, 128, 256, "random"),
    (2, 512, 8, 64, 1, 64, 256, "random"),
])
def test_ssd_tc_rounding_points_hold_the_tolerance(B, L, H, P, G, N, chunk,
                                                   decay):
    """The tensor-core kernel's rounding plan against the plain version at
    the bf16 tolerance (4e-2), on the CPU, before it reaches a card."""
    _, torch_in = _ssd_inputs(B, L, H, P, G, N, decay, "bfloat16")
    y, state = _ssd_tc_emulated(*torch_in, chunk)
    want_y, want_state = ssd_plain(*torch_in, chunk=chunk)
    torch.testing.assert_close(y, want_y, rtol=4e-2, atol=4e-2)
    torch.testing.assert_close(state, want_state, rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("single", ["scores", "state", "xw"])
def test_ssd_one_bf16_in_place_of_a_pair_misses_the_tolerance(single):
    """Why the kernel pays for hi + lo pairs: at the first shape above, one
    bf16 for any of the three rounded operands moves some y past 4e-2."""
    _, torch_in = _ssd_inputs(2, 1024, 8, 64, 1, 128, "random", "bfloat16")
    y, _ = _ssd_tc_emulated(*torch_in, 256, single=single)
    want_y, _ = ssd_plain(*torch_in, chunk=256)
    assert ((y - want_y).abs() > 4e-2 + 4e-2 * want_y.abs()).any()


# ----------------------------------------------------------------------
# the model
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


def _flat(tree):
    return {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_config_is_the_reference_config():
    for smoke in (True, False):
        ours = get_config(ARCH, smoke=smoke).resolve(tp=1)
        theirs = reference_config(ARCH, smoke=smoke).resolve(tp=1)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    cfg = get_config(ARCH).resolve(tp=1)
    assert (cfg.num_layers, cfg.d_model, cfg.padded_vocab) == (48, 2048,
                                                                50432)
    assert (cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
            cfg.ssm.d_state, cfg.ssm.chunk_size) == (64, 64, 128, 256)


def test_init_params_has_the_reference_tree(setup):
    dtype, jcfg, tcfg, jparams, _ = setup
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    flat_ref, flat_ours = _flat(jparams), _flat(ours)
    assert set(flat_ours) == set(flat_ref)
    for name, x in flat_ref.items():
        assert tuple(flat_ours[name].shape) == x.shape, name
        assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name
    assert sum(t.numel() for t in flat_ours.values()) == \
        sum(x.size for x in flat_ref.values())
    mixer = ours["layers"]["mixer"]
    s = tcfg.ssm
    dt0 = torch.nn.functional.softplus(mixer["dt_bias"])
    assert s.dt_min * (1 - 1e-4) <= float(dt0.min())
    assert float(dt0.max()) <= s.dt_max * (1 + 1e-4)
    a = mixer["A_log"].exp()
    assert s.a_init_range[0] <= float(a.min())
    assert float(a.max()) <= s.a_init_range[1]
    assert torch.equal(mixer["Dskip"], torch.ones_like(mixer["Dskip"]))
    w = mixer["in_x"].float()
    std = tcfg.d_model ** -0.5
    assert w.abs().max() <= 2 * std * (1 + 1e-2)     # truncated at 2 sigma
    assert 0.7 * std < w.std() < 1.0 * std


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


def _check_cache(tc, jc, tol):
    for k in ("x", "B", "C"):
        assert tuple(tc["conv"][k].shape) == jc["conv"][k].shape, k
        assert tc["conv"][k].dtype == torch.float32
        assert _rel(tc["conv"][k].numpy(), jc["conv"][k]) < tol, k
    assert tuple(tc["ssm"].shape) == jc["ssm"].shape
    assert _rel(tc["ssm"].numpy(), jc["ssm"]) < tol
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("S", [13, 64])    # one partial chunk; two chunks
def test_prefill_and_decode_match_reference(setup, S):
    dtype, jcfg, tcfg, jparams, tparams = setup
    tol = TOL[dtype]
    toks = _tokens(0, 3, S, tcfg.vocab_size)
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    plain = ssd.plain_calls
    tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.as_tensor(toks)})
    assert ssd.plain_calls == plain + tcfg.num_layers
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _rel(tl.numpy(), jl) < tol
    _check_cache(tc, jc, tol)

    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    V = tcfg.vocab_size
    tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
    for _ in range(4):
        jl, jc = decode(jparams, jc, jnp.asarray(tok[:, None]))
        tl, tc = TM.decode_step(tparams, tcfg, tc, torch.tensor(
            tok[:, None]))
        assert _rel(tl.numpy(), jl) < tol
        _check_cache(tc, jc, tol)
        tok = np.asarray(jnp.argmax(jl[:, :V], -1), np.int32)
    assert np.all(tl[:, V:].numpy() == -1e30)


def test_init_cache_matches_reference(f32):
    _, jcfg, tcfg, _, _ = f32
    theirs = JM.init_cache(jcfg, 3, 16)
    ours = TM.init_cache(tcfg, 3, 16, device="cpu")
    flat_ref, flat_ours = _flat(theirs), _flat(ours)
    assert set(flat_ours) == set(flat_ref)
    for name, x in flat_ref.items():
        assert tuple(flat_ours[name].shape) == x.shape, name
        assert str(flat_ours[name].dtype)[6:] == str(x.dtype), name
        assert not flat_ours[name].any(), name


# ----------------------------------------------------------------------
# the serving engine: ragged prompts left-padded to 64 = 2 chunks of 32
LENGTHS, NEW = (20, 64, 37), (4, 3, 4)
MAX_SEQ = 96


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in LENGTHS]


def test_engine_matches_reference_engine_f32(f32):
    dtype, jcfg, tcfg, jparams, tparams = f32
    prompts = _prompts(tcfg.vocab_size)
    ref_eng = ReferenceEngine(jcfg, jparams, max_batch=3, max_seq=MAX_SEQ,
                              clock=ReferenceClock())
    eng = ServingEngine(tcfg, tparams, device="cpu", max_batch=3,
                        max_seq=MAX_SEQ, clock=SimClock())
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


@pytest.mark.parametrize("plen,match", [(40, "chunk"), (2, "conv")])
def test_wave_of_wrong_padded_length_raises(f32, plen, match):
    _, _, tcfg, _, tparams = f32
    eng = ServingEngine(tcfg, tparams, device="cpu", max_batch=3,
                        max_seq=MAX_SEQ, clock=SimClock())
    eng.submit(Request(rid=0, tokens=np.ones(plen, np.int32),
                       max_new_tokens=2))
    with pytest.raises(ValueError, match=match):
        eng.step_wave()
    assert eng.pending() == 1


@pytest.mark.parametrize("plen", [3, 32, 96])
def test_wave_of_chunkable_padded_length_is_served(f32, plen):
    _, _, tcfg, _, tparams = f32
    eng = ServingEngine(tcfg, tparams, device="cpu", max_batch=3,
                        max_seq=MAX_SEQ + 1, clock=SimClock())
    eng.submit(Request(rid=0, tokens=np.ones(plen, np.int32),
                       max_new_tokens=2))
    (done,) = eng.step_wave()
    assert len(done.output) == 2 and eng.pending() == 0
