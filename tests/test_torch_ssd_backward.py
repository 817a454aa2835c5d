"""The backward pass of the port's SSD scan against the JAX package, on the
CPU, where the wrappers run their plain versions.

- ``ssd_bwd_plain`` against ``jax.vjp`` of the reference model's
  ``models/ssm.py::ssd_chunked``, with cotangents on y and on the final
  state (or on y alone): f32 and bf16 x / B / C, G = 1 and G < H, one
  chunk, several, and L below the chunk.
- The strong decay (dt 0.1, A -16; dt 0.05, A -8; chunk 256): the
  reference's ``ddt`` and ``dA`` are not finite there (its
  ``jnp.where(causal, exp(seg), 0)`` meets exp's overflow above the
  diagonal, and the where's zero cotangent times inf is NaN), while the
  port's are finite and match ``torch.autograd.grad`` through
  ``ssd_plain``, which selects on the triangle before the exp.
- ``ssd`` under grad goes through the ``SSD`` autograd function and
  counts ``ssd_bwd.plain_calls``; the forward's per-chunk states are the
  scan's states; ``ssd_bwd`` refuses cotangents that do not fit.

Inputs are made with numpy from a seed and handed to both sides.
Tolerance: the largest absolute difference over the largest absolute
reference value of each gradient, 1e-5 in f32 (only the order of sums
differs; dA at the strong decay 1e-4, ``STRONG_DA_TOL``) and 1e-2 with
bf16 x, B and C (each side rounds dx, dB and dC to bf16 once, and a sum
in another order can move a rounding by 2^-8 of an element; tighter than
the forward's 4e-2).  The random cases draw dt from the model's init
range with |A| <= 4, where the reference's gradient is finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssd import (SSD, _bwd_variant, bwd_scratch_floats,
                                     ssd, ssd_bwd, ssd_bwd_plain, ssd_plain)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: dA at the strong decay, against autograd through the plain forward in
#: f32: a sum over 512 positions of terms of both signs as large as
#: |A| dt Q (measured 5.1e-5)
STRONG_DA_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(B, L, H, P, G, N, dtype, dt_A=None, seed=0):
    """numpy arrays: x, dt, A, Bm, Cm, the cotangents dy and dstate."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    if dt_A is None:
        # dt log-uniform in the model's init range [0.001, 0.1], |A| <= 4:
        # a chunk's decay stays below exp's overflow (~88) at chunk 64, so
        # the reference's gradient is finite
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1),
                                (B, L, H))).astype(np.float32)
        A = -rng.uniform(1.0, 4.0, H).astype(np.float32)
    else:
        dt = np.full((B, L, H), dt_A[0], np.float32)
        A = np.full((H,), dt_A[1], np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dstate = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy, dstate


def _reference_vjp(arrays, dy, dstate, chunk, dtype):
    jdt = DTYPES[dtype][0]
    x, dt, A, Bm, Cm = arrays
    primals = (jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
               jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt))
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk), *primals)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp((jnp.asarray(dy), jnp.asarray(dstate)))]


def _port(arrays, dtype):
    tdt = DTYPES[dtype][1]
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    return x.to(tdt), dt, A, Bm.to(tdt), Cm.to(tdt)


# (B, L, H, P, G, N, chunk)
CASES = {
    "one_chunk": (1, 64, 2, 8, 1, 4, 64),
    "chunks_groups": (2, 128, 4, 16, 2, 8, 32),
    "chunks_one_group": (1, 96, 4, 16, 1, 16, 32),
    "below_chunk": (2, 40, 4, 16, 1, 16, 256),
}


@pytest.mark.parametrize("final", [True, False],
                         ids=["dy_and_dstate", "dy_only"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_bwd_plain_matches_reference_vjp(dtype, case, final):
    B, L, H, P, G, N, chunk = CASES[case]
    arrays, dy, dstate = _inputs(B, L, H, P, G, N, dtype)
    if not final:
        dstate = np.zeros_like(dstate)
    want = _reference_vjp(arrays, dy, dstate, chunk, dtype)
    assert all(np.isfinite(w).all() for w in want)
    x, dt, A, Bm, Cm = _port(arrays, dtype)
    _, _, states = ssd_plain(x, dt, A, Bm, Cm, chunk, return_states=True)
    got = ssd_bwd_plain(x, dt, A, Bm, Cm, states, torch.from_numpy(dy),
                        torch.from_numpy(dstate) if final else None, chunk)
    for g, w, name, t in zip(got, want, NAMES, (x, dt, A, Bm, Cm)):
        assert g.dtype == t.dtype and tuple(g.shape) == w.shape, name
        assert _rel(g.float(), w) < TOL[dtype], (name, _rel(g.float(), w))


@pytest.mark.parametrize("dt_A", [(0.1, -16.0), (0.05, -8.0)],
                         ids=["dt0.1_A-16", "dt0.05_A-8"])
def test_strong_decay_reference_gradient_overflows_port_is_finite(dt_A):
    B, L, H, P, G, N, chunk = 1, 512, 4, 8, 1, 16, 256
    arrays, dy, dstate = _inputs(B, L, H, P, G, N, "float32", dt_A=dt_A)
    x, dt, A, Bm, Cm = _port(arrays, "float32")
    # the reference's forward is finite, its ddt and dA are not
    y_ref, _ = ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk)
    assert np.isfinite(np.asarray(y_ref)).all()
    ref = _reference_vjp(arrays, dy, dstate, chunk, "float32")
    assert not np.isfinite(ref[1]).all() and not np.isfinite(ref[2]).all()
    # the port's, against autograd through the plain forward
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, state, states = ssd_plain(*leaves, chunk, return_states=True)
    want = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum()
        + (state * torch.from_numpy(dstate)).sum(), leaves)
    got = ssd_bwd_plain(x, dt, A, Bm, Cm, states.detach(),
                        torch.from_numpy(dy), torch.from_numpy(dstate), chunk)
    for g, w, name in zip(got, want, NAMES):
        assert torch.isfinite(g).all(), name
        tol = STRONG_DA_TOL if name == "dA" else TOL["float32"]
        assert _rel(g, w) < tol, (name, _rel(g, w))
    # where the reference is finite (dx, dB, dC), the two agree
    for i in (0, 3, 4):
        assert _rel(got[i], ref[i]) < TOL["float32"], NAMES[i]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_bwd_plain_matches_autograd_f64(case):
    """In f64 the explicit backward is autograd's through ``ssd_plain``
    to the last bits (1e-10)."""
    B, L, H, P, G, N, chunk = CASES[case]
    arrays, dy, dstate = _inputs(B, L, H, P, G, N, "float32", seed=4)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    y, state, states = ssd_plain(*leaves, chunk, return_states=True)
    dy, dstate = torch.from_numpy(dy).double(), \
        torch.from_numpy(dstate).double()
    want = torch.autograd.grad((y * dy).sum() + (state * dstate).sum(),
                               leaves)
    got = ssd_bwd_plain(*(t.detach() for t in leaves), states.detach(), dy,
                        dstate, chunk)
    for g, w, name in zip(got, want, NAMES):
        assert g.dtype == torch.float64
        assert _rel(g, w) < 1e-10, (name, _rel(g, w))


def test_forward_states_are_the_scans_states():
    """``return_states``: chunk c's incoming state is the final state of
    the scan over the first c chunks; the first is zeros."""
    B, L, H, P, G, N, chunk = 2, 128, 4, 16, 2, 8, 32
    arrays, _, _ = _inputs(B, L, H, P, G, N, "float32", seed=2)
    x, dt, A, Bm, Cm = _port(arrays, "float32")
    y, final, states = ssd_plain(x, dt, A, Bm, Cm, chunk, return_states=True)
    assert states.shape == (B, L // chunk, H, P, N)
    assert torch.equal(states[:, 0], torch.zeros_like(states[:, 0]))
    for c in range(1, L // chunk):
        n = c * chunk
        _, want = ssd_plain(x[:, :n], dt[:, :n], A, Bm[:, :n], Cm[:, :n],
                            chunk)
        torch.testing.assert_close(states[:, c], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(y, ssd_plain(x, dt, A, Bm, Cm, chunk)[0])


def test_ssd_under_grad_takes_the_autograd_function():
    arrays, dy, dstate = _inputs(2, 64, 4, 16, 2, 8, "float32", seed=3)
    x, dt, A, Bm, Cm = _port(arrays, "float32")
    x.requires_grad_()
    A.requires_grad_()
    before = (ssd.plain_calls, ssd_bwd.plain_calls, ssd_bwd.launches)
    y, state = ssd(x, dt, A, Bm, Cm, chunk=32)
    assert "SSD" in type(y.grad_fn).__name__
    (y * torch.from_numpy(dy)).sum().backward()   # the final state unused
    assert (ssd.plain_calls - before[0], ssd_bwd.plain_calls - before[1],
            ssd_bwd.launches - before[2]) == (1, 1, 0)
    assert dt.grad is None and Bm.grad is None
    want = ssd_bwd_plain(x.detach(), dt, A.detach(), Bm, Cm,
                         ssd_plain(x.detach(), dt, A.detach(), Bm, Cm, 32,
                                   return_states=True)[2],
                         torch.from_numpy(dy), None, 32)
    assert torch.equal(x.grad, want[0]) and torch.equal(A.grad, want[2])
    with torch.no_grad():
        again = ssd(x, dt, A, Bm, Cm, chunk=32)
    assert again[0].grad_fn is None and torch.equal(again[0], y.detach())


def test_ssd_function_matches_autograd_through_plain():
    """``SSD.apply`` in f32 with both outputs used, against autograd
    through the plain forward (1e-5)."""
    arrays, dy, dstate = _inputs(1, 96, 4, 16, 2, 8, "float32", seed=5)
    dy, dstate = torch.from_numpy(dy), torch.from_numpy(dstate)
    grads = []
    for fn in (lambda *a: SSD.apply(*a, 32), lambda *a: ssd_plain(*a, 32)):
        leaves = [torch.from_numpy(a).clone().requires_grad_()
                  for a in arrays]
        y, state = fn(*leaves)
        grads.append(torch.autograd.grad(
            (y * dy).sum() + (state * dstate).sum(), leaves))
    for g, w, name in zip(*grads, NAMES):
        assert _rel(g, w) < TOL["float32"], (name, _rel(g, w))


@pytest.mark.parametrize("case", ["dy_shape", "states_shape",
                                  "dstate_shape"])
def test_ssd_bwd_refuses_cotangents_that_do_not_fit(case):
    arrays, dy, dstate = _inputs(1, 64, 4, 16, 1, 8, "float32")
    x, dt, A, Bm, Cm = _port(arrays, "float32")
    states = torch.zeros((1, 2, 4, 16, 8))
    dy, dstate = torch.from_numpy(dy), torch.from_numpy(dstate)
    if case == "dy_shape":
        dy = dy[:, :32]
    elif case == "states_shape":
        states = states[:, :1]
    else:
        dstate = dstate[..., :4]
    with pytest.raises(ValueError, match="ssd_bwd"):
        ssd_bwd(x, dt, A, Bm, Cm, states, dy, dstate, chunk=32)


@pytest.mark.parametrize("dtype,P,N,chunk,strides,ptrs,want", [
    (torch.bfloat16, 64, 128, 256, (), (), "tc"),      # mamba2-1.3b
    (torch.bfloat16, 64, 64, 256, (), (), "tc"),       # zamba2-2.7b
    (torch.bfloat16, 16, 8, 32, (), (), "tc"),
    (torch.float32, 64, 128, 256, (), (), "fma"),
    (torch.bfloat16, 12, 128, 256, (), (), "fma"),     # P not 8k
    (torch.bfloat16, 64, 4, 16, (), (), "fma"),        # N not 8k
    (torch.bfloat16, 64, 128, 512, (), (), "fma"),     # chunk > 256
    (torch.bfloat16, 64, 128, 256, (8, 8, 4), (), "fma"),
    (torch.bfloat16, 64, 128, 256, (), (0, 16, 8), "fma")])
def test_ssd_bwd_variant_rule(dtype, P, N, chunk, strides, ptrs, want):
    """bf16 with P and N multiples of 8, a chunk of at most 256 and
    16-byte rows of x, B and C takes the tensor-core backward; the rest
    the FMA kernel."""
    assert _bwd_variant(dtype, P, N, chunk, strides, ptrs) == want


@pytest.mark.parametrize("Bsz,L,H,P,N,Q", [
    (4, 1024, 64, 64, 128, 256), (4, 1024, 80, 64, 64, 256),
    (2, 200, 4, 64, 128, 100), (1, 40, 3, 8, 8, 40), (3, 96, 5, 16, 24, 32)])
def test_ssd_bwd_scratch_floats(Bsz, L, H, P, N, Q):
    """The tensor-core backward's scratch: bf16 hi + lo planes of dy and
    of the chunk boundaries' states and cotangents, then f32 U, inner,
    dcum and W, each part starting 16 bytes in (as the C side lays them
    out)."""
    nc = L // Q
    X, Y = Bsz * nc * H * P * N, Bsz * L * H * P
    bf16_parts = [Y, Y, X, X, X, X]          # elements of 2 bytes
    f32_parts = [X, Bsz * nc * H, Bsz * L * H, Bsz * L * H]
    offset = 0
    for n in bf16_parts:
        assert offset % 16 == 0
        offset += 2 * n
    for n in f32_parts:
        assert offset % 16 == 0
        offset += 4 * n
        offset = -(-offset // 16) * 16
    got = bwd_scratch_floats(Bsz, L, H, P, N, Q)
    assert 4 * got == offset


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_cpu_calls_count_neither_variant(dtype):
    """On the CPU both dtypes take the plain backward: ``plain_calls``
    moves, no launch counter does."""
    arrays, dy, _ = _inputs(1, 64, 4, 16, 1, 8, "float32", seed=7)
    x, dt, A, Bm, Cm = _port(arrays, "float32")
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    states = ssd_plain(x, dt, A, Bm, Cm, 32, return_states=True)[2]
    counters = ("plain_calls", "launches", "tc_launches", "fma_launches")
    before = [getattr(ssd_bwd, c) for c in counters]
    ssd_bwd(x, dt, A, Bm, Cm, states, torch.from_numpy(dy), None, 32)
    after = [getattr(ssd_bwd, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 0]
