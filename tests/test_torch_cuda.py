"""The port on the CUDA card: each hand-written kernel against its plain
PyTorch version, and the campaign and the serving path on CUDA against
the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it also runs where those are
not installed (the repository's ``conftest.py`` imports jax; skip it)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 0/1 masks are integer sums, exact; other values 1e-12
relative in f64 and 1e-5 in f32 (shared-memory atomics add in a
run-dependent order); campaign stats 1e-5 relative (the reference's own
contract between backends).  Attention kernels 2e-5 in f32 and 2e-2 in
bf16, the SSD kernel 2e-4 in f32 and 4e-2 with bf16 x, B and C, the
grouped matmul 2e-5 in f32 and 2e-2 in bf16 (tests/test_kernels.py's);
the models' logits at f32 1e-4 relative to their largest value, with
identical greedy tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.campaign import SUMMARY_STATS, run_scenario
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.gmm import gmm, gmm_plain
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
from repro_torch.kernels.ssd import ssd, ssd_plain
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("T,R,B", [(8, 128, 128), (3, 50, 20),
                                   (16, 300, 60), (1, 1, 1),
                                   (256, 1000, 1250), (4, 5000, 10000)])
def test_segment_sum_kernel_matches_plain(cuda, T, R, B, dtype, tol):
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(-3, B + 3, size=(T, R)),
                          dtype=torch.int32, device=cuda)
    v = torch.as_tensor(rng.standard_normal((T, R)), dtype=dtype,
                        device=cuda)
    launches = segment_sum.launches
    got = segment_sum(v, ids, B)
    torch.cuda.synchronize()
    assert segment_sum.launches == launches + 1
    torch.testing.assert_close(got, segment_sum_plain(v, ids, B),
                               rtol=tol, atol=tol)
    mask = (v > 0).to(dtype)
    assert torch.equal(segment_sum(mask, ids, B),
                       segment_sum_plain(mask, ids, B))


def _unaligned(x):
    """A contiguous copy of ``x`` whose base is 8 bytes past a 16-byte
    boundary (the kernel then takes its scalar loads)."""
    flat = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    off = 2 if x.element_size() == 4 else 1
    out = flat[off:off + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 8
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("T,R,B,where", [
    (256, 1000, 1250, "vector loads, the simulation path's shape"),
    (256, 1001, 1250, "scalar loads: R % 4 != 0"),
    (256, 1000, 1251, "odd B: scalar head or tail of the 16-byte stores"),
    (4, 1000, 6145, "bin tiles: B past 48 KB of f64 histogram"),
    (37, 1000, 999, "unaligned base pointers: scalar loads"),
    (3, 8000, 1250, "more than one pass of vector loads a thread")])
def test_segment_sum_load_and_store_paths(cuda, T, R, B, where, dtype,
                                          tol):
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(-3, B + 3, size=(T, R)),
                          dtype=torch.int32, device=cuda)
    v = torch.as_tensor(rng.standard_normal((T, R)), dtype=dtype,
                        device=cuda)
    mask = (v > 0).to(dtype)
    if where.startswith("unaligned"):
        ids, v, mask = _unaligned(ids), _unaligned(v), _unaligned(mask)
    got = segment_sum(v, ids, B)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, segment_sum_plain(v, ids, B),
                               rtol=tol, atol=tol, msg=where)
    assert torch.equal(segment_sum(mask, ids, B),
                       segment_sum_plain(mask, ids, B)), where


def test_segment_sum_rejects_cpu_ids_with_cuda_values(cuda):
    v = torch.zeros((2, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        segment_sum(v, torch.zeros((2, 3), dtype=torch.int32), 4)


@pytest.mark.parametrize("name", ("stale-predictions", "churn",
                                  "cold-start", "drift-fallback"))
def test_campaign_cuda_matches_cpu(cuda, name):
    kw = dict(seeds=(0, 1), n_trials=8, n_requests=150, n_nodes=30,
              n_replicas_per_app=20)
    if name == "drift-fallback":
        # warm-up, retrains, the drift onset and the fallback in the run
        kw.update(arrival_rate=2.0, t_drift=40.0, online_warmup_s=10.0,
                  retrain_every_s=6.0)
    launches = segment_sum.launches
    on_gpu = run_scenario(name, device="cuda", **kw)
    assert (segment_sum.launches > launches) == (name in ("stale-predictions",
                                                          "churn"))
    on_cpu = run_scenario(name, device="cpu", **kw)
    for pol, want in on_cpu.items():
        got = on_gpu[pol]
        for k in SUMMARY_STATS + ("hedged", "fallback"):
            np.testing.assert_allclose(got.per_seed[k], want.per_seed[k],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}/{pol}/{k}")
        assert got.n_hedged == want.n_hedged
        assert got.n_fallback == want.n_fallback
    if name == "drift-fallback":
        assert on_cpu["perf_aware"].n_fallback > 0


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype=dtype, device=device)


def _flash_counts():
    return (flash_attention.launches, flash_attention.tc_launches,
            flash_attention.fma_launches)


def _assert_one_launch(before, variant):
    """One launch more, counted in ``variant``'s counter alone."""
    launches, tc, fma = before
    assert _flash_counts() == (launches + 1, tc + (variant == "tc"),
                               fma + (variant == "fma"))


# bf16 with D a multiple of 16 and G <= 128 takes the tensor-core kernel,
# the rest the FMA kernel.  Beside tests/test_kernels.py's sweep: the
# serving paths' shapes (qwen2-vl-7b at S = 1002, G = 7; qwen3-moe-30b-a3b
# at S = 910, G = 8), D = 256 (at G = 128, one position an item), D = 40
# (no multiple of 16) and G = 160.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 128, 8, 1, 16),
    (2, 100, 4, 2, 32), (1, 777, 28, 4, 128), (1, 130, 4, 2, 256),
    (8, 1002, 28, 4, 128), (8, 910, 32, 4, 128), (2, 333, 8, 4, 256),
    (2, 200, 6, 2, 40), (1, 50, 128, 1, 256), (1, 64, 160, 1, 64)])
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, D, causal, dtype):
    q = _randn((B, S, H, D), dtype, cuda, 0)
    k = _randn((B, S, KV, D), dtype, cuda, 1)
    v = _randn((B, S, KV, D), dtype, cuda, 2)
    before = _flash_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _assert_one_launch(before, "tc" if dtype == torch.bfloat16
                       and D % 16 == 0 and H // KV <= 128 else "fma")
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("offset,variant", [(0, "tc"), (1, "fma")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_takes_fused_qkv_views(cuda, causal, offset, variant):
    """q, k and v as strided views of one (B, S, H + 2 KV, D) tensor, as a
    fused projection gives them: rows 16-byte aligned take the tensor-core
    kernel; the same views one element off the alignment, the FMA kernel."""
    B, S, H, KV, D = 2, 300, 8, 2, 128
    n = B * S * (H + 2 * KV) * D
    flat = _randn((n + offset,), torch.bfloat16, cuda, 7)[offset:]
    qkv = flat.view(B, S, H + 2 * KV, D)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    before = _flash_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _assert_one_launch(before, variant)
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 128, 4, 4, 32), (1, 256, 8, 2, 64), (3, 64, 8, 1, 16),
    (8, 2048, 28, 4, 128), (100, 100, 4, 2, 32), (2, 70, 4, 1, 256)])
def test_decode_kernel_matches_plain(cuda, B, S, H, KV, D, dtype):
    q = _randn((B, 1, H, D), dtype, cuda, 3)
    k = _randn((B, S, KV, D), dtype, cuda, 4)
    v = _randn((B, S, KV, D), dtype, cuda, 5)
    lens = (torch.arange(B) * 37 % S + 1).to(torch.int32).to(cuda)
    lens[0] = S
    launches = decode_attention.launches
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == launches + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               decode_attention_plain(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


def _decode_checked(q, k, v, lens, variant):
    """One decode call: one launch, of ``variant``, within tolerance of the
    plain version; returns the output."""
    before = (decode_attention.launches, decode_attention.mma_launches,
              decode_attention.fma_launches)
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert (decode_attention.launches, decode_attention.mma_launches,
            decode_attention.fma_launches) == (
        before[0] + 1, before[1] + (variant == "mma"),
        before[2] + (variant == "fma"))
    tol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(got.float(),
                               decode_attention_plain(q, k, v, lens).float(),
                               rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma"),
                                           (torch.bfloat16, "mma")])
@pytest.mark.parametrize("S,KV,G,D", [(300, 1, 7, 128), (130, 2, 4, 64),
                                      (2048, 1, 7, 128)])
def test_decode_every_length(cuda, S, KV, G, D, dtype, variant):
    """Every kv_len from 1 to S, one row each, in one call (B = S)."""
    q = _randn((S, 1, KV * G, D), dtype, cuda, 21)
    k = _randn((S, S, KV, D), dtype, cuda, 22)
    v = _randn((S, S, KV, D), dtype, cuda, 23)
    lens = torch.arange(1, S + 1, dtype=torch.int32, device=cuda)
    _decode_checked(q, k, v, lens, variant)


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma"),
                                           (torch.bfloat16, "mma")])
def test_decode_lengths_below_the_split_count(cuda, dtype, variant):
    """One (batch, kv head) pair gets many splits (about two per SM), so
    lengths 1-16 leave most splits empty, and 0 writes zeros."""
    B, S, H, KV, D = 17, 4096, 7, 1, 128
    q = _randn((B, 1, H, D), dtype, cuda, 31)
    k = _randn((B, S, KV, D), dtype, cuda, 32)
    v = _randn((B, S, KV, D), dtype, cuda, 33)
    lens = torch.arange(B, dtype=torch.int32, device=cuda)  # 0 .. 16
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0
    want = decode_attention_plain(q[1:], k[1:], v[1:], lens[1:])
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got[1:].float(), want.float(), rtol=tol,
                               atol=tol)
    _decode_checked(q[1:], k[1:], v[1:], lens[1:], variant)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_zero_length_writes_zeros(cuda, dtype):
    q = _randn((3, 1, 28, 128), dtype, cuda, 41)
    k = _randn((3, 256, 4, 128), dtype, cuda, 42)
    v = _randn((3, 256, 4, 128), dtype, cuda, 43)
    lens = torch.tensor([0, 256, 0], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0 and torch.count_nonzero(got[2]) == 0
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(
        got[1:2].float(),
        decode_attention_plain(q[1:2], k[1:2], v[1:2], lens[1:2]).float(),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_graph_replays_are_bit_identical(cuda, dtype):
    """The last CTA of each (batch, kv head) resets its ticket, so every
    replay of a captured call combines again, in the same order."""
    B, S, H, KV, D = 8, 2048, 28, 4, 128
    q = _randn((B, 1, H, D), dtype, cuda, 51)
    k = _randn((B, S, KV, D), dtype, cuda, 52)
    v = _randn((B, S, KV, D), dtype, cuda, 53)
    lens = torch.tensor([1018, 1, 7, 64, 65, 2048, 500, 999],
                        dtype=torch.int32, device=cuda)
    eager = decode_attention(q, k, v, lens)   # allocates the tickets
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, lens)
    replays = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], eager)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(eager.float(),
                               decode_attention_plain(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


def test_serving_cuda_matches_cpu(cuda):
    cfg = dataclasses.replace(get_config("qwen2-vl-7b", smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 17, 12)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, device=dev, max_batch=3,
                            max_seq=32)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=5))
        before = (flash_attention.launches, decode_attention.launches)
        out[dev] = [r.output for r in eng.step_wave()]
        if dev == "cuda":
            assert flash_attention.launches - before[0] == cfg.num_layers
            assert decode_attention.launches - before[1] == \
                cfg.num_layers * 4
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(got, want)


SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 4e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk,strong", [
    (1, 64, 2, 8, 1, 4, 16, False), (2, 128, 4, 16, 2, 8, 32, False),
    (1, 256, 8, 32, 1, 16, 64, False), (2, 40, 4, 16, 1, 16, 256, False),
    (2, 200, 4, 64, 2, 128, 100, False), (1, 512, 8, 64, 1, 128, 256, True),
    (2, 1024, 4, 64, 1, 128, 256, False),
    (2, 512, 8, 64, 1, 64, 256, False),      # zamba2-2.7b's P and N
    (2, 1024, 64, 64, 1, 128, 256, False)])  # mamba2-1.3b's, batch 2
def test_ssd_kernel_matches_plain(cuda, B, L, H, P, G, N, chunk, strong,
                                  dtype):
    x = _randn((B, L, H, P), dtype, cuda, 6)
    Bm = _randn((B, L, G, N), dtype, cuda, 7)
    Cm = _randn((B, L, G, N), dtype, cuda, 8)
    if strong:    # dA = -1.6 per step: exp of the upper triangle overflows
        dt = torch.full((B, L, H), 0.1, device=cuda)
        A = torch.full((H,), -16.0, device=cuda)
    else:
        dt = torch.nn.functional.softplus(_randn((B, L, H), torch.float32,
                                                 cuda, 9))
        A = -_randn((H,), torch.float32, cuda, 10).exp()
    # the tensor cores take bf16 with P, N multiples of 8 and chunks <= 256
    variant = "tc" if dtype == torch.bfloat16 and P % 8 == 0 \
        and N % 8 == 0 and min(chunk, L) <= 256 else "fma"
    before = (ssd.launches, ssd.tc_launches, ssd.fma_launches)
    y, state = ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(
        (ssd.launches, ssd.tc_launches, ssd.fma_launches), before))
    assert moved == (1, int(variant == "tc"), int(variant == "fma")), \
        f"took {moved} (all, tc, fma) launches, not {variant}"
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want_y, want_state = ssd_plain(x, dt, A, Bm, Cm, chunk)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)


def test_mamba2_bf16_prefill_through_the_kernel(cuda, monkeypatch):
    """mamba2-1.3b's smoke config in bf16 on the card: the prefill through
    the tensor-core kernel against the same prefill with the plain version
    in its place.  Logits within 2e-2 of their largest value (only the
    SSD's sums differ, by ~1e-4 of y, and the bf16 casts after it may
    round either way), identical greedy tokens, SSD states within 4e-2."""
    import repro_torch.models.ssm as ssm_mod
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              dtype="bfloat16").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), device=cuda)
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, 64))
                           .astype(np.int32), device=cuda)
    before = ssd.tc_launches
    got, got_cache = model.prefill(params, cfg, {"tokens": toks},
                                   cache_len=72)
    assert ssd.tc_launches - before == cfg.num_layers
    monkeypatch.setattr(ssm_mod, "ssd", ssd_plain)
    want, want_cache = model.prefill(params, cfg, {"tokens": toks},
                                     cache_len=72)
    V = cfg.vocab_size
    got, want = got[:, :V].float(), want[:, :V].float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 2e-2
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(got_cache["ssm"], want_cache["ssm"],
                               rtol=4e-2, atol=4e-2)


def test_mamba2_serving_cuda_matches_cpu(cuda):
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 64, 40)]              # padded to 2 chunks of 32
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, device=dev, max_batch=3,
                            max_seq=96)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=5))
        before = (ssd.launches, ssd.fma_launches)
        out[dev] = [r.output for r in eng.step_wave()]
        if dev == "cuda":    # f32 stays on the FMA kernel
            assert ssd.launches - before[0] == cfg.num_layers
            assert ssd.fma_launches - before[1] == cfg.num_layers
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(got, want)


GMM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [
    (2, 64, 32, 48), (4, 128, 64, 64), (1, 32, 16, 128),   # the sweep
    (3, 1, 32, 48), (2, 5, 64, 16), (4, 100, 48, 80),      # ragged C
    (8, 16, 2048, 768), (8, 17, 768, 2048), (4, 624, 2048, 768)])
def test_gmm_kernel_matches_plain(cuda, E, C, D, F, dtype):
    # w at the model's scale, D^-1/2, so outputs are O(1): with unit
    # weights at D = 2048 they reach ~45, and two f32 sums of 2048 terms
    # in different orders differ by ~1e-4, past an absolute 2e-5
    x = _randn((E, C, D), dtype, cuda, 11)
    w = (_randn((E, D, F), torch.float32, cuda, 12) * D ** -0.5).to(dtype)
    launches = gmm.launches
    got = gmm(x, w)
    torch.cuda.synchronize()
    assert gmm.launches == launches + 1
    assert got.shape == (E, C, F) and got.dtype == dtype
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(got.float(), gmm_plain(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("E", [1, 128])
@pytest.mark.parametrize("D,F", [(2048, 768), (768, 2048)])
@pytest.mark.parametrize("C", [1, 4, 5, 100, 112, 128, 576, 608, 624, 625])
def test_gmm_wgmma_every_row_count(cuda, C, D, F, E):
    """The bf16 kernel at qwen3-moe-30b-a3b's widths (wi/wg and wo) for
    row counts on both sides of the decode operand swap (C <= 16) and of
    the 128-row tile edge; every call takes the wgmma kernel."""
    x = _randn((E, C, D), torch.bfloat16, cuda, C)
    w = (_randn((E, D, F), torch.float32, cuda, C + 1) * D ** -0.5) \
        .to(torch.bfloat16)
    before = (gmm.launches, gmm.wgmma_launches, gmm.fma_launches)
    got = gmm(x, w)
    torch.cuda.synchronize()
    assert (gmm.launches, gmm.wgmma_launches, gmm.fma_launches) == \
        (before[0] + 1, before[1] + 1, before[2])
    tol = GMM_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), gmm_plain(x, w).float(),
                               rtol=tol, atol=tol)


def test_moe_serving_cuda_matches_cpu(cuda):
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 17, 12)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, device=dev, max_batch=3,
                            max_seq=32)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=5))
        before = (gmm.launches, flash_attention.launches,
                  decode_attention.launches)
        out[dev] = [r.output for r in eng.step_wave()]
        if dev == "cuda":
            assert gmm.launches - before[0] == 3 * cfg.num_layers * 5
            assert flash_attention.launches - before[1] == cfg.num_layers
            assert decode_attention.launches - before[2] == \
                cfg.num_layers * 4
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(got, want)
