"""The port on the CUDA card: each hand-written kernel against its plain
PyTorch version, and the campaign, the serving path and the router on
CUDA against the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it also runs where those are
not installed (the repository's ``conftest.py`` imports jax; skip it)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 0/1 masks are integer sums, exact; other values 1e-12
relative in f64 and 1e-5 in f32 (shared-memory atomics add in a
run-dependent order); campaign stats 1e-5 relative (the reference's own
contract between backends).  Attention kernels 2e-5 in f32 and 2e-2 in
bf16, the SSD kernel 2e-4 in f32 and 4e-2 with bf16 x, B and C (its
backward 2e-4 and 1e-2 of the largest value), the
grouped matmul 2e-5 in f32 and 2e-2 in bf16 (tests/test_kernels.py's);
the models' logits at f32 1e-4 relative to their largest value, with
identical greedy tokens.  Predictor training: the segment sum at the
trees' (2d, n) f64 and MIC's (m, n) f32 shapes as above; a tree fit on
the card equal to the CPU's by column, bin and base, leaves 1e-6; the
correlation battery 1e-5 (pearson, spearman, kendall) and 1e-4
(distance, mic); the Adam fits' CUDA-graph replay equal to the eager
loop bit for bit; a lifecycle on the card against the CPU by
``repro_torch.testing.assert_lifecycles_equal`` (RMSEs 1e-4).  The
simulation core's CUDA-graph replay equal to the same steps run eagerly
on every summary stat (the same kernels on the same inputs), and to the
CPU within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.campaign import (RESILIENCE_STATS, SUMMARY_STATS,
                                       run_scenario)
from repro_torch.core.telemetry import TraceConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.gmm import gmm, gmm_plain
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
from repro_torch.kernels.ssd import ssd, ssd_plain
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.testing import seed_lora

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


#: the scenarios whose passes rebuild counts with the segment sum
RECOUNTS = ("stale-predictions", "churn", "staleness-storm",
            "correlated-outage")
TELEMETRY = ("decisions", "scale_ups", "scale_downs", "wakeups",
             "active_final", "routed_inactive")


@pytest.mark.parametrize("name", ("stale-predictions", "churn",
                                  "cold-start", "drift-fallback",
                                  "spot-preemption", "scale-to-zero-idle",
                                  "gray-failure", "staleness-storm",
                                  "correlated-outage", "retry-storm",
                                  "breaker-saves-retry-storm",
                                  "traced-baseline"))
def test_campaign_cuda_matches_cpu(cuda, name):
    kw = dict(seeds=(0, 1), n_trials=8, n_requests=150, n_nodes=30,
              n_replicas_per_app=20)
    if name == "traced-baseline":
        name = "baseline"
        kw["trace"] = TraceConfig(sample_every=4)
    client = name in ("correlated-outage", "retry-storm",
                      "breaker-saves-retry-storm")
    if client:
        # the client plane at its registry shape and depth (its
        # calibration): the storm forms, and on seed 8 a breaker leaves
        # round_robin no routable replica (a fail-fast attempt)
        kw = dict(seeds=(0, 8))
    if name == "drift-fallback":
        # warm-up, retrains, the drift onset and the fallback in the run
        kw.update(arrival_rate=2.0, t_drift=40.0, online_warmup_s=10.0,
                  retrain_every_s=6.0)
    launches = segment_sum.launches
    on_gpu = run_scenario(name, device="cuda", **kw)
    assert (segment_sum.launches > launches) == (name in RECOUNTS)
    on_cpu = run_scenario(name, device="cpu", **kw)
    for pol, want in on_cpu.items():
        got = on_gpu[pol]
        for k in SUMMARY_STATS + RESILIENCE_STATS + ("hedged", "fallback"):
            np.testing.assert_allclose(got.per_seed[k], want.per_seed[k],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}/{pol}/{k}")
        for k in ("timeouts", "trips"):
            np.testing.assert_array_equal(got.per_seed[k], want.per_seed[k],
                                          err_msg=f"{name}/{pol}/{k}")
        assert (got.trace is None) == (want.trace is None)
        if want.trace is not None:
            a, b = got.trace["data"], want.trace["data"]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                       rtol=1e-5, atol=1e-7)
        assert got.n_hedged == want.n_hedged
        assert got.n_fallback == want.n_fallback
        assert (got.telemetry is None) == (want.telemetry is None)
        if want.telemetry is not None:
            for k in TELEMETRY:
                np.testing.assert_array_equal(got.telemetry[k],
                                              want.telemetry[k],
                                              err_msg=f"{name}/{pol}/{k}")
            assert got.telemetry["routed_inactive"] == 0
    if name == "drift-fallback":
        assert on_cpu["perf_aware"].n_fallback > 0
    if client:
        # the parity covers retries, and with breakers trips and
        # fail-fast attempts
        assert on_cpu["perf_aware"].per_seed["timeouts"].sum() > 0
        if name != "retry-storm":
            for k in ("trips", "fail_fast_rate"):
                assert sum(r.per_seed[k].sum() for r in on_cpu.values()) > 0


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


# ----------------------------------------------------------------------
# the prediction plane: features, every zoo family and one plane call
@pytest.mark.parametrize("w", [1, 2, 24, 25])
def test_extract_features_cuda_matches_cpu(cuda, w):
    from repro_torch.core.features import extract_features
    X = torch.as_tensor(np.random.default_rng(w).standard_normal(
        (128, 4, w)), dtype=torch.float32)
    got = extract_features(X.to(cuda)).cpu()
    want = extract_features(X)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("fam", ["lr", "svm", "xgb", "rf", "fnn", "rnn",
                                 "lstm", "gru", "cnn"])
def test_stacked_apply_cuda_matches_cpu(cuda, fam):
    from repro_torch.core import zoo
    from repro_torch.testing import random_params
    B, k, w = 128, 4, 25
    params = zoo.tree_map(lambda *xs: torch.stack(xs), *[
        random_params(fam, k, seed=s) for s in range(B)])
    rng = np.random.default_rng(1)
    shape = (B, k, w) if fam in zoo.SEQ_MODELS else (B, k * 12)
    X = torch.as_tensor(rng.uniform(-0.2, 1.2, shape), dtype=torch.float32)
    apply = zoo.stacked_apply(fam)
    got = apply(zoo.tree_map(lambda p: p.to(cuda), params), X.to(cuda))
    want = apply(params, X)
    rtol = 1e-4 if fam in zoo.SEQ_MODELS else 1e-5
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=rtol,
                               atol=1e-6, err_msg=fam)


def test_prediction_plane_cuda_matches_cpu(cuda):
    from repro_torch.core import zoo
    from repro_torch.core.prediction_plane import PredictionPlane
    from repro_torch.testing import make_store, random_artifact
    store = make_store(seed=2, n_metrics=12)
    planes = [PredictionPlane(device=d) for d in (cuda, "cpu")]
    for i in range(40):
        art = random_artifact(f"app{i % 5}", f"n{i}", zoo.ALL_MODELS[i % 9],
                              store.names[i % 8:i % 8 + 4], seed=i)
        for p in planes:
            p.register(art, store)
    got, want = (p.predict_all() for p in planes)
    assert planes[0].dispatches == planes[1].dispatches == 9
    assert set(got) == set(want)
    for key, rec in want.items():
        fam = zoo.ALL_MODELS[int(key[1][1:]) % 9]
        rtol = 1e-4 if fam in zoo.SEQ_MODELS else 1e-5
        np.testing.assert_allclose(got[key].rtt_pred, rec.rtt_pred,
                                   rtol=rtol, err_msg=str(key))
        assert got[key].t_state == rec.t_state


# ----------------------------------------------------------------------
# the router: one scenario per plane it mirrors, on the card against the
# CPU at deepseek-67b's smoke config in f32 (repro_torch.testing)
@pytest.fixture(scope="module")
def router_model():
    cfg = dataclasses.replace(get_config("deepseek-67b", smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return cfg, params


@pytest.mark.parametrize("name", ["hedged-perf-aware", "capacity-admission",
                                  "resilience-breaker"])
def test_router_cuda_matches_cpu(cuda, router_model, name):
    from repro_torch.testing import assert_router_runs_equal, router_scenario
    cfg, params = router_model
    got = router_scenario(name, cfg, params, cuda)
    want = router_scenario(name, cfg, params, "cpu")
    assert_router_runs_equal(got, want)
    assert len(got["routed"]) > 0


def test_router_policy_state_on_the_card(cuda):
    from repro_torch.serving.router import MorpheusRouter

    class _Stub:
        def __init__(self, node, pending):
            self.node, self.max_batch, self._pending = node, 2, pending
            self.device = cuda

        def pending(self):
            return self._pending

        def submit(self, req):
            self._pending += 1
    router = MorpheusRouter([_Stub(f"n{i}", i % 3) for i in range(4)],
                            policy="round_robin")
    assert router.device.type == "cuda"
    picks = [router.route(object()) for _ in range(6)]
    assert picks == [0, 1, 2, 3, 0, 1]
    assert router.policy._cursor.device.type == "cuda"
    assert router.cluster_state().busy_until.device.type == "cuda"


# ----------------------------------------------------------------------
# predictor training: the segment sum's new call sites, fits, correlations
@pytest.mark.parametrize("T,R,B", [(240, 10_000, 32), (240, 8_001, 32),
                                   (24, 133, 32)])
def test_segment_sum_at_the_tree_shapes(cuda, T, R, B):
    """The split search's launch: d count rows (0/1, exact) over d
    residual rows (f64), ids the binned columns."""
    rng = np.random.default_rng(R)
    d = T // 2
    ids = torch.as_tensor(np.tile(rng.integers(0, B, (d, R)), (2, 1)),
                          dtype=torch.int32, device=cuda)
    mask = (rng.random(R) < 0.6).astype(float)
    res = rng.standard_normal(R).astype(np.float32).astype(float)
    v = torch.as_tensor(np.concatenate([np.tile(mask, (d, 1)),
                                        np.tile(mask * res, (d, 1))]),
                        device=cuda)
    got = segment_sum(v, ids, B)
    want = segment_sum_plain(v, ids, B)
    assert torch.equal(got[:d], want[:d])
    torch.testing.assert_close(got[d:], want[d:], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n,B", [(294, 600, 9), (294, 137, 64),
                                   (5, 10_000, 144), (39, 61, 4)])
def test_segment_sum_at_the_mic_shapes(cuda, m, n, B):
    rng = np.random.default_rng(m + n)
    ids = torch.as_tensor(rng.integers(0, B, (m, n)), dtype=torch.int32,
                          device=cuda)
    ones = torch.ones((m, n), device=cuda)
    assert torch.equal(segment_sum(ones, ids, B),
                       segment_sum_plain(ones, ids, B))


def _tree_data(n=2000, d=24):
    from repro_torch.testing import zoo_data
    X, y, _, _ = zoo_data(n, d, 2, 2, seed=5)
    X[:, d - 1] = 1.0 - X[:, 0]            # a mirrored column: a tie
    X[:, d - 2] = X[:, 1]                  # a duplicated one
    return X, y


@pytest.mark.parametrize("fam", ["xgb", "rf"])
def test_tree_fit_cuda_matches_cpu(cuda, fam):
    from repro_torch.core import zoo
    from repro_torch.testing import assert_fits_equal
    X, y = _tree_data()
    before = segment_sum.launches
    on_card = zoo.FIT_CLASSES[fam](device=cuda).fit(X, y)
    n_rounds = on_card.n_rounds
    assert segment_sum.launches - before == 3 * n_rounds
    on_cpu = zoo.FIT_CLASSES[fam](device="cpu").fit(X, y)
    assert_fits_equal(on_card, on_cpu, rtol=1e-6)
    torch.testing.assert_close(on_card.predict(X).cpu(), on_cpu.predict(X),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fam", ["svm", "fnn", "rnn", "gru", "lstm", "cnn"])
def test_descent_fits_cuda_match_cpu(cuda, fam):
    from repro_torch.core import zoo
    from repro_torch.testing import FIT_RTOL, assert_fits_equal, zoo_data
    X, y, Xs, ys = zoo_data(300, 24, 4, 10, seed=6)
    seq = fam in zoo.SEQ_MODELS
    kw = {} if fam == "svm" else {"epochs": 30}
    a = zoo.FIT_CLASSES[fam](device=cuda, **kw).fit(Xs if seq else X,
                                                    ys if seq else y)
    b = zoo.FIT_CLASSES[fam](device="cpu", **kw).fit(Xs if seq else X,
                                                     ys if seq else y)
    assert_fits_equal(a, b, FIT_RTOL[fam])


@pytest.mark.parametrize("fam", ["fnn", "rnn", "gru", "lstm", "cnn"])
def test_adam_graph_replays_the_eager_steps(cuda, fam, monkeypatch):
    """The card captures one Adam step in a CUDA graph after three eager
    ones and replays it: the same kernels, so the same bits as the eager
    loop."""
    from repro_torch.core import zoo
    from repro_torch.testing import zoo_data
    X, y, Xs, ys = zoo_data(500, 24, 4, 10, seed=9)
    seq = fam in zoo.SEQ_MODELS
    data = (Xs, ys) if seq else (X, y)
    graphed = zoo.FIT_CLASSES[fam](epochs=40, device=cuda).fit(*data)
    monkeypatch.setattr(zoo, "_GRAPH_WARMUP", 10 ** 9)
    eager = zoo.FIT_CLASSES[fam](epochs=40, device=cuda).fit(*data)
    for a, b in zip(zoo.tree_leaves(graphed.params),
                    zoo.tree_leaves(eager.params)):
        assert torch.equal(a, b)


def test_correlate_all_cuda_matches_cpu(cuda):
    from repro_torch.core.correlate import _mic_grids, correlate_all
    rng = np.random.default_rng(8)
    n = 1500
    x = rng.standard_normal(n)
    X = np.stack([2 * x + 0.1 * rng.standard_normal(n), x ** 2,
                  rng.standard_normal(n), (rng.random(n) < 0.3) * 1.0,
                  np.round(x), np.full(n, 0.3)])
    before = segment_sum.launches
    got = correlate_all(X, x, device=cuda)
    assert segment_sum.launches - before == len(_mic_grids(n))
    want = correlate_all(X, x, device="cpu")
    for name, tol in (("pearson", 1e-5), ("spearman", 1e-5),
                      ("kendall", 0.0), ("distance", 1e-4), ("mic", 1e-4)):
        np.testing.assert_allclose(got[name], want[name], rtol=tol,
                                   atol=1e-6, err_msg=name)


def test_select_model_raises_when_the_kernel_fails(cuda, monkeypatch):
    """A failed launch propagates: the candidate is not skipped."""
    from repro_torch.core import selection, zoo

    def failed(*args, **kw):
        raise RuntimeError("segment_sum kernel launch failed: CUDA error 700")
    monkeypatch.setattr(zoo, "segment_sum", failed)
    X, y = _tree_data(n=200)
    before = selection.select_model.skipped
    with pytest.raises(RuntimeError, match="launch failed"):
        selection.select_model(["lr", "xgb"], X, None, y, 10.0, device=cuda)
    assert selection.select_model.skipped == before


def test_lifecycle_cuda_matches_cpu(cuda):
    from repro_torch.testing import assert_lifecycles_equal, run_lifecycle
    before = segment_sum.launches
    on_card = run_lifecycle(0, cuda, n_noise_metrics=24, n_cycles=3)
    assert segment_sum.launches > before
    on_cpu = run_lifecycle(0, "cpu", n_noise_metrics=24, n_cycles=3)
    assert assert_lifecycles_equal(on_card, on_cpu) >= 1


# ----------------------------------------------------------------------
# the rest of the catalogue: Zamba2's shared block (head dim 160), MLA's
# prefill (D 96 / Dv 64, v a view of the expanded latent) and the
# encoder-decoder's cross-attention (Sq != Skv, not causal), in prefill
# and in decode
def _catalogue_inputs(form, dtype, cuda):
    if form == "zamba2":
        return (*(_randn((2, 300, 4, 160), dtype, cuda, i)
                  for i in range(3)), True)
    if form == "mla":
        kv = _randn((2, 200, 6, 128), dtype, cuda, 2)
        return (_randn((2, 200, 6, 96), dtype, cuda, 0),
                _randn((2, 200, 6, 96), dtype, cuda, 1), kv[..., 64:], True)
    Skv = {"cross": 8, "cross_long": 300}[form]
    return (_randn((2, 130, 4, 64), dtype, cuda, 0),
            *(_randn((2, Skv, 4, 64), dtype, cuda, i) for i in (1, 2)),
            False)


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma"),
                                           (torch.bfloat16, "tc")])
@pytest.mark.parametrize("form", ["zamba2", "mla", "cross", "cross_long"])
def test_flash_kernel_at_the_catalogue_forms(cuda, form, dtype, variant):
    q, k, v, causal = _catalogue_inputs(form, dtype, cuda)
    before = _flash_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _assert_one_launch(before, variant)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma"),
                                           (torch.bfloat16, "mma")])
@pytest.mark.parametrize("B,S,H,D,lens", [
    (8, 2048, 32, 160, [1040] * 8),           # Zamba2's shared block
    (3, 700, 32, 160, [1, 64, 700]),
    (8, 8, 16, 64, [8] * 8)])                 # cross over 8 frames
def test_decode_kernel_at_the_catalogue_forms(cuda, B, S, H, D, lens, dtype,
                                              variant):
    q = _randn((B, 1, H, D), dtype, cuda, 3)
    k = _randn((B, S, H, D), dtype, cuda, 4)
    v = _randn((B, S, H, D), dtype, cuda, 5)
    _decode_checked(q, k, v, torch.tensor(lens, dtype=torch.int32,
                                          device=cuda), variant)


@pytest.mark.parametrize("arch,lengths,max_seq", [
    ("zamba2-2.7b", (9, 64, 40), 96),         # padded to 2 chunks of 32
    ("minicpm3-4b", (9, 17, 12), 32),
    ("seamless-m4t-medium", (9, 17, 12), 32)])
def test_catalogue_serving_cuda_matches_cpu(cuda, arch, lengths, max_seq):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    if cfg.family == "hybrid":
        seed_lora(params, cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    L = cfg.num_layers
    G = L // cfg.hybrid.shared_every if cfg.hybrid else 0
    # (flash, decode a step, ssd): Zamba2's shared block once a group, MLA
    # (its decode is PyTorch ops), seamless's encoder, self and cross
    want_launches = {"hybrid": (G, G, L), "dense": (L, 0, 0),
                     "encdec": (cfg.enc_layers + 2 * L, 2 * L, 0)}[cfg.family]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, device=dev, max_batch=3,
                            max_seq=max_seq)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=5))
        before = (flash_attention.launches, decode_attention.launches,
                  ssd.launches)
        out[dev] = [r.output for r in eng.step_wave()]
        if dev == "cuda":
            flash, decode, scans = want_launches
            assert (flash_attention.launches - before[0],
                    decode_attention.launches - before[1],
                    ssd.launches - before[2]) == (flash, 4 * decode, scans)
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(got, want)


def test_encdec_prefill_with_frames_cuda_matches_cpu(cuda):
    """The encoder on seeded normal frames (an engine wave's are zeros):
    prefill and 4 decode steps, logits within 1e-4 of the largest."""
    cfg = dataclasses.replace(get_config("seamless-m4t-medium", smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 20))
    frames = rng.standard_normal((3, 8, cfg.d_model)).astype(np.float32)
    seqs = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "enc_frames": torch.as_tensor(frames, device=dev)}
        logits, cache = model.prefill(p, cfg, batch, cache_len=28)
        seq = [logits.cpu()]
        for _ in range(4):
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(p, cfg, cache, tok)
            seq.append(logits.cpu())
        seqs[dev] = seq
    V = cfg.vocab_size
    for a, b in zip(seqs["cuda"], seqs["cpu"]):
        assert float((a[:, :V] - b[:, :V]).abs().max()
                     / b[:, :V].abs().max()) < 1e-4
        assert torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1))


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_int8_decode_cuda_matches_cpu(cuda):
    """Decode from an int8 ``init_cache``: logits within 1e-4 of the
    largest, identical tokens, int8 rows within one step (a projection's
    last-bit drift can flip a rounding tie), scales within 1e-5."""
    cfg = dataclasses.replace(get_config("qwen2-vl-7b", smoke=True),
                              dtype="float32",
                              kv_cache_dtype="int8").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tok0 = torch.tensor([[3], [100], [511]])
    runs = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        cache = model.init_cache(cfg, 3, 16, device=dev)
        tok, seq = tok0.to(dev), []
        for _ in range(6):
            logits, cache = model.decode_step(p, cfg, cache, tok)
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            seq.append(logits.cpu())
        runs[dev] = seq, {k: v.cpu() for k, v in cache.items()}
    V = cfg.vocab_size
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        assert float((a[:, :V] - b[:, :V]).abs().max()
                     / b[:, :V].abs().max()) < 1e-4
        assert torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1))
    got, want = runs["cuda"][1], runs["cpu"][1]
    for k in ("k", "v"):
        assert got[k].dtype == torch.int8
        assert int((got[k].int() - want[k].int()).abs().max()) <= 1
    for k in ("k_scale", "v_scale"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)


# ----------------------------------------------------------------------
# LM training: the backward kernels, the forward's log-sum-exp, a train
# step on the card against the CPU.  Backward tolerances: the largest
# absolute difference over the largest absolute plain value, 2e-5 in f32
# and 2e-2 in bf16 (the forward kernels' own; P and dS round to bf16 in
# the bf16 kernel, and dq sums with atomics in a run-dependent order).

def _bwd_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,Dv,causal", [
    (2, 32, 32, 4, 2, 16, 16, True), (2, 32, 32, 4, 2, 12, 12, True),
    (2, 32, 32, 4, 4, 16, 8, True), (2, 32, 8, 4, 4, 16, 16, False),
    (4, 1024, 1024, 32, 4, 128, 128, True),
    (2, 300, 300, 40, 40, 96, 64, True), (4, 1024, 8, 16, 16, 64, 64, False),
    (1, 65, 65, 2, 1, 160, 160, True), (1, 33, 40, 2, 2, 256, 256, False),
    # the tensor-core kernel's edges: lengths off its 64-row tiles, G 1,
    # 3, 7, 8, 64 and 65, D 64 / 96 / 128 / 160 / 256
    (1, 100, 100, 8, 1, 64, 64, True), (2, 130, 130, 8, 8, 96, 96, True),
    (1, 77, 77, 16, 2, 128, 128, True), (1, 70, 150, 4, 4, 160, 160, False),
    (2, 90, 90, 16, 2, 256, 256, True), (1, 50, 200, 8, 1, 128, 64, False),
    (1, 90, 90, 21, 3, 128, 128, True), (2, 70, 70, 6, 2, 64, 64, True),
    (1, 40, 40, 64, 1, 64, 64, True), (1, 20, 20, 65, 1, 16, 16, True)])
def test_flash_backward_kernel_matches_plain(cuda, B, Sq, Skv, H, KV, D, Dv,
                                             causal, dtype):
    from repro_torch.kernels.flash_attention import (
        _flash_forward, flash_attention_bwd, flash_attention_bwd_plain)
    q = _randn((B, Sq, H, D), dtype, cuda, 0)
    k = _randn((B, Skv, KV, D), dtype, cuda, 1)
    v = _randn((B, Skv, KV, Dv), dtype, cuda, 2)
    do = _randn((B, Sq, H, Dv), dtype, cuda, 3)
    o, lse = _flash_forward(q, k, v, causal, True)
    _, want_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    assert _bwd_err(lse, want_lse) < 1e-5
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _bwd_err(g, w) < ATTN_TOL[dtype]


#: C at every edge of the backward's tiles (64-deep stages of dw, dx's
#: 160-row chunks and 320-row tiles)
GMM_BWD_C = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 320, 624)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [
    (4, 20, 48, 32), (3, 1, 32, 48), (2, 130, 256, 144), (8, 4, 16, 16),
    (128, 320, 2048, 768), (128, 320, 768, 2048)]
    + [(3, C, 48, 144) for C in GMM_BWD_C]      # D, F not the tiles'
    + [(3, C, 144, 48) for C in GMM_BWD_C]
    + [(4, C, 2048, 768) for C in (1, 65, 129, 624)]   # both training
    + [(4, C, 768, 2048) for C in (1, 65, 129, 624)])  # orientations
def test_gmm_backward_kernel_matches_plain(cuda, E, C, D, F, dtype):
    """dx and dw within GMM_TOL of the largest plain value, finite; bf16
    on the wgmma kernels, f32 on the FMA kernel; dy as a non-contiguous
    view gives the same outputs."""
    from repro_torch.kernels.gmm import gmm_bwd, gmm_bwd_plain
    x = _randn((E, C, D), dtype, cuda, 0)
    w = _randn((E, D, F), dtype, cuda, 1)
    dy = _randn((E, C, F), dtype, cuda, 2)
    variant = "wgmma" if dtype == torch.bfloat16 else "fma"
    before = (gmm_bwd.launches, getattr(gmm_bwd, f"{variant}_launches"))
    got = gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert (gmm_bwd.launches, getattr(gmm_bwd, f"{variant}_launches")) \
        == (before[0] + 1, before[1] + 1)
    for g, w_ in zip(got, gmm_bwd_plain(x, w, dy)):
        assert g.dtype == dtype and g.shape == w_.shape
        assert bool(torch.isfinite(g).all())
        assert _bwd_err(g, w_) < GMM_TOL[dtype]
    dy_view = torch.zeros((E, C, 2 * F), dtype=dtype, device=cuda)[..., ::2]
    dy_view.copy_(dy)
    assert not dy_view.is_contiguous()
    for g, g_view in zip(got, gmm_bwd(x, w, dy_view)):
        assert torch.equal(g, g_view)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "qwen3-moe-30b-a3b",
                                  "minicpm3-4b", "seamless-m4t-medium",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_train_step_cuda_matches_cpu(cuda, arch):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.testing import (MOE_UPSTREAM_TOL, TRAIN_GRAD_TOL,
                                     train_step_parity)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32").resolve(tp=1)
    d = train_step_parity(cfg, TrainConfig(), cuda)
    assert d["loss"] < TRAIN_GRAD_TOL
    assert d["grad_norm"] < (MOE_UPSTREAM_TOL if cfg.moe is not None
                             else TRAIN_GRAD_TOL)


#: the SSD backward kernel against its plain version, relative to the
#: largest value: 2e-4 in f32 (the forward's: the prefix sums run in
#: another order, dA sums B L terms of both signs) and 1e-2 with bf16 x,
#: B and C (both sides take the same bf16 inputs in f32 and round dx, dB
#: and dC once)
SSD_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk,strong,final", [
    (1, 64, 2, 8, 1, 4, 16, False, True), (2, 128, 4, 16, 2, 8, 32, False,
                                           False),
    (2, 40, 4, 16, 1, 16, 256, False, True),
    (2, 200, 4, 64, 2, 128, 100, False, True),
    (1, 512, 8, 64, 1, 128, 256, True, True),      # strong decay
    (2, 512, 8, 64, 1, 64, 256, False, False),     # zamba2-2.7b's P and N
    (4, 1024, 64, 64, 1, 128, 256, False, False),  # mamba2-1.3b training
    # the tensor-core kernels' edges: several chunks with and without a
    # final-state cotangent, G > 1 with 8-head blocks that do not divide
    # a group's heads, N 64 and 128, chunks off the 64-position tiles
    (2, 768, 6, 64, 2, 64, 256, False, True),
    (2, 768, 12, 64, 2, 128, 256, False, False),
    (1, 384, 10, 32, 1, 64, 128, False, True),
    (2, 288, 5, 64, 1, 128, 96, False, False),
    (1, 600, 6, 64, 3, 128, 200, True, True)])
def test_ssd_backward_kernel_matches_plain(cuda, B, L, H, P, G, N, chunk,
                                           strong, final, dtype):
    """``ssd_bwd`` on the card against ``ssd_bwd_plain`` on the same
    inputs and the forward's per-chunk states (each variant's states
    output against the plain version's), finite at the strong decay."""
    from repro_torch.kernels.ssd import _ssd_forward, ssd_bwd, ssd_bwd_plain
    x = _randn((B, L, H, P), dtype, cuda, 11)
    Bm = _randn((B, L, G, N), dtype, cuda, 12)
    Cm = _randn((B, L, G, N), dtype, cuda, 13)
    if strong:
        dt = torch.full((B, L, H), 0.1, device=cuda)
        A = torch.full((H,), -16.0, device=cuda)
    else:
        dt = torch.nn.functional.softplus(_randn((B, L, H), torch.float32,
                                                 cuda, 14))
        A = -_randn((H,), torch.float32, cuda, 15).exp()
    dy = _randn((B, L, H, P), torch.float32, cuda, 16)
    dstate = _randn((B, H, P, N), torch.float32, cuda, 17) if final \
        else None
    Q = min(chunk, L)
    _, _, states = _ssd_forward(x, dt, A, Bm, Cm, chunk, True)
    _, _, want_states = ssd_plain(x, dt, A, Bm, Cm, chunk,
                                  return_states=True)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(states, want_states, rtol=tol, atol=tol)
    assert states.shape == (B, L // Q, H, P, N)
    before = ssd_bwd.launches
    got = ssd_bwd(x, dt, A, Bm, Cm, states, dy, dstate, chunk)
    torch.cuda.synchronize()
    assert ssd_bwd.launches == before + 1
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, states, dy, dstate, chunk)
    for g, w, t in zip(got, want, (x, dt, A, Bm, Cm)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.isfinite(g).all()
        assert _bwd_err(g, w) < SSD_BWD_TOL[dtype]


def test_f32_logits_product_backward_on_card(cuda):
    """The bf16 LM-head product under grad on the card
    (``models.common._MatmulF32``: ``mm(out_dtype=f32)`` forward, the f32
    cotangent split into three bf16 parts in the backward) against the
    exact product in f64 of the same bf16 operands and f32 cotangent:
    the logits to 1e-5 of their largest, each gradient within one bf16
    ulp of the exact one rounded to bf16, at most 1% of elements off."""
    from repro_torch.models.common import matmul_f32
    g = torch.Generator().manual_seed(0)
    h = torch.randn((2, 64, 256), generator=g).bfloat16()
    table = (0.05 * torch.randn((1000, 256), generator=g)).bfloat16()
    gy = 1e-3 * torch.randn((2, 64, 1000), generator=g)
    hc = h.to(cuda).requires_grad_()
    tc = table.to(cuda).requires_grad_()
    y = matmul_f32(hc, tc.t())
    assert y.dtype == torch.float32 and "MatmulF32" in type(
        y.grad_fn).__name__
    y.backward(gy.to(cuda))
    h64, t64, g64 = h.double(), table.double(), gy.double()
    want_y = h64 @ t64.t()
    err = (y.detach().cpu().double() - want_y).abs().max()
    assert err < 1e-5 * want_y.abs().max()
    for got, exact in ((hc.grad, g64 @ t64),
                       (tc.grad, torch.einsum("bsv,bsd->vd", g64, h64))):
        got = got.cpu().double()
        want = exact.bfloat16().double()
        assert bool(((got - want).abs()
                     <= want.abs() * 2.0 ** -7 + 1e-30).all())
        assert float((got != want).double().mean()) <= 0.01


# ----------------------------------------------------------------------
# the simulation core's compiled mode: the loop captured in CUDA graphs
#: T = 8, J = 150: two blocks of 64 steps and a tail graph of 22
GRAPH_SHAPE = dict(n_trials=8, n_requests=150, n_nodes=30,
                   n_replicas_per_app=20)
GRAPH_CELLS = [(p, None) for p in ("round_robin", "random", "least_conn",
                                   "perf_aware", "oracle")] \
    + [("perf_aware", 0.5), ("oracle", 0.5)]


def _same_summary(got, want, label):
    """Every stat equal, NaN where NaN (timings and labels aside)."""
    assert set(got) == set(want), label
    for k, v in want.items():
        if k in ("loop_s", "capture_s", "backend"):
            continue
        if isinstance(v, dict):
            _same_summary(got[k], v, f"{label}/{k}")
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=f"{label}/{k}")


def _graph_cluster(seed=0, hedge=None):
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.simulator import _build_cluster
    kw = dict(GRAPH_SHAPE)
    if hedge is not None:
        # a loaded cluster, so that the hedge fires
        kw.update(hedge_factor=hedge, arrival_rate=8.0)
    return _build_cluster(get_scenario("baseline").compile(seed=seed, **kw))


@pytest.mark.parametrize("policy,hedge", GRAPH_CELLS)
def test_graph_matches_eager_on_baseline(cuda, policy, hedge):
    from repro_torch.core import simcore
    simcore.clear_cache()
    cluster = _graph_cluster(hedge=hedge)
    eager = simcore.run_compiled(cluster, policy, device="cuda", eager=True)
    graph = simcore.run_compiled(cluster, policy, device="cuda")
    assert eager["backend"] == "eager" and graph["backend"] == "graph"
    assert graph["capture_s"] > 0 and graph["host_syncs"] == 0
    _same_summary(graph, eager, f"{policy}/{hedge}")
    if hedge is not None:
        assert graph["n_hedged"] > 0
    on_cpu = simcore.run_compiled(cluster, policy, device="cpu")
    for k in SUMMARY_STATS:
        np.testing.assert_allclose(graph[k], on_cpu[k], rtol=1e-5,
                                   atol=1e-7, err_msg=f"{policy}/{k}")


def test_graph_capture_failure_raises(cuda, monkeypatch):
    """A host read inside the step makes the capture fail: the run
    raises, it does not step eagerly instead."""
    from repro_torch.core import simcore
    simcore.clear_cache()
    cluster = _graph_cluster(seed=1)
    lognormal = simcore._lognormal

    def reads_the_host(inter, log_rbar, z):
        float(inter.sum())
        return lognormal(inter, log_rbar, z)

    monkeypatch.setattr(simcore, "_lognormal", reads_the_host)
    with pytest.raises(RuntimeError):
        simcore.run_compiled(cluster, "least_conn", device="cuda")
    monkeypatch.undo()
    torch.cuda.synchronize()
    # the card is fine afterwards, and the entry captures anew
    got = simcore.run_compiled(cluster, "least_conn", device="cuda")
    assert got["backend"] == "graph" and got["capture_s"] > 0
    _same_summary(got, simcore.run_compiled(cluster, "least_conn",
                                            device="cuda", eager=True),
                  "after the failed capture")


def test_graph_cache_hit_replays_without_a_capture(cuda):
    """Two closures share one cached graph, each copying its own inputs
    into it before it replays."""
    from repro_torch.core import simcore
    simcore.clear_cache()
    a = _graph_cluster(seed=2)
    # other noise on the same placement: the inputs' shapes (the mates
    # table's padding among them) key the cache
    rng = np.random.default_rng(3)
    b = dataclasses.replace(a, z_rtt=rng.standard_normal(a.z_rtt.shape),
                            z_pred=rng.standard_normal(a.z_pred.shape))
    run_a = simcore.prepare_compiled(a, "perf_aware", device="cuda")
    first = run_a()
    assert first["capture_s"] > 0
    stats = simcore.cache_stats()
    run_b = simcore.prepare_compiled(b, "perf_aware", device="cuda")
    assert simcore.cache_stats()["hits"] == stats["hits"] + 1
    assert simcore.cache_stats()["misses"] == stats["misses"]
    got_b = run_b()
    assert got_b["capture_s"] == 0 and got_b["backend"] == "graph"
    _same_summary(got_b, simcore.run_compiled(b, "perf_aware",
                                              device="cuda", eager=True),
                  "second closure")
    again = run_a()
    assert again["capture_s"] == 0
    _same_summary(again, first, "first closure again")
    assert not np.array_equal(first["mean_rtt"], got_b["mean_rtt"])


def test_fleet_generator_advances_and_repeats(cuda):
    """Each replay advances the registered generator: the graph's
    responses equal the same steps run eagerly (a stale offset would
    repeat one block's noise), and one seed repeats."""
    from repro_torch.core import simcore
    kw = dict(n_requests=300, n_nodes=40, n_replicas_per_app=30, n_apps=3,
              n_trials=4, seed=0, arrival_rate=2000.0, device="cuda")
    for policy in ("perf_aware", "random"):
        g1, r1 = simcore._fleet(policy=policy, noise_seed=11, **kw)
        g2, r2 = simcore._fleet(policy=policy, noise_seed=11, **kw)
        e, re = simcore._fleet(policy=policy, noise_seed=11, eager=True,
                               **kw)
        other, _ = simcore._fleet(policy=policy, noise_seed=12, **kw)
        assert g1["backend"] == "graph" and e["backend"] == "eager"
        assert np.array_equal(r1, r2) and np.array_equal(r1, re), policy
        assert other["mean_rtt"] != g1["mean_rtt"]
    _, st = simcore.fleet_throughput(n_requests=300, n_nodes=40,
                                     n_replicas_per_app=30, n_apps=3,
                                     n_trials=4)
    assert st["backend"] == "graph" and np.isfinite(st["mean_rtt"])


# ----------------------------------------------------------------------
# the multi-device layer on a one-rank NCCL group
@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    """A one-rank NCCL process group, joined through a file store."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card")
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen3-moe-30b-a3b"])
def test_sharded_step_one_rank_nccl_matches_plain(cuda, nccl_rank, arch,
                                                  dtype):
    """The FSDP step with two microbatches on a (1, 1) data x model mesh
    runs its collectives (all-gathers, reduce-scatters, all-reduces) on
    NCCL beside the single-device step, two steps, on the single-device
    step's gradients (``testing.sharded_step_parity``; two backward
    passes on the card differ in their last bits): every microbatch and
    the params it ran on equal bit for bit, the loss equal bit for bit
    where the params are, master, m and v within STATE_TOL of each
    leaf's largest value and the params within one ulp of theirs."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import (STATE_TOL, sharded_step_parity,
                                     train_batch)
    from repro_torch.training.train_step import make_train_state
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=dtype).resolve(tp=1)
    tcfg = TrainConfig(microbatches=2, learning_rate=1e-3, warmup_steps=1)
    rules = make_rules(make_mesh((1, 1), ("data", "model")), mode="train",
                       fsdp=True)
    state = make_train_state(cfg, tcfg, torch.Generator(cuda).manual_seed(0),
                             cuda)
    batch = {k: v.to(cuda) for k, v in train_batch(cfg, 4, 64).items()}
    steps = sharded_step_parity(cfg, tcfg, rules, state, batch)
    assert steps[0]["params_equal"], steps
    for d in steps:
        assert d["batch_equal"], d
        assert d["loss_equal"] or not d["params_equal"], d
        for kind in ("master", "m", "v"):
            assert d["drift"][kind] <= STATE_TOL, (kind, d)
        assert d["drift"]["params"] <= 1.0, d


def test_compressed_allreduce_one_rank_on_card(cuda, nccl_rank):
    """The int8 all-reduce over a one-rank ``pod`` axis on the card: the
    mean within one scale of the input, the residual within one scale,
    both equal to the CPU's quantiser bit for bit."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (dequantize,
                                               make_compressed_allreduce,
                                               quantize)
    fn = make_compressed_allreduce(make_mesh((1, 1), ("pod", "data")),
                                   axis_name="pod")
    g = {"a": torch.randn(64, 96, generator=torch.Generator().manual_seed(1)),
         "b": torch.randn(300, generator=torch.Generator().manual_seed(2))
         * 1e-3}
    r = {k: torch.full_like(v, 1e-4) for k, v in g.items()}
    mean, res = fn({k: v.to(cuda) for k, v in g.items()},
                   {k: v.to(cuda) for k, v in r.items()})
    for k in g:
        x = g[k] + r[k]
        q, scale = quantize(x)
        assert float((mean[k].cpu() - x).abs().max()) <= float(scale) + 1e-6
        assert float(res[k].abs().max()) <= float(scale) + 1e-6
        assert torch.equal(mean[k].cpu(), dequantize(q, scale))
        assert torch.equal(res[k].cpu(), x - dequantize(q, scale))


# ----------------------------------------------------------------------
# tensor parallelism over the model axis: the kernels at a TP rank's
# local shapes (small sizes), and the TP path on a one-rank NCCL group
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,tp", [("qwen3-moe-30b-a3b", 4),
                                     ("mistral-large-123b", 8)])
def test_flash_at_tp_local_heads(cuda, arch, tp, dtype):
    """Flash attention forward and backward at a TP rank's heads (8 of
    32 over one kv head; 12 of 96 over one of 8) and full head dim, at a
    short sequence: against the plain versions."""
    from repro_torch.kernels.flash_attention import (
        _flash_forward, flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.models.attention import local_kv_heads
    cfg = get_config(arch).resolve(tp=tp)
    H = cfg.padded_heads // tp
    kv = local_kv_heads(H, cfg.padded_kv, tp, tp - 1)
    KV, D = kv.stop - kv.start, cfg.head_dim
    q = _randn((2, 96, H, D), dtype, cuda, 0)
    k = _randn((2, 96, KV, D), dtype, cuda, 1)
    v = _randn((2, 96, KV, D), dtype, cuda, 2)
    do = _randn((2, 96, H, D), dtype, cuda, 3)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True).float(),
        flash_attention_plain(q, k, v, True).float(), rtol=tol, atol=tol)
    o, lse = _flash_forward(q, k, v, True, True)
    for g, w in zip(flash_attention_bwd(q, k, v, o, do, lse, True),
                    flash_attention_bwd_plain(q, k, v, o, do, lse, True)):
        assert g.shape == w.shape and _bwd_err(g, w) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_at_tp_local_experts(cuda, dtype):
    """``gmm`` forward and backward at qwen3-moe-30b-a3b's tp 4 rank: 32
    of 128 experts, D 2048, F 768, a few rows each."""
    from repro_torch.kernels.gmm import gmm_bwd, gmm_bwd_plain
    x = _randn((32, 40, 2048), dtype, cuda, 0)
    w = (_randn((32, 2048, 768), torch.float32, cuda, 1)
         * 2048 ** -0.5).to(dtype)
    dy = _randn((32, 40, 768), dtype, cuda, 2)
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(gmm(x, w).float(), gmm_plain(x, w).float(),
                               rtol=tol, atol=tol)
    for g, w_ in zip(gmm_bwd(x, w, dy), gmm_bwd_plain(x, w, dy)):
        assert g.shape == w_.shape and _bwd_err(g, w_) < tol


@pytest.mark.parametrize("dt_form", ["own", "sliced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,tp", [("mamba2-1.3b", 4),
                                     ("zamba2-2.7b", 8)])
def test_ssd_at_tp_local_heads(cuda, arch, tp, dtype, dt_form):
    """The SSD kernel forward and backward at a TP rank's Mamba2 heads
    (16 of mamba2-1.3b's 64, N 128; 10 of zamba2-2.7b's 80, N 64; one
    group, chunk 256) at a shorter sequence, against the plain versions;
    bf16 on the tensor-core kernels.  ``sliced``: dt is the rank's heads
    cut from every head's dt, a strided view the kernels read in
    place."""
    from repro_torch.kernels.ssd import _ssd_forward, ssd_bwd, ssd_bwd_plain
    cfg = get_config(arch)
    s = cfg.ssm
    Hw = s.n_heads(cfg.d_model)
    B, L, H, P, N, Q = 2, 512, Hw // tp, s.head_dim, s.d_state, s.chunk_size
    x = _randn((B, L, H, P), dtype, cuda, 21)
    Bm = _randn((B, L, 1, N), dtype, cuda, 22)
    Cm = _randn((B, L, 1, N), dtype, cuda, 23)
    dt_all = torch.nn.functional.softplus(_randn((B, L, Hw), torch.float32,
                                                 cuda, 24))
    dt = dt_all[..., :H].contiguous() if dt_form == "own" \
        else dt_all[..., (tp - 1) * H:]
    A = -_randn((H,), torch.float32, cuda, 25).exp()
    dy = _randn((B, L, H, P), torch.float32, cuda, 26)
    variant = "tc" if dtype == torch.bfloat16 else "fma"
    before = (getattr(ssd, f"{variant}_launches"),
              getattr(ssd_bwd, f"{variant}_launches"))
    y, state, states = _ssd_forward(x, dt, A, Bm, Cm, Q, True)
    got = ssd_bwd(x, dt, A, Bm, Cm, states, dy, None, Q)
    torch.cuda.synchronize()
    assert (getattr(ssd, f"{variant}_launches") - before[0],
            getattr(ssd_bwd, f"{variant}_launches") - before[1]) == (1, 1)
    want_y, want_state = ssd_plain(x, dt, A, Bm, Cm, Q)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, states, dy, None, Q)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _bwd_err(g, w) < SSD_BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "minicpm3-4b"])
def test_flash_at_tp_local_latent_and_shared_heads(cuda, arch, dtype):
    """Flash attention forward and backward at a tp 4 rank's heads:
    Zamba2's shared block (8 of 32 heads, MHA, D 160) and MLA's (10 of
    40, D 96 / Dv 64 with v a view of the expanded latent), at a short
    sequence, against the plain versions; bf16 on the tensor-core
    kernels."""
    from repro_torch.kernels.flash_attention import (
        _flash_forward, flash_attention_bwd, flash_attention_bwd_plain)
    tp, B, S = 4, 2, 300
    cfg = get_config(arch).resolve(tp=tp)
    if cfg.mla is not None:
        m = cfg.mla
        H, D, Dv = cfg.padded_heads // tp, m.qk_nope_head_dim \
            + m.qk_rope_head_dim, m.v_head_dim
        q, k = (_randn((B, S, H, D), dtype, cuda, i) for i in range(2))
        v = _randn((B, S, H, m.qk_nope_head_dim + Dv), dtype, cuda,
                   2)[..., m.qk_nope_head_dim:]
    else:
        H, D = cfg.hybrid.shared_num_heads // tp, cfg.head_dim
        Dv = D
        q, k, v = (_randn((B, S, H, D), dtype, cuda, i) for i in range(3))
    do = _randn((B, S, H, Dv), dtype, cuda, 3)
    variant = "tc" if dtype == torch.bfloat16 else "fma"
    before = _flash_counts()
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_one_launch(before, variant)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(),
                               flash_attention_plain(q, k, v, True).float(),
                               rtol=tol, atol=tol)
    o, lse = _flash_forward(q, k, v, True, True)
    for g, w in zip(flash_attention_bwd(q, k, v, o, do, lse, True),
                    flash_attention_bwd_plain(q, k, v, o, do, lse, True)):
        assert g.shape == w.shape and _bwd_err(g, w) < tol


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma"),
                                           (torch.bfloat16, "mma")])
def test_decode_lse_at_zamba2_tp_block(cuda, dtype, variant):
    """The decode kernel with ``lse`` on a Zamba2 tp 4 rank's block of a
    2048-row cache (8 rows of the batch, 512 positions, 32 heads of 160,
    MHA): full, partial and empty blocks, against the plain version."""
    B, n, H, D = 8, 512, 32, 160
    q = _randn((B, 1, H, D), dtype, cuda, 31)
    k = _randn((B, n, H, D), dtype, cuda, 32)
    v = _randn((B, n, H, D), dtype, cuda, 33)
    lens = torch.tensor([n, n // 3, 0, 1, 17, 255, 256, 511],
                        dtype=torch.int32, device=cuda)
    before = (decode_attention.launches,
              getattr(decode_attention, f"{variant}_launches"))
    out, lse = decode_attention(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    assert (decode_attention.launches - before[0],
            getattr(decode_attention, f"{variant}_launches") - before[1]) \
        == (1, 1)
    p_out, p_lse = decode_attention_plain(q, k, v, lens, return_lse=True)
    live = lens > 0
    assert torch.isinf(lse[~live]).all() and (lse[~live] < 0).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(lse[live], p_lse[live], rtol=tol, atol=tol)
    torch.testing.assert_close(out[live].float(), p_out[live].float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["deepseek-67b", "qwen2-vl-7b",
                                  "qwen3-moe-30b-a3b", "minicpm3-4b",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_tp_path_one_rank_nccl_matches_plain(cuda, nccl_rank, arch):
    """``value_and_grad`` on the tensor-parallel path (a (1, 1) data x
    model mesh on NCCL: the sequence-split residual and the vocab-parallel
    loss over one-rank groups; MLA's local heads, the Mamba2 layers'
    channels and heads and the gated norm's sum for minicpm3-4b to
    zamba2-2.7b; the encoder's frames block, its output's gather and the
    cross-attention for seamless-m4t-medium, its frames nonzero) against
    the single-device one on the card at the f32 smoke config
    (``testing.tp_grad_parity``, Zamba2's LoRA seeded nonzero:
    TRAIN_GRAD_TOL, a MoE arch's upstream leaves MOE_UPSTREAM_TOL)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import TRAIN_GRAD_TOL, tp_grad_parity
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              remat="full").resolve(tp=1)
    rules = make_rules(make_mesh((1, 1), ("data", "model")), mode="train",
                       fsdp=True)
    d = tp_grad_parity(cfg, rules, cuda)
    assert d["loss"] < TRAIN_GRAD_TOL, d


# ----------------------------------------------------------------------
# serving under tensor parallelism: the decode kernel's log-sum-exp and
# the sequence-parallel cache's blocks, and the TP wave on one rank
def _lse_inputs(dtype, cuda, B=6, S=512, H=8, KV=2, D=64):
    q = _randn((B, 1, H, D), dtype, cuda, 71)
    k = _randn((B, S, KV, D), dtype, cuda, 72)
    v = _randn((B, S, KV, D), dtype, cuda, 73)
    lens = torch.tensor([0, 1, 63, 64, 300, S][:B], dtype=torch.int32,
                        device=cuda)
    return q, k, v, lens


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma"),
                                           (torch.bfloat16, "mma"),
                                           (torch.bfloat16, "fma")])
def test_decode_lse_matches_plain(cuda, dtype, variant):
    """``return_lse=True`` on both kernels: one launch of ``variant``,
    ``out`` equal bit for bit to the call without the flag, and ``lse``
    within the dtype's tolerance of the plain version's (-inf where
    ``kv_len == 0``)."""
    q, k, v, lens = _lse_inputs(dtype, cuda)
    if variant == "fma":        # a head dim the mma kernel does not take
        q, k, v = (t[..., :60] for t in (q, k, v))
    before = (decode_attention.launches, decode_attention.mma_launches,
              decode_attention.fma_launches)
    out, lse = decode_attention(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    assert (decode_attention.launches, decode_attention.mma_launches,
            decode_attention.fma_launches) == (
        before[0] + 1, before[1] + (variant == "mma"),
        before[2] + (variant == "fma"))
    assert torch.equal(out, decode_attention(q, k, v, lens))
    p_out, p_lse = decode_attention_plain(q, k, v, lens, return_lse=True)
    assert lse.shape == (q.shape[0], q.shape[2]) and lse.dtype == torch.float32
    assert torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(lse[1:], p_lse[1:], rtol=tol, atol=tol)
    torch.testing.assert_close(out[1:].float(), p_out[1:].float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [4, 8])
def test_decode_blocks_merged_match_whole_cache(cuda, tp, dtype):
    """A cache cut into the tp blocks of the sequence-parallel layout,
    each block's call with its valid rows and ``lse`` (empty blocks
    included), merged by their log-sum-exps as ``combine_over_model``
    merges the ranks': within the dtype's tolerance of the whole-cache
    call."""
    q, k, v, lens = _lse_inputs(dtype, cuda, B=5, S=64 * tp)
    lens = torch.tensor([1, 40, 64 * tp // 2 + 3, 64 * tp - 1, 64 * tp],
                        dtype=torch.int32, device=cuda)
    n = k.shape[1] // tp
    outs, lses = [], []
    for r in range(tp):
        kl = (lens - r * n).clamp(0, n).to(torch.int32)
        o, lse = decode_attention(q, k[:, r * n:(r + 1) * n],
                                  v[:, r * n:(r + 1) * n], kl,
                                  return_lse=True)
        assert torch.equal(torch.isinf(lse).all(1), kl == 0)
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(0))[:, :, None, :, None]
    merged = ((torch.stack([o.float() for o in outs]) * w).sum(0)
              / w.sum(0)).to(dtype)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(merged.float(),
                               decode_attention(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,int8", [("qwen2-vl-7b", False),
                                       ("qwen2-vl-7b", True),
                                       ("qwen3-moe-30b-a3b", False),
                                       ("minicpm3-4b", False),
                                       ("mamba2-1.3b", False),
                                       ("zamba2-2.7b", False),
                                       ("seamless-m4t-medium", False)])
def test_tp_wave_one_rank_nccl_bit_for_bit(cuda, nccl_rank, arch, int8):
    """A serving wave on the tensor-parallel path (a (1, 1) data x model
    mesh on NCCL: the prefill and decode rules, the sequence-parallel
    cache, the decode kernel's ``lse`` (MLA's latent softmax) and the
    combine over one-rank groups; the Mamba2 layers' sums; the
    encoder-decoder's read-only cross block, its 8 frames nonzero)
    against the single-device wave at the f32 smoke config (``testing.
    tp_serve_parity``; the int8 cache from ``init_cache``; Zamba2's LoRA
    seeded nonzero): tokens equal, logits and cache bit for bit."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.testing import tp_serve_parity
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    cfg = cfg.resolve(tp=1, dp=1)
    params = model.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                               cuda)
    if cfg.family == "hybrid":
        seed_lora(params, cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (3, 14)), dtype=torch.int32,
        device=cuda)}
    if cfg.family == "encdec":
        batch["enc_frames"] = _randn((3, 8, cfg.d_model), torch.float32,
                                     cuda, 5)
    d = tp_serve_parity(cfg, make_mesh((1, 1), ("data", "model")), params,
                        batch, 32, 8, from_init=int8)
    assert d["tokens_equal"] and d["logits_exact"] and d["cache_exact"], d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Skv", [1024, 512], ids=["encoder", "cross"])
def test_flash_non_causal_at_tp_local_encdec_heads(cuda, Skv, dtype):
    """Flash attention forward and backward, non-causal, at a tp 4 rank's
    heads of seamless-m4t-medium (4 of 16, MHA, D 64), B 4 x 1024
    queries: the encoder's self-attention (1024 keys) and the
    cross-attention over 512 encoder frames (Sq != Skv), against the
    plain versions; bf16 on the tensor-core kernels."""
    from repro_torch.kernels.flash_attention import (
        _flash_forward, flash_attention_bwd, flash_attention_bwd_plain)
    B, S, H, D = 4, 1024, 4, 64
    q = _randn((B, S, H, D), dtype, cuda, 40)
    k, v = (_randn((B, Skv, H, D), dtype, cuda, 41 + i) for i in range(2))
    do = _randn((B, S, H, D), dtype, cuda, 43)
    variant = "tc" if dtype == torch.bfloat16 else "fma"
    before = _flash_counts()
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_one_launch(before, variant)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(),
                               flash_attention_plain(q, k, v, False).float(),
                               rtol=tol, atol=tol)
    o, lse = _flash_forward(q, k, v, False, True)
    for g, w in zip(flash_attention_bwd(q, k, v, o, do, lse, False),
                    flash_attention_bwd_plain(q, k, v, o, do, lse, False)):
        assert g.shape == w.shape and _bwd_err(g, w) < tol


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma"),
                                           (torch.bfloat16, "mma")])
def test_decode_lse_on_read_only_cross_block(cuda, nccl_rank, dtype,
                                             variant):
    """The decode kernel with ``lse`` on a tp 4 rank's read-only block of
    seamless-m4t-medium's cross cache (8 rows of the batch, 128 of 512
    encoder frames, 16 heads of 64, MHA), every row valid, against the
    plain version; and ``attention_decode``'s read-only block path on it
    (one model rank) equal to the unsplit cross-attention bit for bit,
    the block left as it was."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import rules_for
    from repro_torch.models.attention import attention_decode, init_attention
    from repro_torch.parallel.sharding import axis_rules
    B, n, H, D = 8, 128, 16, 64
    q = _randn((B, 1, H, D), dtype, cuda, 50)
    k = _randn((B, n, H, D), dtype, cuda, 51)
    v = _randn((B, n, H, D), dtype, cuda, 52)
    lens = torch.full((B,), n, dtype=torch.int32, device=cuda)
    before = getattr(decode_attention, f"{variant}_launches")
    out, lse = decode_attention(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    assert getattr(decode_attention, f"{variant}_launches") == before + 1
    p_out, p_lse = decode_attention_plain(q, k, v, lens, return_lse=True)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(lse, p_lse, rtol=tol, atol=tol)
    torch.testing.assert_close(out.float(), p_out.float(), rtol=tol,
                               atol=tol)
    cfg = dataclasses.replace(get_config("seamless-m4t-medium", smoke=True),
                              dtype=str(dtype).split(".")[1]).resolve(tp=1)
    p = init_attention(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    x = _randn((B, 1, cfg.d_model), dtype, cuda, 53)
    ck = _randn((B, 12, cfg.padded_kv, cfg.head_dim), dtype, cuda, 54)
    cv = _randn((B, 12, cfg.padded_kv, cfg.head_dim), dtype, cuda, 55)
    pos = torch.arange(B, dtype=torch.int32, device=cuda)
    last = torch.full((B,), 11, dtype=torch.int32, device=cuda)
    want = attention_decode(p, cfg, x, pos, ck, cv, last,
                            update_cache=False, use_rope=False)[0]
    kept = (ck.clone(), cv.clone())
    with axis_rules(rules_for(cfg, make_mesh((1, 1), ("data", "model")),
                              "decode")):
        got = attention_decode(p, cfg, x, pos, ck, cv, last,
                               update_cache=False, use_rope=False)[0]
    assert torch.equal(got, want)
    assert torch.equal(ck, kept[0]) and torch.equal(cv, kept[1])

