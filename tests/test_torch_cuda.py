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
bf16 (tests/test_kernels.py's); the model's logits at f32 1e-4 relative
to their largest value, with identical greedy tokens.
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
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
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


def test_segment_sum_rejects_cpu_ids_with_cuda_values(cuda):
    v = torch.zeros((2, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        segment_sum(v, torch.zeros((2, 3), dtype=torch.int32), 4)


@pytest.mark.parametrize("name", ("stale-predictions", "churn"))
def test_campaign_cuda_matches_cpu(cuda, name):
    kw = dict(seeds=(0, 1), n_trials=8, n_requests=150, n_nodes=30,
              n_replicas_per_app=20)
    launches = segment_sum.launches
    on_gpu = run_scenario(name, device="cuda", **kw)
    assert segment_sum.launches > launches
    on_cpu = run_scenario(name, device="cpu", **kw)
    for pol, want in on_cpu.items():
        got = on_gpu[pol]
        for k in SUMMARY_STATS + ("hedged",):
            np.testing.assert_allclose(got.per_seed[k], want.per_seed[k],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}/{pol}/{k}")
        assert got.n_hedged == want.n_hedged


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 128, 8, 1, 16),
    (2, 100, 4, 2, 32), (1, 777, 28, 4, 128), (1, 130, 4, 2, 256)])
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, D, causal, dtype):
    q = _randn((B, S, H, D), dtype, cuda, 0)
    k = _randn((B, S, KV, D), dtype, cuda, 1)
    v = _randn((B, S, KV, D), dtype, cuda, 2)
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    tol = ATTN_TOL[dtype]
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
