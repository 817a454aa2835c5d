"""The port on the CUDA card: each hand-written kernel against its plain
PyTorch version, and the campaign on CUDA against the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it also runs where those are
not installed (the repository's ``conftest.py`` imports jax; skip it)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 0/1 masks are integer sums, exact; other values 1e-12
relative in f64 and 1e-5 in f32 (shared-memory atomics add in a
run-dependent order); campaign stats 1e-5 relative (the reference's own
contract between backends).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.campaign import SUMMARY_STATS, run_scenario
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain

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
