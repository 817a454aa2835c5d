"""Processes of the port's dry-run tests (``tests/test_torch_dryrun.py``):
every fake or gloo process group lives in one of them, never in the test
process.  Nothing here imports jax.

``python tests/_torch_dist_dryrun.py gloo RANK STORE OUT``: rank ``RANK``
of a four-rank gloo group (a ``file://`` store) on a (data 2, model 2)
mesh runs each of :data:`CASES` once and writes its counts to ``OUT``.

``python tests/_torch_dist_dryrun.py fake OUT``: rank 0 of a fake
four-rank group on the same mesh does the same, and the dense train case
at depth 1 and 2 (``train_L1``, ``train_L2``).

``python tests/_torch_dist_dryrun.py main OUT``: ``dryrun_lib.main`` over
the smoke configs of deepseek-67b and mamba2-1.3b at ``decode_32k`` on
the CPU (mamba2-1.3b's smoke heads do not split over 16 model ranks: an
error cell), twice, the second run counting the cells it runs again;
writes the return codes, the second run's cells and the artifact.
"""
import json
import sys

import torch

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.counts import (collective_bytes, cost_dict,
                                       kernel_counts)
from repro_torch.launch.specs import build_cell, lower_cell

MESH = ((2, 2), ("data", "model"))
#: the cells held on gloo against the fake group: deepseek-67b's smoke
#: config, a global batch of 16 x 64 tokens (4 microbatches over 2 data
#: ranks) and a decode step of 8 rows against a 64-row cache, 2 layers
TRAIN_TINY = ShapeSpec("train_tiny", "train", 64, 16)
DECODE_TINY = ShapeSpec("decode_tiny", "decode", 64, 8)
ARCH = "deepseek-67b"
CASES = {"train": (TRAIN_TINY, 2), "decode": (DECODE_TINY, 2)}


def counts(mesh, shape, layers: int) -> dict:
    cell = build_cell(ARCH, shape, mesh, cfg=get_config(ARCH, smoke=True),
                      overrides={"num_layers": layers}, device="cpu")
    ran = lower_cell(cell)()
    return {"collectives": collective_bytes(ran), "cost": cost_dict(ran),
            "kernels": kernel_counts(ran)}


def gloo(rank: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        mesh = make_mesh(*MESH, "cpu")
        res = {k: counts(mesh, *v) for k, v in CASES.items()}
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def fake(out: str) -> None:
    from repro_torch.launch.dryrun_lib import fake_group
    torch.set_num_threads(1)
    with fake_group(*MESH, rank=0, device="cpu") as mesh:
        res = {k: counts(mesh, *v) for k, v in CASES.items()}
        for n in (1, 2):
            res[f"train_L{n}"] = counts(mesh, TRAIN_TINY, n)
    with open(out, "w") as f:
        json.dump(res, f)


def main_runs(out: str) -> None:
    import repro_torch.launch.dryrun_lib as DL
    import repro_torch.launch.specs as SP

    def smoke(name, smoke=False):
        return get_config(name, smoke=True)

    torch.set_num_threads(1)
    DL.get_config = SP.get_config = smoke
    art = out + ".artifact.json"
    argv = ["--arch", "deepseek-67b,mamba2-1.3b", "--shape", "decode_32k",
            "--device", "cpu", "--out", art]
    rc1 = DL.main(argv)
    again, run_cell = [], DL.run_cell

    def counted(arch, shape, *a, **kw):
        again.append([arch, shape])
        return run_cell(arch, shape, *a, **kw)

    DL.run_cell = counted
    rc2 = DL.main(argv)
    with open(art) as f:
        artifact = json.load(f)
    with open(out, "w") as f:
        json.dump({"rc": [rc1, rc2], "again": again, "artifact": artifact},
                  f)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "gloo":
        gloo(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif mode == "fake":
        fake(sys.argv[2])
    else:
        main_runs(sys.argv[2])
