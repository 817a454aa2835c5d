"""The dry-run of the port (importable; ``python -m
repro_torch.launch.dryrun`` calls :func:`main`).

Translated from the reference's ``launch/dryrun_lib.py``.  For every
requested (arch x shape x mesh) this process is one rank of the
production mesh (:func:`fake_group`: rank 0 of 256 ranks, (data 16,
model 16), or of 512 with the pod axis): the cell's real step runs once
at that rank's local shapes on the device (``launch.specs.build_cell``
/ ``lower_cell``), its collectives called on a fake process group that
moves nothing, and the run's memory, flops, bytes accessed and
collective bytes (``launch.counts``) go into an incremental JSON artifact
(resumable: cells recorded ``ok`` are skipped).

Per-layer marginal terms, as the reference's: two more runs at depth 1
and 2 (:func:`_depth_override`), whose difference is one block's
flops, bytes and collectives; the roofline scales them to full depth.
The record keeps the reference's keys (``compile_s`` becomes ``run_s``)
and adds ``device``, ``rank``, each depth run's ``memory_L1`` /
``memory_L2`` and the kernels' calls, bytes and operations.  A cell that
raises, out of memory included, is recorded with ``status: "error"``,
its message and its trace, and the run goes on.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import (SHAPES, available_archs, get_config,
                                      supported_shapes)
from repro_torch.device import resolve_device
from repro_torch.launch.counts import (collective_bytes, cost_dict,
                                       kernel_counts)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_cell, lower_cell

#: the reason recorded for a full-attention arch's long_500k cell (the
#: reference's text)
LONG_SKIP = ("full-attention arch: long_500k requires sub-quadratic "
             "attention (see DESIGN.md)")


def production_shape(multi_pod: bool):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@contextlib.contextmanager
def fake_group(shape=(16, 16), axes=("data", "model"), rank: int = 0,
               device=None):
    """This process as rank ``rank`` of a fake process group of
    ``prod(shape)`` ranks (``torch.testing._internal.distributed.
    fake_pg``: collectives run and move nothing), yielding the mesh
    ``shape`` x ``axes`` on ``device``'s type over it; the group is
    destroyed on exit.  Refused where a process group already exists: the
    fake group must not be the default group of a process that runs a
    real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group: this process already has a default "
                           "process group; run the dry-run in a process "
                           "of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, device)
    finally:
        dist.destroy_process_group()


def _depth_override(cfg, n_blocks: int) -> dict:
    """Config overrides that set the number of repeated blocks to n_blocks."""
    if cfg.family == "hybrid":
        return {"num_layers": n_blocks * cfg.hybrid.shared_every,
                "scan_layers": False}
    if cfg.family == "encdec":
        return {"num_layers": n_blocks, "enc_layers": n_blocks,
                "scan_layers": False}
    return {"num_layers": n_blocks, "scan_layers": False}


def _n_blocks(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.shared_every
    return cfg.num_layers


def _mem_dict(mem: dict) -> dict:
    return {k: mem[k] for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes",
             "alias_size_in_bytes")}


def _release(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _one_run(arch, shape_name, mesh, dev, **kw):
    """The CellRun of one build and run, its output and the cell
    released."""
    cell = build_cell(arch, shape_name, mesh, device=dev, **kw)
    ran = lower_cell(cell)()
    ran.out = None
    del cell
    _release(dev)
    return ran


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             extrapolate: bool = True, verbose: bool = True, device=None,
             rank: int = 0, full: bool = True,
             fsdp: Optional[bool] = None) -> dict:
    """One cell's record: this process as rank ``rank`` of the production
    mesh on ``device`` (None: the card).  ``full`` runs the cell at its
    full depth (``memory``, ``cost_full``, ``collectives_full``,
    ``run_s``); ``extrapolate`` (single pod only) the depth-1 and depth-2
    runs (``cost_L1`` / ``cost_L2``, ``collectives_L*``, ``memory_L*``,
    ``run_L*_s``).  ``fsdp`` None lets each run's config choose its
    layout, as the reference's (a train cell past 8 B parameters is FSDP
    at full depth, ZeRO-1 at depth 1 and 2); True or False sets it for
    every run (``fsdp`` is then recorded)."""
    dev = resolve_device(device)
    shape, axes = production_shape(multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, shape)), "chips": 512 if multi_pod
           else 256, "device": str(dev), "rank": rank}
    base_cfg = get_config(arch)
    rec["n_blocks"] = _n_blocks(base_cfg)
    rec["params"] = base_cfg.param_count()
    rec["params_active"] = base_cfg.param_count(active_only=True)
    if fsdp is not None:
        rec["fsdp"] = fsdp
    with fake_group(shape, axes, rank, dev) as mesh:
        if full:
            t0 = time.perf_counter()
            ran = _one_run(arch, shape_name, mesh, dev, fsdp=fsdp)
            rec["memory"] = _mem_dict(ran.memory)
            rec["cost_full"] = cost_dict(ran)
            rec["collectives_full"] = collective_bytes(ran)
            rec["kernels_full"] = kernel_counts(ran)
            rec["run_s"] = round(time.perf_counter() - t0, 1)
            if verbose:
                print(f"  memory: {rec['memory']}")
                print(f"  cost: flops={rec['cost_full']['flops']:.3e} "
                      f"bytes={rec['cost_full']['bytes accessed']:.3e}")
                print(f"  collectives: {rec['collectives_full']}")
        if extrapolate and not multi_pod:
            for n in (1, 2):
                t1 = time.perf_counter()
                ran = _one_run(arch, shape_name, mesh, dev,
                               overrides=_depth_override(base_cfg, n),
                               tcfg_overrides={"unroll_microbatches": True},
                               fsdp=fsdp)
                rec[f"memory_L{n}"] = _mem_dict(ran.memory)
                rec[f"cost_L{n}"] = cost_dict(ran)
                rec[f"collectives_L{n}"] = collective_bytes(ran)
                rec[f"kernels_L{n}"] = kernel_counts(ran)
                rec[f"run_L{n}_s"] = round(time.perf_counter() - t1, 1)
                if verbose:
                    print(f"  L{n}: memory {rec[f'memory_L{n}']}, flops "
                          f"{rec[f'cost_L{n}']['flops']:.3e}, collectives "
                          f"{rec[f'collectives_L{n}']}")
    rec["status"] = "ok"
    return rec


def cell_list(archs, shapes):
    cells = []
    for a in archs:
        cfg = get_config(a)
        names = [s.name for s in supported_shapes(cfg)]
        skips = [n for n in SHAPES if n not in names]
        for n in names:
            if not shapes or n in shapes:
                cells.append((a, n, False))
        for n in skips:
            cells.append((a, n, None))  # recorded as skipped
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/artifacts/dryrun_torch.json")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    archs = available_archs() if args.arch == "all" else args.arch.split(",")
    shapes = None if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    dev = resolve_device(args.device)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)   # --force only bypasses the skip check

    def save():
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
        os.replace(tmp, args.out)

    for arch, shape_name, runnable in cell_list(archs, shapes):
        if runnable is None:
            key = f"{arch}|{shape_name}|skip"
            if key not in results:
                results[key] = {
                    "arch": arch, "shape": shape_name, "status": "skipped",
                    "reason": LONG_SKIP if shape_name == "long_500k"
                    else "n/a for family",
                }
                save()
            continue
        for multi in meshes:
            key = f"{arch}|{shape_name}|{'multi' if multi else 'single'}"
            if (key in results and results[key].get("status") == "ok"
                    and not args.force):
                continue
            print(f"[dryrun] {key}", flush=True)
            try:
                rec = run_cell(arch, shape_name, multi,
                               extrapolate=not args.no_extrapolate,
                               device=dev)
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": "2x16x16" if multi else "16x16",
                       "device": str(dev), "rank": 0,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"  ERROR {e}", flush=True)
                del e
                _release(dev)
            results[key] = rec
            save()
    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    print(f"[dryrun] done: {n_ok} ok, {n_err} error, {n_skip} skipped")
    return 1 if n_err else 0
