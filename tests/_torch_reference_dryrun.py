"""The reference's dry-run cells, for the port's dry-run tests.

Run as a child process with ``XLA_FLAGS=--xla_force_host_platform_device_
count=16`` set by the caller (jax fixes its device count when it starts),
as ``tests/test_distributed.py`` runs the reference's meshes.  Reads a JSON
list of requests on stdin and prints one JSON list, one object a request.

A request: ``{"arch", "shape" (a SHAPES name, or [name, kind, seq_len,
global_batch] for a cell of the test's own, in ``SHAPES`` while its cell
is built), "mesh": [sizes], "axes": [names], "smoke" (start from the
smoke config), "overrides" (config fields), "compile"}``.  Its answer: the resolved config (``cfg``, nested
dataclasses as dicts), ``kind``, ``donate``, for a train cell the
``TrainConfig``'s ``microbatches`` / ``master_fp32`` / ``moment_dtype``
(read off the step's closure: the reference's ``Cell`` does not keep
it), and ``args``: ``{"<arg index><key path>": {"spec", "shape",
"bytes", "kept"}}``, each leaf's ``in_shardings`` spec (a tuple entry as
a list), its shard shape, its bytes there and whether the lowered step
keeps it (``jax.jit`` drops the arguments a step does not read, and
``memory_analysis`` does not count them).  With ``compile``, the
compiled step's ``memory_analysis().argument_size_in_bytes``, its
``cost_analysis`` flops and ``collective_bytes``.  ``"cell_list"`` in
place of a request gives ``dryrun_lib.cell_list`` over every arch.
"""
import dataclasses
import inspect
import json
import sys

import jax
import numpy as np

from repro.configs.base import SHAPES, ShapeSpec, available_archs, get_config
from repro.launch.dryrun_lib import cell_list
from repro.launch.hlo import collective_bytes, cost_dict
from repro.launch.mesh import make_mesh
from repro.launch.specs import build_cell, lower_cell


def _key(path) -> str:
    return "".join(f"[{getattr(p, 'key', getattr(p, 'idx', p))!r}]"
                   for p in path)


def _tcfg(cell):
    step = inspect.getclosurevars(cell.fn).nonlocals["step"]
    tcfg = inspect.getclosurevars(step).nonlocals["tcfg"]
    return {"microbatches": tcfg.microbatches,
            "master_fp32": tcfg.master_fp32,
            "moment_dtype": tcfg.moment_dtype}


def answer(req: dict) -> dict:
    if req == "cell_list":
        return [list(c) for c in cell_list(available_archs(), None)]
    mesh = make_mesh(tuple(req["mesh"]), tuple(req["axes"]))
    cfg = get_config(req["arch"], smoke=req.get("smoke", False))
    shape = req["shape"]
    if isinstance(shape, list):
        SHAPES[shape[0]] = ShapeSpec(*shape)
    try:
        cell = build_cell(req["arch"], shape[0] if isinstance(shape, list)
                          else shape, mesh,
                          overrides=req.get("overrides") or None, cfg=cfg)
    finally:
        if isinstance(shape, list):
            SHAPES.pop(shape[0])
    lowered = lower_cell(cell)
    kept = lowered._lowering.compile_args["kept_var_idx"]
    args, n = {}, 0
    for i, (sds_tree, sh_tree) in enumerate(zip(cell.args,
                                                cell.in_shardings)):
        flat = jax.tree_util.tree_flatten_with_path(sds_tree)[0]
        for (path, sds), ns in zip(flat, jax.tree.leaves(sh_tree)):
            shape = ns.shard_shape(sds.shape)
            args[f"{i}{_key(path)}"] = {
                "spec": [list(e) if isinstance(e, tuple) else e
                         for e in ns.spec],
                "shape": list(shape),
                "bytes": int(np.prod(shape)) * sds.dtype.itemsize,
                "kept": n in kept}
            n += 1
    out = {"cfg": json.loads(json.dumps(dataclasses.asdict(cell.cfg))),
           "kind": cell.kind, "donate": list(cell.donate), "args": args}
    if cell.kind == "train":
        out["tcfg"] = _tcfg(cell)
    if req.get("compile"):
        compiled = lowered.compile()
        out["argument_size_in_bytes"] = \
            compiled.memory_analysis().argument_size_in_bytes
        out["flops"] = cost_dict(compiled).get("flops")
        out["collectives"] = collective_bytes(compiled.as_text())
    return out


def main() -> None:
    reqs = json.load(sys.stdin)
    json.dump([answer(r) for r in reqs], sys.stdout)


if __name__ == "__main__":
    main()
