"""The reference's argument layouts, for the port's parallel tests.

Run as a child process with ``XLA_FLAGS=--xla_force_host_platform_device_
count=16`` set by the caller (jax fixes its device count when it starts),
as ``tests/test_distributed.py`` runs the reference's meshes.  Reads a JSON
list of requests on stdin and prints one JSON object: for each request,
``{leaf key path: {"spec": [...], "shape": [...]}}``, the reference's
``arg_sharding`` spec of the leaf (a tuple entry as a list) and its shard
shape.

A request: ``{"arch", "smoke", "dtype" (or null), "mesh": [sizes],
"axes": [names], "fsdp", "what"}``, ``what`` one of ``"state"`` (the train
state's layouts, ``build_cell``'s: params by ``params_logical``, master /
m / v with ``embed -> opt_embed``, the step replicated), ``"cache"`` (the
decode cache at B 8 x S 64 under decode rules) or a ``SHAPES`` name (that
cell's inputs under ``rules_for``).  The config is resolved with tp = the
model axis and dp = the data axes' product, as ``build_cell`` does.
"""
import dataclasses
import json
import math
import sys

import jax

from repro.configs.base import SHAPES, get_config
from repro.launch.mesh import make_mesh
from repro.launch.specs import (batch_logical, input_specs, rules_for,
                                tree_arg_shardings)
from repro.models import model as M
from repro.parallel.sharding import make_rules


def _key(path) -> str:
    return "".join(f"[{getattr(p, 'key', getattr(p, 'idx', p))!r}]"
                   for p in path)


def _layouts(sds_tree, shardings) -> dict:
    out = {}
    flat_s = jax.tree_util.tree_flatten_with_path(sds_tree)[0]
    flat_n = jax.tree.leaves(shardings)
    for (path, sds), ns in zip(flat_s, flat_n):
        spec = [list(e) if isinstance(e, tuple) else e for e in ns.spec]
        out[_key(path)] = {"spec": spec,
                           "shape": list(ns.shard_shape(sds.shape))}
    return out


def layouts(req: dict) -> dict:
    mesh = make_mesh(tuple(req["mesh"]), tuple(req["axes"]))
    sizes = dict(zip(req["axes"], req["mesh"]))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    cfg = get_config(req["arch"], smoke=req["smoke"])
    if req.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=req["dtype"])
    cfg = cfg.resolve(tp=sizes.get("model", 1),
                      dp=math.prod(sizes[a] for a in dp_axes))
    what = req["what"]
    if what == "state":
        rules = make_rules(mesh, mode="train", fsdp=req["fsdp"], zero1=True,
                           dp_axes=dp_axes)
        p_logical = M.params_logical(cfg)
        sds = jax.eval_shape(
            lambda k: {"params": M.init_params(k, cfg)},
            jax.random.PRNGKey(0))["params"]
        o_logical = jax.tree.map(
            lambda a: tuple("opt_embed" if x == "embed" else x for x in a),
            p_logical, is_leaf=lambda x: isinstance(x, tuple))
        state = {"params": sds, "opt": {"master": sds, "m": sds, "v": sds,
                                        "step": jax.ShapeDtypeStruct(
                                            (), jax.numpy.int32)}}
        logical = {"params": p_logical,
                   "opt": {"master": o_logical, "m": o_logical,
                           "v": o_logical, "step": ()}}
        return _layouts(state, tree_arg_shardings(state, logical, rules))
    if what == "cache":
        rules = make_rules(mesh, mode="decode", fsdp=req["fsdp"],
                           dp_axes=dp_axes)
        sds = jax.eval_shape(lambda: M.init_cache(cfg, 8, 64))
        return _layouts(sds, tree_arg_shardings(sds, M.cache_logical(cfg),
                                                rules))
    shape = SHAPES[what]
    rules = rules_for(cfg, mesh, shape.kind)
    sds = input_specs(cfg, shape)
    return _layouts(sds, tree_arg_shardings(
        sds, batch_logical(cfg, shape.kind), rules))


def main() -> None:
    reqs = json.load(sys.stdin)
    json.dump([layouts(r) for r in reqs], sys.stdout)


if __name__ == "__main__":
    main()
