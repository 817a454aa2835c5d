"""The reference's own train step on a mesh with a ``model`` axis, for the
port's tensor-parallel tests.

Run as a child process with ``XLA_FLAGS=--xla_force_host_platform_device_
count=8`` set by the caller (jax fixes its device count when it starts),
as ``tests/test_distributed.py`` runs the reference's (2, 4) case.  Reads
a JSON list of requests on stdin; a request: ``{"arch", "mesh": [sizes],
"axes": [names], "fsdp", "train": {TrainConfig fields}, "steps",
"batch": <npz of the global batch>, "out": <directory>}`` and optionally
``"config": {ModelConfig fields}`` (``scan_layers``: the reference's
scanned encoder refuses frames of another dtype than its carry).

For each, the arch's f32 smoke config resolved with tp = the model axis
and dp = the data axes' product, as ``build_cell`` resolves it, and the
state ``make_train_state(PRNGKey(0))``; then ``steps`` steps of the
reference's GSPMD ``make_train_step`` under the mesh's train rules (ZeRO-1
or FSDP), jitted, on the batch laid out over the data axes.  Writes into
``out``: ``state<k>.npz`` before step k and after the last (every leaf of
``{"params", "opt"}`` whole, by its key path) and ``metrics.json`` (a dict
of floats a step).
"""
import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs.base import TrainConfig, get_config
from repro.launch.mesh import make_mesh
from repro.parallel.sharding import axis_rules, make_rules
from repro.training.train_step import make_train_state, make_train_step


def _key(path) -> str:
    return "".join(f"[{getattr(p, 'key', getattr(p, 'idx', p))!r}]"
                   for p in path)


def _save(path: str, state) -> None:
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    np.savez(path, **{_key(p): np.asarray(x) for p, x in flat})


def run(req: dict) -> None:
    shape, axes = tuple(req["mesh"]), tuple(req["axes"])
    mesh = make_mesh(shape, axes)
    sizes = dict(zip(axes, shape))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    cfg = dataclasses.replace(get_config(req["arch"], smoke=True),
                              dtype="float32", **req.get("config", {}))
    cfg = cfg.resolve(tp=sizes.get("model", 1),
                      dp=math.prod(sizes[a] for a in dp_axes))
    tcfg = TrainConfig(**req["train"])
    rules = make_rules(mesh, mode="train", fsdp=req["fsdp"], zero1=True,
                       dp_axes=dp_axes)
    with np.load(req["batch"]) as f:
        batch = {k: jnp.asarray(f[k]) for k in f.files}
    batch = jax.device_put(batch, NamedSharding(mesh, P(dp_axes)))
    metrics = []
    with axis_rules(rules):
        state = make_train_state(jax.random.PRNGKey(0), cfg, tcfg)
        step = jax.jit(make_train_step(cfg, tcfg, rules))
        for k in range(req["steps"]):
            _save(os.path.join(req["out"], f"state{k}.npz"), state)
            state, m = step(state, batch)
            metrics.append({n: float(v) for n, v in m.items()})
        _save(os.path.join(req["out"], f"state{req['steps']}.npz"), state)
    with open(os.path.join(req["out"], "metrics.json"), "w") as f:
        json.dump(metrics, f)


def main() -> None:
    for req in json.load(sys.stdin):
        run(req)


if __name__ == "__main__":
    main()
