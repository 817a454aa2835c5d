"""The reference's own prefill and decode on a mesh with a ``model`` axis,
for the port's tensor-parallel serving tests.

Run as a child process with ``XLA_FLAGS=--xla_force_host_platform_device_
count=8`` set by the caller (jax fixes its device count when it starts),
as ``tests/_torch_reference_tp_steps.py`` runs the reference's train
steps.  Reads a JSON list of requests on stdin; a request: ``{"arch",
"mesh": [sizes], "axes": [names], "cache_len", "steps", "dir"}`` and
optionally ``"config": {ModelConfig fields}``, where ``dir`` holds
``params.npz`` (every leaf of the reference's params by its key path) and
``batch.npz`` (the prefill's global batch; an ``encdec`` wave's encoder
frames in it).

For each, the arch's f32 smoke config resolved with tp = the model axis
and dp = the data axes' product, as ``build_cell`` resolves it; the
reference's GSPMD ``prefill`` jitted under ``rules_for(cfg, mesh,
"prefill")`` with ``build_cell``'s argument shardings, then ``steps``
greedy ``decode_step``s jitted under the decode rules, the cache in
``build_cell``'s decode layout (``tree_arg_shardings`` of
``cache_logical``).  Writes ``dir/wave.npz``: ``logits`` (steps + 1, B,
V_padded) f32 and ``tokens`` (B, steps + 1).
"""
import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config
from repro.launch.mesh import make_mesh
from repro.launch.specs import batch_logical, rules_for, tree_arg_shardings
from repro.models import model as M
from repro.parallel.sharding import axis_rules


def _key(path) -> str:
    return "".join(f"[{getattr(p, 'key', getattr(p, 'idx', p))!r}]"
                   for p in path)


def run(req: dict) -> None:
    shape, axes = tuple(req["mesh"]), tuple(req["axes"])
    mesh = make_mesh(shape, axes)
    sizes = dict(zip(axes, shape))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    cfg = dataclasses.replace(get_config(req["arch"], smoke=True),
                              dtype="float32", **req.get("config", {}))
    cfg = cfg.resolve(tp=sizes.get("model", 1),
                      dp=math.prod(sizes[a] for a in dp_axes))
    pre, dec = rules_for(cfg, mesh, "prefill"), rules_for(cfg, mesh, "decode")
    sds = jax.eval_shape(lambda k: M.init_params(k, cfg),
                         jax.random.PRNGKey(0))
    with np.load(os.path.join(req["dir"], "params.npz")) as f:
        flat, tree = jax.tree_util.tree_flatten_with_path(sds)
        params = jax.tree_util.tree_unflatten(
            tree, [jnp.asarray(f[_key(p)]) for p, _ in flat])
    with np.load(os.path.join(req["dir"], "batch.npz")) as f:
        batch = {k: jnp.asarray(f[k]) for k in f.files}
    p_logical = M.params_logical(cfg)
    params = jax.device_put(params, tree_arg_shardings(params, p_logical,
                                                       pre))
    batch = jax.device_put(batch, tree_arg_shardings(
        batch, batch_logical(cfg, "prefill"), pre))
    B, S = batch["tokens"].shape[0], req["cache_len"]
    cache_sh = tree_arg_shardings(
        jax.eval_shape(lambda: M.init_cache(cfg, B, S)), M.cache_logical(cfg),
        dec)
    tok_sh = tree_arg_shardings(
        {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32)},
        batch_logical(cfg, "decode"), dec)["tokens"]
    p_dec = tree_arg_shardings(params, p_logical, dec)

    def prefill(p, b):
        with axis_rules(pre):
            return M.prefill(p, cfg, b, S)

    def decode(p, c, t):
        with axis_rules(dec):
            return M.decode_step(p, cfg, c, t)

    prefill = jax.jit(prefill)
    decode = jax.jit(decode, in_shardings=(p_dec, cache_sh, tok_sh),
                     out_shardings=(None, cache_sh))
    logits, cache = prefill(params, batch)
    cache = jax.device_put(cache, cache_sh)
    out = [np.asarray(logits)]
    tok = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
    toks = [tok]
    for _ in range(req["steps"]):
        logits, cache = decode(params, cache, jax.device_put(tok, tok_sh))
        out.append(np.asarray(logits))
        tok = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
        toks.append(tok)
    np.savez(os.path.join(req["dir"], "wave.npz"), logits=np.stack(out),
             tokens=np.concatenate(toks, axis=1))


def main() -> None:
    for req in json.load(sys.stdin):
        run(req)


if __name__ == "__main__":
    main()
