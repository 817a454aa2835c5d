"""Carry configurations, clusters and model parameters across from the
reference.

For the simulation, data takes the place of weights: a cluster
(topology, request stream, pre-drawn noise) is what both sides must share
for a comparison to mean anything.  For the models, the port cannot
replay the reference's jax PRNG draws, so a comparison hands both sides
the reference's parameters.  These helpers are duck-typed — they read
attributes and leaves by the reference's names and import nothing of it.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from repro_torch.core.simulator import SimConfig, _Cluster
from repro_torch.device import DeviceLike, resolve_device


def config_from_reference(cfg) -> SimConfig:
    """The port's :class:`SimConfig` with every field read by name from
    ``cfg`` (any object with the reference's SimConfig fields).  Values
    of features the port does not lower (capacity, resilience, trace)
    are carried as they are."""
    return SimConfig(**{f.name: getattr(cfg, f.name)
                        for f in fields(SimConfig)})


def cluster_from_reference(c) -> _Cluster:
    """The port's :class:`_Cluster` from any object with the reference's
    ``_Cluster`` fields: arrays are copied to numpy (None stays None)
    and the config goes through :func:`config_from_reference`."""
    kwargs = {}
    for f in fields(_Cluster):
        v = getattr(c, f.name, None)
        if f.name == "cfg":
            kwargs["cfg"] = config_from_reference(v)
        else:
            kwargs[f.name] = None if v is None else np.array(v)
    return _Cluster(**kwargs)


def params_from_reference(tree, device: DeviceLike, dtype=None):
    """The port's parameters from the reference's parameter pytree, given
    as nested dicts of arrays (anything ``np.asarray`` takes, bfloat16
    included): the same nesting and leaf names, each leaf a tensor on
    ``device`` (None: the CUDA card).  ``dtype`` casts the floating
    leaves; by default each keeps its own dtype."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, dev, dtype)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16: carry the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)
