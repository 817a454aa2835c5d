"""Carry configurations and clusters across from the reference.

In this system data takes the place of weights: a cluster (topology,
request stream, pre-drawn noise) is what both sides must share for a
comparison to mean anything.  These helpers are duck-typed — they read
attributes by the reference's field names and import nothing of it.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np

from repro_torch.core.simulator import SimConfig, _Cluster


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
