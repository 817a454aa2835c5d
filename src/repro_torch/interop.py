"""Carry configurations, clusters and model parameters across from the
reference.

For the simulation, data takes the place of weights: a cluster
(topology, request stream, pre-drawn noise) is what both sides must share
for a comparison to mean anything.  For the models, the port cannot
replay the reference's jax PRNG draws, so a comparison hands both sides
the reference's parameters.  These helpers are duck-typed — they read
attributes and leaves by the reference's names and import nothing of it.
A predictor's exported artifact crosses the same way
(:func:`artifact_from_reference`), and a trained predictor with it
(:func:`predictor_from_reference`), and an LM's train state
(:func:`train_state_from_reference`).
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from repro_torch.core import zoo
from repro_torch.core.capacity import CapacityConfig
from repro_torch.core.predictor import (InferenceArtifact, MinMax,
                                        ModelChoice, RTTPredictor,
                                        SelectedConfig)
from repro_torch.core.resilience import ResilienceConfig
from repro_torch.core.simulator import SimConfig, _Cluster
from repro_torch.core.telemetry import TraceConfig
from repro_torch.device import DeviceLike, resolve_device


def _by_name(cls, obj):
    """An instance of the dataclass ``cls`` with every field read by
    name from ``obj`` (None stays None)."""
    if obj is None:
        return None
    return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)})


def config_from_reference(cfg) -> SimConfig:
    """The port's :class:`SimConfig` with every field read by name from
    ``cfg`` (any object with the reference's SimConfig fields).  The
    capacity, resilience and trace configs become the port's own
    classes, read by name the same way."""
    kw = {f.name: getattr(cfg, f.name) for f in fields(SimConfig)}
    kw["capacity"] = _by_name(CapacityConfig, kw["capacity"])
    kw["resilience"] = _by_name(ResilienceConfig, kw["resilience"])
    kw["trace"] = _by_name(TraceConfig, kw["trace"])
    return SimConfig(**kw)


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
    as nested dicts, tuples and lists of arrays (anything ``np.asarray``
    takes, bfloat16 included): the same nesting, containers and leaf
    names, each leaf a tensor on ``device`` (None: the CUDA card).
    ``dtype`` casts the floating leaves; by default each keeps its own
    dtype."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, dev, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_reference(v, dev, dtype)
                          for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16: carry the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


def train_state_from_reference(state, device: DeviceLike) -> dict:
    """The port's train state from the reference's
    (``make_train_state``'s ``{"params", "opt": {"master", "m", "v",
    "step"}}``): every leaf through :func:`params_from_reference` onto
    ``device`` (None: the CUDA card), each in its own dtype, the step an
    int32 scalar."""
    return {"params": params_from_reference(state["params"], device),
            "opt": params_from_reference(state["opt"], device)}


def artifact_from_reference(art, device: DeviceLike = None
                            ) -> InferenceArtifact:
    """The port's :class:`InferenceArtifact` from a reference one: the
    params through :func:`params_from_reference` onto ``device`` (None:
    the CUDA card), the scalers as numpy arrays (None stays None) and
    every other field by name."""
    kw = {f.name: getattr(art, f.name) for f in fields(InferenceArtifact)}
    kw["params"] = params_from_reference(art.params, device)
    for name in ("scaler_lo", "scaler_hi", "seq_lo", "seq_hi"):
        if kw[name] is not None:
            kw[name] = np.array(kw[name])
    return InferenceArtifact(**kw)


def predictor_from_reference(p, store, device: DeviceLike = None
                             ) -> RTTPredictor:
    """The port's :class:`RTTPredictor` from a trained reference one,
    reading the port's ``store`` (the reference's reads its own): the
    model through :func:`artifact_from_reference` onto ``device`` (None:
    the CUDA card) into a fit object (``zoo.from_params``), the
    selection, scalers, target range, version, ``c_max`` and seed by
    name."""
    art = artifact_from_reference(p.export_artifact(), device)
    q = RTTPredictor(p.app, p.node, store, c_max=p.dataset.c_max,
                     seed=p.seed, fast_state=p.fast_state, device=device)
    q.selected = _by_name(SelectedConfig, p.selected)
    q.selected.metric_idx = np.array(q.selected.metric_idx)
    q.choice = ModelChoice(art.family,
                           zoo.from_params(art.family, art.params),
                           float(p.choice.rmse), float(p.choice.t_inference))
    q.scaler_X = MinMax(np.array(p.scaler_X.lo), np.array(p.scaler_X.hi))
    q._seq_lo, q._seq_hi = np.array(p._seq_lo), np.array(p._seq_hi)
    q.y_lo, q.y_hi = float(p.y_lo), float(p.y_hi)
    q.artifact_version = p.artifact_version
    return q
