"""Fleet prediction plane: one batched inference path from the
``MetricsStore`` to the router (a port of the reference's
``core/prediction_plane.py``).

The paper's feasibility claim is that prediction delay stays within 10%
of the application RTT.  Serving a fleet of per-(app, node) predictors
one at a time multiplies every component by the fleet size; the plane
amortizes both:

1. **State retrieval**: all registered predictors' (metric names,
   window) requests against one store go out as ONE
   ``MetricsStore.query_windows`` range query per (store, fast) group.
2. **Feature extraction + inference**: artifacts are bucketed by
   (family, window, k, the store's window points, parameter shapes).
   Each bucket's parameters and scalers are stacked along a leading
   fleet axis on the plane's device once per registry change, padded to
   the next power of two with copies of the first artifact, and served
   by one batched normalize -> features -> ``zoo.stacked_apply`` ->
   denormalize call: O(buckets) device calls, each copying its
   (B_pad, k, w) windows in and its (B_pad,) predictions out once.

Timing keeps the reference's two bases: under a simulated clock each
record carries the *modeled* delays (the batched retrieval's per-request
share, the Eq. 4 feature term, the Eq. 6 inference cost) and the
measured wall shares go to ``t_wall_*``; under a wall clock the record
carries the measured shares.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import zoo
from repro_torch.core.features import extract_features
from repro_torch.core.predictor import (FEATURE_DELAY_PER_METRIC,
                                        InferenceArtifact, PredictionRecord)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.monitoring.metrics import MetricsStore, PeriodicRefresh

__all__ = ["PredictionPlane"]

Key = Tuple[str, str]


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _structure(tree):
    """The containers of a parameter tree, leaves left out."""
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    return None


def _shape_signature(params) -> Tuple:
    """Hashable tree signature: two parameter sets stack iff equal."""
    return (_structure(params),
            tuple((tuple(x.shape), str(x.dtype))
                  for x in zoo.tree_leaves(params)))


def _bucket_predict(family: str, sequential: bool, params,
                    windows: torch.Tensor, lo, hi, y_lo, y_hi):
    """One bucket's fleet call: normalize -> (features) -> stacked apply
    -> denormalize.  windows (B, k, w); lo / hi (B, k, 1) for the
    sequential families, (B, k * F) otherwise; y_lo / y_hi (B,)."""
    if sequential:
        X = (windows - lo) / torch.clamp(hi - lo, min=1e-9)
    else:
        feats = extract_features(windows)                     # (B, k, F)
        Xf = feats.reshape(feats.shape[0], -1)
        X = (Xf - lo) / torch.clamp(hi - lo, min=1e-9)
    y_n = zoo.stacked_apply(family)(params, X)
    return y_n * torch.clamp(y_hi - y_lo, min=1e-9) + y_lo


@dataclass
class _Entry:
    artifact: InferenceArtifact
    store: MetricsStore


@dataclass
class _Bucket:
    """Artifacts stacked for one device call (built lazily, reused until
    the registry changes)."""
    family: str
    sequential: bool
    keys: List[Key]                       # (app, node), len B
    params: object                        # stacked tree, leading B_pad
    lo: torch.Tensor                      # (B_pad, ...) scaler lows
    hi: torch.Tensor
    y_lo: torch.Tensor                    # (B_pad,)
    y_hi: torch.Tensor
    pad: int                              # B_pad - B
    w_pts: int                            # window points (shared in-bucket)


class PredictionPlane:
    """Registry of :class:`InferenceArtifact` + the batched predict path.

    ``register`` / ``register_predictor`` are idempotent and cheap: a
    predictor is re-exported only when its ``artifact_version`` moved,
    and buckets are restacked only when the registry changed.
    ``device=None`` serves on the CUDA card (RuntimeError without one);
    ``device="cpu"`` on the CPU.
    """

    def __init__(self, refresh_s: float = 0.0, outages=(),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._entries: Dict[Key, _Entry] = {}
        self._buckets: Optional[List[_Bucket]] = None
        self._refresh = PeriodicRefresh(refresh_s, outages) \
            if (refresh_s > 0 or outages) else None
        #: last record computed per key, by any call: what outage
        #: windows freeze for subset callers
        self._last: Dict[Key, PredictionRecord] = {}
        self.dispatches = 0       # bucket device calls issued (telemetry)
        self.batched_predictions = 0

    def add_outage(self, start_s: float, end_s: float):
        """Declare a metric-source blackout window: full-fleet calls
        inside it serve the last snapshot instead of re-querying the
        store."""
        if self._refresh is None:
            self._refresh = PeriodicRefresh(0.0)
        self._refresh.outages = self._refresh.outages + ((start_s, end_s),)

    # ------------------------------------------------------------------
    # registry
    def register(self, artifact: InferenceArtifact, store: MetricsStore):
        key = (artifact.app, artifact.node)
        old = self._entries.get(key)
        if old is not None and old.artifact.version == artifact.version \
                and old.store is store:
            return
        self._entries[key] = _Entry(artifact, store)
        self._buckets = None

    def register_predictor(self, pred) -> bool:
        """Export + register a trained predictor (anything with ``app``,
        ``node``, ``artifact_version``, ``export_artifact()`` and
        ``store``); False if untrained or unchanged since the last
        registration."""
        key = (pred.app, pred.node)
        old = self._entries.get(key)
        if old is not None and old.artifact.version == pred.artifact_version:
            return False
        art = pred.export_artifact()
        if art is None:
            return False
        self.register(art, pred.store)
        return True

    def unregister(self, app: str, node: str):
        if self._entries.pop((app, node), None) is not None:
            self._buckets = None
        self._last.pop((app, node), None)

    def keys(self) -> List[Key]:
        return list(self._entries)

    def __contains__(self, key: Key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    # bucketing
    def _build_buckets(self) -> List[_Bucket]:
        dev = self.device
        groups: Dict[Tuple, List[Tuple[Key, _Entry]]] = {}
        for key, e in self._entries.items():
            a = e.artifact
            # w_points is part of the key: a store shorter than the
            # window clips it, so equal window_s can still mean different
            # gathered shapes across stores
            sig = (a.family, a.window_s, a.k,
                   e.store._w_points(a.window_s),
                   _shape_signature(a.params))
            groups.setdefault(sig, []).append((key, e))

        def stack(rows):
            return torch.as_tensor(np.stack(rows), dtype=torch.float32,
                                   device=dev)
        buckets = []
        for (family, _w, _k, w_pts, _sig), members in groups.items():
            arts = [e.artifact for _, e in members]
            B = len(arts)
            pad = _next_pow2(B) - B
            # pad with copies of the first artifact: well-formed numerics
            # (no NaNs through the models), outputs discarded
            padded = arts + [arts[0]] * pad
            seq = arts[0].sequential
            params = zoo.tree_map(
                lambda *xs: torch.stack([x.to(dev) for x in xs]),
                *[a.params for a in padded])
            lo, hi = (("seq_lo", "seq_hi") if seq
                      else ("scaler_lo", "scaler_hi"))
            buckets.append(_Bucket(
                family=family, sequential=seq,
                keys=[k for k, _ in members], params=params,
                lo=stack([getattr(a, lo) for a in padded]),
                hi=stack([getattr(a, hi) for a in padded]),
                y_lo=stack([a.y_lo for a in padded]),
                y_hi=stack([a.y_hi for a in padded]),
                pad=pad, w_pts=w_pts))
        return buckets

    def buckets(self) -> List[_Bucket]:
        if self._buckets is None:
            self._buckets = self._build_buckets()
        return self._buckets

    # ------------------------------------------------------------------
    # batched prediction
    def _gather_state(self, keys: Sequence[Key]):
        """One batched range query per (store, fast-flag) group.  Returns
        key -> ((k, w) window array, modeled per-request delay, measured
        wall-time share of the group's gather)."""
        groups: Dict[Tuple[int, bool], List[Tuple[Key, _Entry]]] = {}
        for key in keys:
            e = self._entries[key]
            groups.setdefault((id(e.store), e.artifact.fast_state),
                              []).append((key, e))
        out: Dict[Key, Tuple[np.ndarray, float, float]] = {}
        for (_sid, fast), members in groups.items():
            store = members[0][1].store
            reqs = [(e.artifact.metric_names, e.artifact.window_s)
                    for _, e in members]
            t0 = time.perf_counter()
            arrays, delays = store.query_windows(reqs, fast=fast)
            wall = (time.perf_counter() - t0) / len(members)
            for (key, _e), arr, d in zip(members, arrays, delays):
                out[key] = (arr, float(d), wall)
        return out

    def predict_all(self, keys: Optional[Sequence[Key]] = None
                    ) -> Dict[Key, PredictionRecord]:
        """Predict for every registered (app, node), or the given subset,
        in O(buckets) device calls.

        With ``refresh_s`` set, calls within the refresh horizon serve
        the cached full-fleet snapshot (periodic collection, the paper's
        §4 cadence), and subset calls are served from it.  Outage
        windows freeze subset calls too: each key's last computed record
        is served instead of re-querying the store.  Outside outages, an
        outage-only plane (lag 0) computes just the requested keys.
        Keys never computed before an outage began bootstrap once inside
        it, then stay frozen.
        """
        if self._refresh is None or not self._entries:
            return self._predict_now(keys)
        now = next(iter(self._entries.values())).store.clock.now()
        if keys is None:
            return self._refresh.get(now, lambda: self._predict_now(None))
        if self._refresh.in_outage(now):
            cached = {k: self._last[k] for k in keys if k in self._last}
            return cached if cached else self._predict_now(keys)
        if self._refresh.lag_s > 0:
            snapshot = self._refresh.get(
                now, lambda: self._predict_now(None))
            return {k: snapshot[k] for k in keys if k in snapshot}
        return self._predict_now(keys)

    def _predict_now(self, keys=None):
        if keys is None:
            wanted = set(self._entries)
        else:
            wanted = {k for k in keys if k in self._entries}
        if not wanted:
            return {}
        state = self._gather_state(sorted(wanted))
        records: Dict[Key, PredictionRecord] = {}
        for bucket in self.buckets():
            sel = [(i, key) for i, key in enumerate(bucket.keys)
                   if key in wanted]
            if not sel:
                continue
            # full-bucket tensors for subset calls too; unsampled rows
            # stay zero windows through well-formed parameters
            B_pad = len(bucket.keys) + bucket.pad
            e0 = self._entries[bucket.keys[0]]
            windows = np.zeros((B_pad, e0.artifact.k, bucket.w_pts),
                               np.float32)
            for i, key in sel:
                windows[i] = state[key][0]
            t0 = time.perf_counter()
            preds = _bucket_predict(
                bucket.family, bucket.sequential, bucket.params,
                torch.from_numpy(windows).to(self.device), bucket.lo,
                bucket.hi, bucket.y_lo, bucket.y_hi).cpu().numpy()
            wall = (time.perf_counter() - t0) / len(sel)
            self.dispatches += 1
            for i, key in sel:
                e = self._entries[key]
                a = e.artifact
                if e.store.clock.simulated:
                    rec = PredictionRecord(
                        e.store.clock.now(), float(preds[i]), state[key][1],
                        FEATURE_DELAY_PER_METRIC * a.k, a.t_inference,
                        basis="modeled")
                else:
                    # wall basis: features and inference run fused in one
                    # device call, recorded under t_feature
                    rec = PredictionRecord(
                        e.store.clock.now(), float(preds[i]), state[key][2],
                        wall, 0.0, basis="wall")
                rec.t_wall_state = state[key][2]
                rec.t_wall_feature = wall
                records[key] = rec
                self.batched_predictions += 1
        self._last.update(records)
        return records
