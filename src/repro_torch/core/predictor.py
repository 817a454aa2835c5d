"""The predictor's exported data (a copy of the data half of the
reference's ``core/predictor.py``): the modeled feature cost, one
prediction's record and the artifact the prediction plane stacks.  The
predictor's lifecycle (``RTTPredictor``: collection, selection,
training) is not ported yet."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["FEATURE_DELAY_PER_METRIC", "PredictionRecord",
           "InferenceArtifact"]

# modeled feature-extraction cost per selected metric (the same linear
# model Eq. 4's feature_delay budget term uses during (w*, r*, k*)
# selection) — also the t_feature recorded under a simulated clock
FEATURE_DELAY_PER_METRIC = 1e-4


@dataclass
class PredictionRecord:
    t: float
    rtt_pred: float
    t_state: float
    t_feature: float
    t_inference: float
    basis: str = "modeled"    # "modeled" (SimClock) or "wall" (live serving)
    # measured wall deltas of the implementation, kept apart so that
    # t_prediction never mixes time bases
    t_wall_state: float = 0.0
    t_wall_feature: float = 0.0
    t_wall_inference: float = 0.0

    @property
    def t_prediction(self):
        return self.t_state + self.t_feature + self.t_inference

    @property
    def t_wall_prediction(self):
        return self.t_wall_state + self.t_wall_feature + self.t_wall_inference


@dataclass
class InferenceArtifact:
    """A predictor's trained state, exported for fleet-batched inference:
    pure data the :class:`~repro_torch.core.prediction_plane.
    PredictionPlane` stacks with the other artifacts of its bucket."""
    app: str
    node: str
    family: str                      # zoo model name
    sequential: bool
    metric_names: Tuple[str, ...]
    window_s: float
    params: object                   # torch tree (zoo's layout)
    scaler_lo: Optional[np.ndarray]  # (k*F,) feature MinMax (non-sequential)
    scaler_hi: Optional[np.ndarray]
    seq_lo: Optional[np.ndarray]     # (k, 1) raw-window scale (sequential)
    seq_hi: Optional[np.ndarray]
    y_lo: float
    y_hi: float
    t_inference: float               # modeled per-inference cost (Eq. 6)
    fast_state: bool
    version: int                     # bumped by every (re)training

    @property
    def k(self) -> int:
        return len(self.metric_names)
