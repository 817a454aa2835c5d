"""Analysis-linter fixture for the port: config definitions and the one
function that only names refused features.

Seeded violations of the parity rule: ``MiniConfig.gamma`` is read by no
scope, ``MiniConfig.delta`` only by ``unlowered`` (a refused feature),
and ``MiniConfig.zeta`` only by a property nobody reads.  ``epsilon`` is
read through the ``scaled`` property, which the lowering reads: covered.
``MiniSpec.extra_knob`` names no MiniConfig field
(scenario-field-mapping).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class MiniConfig:
    alpha: float = 1.0
    beta: int = 2
    gamma: bool = False       # read nowhere: the seeded violation
    delta: float = 0.0        # only named by unlowered()
    epsilon: float = 1.0      # read through the ``scaled`` property
    zeta: float = 0.0         # read by a property nobody reads

    @property
    def scaled(self):
        return self.alpha * self.epsilon

    @property
    def unused(self):
        return self.zeta


@dataclass(frozen=True)
class MiniSpec:
    name: str = ""
    description: str = ""
    alpha: float = 1.0
    extra_knob: float = 0.0   # not a MiniConfig field: compile() drops it


def unlowered(cfg):
    return "delta" if cfg.delta else None
