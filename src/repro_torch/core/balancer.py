"""What the simulation core reads of the policy engine.

The reference keeps full policy classes (``core/balancer.py``) shared by
the simulator, the live router and the benchmarks.  The port's core only
needs each policy's name, the signals it reads, and whether the batched
step has a lowering of its score; the scores themselves are written out
in ``repro_torch.core.simcore``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

#: score added to busy replicas by the idle-first policies, so an idle
#: replica always beats a busy one
BUSY_PENALTY = 1e9


@dataclass(frozen=True)
class PolicySpec:
    name: str
    #: signals the policy reads from the cluster state
    requires: Tuple[str, ...] = ()
    #: the batched step carries a lowering of this policy's score
    scan_lowered: bool = True


POLICIES: Dict[str, PolicySpec] = {p.name: p for p in (
    PolicySpec("round_robin"),
    PolicySpec("random"),
    PolicySpec("least_conn"),
    PolicySpec("perf_aware", requires=("predicted",)),
    PolicySpec("oracle", requires=("actual",)),
)}
