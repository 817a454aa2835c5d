"""Static contract linter for the port's simulation core (the
counterpart of the reference's ``analysis`` package, over
``src/repro_torch/`` only).

Three rule families: the parity contracts
(:mod:`~repro_torch.analysis.contracts`), the RNG streams
(:mod:`~repro_torch.analysis.rng_audit`) and the step audit
(:mod:`~repro_torch.analysis.step_audit`: device reads, carry storage,
scatter budget and hashable statics of every distinct request-loop
step).  Run it as ``python -m repro_torch.analysis``; the exit status is
0 if and only if no error finding survives the committed baseline.
"""
from repro_torch.analysis.baseline import (BaselineEntry, MatchResult,
                                           load_baseline, match)
from repro_torch.analysis.findings import (ERROR, INFO, SEVERITIES, WARNING,
                                           Finding)
from repro_torch.analysis.registry import (RULES, AnalysisContext, Rule,
                                           load_rules, rule, run_rules)

__all__ = [
    "AnalysisContext", "BaselineEntry", "ERROR", "Finding", "INFO",
    "MatchResult", "RULES", "Rule", "SEVERITIES", "WARNING",
    "load_baseline", "load_rules", "match", "rule", "run_rules",
]
