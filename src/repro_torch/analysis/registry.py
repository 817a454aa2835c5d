"""Rules registry + analysis context (the reference's
``analysis/registry.py``).

Rules are plain functions ``fn(ctx) -> List[Finding]`` registered with
the :func:`rule` decorator.  The CLI runs every registered rule (or a
``--rules`` subset) against one :class:`AnalysisContext`, which pins the
repo root and caches parsed ASTs so the three rule families share one
pass over the source tree, and the step audit's records so its three
rules share one run of the steps.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.findings import Finding

#: Rule families: the parity contracts, the RNG streams, the step audit
#: (the reference's ``jaxpr`` family, over the port's request-loop step)
FAMILIES = ("contracts", "rng", "step")


@dataclass(frozen=True)
class Rule:
    name: str
    family: str
    description: str
    fn: Callable[["AnalysisContext"], List[Finding]]


RULES: Dict[str, Rule] = {}


def rule(name: str, family: str, description: str):
    """Register an analysis rule.  Names are unique; re-registration is
    an error (it would silently shadow a rule in the CLI)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown rule family {family!r}")

    def deco(fn):
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name, family, description, fn)
        return fn
    return deco


def _default_root() -> Path:
    # src/repro_torch/analysis/registry.py -> the repo root is three up
    return Path(__file__).resolve().parents[3]


@dataclass
class AnalysisContext:
    """Repo root + per-run AST cache handed to every rule."""
    root: Path = field(default_factory=_default_root)
    _asts: Dict[str, ast.Module] = field(default_factory=dict)
    #: scratch shared across rules in one run (the step audit records
    #: the steps once and its three rules read the records)
    cache: Dict[str, object] = field(default_factory=dict)

    def path(self, rel: str) -> Path:
        return self.root / rel

    def parse(self, rel: str) -> ast.Module:
        if rel not in self._asts:
            src = (self.root / rel).read_text()
            self._asts[rel] = ast.parse(src, filename=rel)
        return self._asts[rel]


def load_rules() -> Dict[str, Rule]:
    """Import the rule modules (registration is an import side effect)
    and return the registry."""
    from repro_torch.analysis import (contracts, rng_audit,  # noqa: F401
                                      step_audit)
    return RULES


def run_rules(ctx: Optional[AnalysisContext] = None,
              names: Optional[List[str]] = None) -> List[Finding]:
    """Run the named rules (default: all) and return sorted findings."""
    registry = load_rules()
    ctx = ctx or AnalysisContext()
    if names is None:
        names = sorted(registry)
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise KeyError(f"unknown rules: {unknown}; "
                       f"available: {sorted(registry)}")
    out: List[Finding] = []
    for n in names:
        out.extend(registry[n].fn(ctx))
    return sorted(out)
