"""Parity contracts: every config knob reaches the port's lowering.

The reference lowers one semantics twice (its serial stepper and its
compiled kernel) and checks that every config field is read by both.
The port has no serial stepper: its one path is the lowering of the
batched core, so the two scopes become one.  This rule family
AST-extracts every dataclass field of ``SimConfig``, ``CapacityConfig``,
``ResilienceConfig`` and ``TraceConfig`` and checks that each is read by
the port's core modules.

Read extraction over-approximates as the reference's does: any
``<expr>.field`` load of a matching attribute name inside a scope counts
as a read of that field, whatever the receiver.  Scopes are per module,
with per-symbol overrides:

* ``read``: a read where the core lowers or runs a configuration;
* ``named``: a read inside ``simulator.unlowered``, which only names a
  refused feature; a field read only there is an error unless it is
  declared in :data:`REFUSED` with a justification;
* ``class-body``: a config class's own body reads nothing at run time;
  a field read only by one of its properties counts where the property
  is read in a ``read`` scope.

A field no scope reads is a knob the port drops silently: an error.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.analysis.registry import AnalysisContext, rule

READ, NAMED, BODY = "read", "named", "class-body"

CORE = "src/repro_torch/core"


@dataclass(frozen=True)
class ModuleScope:
    """One analysed module: default scope + per-top-level-symbol
    overrides (function or class name -> scope)."""
    path: str
    default: str
    overrides: Mapping[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class ContractSpec:
    """Everything the rules need, injectable for fixture tests."""
    config_classes: Mapping[str, str]        # class name -> module path
    scopes: Tuple[ModuleScope, ...]
    refused: Mapping[str, str] = field(default_factory=dict)
    # ScenarioSpec mapping rule inputs (None disables that rule)
    scenario_module: Optional[str] = None
    scenario_class: str = "ScenarioSpec"
    scenario_target: str = "SimConfig"   # the config compile() maps onto
    scenario_extra: Tuple[str, ...] = ("name", "description")


#: Fields the port may only name, each with its justification: a field
#: ``supports()`` refuses (``simulator.unlowered``).  Today the port
#: lowers every field, so this is empty.
REFUSED: Dict[str, str] = {}

#: config class -> the core module that defines it
_CLASSES = {"SimConfig": "simulator", "CapacityConfig": "capacity",
            "ResilienceConfig": "resilience", "TraceConfig": "telemetry",
            "ScenarioSpec": "scenarios"}


def _scope(module: str) -> ModuleScope:
    overrides = {cls: BODY for cls, m in _CLASSES.items() if m == module}
    if module == "simulator":
        overrides["unlowered"] = NAMED
    return ModuleScope(f"{CORE}/{module}.py", READ, overrides)


DEFAULT_SPEC = ContractSpec(
    config_classes={cls: f"{CORE}/{m}.py" for cls, m in _CLASSES.items()
                    if cls != "ScenarioSpec"},
    scopes=tuple(_scope(m) for m in (
        "simulator", "simcore", "online", "campaign", "scenarios",
        "capacity", "resilience", "telemetry")),
    refused=REFUSED,
    scenario_module=f"{CORE}/scenarios.py",
)


def dataclass_fields(tree: ast.Module, class_name: str) -> List[str]:
    """Annotated field names of a (data)class, in declaration order.
    Underscore-prefixed and ClassVar annotations are skipped."""
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            out = []
            for stmt in node.body:
                if not isinstance(stmt, ast.AnnAssign):
                    continue
                if not isinstance(stmt.target, ast.Name):
                    continue
                name = stmt.target.id
                if name.startswith("_"):
                    continue
                if "ClassVar" in ast.unparse(stmt.annotation):
                    continue
                out.append(name)
            return out
    raise KeyError(f"class {class_name} not found")


def _attr_loads(node: ast.AST) -> List[Tuple[str, int]]:
    """All ``<expr>.attr`` loads under ``node`` as (attr, line)."""
    return [(n.attr, n.lineno) for n in ast.walk(node)
            if isinstance(n, ast.Attribute)
            and isinstance(n.ctx, ast.Load)]


def collect_reads(ctx: AnalysisContext, scopes: Sequence[ModuleScope],
                  ) -> Dict[str, Dict[str, List[Tuple[str, int]]]]:
    """field name -> scope -> [(path, line), ...] over all modules."""
    reads: Dict[str, Dict[str, List[Tuple[str, int]]]] = {}
    for ms in scopes:
        tree = ctx.parse(ms.path)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                scope = ms.overrides.get(node.name, ms.default)
            else:
                scope = ms.default
            for attr, line in _attr_loads(node):
                reads.setdefault(attr, {}).setdefault(scope, []).append(
                    (ms.path, line))
    return reads


def property_reads(tree: ast.Module, class_name: str) -> Dict[str, Set[str]]:
    """field -> the properties of ``class_name`` whose bodies read it."""
    out: Dict[str, Set[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and any(
                        getattr(d, "id", None) == "property"
                        for d in fn.decorator_list):
                    for attr, _ in _attr_loads(fn):
                        out.setdefault(attr, set()).add(fn.name)
    return out


def field_coverage(ctx: Optional[AnalysisContext] = None,
                   spec: ContractSpec = DEFAULT_SPEC,
                   ) -> Dict[str, Dict[str, List[Tuple[str, int]]]]:
    """``"Config.field" -> {scope: [(path, line), ...]}`` for every
    contract field, a property's reads counted as ``read`` where the
    property is read in a ``read`` scope: the surface behind the rule."""
    ctx = ctx or AnalysisContext()
    reads = collect_reads(ctx, spec.scopes)
    out: Dict[str, Dict[str, List[Tuple[str, int]]]] = {}
    for cls, mod in spec.config_classes.items():
        tree = ctx.parse(mod)
        props = property_reads(tree, cls)
        for f in dataclass_fields(tree, cls):
            by = {k: list(v) for k, v in reads.get(f, {}).items()}
            for p in sorted(props.get(f, ())):
                by.setdefault(READ, []).extend(reads.get(p, {}).get(READ, []))
            if not by.get(READ):
                by.pop(READ, None)
            out[f"{cls}.{f}"] = by
    return out


def uncovered(ctx: Optional[AnalysisContext] = None,
              spec: ContractSpec = DEFAULT_SPEC) -> List[str]:
    """The contract fields no ``read`` scope reads, directly or through a
    property."""
    return sorted(q for q, by in field_coverage(ctx, spec).items()
                  if not by.get(READ))


def analyze_contracts(ctx: Optional[AnalysisContext] = None,
                      spec: ContractSpec = DEFAULT_SPEC) -> List[Finding]:
    """The parity-read-coverage rule body (spec-injectable for tests)."""
    ctx = ctx or AnalysisContext()
    cov = field_coverage(ctx, spec)
    findings: List[Finding] = []
    for qual, by_scope in cov.items():
        if by_scope.get(READ):
            continue
        mod = spec.config_classes[qual.split(".", 1)[0]]
        if by_scope.get(NAMED):
            if qual in spec.refused:
                continue
            findings.append(Finding(
                "parity-read-coverage", ERROR, mod, qual,
                f"config field {qual} is only named by unlowered(): lower "
                "it in the core, or declare it refused (contracts.REFUSED "
                "+ its supports() rejection)"))
        else:
            findings.append(Finding(
                "parity-read-coverage", ERROR, mod, qual,
                f"config field {qual} is never read by the port's "
                "lowering: the port drops this knob silently, or the read "
                "lives outside the analysed scopes"))
    for qual in spec.refused:
        if qual not in cov:
            findings.append(Finding(
                "parity-read-coverage", ERROR, "", qual,
                f"REFUSED entry {qual} names no known config field"))
    return findings


def analyze_scenario_mapping(ctx: Optional[AnalysisContext] = None,
                             spec: ContractSpec = DEFAULT_SPEC,
                             ) -> List[Finding]:
    """ScenarioSpec -> SimConfig mapping rule body.

    ``ScenarioSpec.compile`` copies exactly the fields whose names are
    ``SimConfig`` fields: a ScenarioSpec field that is not one (and not
    a declared extra) compiles to nothing, silently."""
    ctx = ctx or AnalysisContext()
    if spec.scenario_module is None:
        return []
    sim_mod = spec.config_classes[spec.scenario_target]
    sim_fields = set(dataclass_fields(ctx.parse(sim_mod),
                                      spec.scenario_target))
    findings: List[Finding] = []
    for f in dataclass_fields(ctx.parse(spec.scenario_module),
                              spec.scenario_class):
        if f in sim_fields or f in spec.scenario_extra:
            continue
        findings.append(Finding(
            "scenario-field-mapping", ERROR, spec.scenario_module,
            f"{spec.scenario_class}.{f}",
            f"{spec.scenario_class}.{f} is not a "
            f"{spec.scenario_target} field: compile() drops it silently; "
            "rename it, add the SimConfig field, or declare it in the "
            "spec's scenario_extra"))
    return findings


@rule("parity-read-coverage", "contracts",
      "every SimConfig / CapacityConfig / ResilienceConfig / TraceConfig "
      "field is read by the port's core lowering (or declared refused)")
def _parity_rule(ctx: AnalysisContext) -> List[Finding]:
    return analyze_contracts(ctx)


@rule("scenario-field-mapping", "contracts",
      "every ScenarioSpec field maps onto a SimConfig field (compile() "
      "drops unknown names silently)")
def _scenario_rule(ctx: AnalysisContext) -> List[Finding]:
    return analyze_scenario_mapping(ctx)
