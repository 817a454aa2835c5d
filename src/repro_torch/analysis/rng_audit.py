"""RNG-stream audit: no raw generators in the port's core, no aliased
streams (the reference's ``analysis/rng_audit.py``).

Two rules:

``rng-raw-constructor``: no raw generator construction anywhere under
``src/repro_torch/core/`` except ``core/rng.py`` itself: numpy's
``np.random.default_rng`` / ``RandomState`` / ``np.random.seed`` and
torch's ``torch.Generator`` / ``torch.manual_seed`` /
``torch.cuda.manual_seed[_all]``.  Every stream in the core goes through
the named-stream helpers (``rng_stream`` / ``rng_seed``) or
``rng_from_key`` for a key pinned outside it.  The sites that must build
a generator (a seeded initialisation the tests are calibrated on, a
device generator a CUDA graph registers) are in the committed baseline
with their reasons.

``rng-stream-uniqueness``: every ``rng_stream(seed, name)`` /
``rng_seed(seed, name)`` call under ``src/repro_torch/`` is collected,
and the literal names are *proven* to map to pairwise-distinct generator
identities by evaluating the port's own ``rng_seed`` on probe seeds
(``core/rng.py::stream_identity``), which finds a crc32 collision
between hashed names or an alias of a legacy offset or salt.  A
non-literal name cannot be proven: a warning.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.analysis.registry import AnalysisContext, rule

#: dotted-suffix patterns of raw constructors (matched against the
#: trailing two components of the call target)
RAW_SUFFIXES = {
    ("random", "default_rng"), ("random", "RandomState"), ("random", "seed"),
    ("torch", "Generator"), ("torch", "manual_seed"),
    ("cuda", "manual_seed"), ("cuda", "manual_seed_all"),
}
#: bare names that count when imported from a ``*.random`` module
RAW_BARE = {"default_rng", "RandomState"}
#: bare names that count when imported from ``torch``
TORCH_BARE = {"Generator", "manual_seed"}

STREAM_HELPERS = ("rng_stream", "rng_seed")

CORE_REL = "src/repro_torch/core"
RNG_MODULE = "src/repro_torch/core/rng.py"
PACKAGE_REL = "src/repro_torch"


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a", "b", "c"); None for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _raw_imported_names(tree: ast.Module) -> set:
    """Locals bound by ``from <...>.random import <raw constructor>`` or
    ``from torch import Generator``."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or not node.module:
            continue
        if node.module.split(".")[-1] == "random":
            names = RAW_BARE
        elif node.module in ("torch", "torch.cuda"):
            names = TORCH_BARE
        else:
            continue
        for alias in node.names:
            if alias.name in names:
                out.add(alias.asname or alias.name)
    return out


class _QualnameVisitor(ast.NodeVisitor):
    """Collects Call nodes tagged with their enclosing dotted qualname
    (``Class.method`` / ``func`` / ``<module>``)."""

    def __init__(self):
        self.stack: List[str] = []
        self.calls: List[Tuple[str, ast.Call]] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scoped

    def visit_Call(self, node: ast.Call):
        self.calls.append((self.qualname, node))
        self.generic_visit(node)


def _calls_with_qualnames(tree: ast.Module) -> List[Tuple[str, ast.Call]]:
    v = _QualnameVisitor()
    v.visit(tree)
    return v.calls


def core_modules(ctx: AnalysisContext) -> List[str]:
    root = ctx.path(CORE_REL)
    return sorted(Path(p.relative_to(ctx.root)).as_posix()
                  for p in root.glob("*.py"))


def find_raw_constructors(ctx: Optional[AnalysisContext] = None,
                          modules: Optional[List[str]] = None,
                          ) -> List[Finding]:
    """``rng-raw-constructor`` rule body (module list injectable)."""
    ctx = ctx or AnalysisContext()
    modules = core_modules(ctx) if modules is None else modules
    findings: List[Finding] = []
    for rel in modules:
        if Path(rel).as_posix() == RNG_MODULE:
            continue
        tree = ctx.parse(rel)
        bare = _raw_imported_names(tree)
        counts: Dict[Tuple[str, str], int] = {}
        for qual, call in _calls_with_qualnames(tree):
            dotted = _dotted(call.func)
            if dotted is None:
                continue
            name = ".".join(dotted)
            hit = tuple(dotted[-2:]) in RAW_SUFFIXES \
                or (len(dotted) == 1 and dotted[0] in bare)
            if not hit:
                continue
            ordinal = counts.setdefault((qual, name), 0)
            counts[(qual, name)] += 1
            findings.append(Finding(
                "rng-raw-constructor", ERROR, rel,
                f"{qual}:{name}#{ordinal}",
                f"raw rng constructor {name}() in core/: draw from a "
                "core/rng.py named stream (rng_stream / rng_seed) or, for "
                "an externally pinned key, rng_from_key",
                line=call.lineno))
    return findings


def collect_stream_names(ctx: Optional[AnalysisContext] = None,
                         root_rel: str = PACKAGE_REL,
                         ) -> Tuple[List[Tuple[str, str, int]],
                                    List[Tuple[str, str, int]]]:
    """All STREAM_HELPERS call sites under ``root_rel``.

    Returns (literal, dynamic): literal entries are ``(stream_name, path,
    line)``; dynamic entries are ``(qualname, path, line)`` for call
    sites whose name argument is not a string literal."""
    ctx = ctx or AnalysisContext()
    literal, dynamic = [], []
    for p in sorted(ctx.path(root_rel).rglob("*.py")):
        rel = Path(p.relative_to(ctx.root)).as_posix()
        if rel == RNG_MODULE:
            continue       # the helpers' own definitions
        tree = ctx.parse(rel)
        for qual, call in _calls_with_qualnames(tree):
            dotted = _dotted(call.func)
            if dotted is None or dotted[-1] not in STREAM_HELPERS:
                continue
            name_arg = call.args[1] if len(call.args) >= 2 else None
            for kw in call.keywords:
                if kw.arg == "name":
                    name_arg = kw.value
            if isinstance(name_arg, ast.Constant) \
                    and isinstance(name_arg.value, str):
                literal.append((name_arg.value, rel, call.lineno))
            else:
                dynamic.append((qual, rel, call.lineno))
    return literal, dynamic


def check_stream_uniqueness(ctx: Optional[AnalysisContext] = None,
                            root_rel: str = PACKAGE_REL) -> List[Finding]:
    """``rng-stream-uniqueness`` rule body."""
    from repro_torch.core.rng import stream_identity
    ctx = ctx or AnalysisContext()
    literal, dynamic = collect_stream_names(ctx, root_rel)
    findings: List[Finding] = []
    # two names alias iff rng_seed agrees on them for independent probe
    # seeds (legacy offsets give ints, hashed names (salt, seed) tuples)
    ident: Dict[Tuple, str] = {}
    for name in sorted({n for n, _, _ in literal}):
        probe = stream_identity(name)
        other = ident.get(probe)
        if other is not None and other != name:
            sites = [(p, ln) for n, p, ln in literal if n == name]
            findings.append(Finding(
                "rng-stream-uniqueness", ERROR, sites[0][0],
                f"collision:{other}~{name}",
                f"stream names {other!r} and {name!r} map to the same "
                f"generator identity {probe[0]!r}: their draws are "
                "correlated; rename one (crc32 / legacy-salt collision)",
                line=sites[0][1]))
        ident[probe] = name
    for qual, rel, line in dynamic:
        findings.append(Finding(
            "rng-stream-uniqueness", WARNING, rel,
            f"dynamic-name:{qual}",
            "stream name is not a string literal: uniqueness cannot be "
            "proven statically; prefer literal names or document the "
            "namespace the dynamic name draws from",
            line=line))
    return findings


@rule("rng-raw-constructor", "rng",
      "no raw numpy / torch generator construction in core/ outside "
      "core/rng.py")
def _raw_rule(ctx: AnalysisContext) -> List[Finding]:
    return find_raw_constructors(ctx)


@rule("rng-stream-uniqueness", "rng",
      "literal rng stream names map to pairwise-distinct generator "
      "identities")
def _uniq_rule(ctx: AnalysisContext) -> List[Finding]:
    return check_stream_uniqueness(ctx)
