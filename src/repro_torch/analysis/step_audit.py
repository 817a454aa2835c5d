"""Step audit: the purity, carry and scatter checks of every distinct
request-loop step (the counterpart of the reference's
``analysis/jaxpr_audit.py``).

The reference traces each distinct compiled kernel to a jaxpr and walks
it.  The port's step is PyTorch ops run by Python (``simcore._step_fn``),
so the audit *runs* each distinct step, one step at a time, under a
``TorchDispatchMode`` that records the aten ops it dispatches.  The
steps are enumerated as the reference's ``kernel_specs`` does: the
registered scenarios x the default policies and the oracle, deduplicated
by ``_Static`` (the key of the loop cache) and labelled from its feature
flags.  Each runs at two trials and :data:`AUDIT_REQUESTS` requests, at
1 / :data:`RATE_DIVISOR` of its scenario's arrival rate: the static is
the same, and every host-known event (churn, drift, cold start's end,
the gray window, retrains, autoscaler epochs, preemption) falls within
the audited requests.  A host-flag branch of the static that no audited
step took is a warning.

A hand-written kernel's wrapper counts as one call, ``kernel:<name>``:
the recorder is an open count of ``kernels.work`` (the wrapper records
its call there), and the plain version a CPU tensor takes runs under
``work.uncounted()``, which the recorder leaves out; allocations are not
counted either.  So a CPU run and a card run count the same ops.

Rules, with the reference's names:

* ``kernel-purity``: a device read inside a step (``_local_scalar_dense``
  / ``item``, ``equal``, ``nonzero``, ``masked_select``, ``unique``, a
  boolean-mask index, a copy from the card to the host): the
  counterparts of a host callback and of a dynamic shape, each of which
  breaks CUDA-graph capture; and a carry tensor of ``s`` or ``ys`` whose
  dtype, shape or storage changes across steps, the counterpart of a
  weak-typed carry (a rebound tensor is one a captured graph never
  sees).  Errors in every static; the capacity plane's documented
  completion-fold read is baselined with its reason.
* ``kernel-scatter-budget``: scatter-family ops in one step against
  :data:`DEFAULT_SCATTER_BUDGET`.
* ``kernel-static-hashable``: ``_Static`` keys the loop cache and must
  hash.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.analysis.registry import AnalysisContext, rule

#: scatter-family aten ops (the overload packet's name without a
#: trailing underscore) counted against the budget
SCATTER_OPS = frozenset({"index_put", "_index_put_impl", "scatter",
                         "scatter_add", "scatter_reduce", "index_add",
                         "index_copy", "index_fill", "masked_scatter"})
#: ops whose result depends on reading the device's data on the host
DEVICE_READS = frozenset({"_local_scalar_dense", "item", "equal",
                          "nonzero", "nonzero_static", "masked_select",
                          "_unique", "_unique2", "unique_dim",
                          "unique_consecutive", "unique_dim_consecutive"})
#: ops that index by their index tensors: a boolean one is a mask
INDEXING = frozenset({"index", "index_put", "_index_put_impl"})
#: ops that allocate without computing: not counted
ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided"})

#: calibrated ceiling for scatter-family ops in one step.  Measured on
#: this tree (``scatter_counts()``, two trials): 4 for the reactive
#: policies' plain, churn, drift and cold-start steps, 5-7 for the
#: predictive ones and the snapshot, 5-8 with the capacity plane, 9 for
#: the closed loop; the client plane unrolls ``1 + max_retries`` attempts
#: (7-8 for the reactive policies, 14-17 for perf_aware and the oracle,
#: whose count carry takes a dispatch an attempt), and the steps over the
#: ceiling are baselined with their counts.  Raising it is a review
#: decision, not a tweak.
DEFAULT_SCATTER_BUDGET = 9

SIMCORE_PATH = "src/repro_torch/core/simcore.py"
#: requests a static is audited over, and the arrival-rate divisor that
#: brings every host-known event of a registered scenario inside them
AUDIT_REQUESTS = 16
AUDIT_TRIALS = 2
RATE_DIVISOR = 16


@dataclass(frozen=True)
class StepSpec:
    """One distinct step + the (scenario, policy) cells that reach it.
    ``label`` is derived from ``_Static``'s feature flags, not scenario
    names, so baseline keys survive scenario renames."""
    static: object               # simcore._Static
    cfg: object                  # a representative audit SimConfig
    policy: str
    label: str
    cells: Tuple[Tuple[str, str], ...]


@dataclass
class StepRecord:
    """What running one static's steps showed: every dispatched op and
    kernel call summed over the steps, the most scatter-family ops in
    one step, the device reads (op -> (count, first step)), the carry
    changes ((key, what) -> first step) and the host-flag branches of
    the static that no step took."""
    label: str
    ops: Counter = field(default_factory=Counter)
    max_scatters: int = 0
    reads: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    carry: Dict[Tuple[str, str], int] = field(default_factory=dict)
    missed: Tuple[str, ...] = ()
    graphable: bool = False


def static_label(st) -> str:
    """The reference's ``static_label`` (the port's ``_Static`` has no
    separate preemption flag; spot preemption is in ``capacity``)."""
    feats = []
    if st.hedging:
        feats.append("hedge")
    if st.closed_loop:
        feats.append("closed")
    elif st.needs_pred:
        feats.append("pred")
    if st.snapshot:
        feats.append("snap")
    if st.cold_start:
        feats.append("cold")
    if st.churn:
        feats.append("churn")
    if st.drift:
        feats.append("drift")
    if st.capacity is not None:
        feats.append(f"cap[{st.capacity.autoscaler}]")
    if st.admission:
        feats.append("admit")
    if st.resilience is not None:
        r = [f for f, on in (("client", st.res_client),
                             ("breaker", st.res_breaker)) if on]
        feats.append("res[" + ",".join(r or ["faults"]) + "]")
    if st.native_noise:
        feats.append("native")
    return st.policy + ":" + ("+".join(feats) if feats else "plain")


def step_specs(scenarios: Optional[Sequence[str]] = None,
               policies: Optional[Sequence[str]] = None,
               n_trials: int = AUDIT_TRIALS,
               n_requests: int = AUDIT_REQUESTS) -> List[StepSpec]:
    """Distinct steps of the (``scenarios`` x ``policies``) cells, each
    with the audit config of its first such cell.  Labels are numbered
    over the whole registry x the default policies and the oracle, so a
    subset's labels (and their baseline keys) are the full grid's."""
    from repro_torch.core.campaign import DEFAULT_POLICIES
    from repro_torch.core.scenarios import get_scenario, scenario_names
    from repro_torch.core.simcore import _static_for, supports

    grid = DEFAULT_POLICIES + ("oracle",)
    wanted_s = set(scenarios or scenario_names())
    wanted_p = set(policies or grid)
    names = list(scenario_names()) + sorted(wanted_s - set(scenario_names()))
    pols = list(grid) + sorted(wanted_p - set(grid))
    by_static: Dict[object, List] = {}
    for sname in names:
        cfg = get_scenario(sname).compile(seed=0, n_trials=n_trials,
                                          n_requests=n_requests)
        cfg = replace(cfg, arrival_rate=cfg.arrival_rate / RATE_DIVISOR)
        for pol in pols:
            if supports(cfg, pol) is not None:
                continue
            st = _static_for(cfg, pol)
            by_static.setdefault(st, []).append((sname, pol, cfg))
    out: List[StepSpec] = []
    label_counts: Dict[str, int] = {}
    for st, cells in by_static.items():
        label = static_label(st)
        n = label_counts.setdefault(label, 0)
        label_counts[label] += 1
        if n:
            label = f"{label}#{n}"     # distinct statics, same flags
        cells = [c for c in cells if c[0] in wanted_s and c[1] in wanted_p]
        if cells:
            out.append(StepSpec(
                static=st, cfg=cells[0][2], policy=cells[0][1], label=label,
                cells=tuple((s, p) for s, p, _ in cells)))
    return sorted(out, key=lambda s: s.label)


class StepRecorder(TorchDispatchMode):
    """Records each dispatched aten op of a step by name, and each
    hand-written kernel's call (as an open count of ``kernels.work``);
    the ops of a kernel's plain version (``work.uncounted()``) and
    allocations are left out."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.reads: Counter = Counter()
        self._skip = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._skip or func._opname in ALLOCATIONS:
            return out
        name = func._opname
        self.ops[name] += 1
        base = name.rstrip("_")
        if base in DEVICE_READS:
            self.reads[base] += 1
        elif base in INDEXING and any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8)
                for i in (args[1] if len(args) > 1 else ()) or ()):
            self.reads["bool-mask-index"] += 1
        elif base in ("_to_copy", "copy") and isinstance(out, torch.Tensor) \
                and out.device.type == "cpu" and any(
                    isinstance(a, torch.Tensor) and a.device.type != "cpu"
                    for a in args):
            self.reads["copy-to-host"] += 1
        return out

    # the ``kernels.work`` count interface
    def add_kernel(self, name: str, nbytes: float, ops: float) -> None:
        self.ops[f"kernel:{name}"] += 1

    @contextlib.contextmanager
    def excluded(self):
        self._skip += 1
        try:
            yield
        finally:
            self._skip -= 1


def _carry_meta(s: Dict) -> Dict[str, Tuple]:
    out = {}
    for k, v in list(s.items()) + [(f"ys.{k}", v)
                                   for k, v in s.get("ys", {}).items()]:
        if isinstance(v, torch.Tensor):
            out[k] = (v.dtype, tuple(v.shape), v.data_ptr())
    return out


def record_run(label: str, step, s: Dict, n_steps: int,
               graphable: bool = True) -> StepRecord:
    """Run ``step(j)`` for j < ``n_steps`` under a :class:`StepRecorder`
    a step, watching the carry ``s`` (and its ``ys``) for a tensor whose
    dtype, shape or storage changes."""
    from repro_torch.kernels import work

    rec = StepRecord(label=label, graphable=graphable)
    before = _carry_meta(s)
    for j in range(n_steps):
        recorder = StepRecorder()
        work.OPEN.append(recorder)
        try:
            with recorder:
                step(j)
        finally:
            work.OPEN.remove(recorder)
        rec.ops.update(recorder.ops)
        rec.max_scatters = max(rec.max_scatters, sum(
            n for op, n in recorder.ops.items()
            if op.rstrip("_") in SCATTER_OPS))
        for op, n in recorder.reads.items():
            count, first = rec.reads.get(op, (0, j))
            rec.reads[op] = (count + n, first)
        after = _carry_meta(s)
        for k in sorted(set(before) | set(after)):
            b, a = before.get(k), after.get(k)
            for i, what in enumerate(("dtype", "shape", "storage")):
                if b is None or a is None or a[i] != b[i]:
                    rec.carry.setdefault((k, what), j)
        before = after
    return rec


def _branches(st, plan, J: int) -> Dict[str, bool]:
    """The static's host-flag branches -> whether an audited step took
    each (a drift static must run both regimes, a cold start both
    sides of its end)."""
    from repro_torch.core.simcore import _count_flags
    flags = {}
    steps = range(J)

    def took(name, value=True):
        return any(bool(plan[name][j]) == value for j in steps)

    _, need_live, _ = _count_flags(st)
    kinds = {kind for j in steps for kind, _, _ in plan["events"].get(j, ())}
    if st.churn is not None:
        flags["event:churn"] = "churn" in kinds
    if st.group is not None:
        flags["event:group_down"] = "group_down" in kinds
    if need_live and (st.churn is not None or st.group is not None):
        flags["bump"] = took("bump")
    if st.capacity is not None:
        flags["event:scale"] = "scale" in kinds
    if st.snapshot:
        flags["refresh"] = took("refresh")
    if st.drift:
        flags["drift:pre"] = took("drift", False)
        flags["drift:post"] = took("drift")
    if st.cold_start:
        flags["cold:on"] = took("cold")
        flags["cold:off"] = took("cold", False)
    if st.gray is not None:
        flags["gray"] = took("gray")
    if st.closed_loop:
        flags["retrain"] = took("retrain")
    if st.trace_every:
        flags["trace"] = True          # step 0 is always sampled
    return flags


def record_step(spec: StepSpec, device=None) -> StepRecord:
    """Run ``spec``'s steps one at a time on ``device`` (None: the CUDA
    card) under a :class:`StepRecorder`."""
    from repro_torch.core import simcore
    from repro_torch.core.simulator import _build_cluster
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cluster = _build_cluster(spec.cfg)
    st, consts, plan = simcore._lower(cluster, spec.policy)
    c = {k: torch.as_tensor(v, device=dev) for k, v in consts.items()}
    T, J = spec.cfg.n_trials, spec.cfg.n_requests
    s = simcore._new_carry(st, T, J, dev)
    block, _ = simcore._step_fn(st, c, plan, s)
    rec = record_run(spec.label, lambda j: block(j, 1), s, J,
                     simcore._graphable(st))
    rec.missed = tuple(sorted(f for f, ran in _branches(st, plan, J).items()
                              if not ran))
    return rec


def record_steps(scenarios: Optional[Sequence[str]] = None,
                 policies: Optional[Sequence[str]] = None,
                 device=None) -> List[StepRecord]:
    """:func:`record_step` of every distinct step of the grid."""
    return [record_step(spec, device) for spec in step_specs(scenarios,
                                                             policies)]


def audit_static(st, label: str) -> List[Finding]:
    """``_Static`` (the loop cache's key) must stay hashable: an
    unhashable field silently defeats the cache."""
    try:
        hash(st)
    except TypeError as e:
        return [Finding(
            "kernel-static-hashable", ERROR, SIMCORE_PATH,
            f"{label}:unhashable",
            f"_Static of step {label} is not hashable ({e}): the loop "
            "cache keys on it; every call rebuilds the loop")]
    return []


def audit_record(rec: StepRecord,
                 scatter_budget: int = DEFAULT_SCATTER_BUDGET,
                 ) -> List[Finding]:
    """The purity and budget findings of one recorded step."""
    findings: List[Finding] = []
    capture = "breaks its CUDA-graph capture" if rec.graphable else \
        "puts a host sync in every such step"
    for op, (n, first) in sorted(rec.reads.items()):
        findings.append(Finding(
            "kernel-purity", ERROR, SIMCORE_PATH,
            f"{rec.label}:device-read:{op}",
            f"step {rec.label} reads the device {n} time(s) by {op} "
            f"(first at step {first}): a device-to-host round trip "
            f"inside the step {capture}"))
    for (k, what), first in sorted(rec.carry.items()):
        findings.append(Finding(
            "kernel-purity", ERROR, SIMCORE_PATH,
            f"{rec.label}:carry:{k}:{what}",
            f"step {rec.label} changes the {what} of carry tensor {k} "
            f"(at step {first}): a captured graph replays fixed "
            "addresses, dtypes and shapes; update it in place"))
    for flag in rec.missed:
        findings.append(Finding(
            "kernel-purity", WARNING, SIMCORE_PATH,
            f"{rec.label}:branch:{flag}",
            f"no audited step of {rec.label} took its host-flag branch "
            f"{flag}: that branch is unaudited"))
    if rec.max_scatters > scatter_budget:
        findings.append(Finding(
            "kernel-scatter-budget", ERROR, SIMCORE_PATH,
            f"{rec.label}:scatters",
            f"step {rec.label} dispatches {rec.max_scatters} "
            f"scatter-family ops in one step (budget {scatter_budget}): "
            "each is its own kernel and pass over its target"))
    return findings


def audit_steps(scenarios: Optional[Sequence[str]] = None,
                policies: Optional[Sequence[str]] = None,
                scatter_budget: int = DEFAULT_SCATTER_BUDGET,
                device=None) -> List[Finding]:
    """Every rule's findings over the grid's distinct steps, run on
    ``device`` (None: the CUDA card; the linter passes ``"cpu"``)."""
    findings: List[Finding] = []
    for spec in step_specs(scenarios, policies):
        findings.extend(audit_static(spec.static, spec.label))
        findings.extend(audit_record(record_step(spec, device),
                                     scatter_budget))
    return sorted(findings)


def scatter_counts(scenarios: Optional[Sequence[str]] = None,
                   policies: Optional[Sequence[str]] = None,
                   device=None) -> Dict[str, int]:
    """Per-step scatter-family counts (the budget's calibration)."""
    return {r.label: r.max_scatters
            for r in record_steps(scenarios, policies, device)}


def _cached_audit(ctx: AnalysisContext) -> List[Finding]:
    if "step-audit" not in ctx.cache:
        ctx.cache["step-audit"] = audit_steps(device="cpu")
    return ctx.cache["step-audit"]


@rule("kernel-purity", "step",
      "no device read (item, nonzero, masked_select, unique, a boolean "
      "mask, a copy to the host) and no rebound carry tensor in any "
      "distinct request-loop step")
def _purity_rule(ctx: AnalysisContext) -> List[Finding]:
    return [f for f in _cached_audit(ctx) if f.rule == "kernel-purity"]


@rule("kernel-scatter-budget", "step",
      "scatter-family ops in one step stay within the calibrated budget")
def _scatter_rule(ctx: AnalysisContext) -> List[Finding]:
    return [f for f in _cached_audit(ctx)
            if f.rule == "kernel-scatter-budget"]


@rule("kernel-static-hashable", "step",
      "every distinct step's _Static (the loop cache's key) hashes")
def _hashable_rule(ctx: AnalysisContext) -> List[Finding]:
    return [f for f in _cached_audit(ctx)
            if f.rule == "kernel-static-hashable"]
