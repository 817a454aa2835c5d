"""The port's contract linter (``repro_torch.analysis``), one case for each
test of the reference's ``tests/test_analysis.py`` and the step audit's
own fixtures.

1. fixtures: one seeded violation per rule under
   ``tests/fixtures/analysis_torch/`` (and step functions built here),
   each rule firing exactly there;
2. the clean tree: no gating finding above the committed baseline, the
   whole step grid included (~5 s on one CPU);
3. consistency: the linter's coverage agrees with
   ``tests/test_torch_contracts.py``'s reading and with ``supports()``,
   and deleting a read on a copy of the tree makes the parity rule fire.
"""
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import (AnalysisContext, load_baseline, match,
                                  run_rules)
from repro_torch.analysis import baseline as bl
from repro_torch.analysis import contracts as C
from repro_torch.analysis import rng_audit as R
from repro_torch.analysis import step_audit as S
from repro_torch.analysis.findings import ERROR, WARNING, Finding

REPO = Path(__file__).resolve().parents[1]
FIX = "tests/fixtures/analysis_torch"

FIXTURE_SPEC = C.ContractSpec(
    config_classes={"MiniConfig": f"{FIX}/config_mod.py"},
    scopes=(
        C.ModuleScope(f"{FIX}/config_mod.py", C.READ,
                      {"MiniConfig": C.BODY, "MiniSpec": C.BODY,
                       "unlowered": C.NAMED}),
        C.ModuleScope(f"{FIX}/lowering_mod.py", C.READ, {}),
    ),
    scenario_module=f"{FIX}/config_mod.py",
    scenario_class="MiniSpec",
    scenario_target="MiniConfig",
)
STATIC_RULES = ["parity-read-coverage", "scenario-field-mapping",
                "rng-raw-constructor", "rng-stream-uniqueness"]
STEP_RULES = ["kernel-purity", "kernel-scatter-budget",
              "kernel-static-hashable"]


def _ctx(root=REPO):
    return AnalysisContext(root=Path(root))


@pytest.fixture(scope="module")
def step_findings():
    """The step audit over the whole grid on the CPU, once."""
    return S.audit_steps(device="cpu")


# ---------------------------------------------------------------- fixtures

def test_parity_rule_fires_exactly_on_seeded_fields():
    found = C.analyze_contracts(_ctx(), FIXTURE_SPEC)
    assert [f.key for f in found] == ["MiniConfig.gamma", "MiniConfig.delta",
                                      "MiniConfig.zeta"]
    assert all(f.severity == ERROR for f in found)
    assert "never read" in found[0].message
    assert "only named by unlowered" in found[1].message
    # epsilon counts through the property the lowering reads
    cov = C.field_coverage(_ctx(), FIXTURE_SPEC)
    assert cov["MiniConfig.epsilon"].get(C.READ)
    assert not cov["MiniConfig.zeta"].get(C.READ)


def test_parity_rule_respects_the_refused_allowlist():
    spec = C.ContractSpec(
        config_classes=FIXTURE_SPEC.config_classes,
        scopes=FIXTURE_SPEC.scopes,
        refused={"MiniConfig.delta": "fixture: refused by supports()"})
    assert [f.key for f in C.analyze_contracts(_ctx(), spec)] \
        == ["MiniConfig.gamma", "MiniConfig.zeta"]
    # a declaration of a field nobody names still leaves it unread, and a
    # typo'd declaration is itself an error
    spec2 = C.ContractSpec(
        config_classes=FIXTURE_SPEC.config_classes,
        scopes=FIXTURE_SPEC.scopes,
        refused={"MiniConfig.delta": "ok", "MiniConfig.gamma": "ok",
                 "MiniConfig.no_such_field": "typo"})
    keys = [f.key for f in C.analyze_contracts(_ctx(), spec2)]
    assert keys == ["MiniConfig.gamma", "MiniConfig.zeta",
                    "MiniConfig.no_such_field"]


def test_scenario_mapping_rule_fires_on_dropped_knob():
    found = C.analyze_scenario_mapping(_ctx(), FIXTURE_SPEC)
    assert [f.key for f in found] == ["MiniSpec.extra_knob"]
    assert "drops it silently" in found[0].message


def test_rng_raw_constructor_fires_on_each_seeded_site():
    found = R.find_raw_constructors(_ctx(), modules=[f"{FIX}/rng_mod.py"])
    assert [f.key for f in found] == [
        "raw_np:np.random.default_rng#0", "raw_torch:torch.Generator#0",
        "raw_cuda:torch.cuda.manual_seed_all#0", "raw_bare:Generator#0"]
    assert all(f.severity == ERROR for f in found)


def test_rng_uniqueness_proves_crc32_collision():
    found = R.check_stream_uniqueness(_ctx(), root_rel=FIX)
    errors = [f for f in found if f.severity == ERROR]
    warnings = [f for f in found if f.severity == WARNING]
    assert len(errors) == 1
    assert "gauge-probe-8" in errors[0].message
    assert "wedge-wedge-96" in errors[0].message
    # the non-literal name in dynamic() warns but does not gate
    assert [w.key for w in warnings] == ["dynamic-name:dynamic"]


def _carry():
    return {"x": torch.zeros(4, dtype=torch.float64),
            "ys": {"out": torch.zeros((3, 4), dtype=torch.float64)}}


def _audit(label, step, s=None, n=3, budget=S.DEFAULT_SCATTER_BUDGET):
    s = _carry() if s is None else s
    return S.audit_record(S.record_run(label, lambda j: step(s, j), s, n),
                          budget)


def _keys(found):
    return [f.key for f in found]


def test_step_audit_flags_a_rebound_carry_and_a_scatter_chain():
    """The reference's weak-carry and scatter-chain cases: a carry tensor
    rebound (its storage moves), one whose dtype changes, and a chain of
    scatters over a budget that the same step meets under a larger
    one."""
    def rebind(s, j):
        s["x"] = s["x"] + 1.0

    assert _keys(_audit("fx-rebind", rebind)) == ["fx-rebind:carry:x:storage"]

    def retype(s, j):
        s["ys"]["out"] = s["ys"]["out"].to(torch.float32)

    assert _keys(_audit("fx-dtype", retype)) == [
        "fx-dtype:carry:ys.out:dtype", "fx-dtype:carry:ys.out:storage"]

    def chain(s, j):
        x, i = s["x"], torch.tensor([0, 1])
        x.index_put_((i,), torch.ones(2, dtype=x.dtype))
        x.scatter_add_(0, i, torch.ones(2, dtype=x.dtype))
        s["ys"]["out"].index_copy_(0, torch.tensor([j]), x[None])

    found = _audit("fx-chain", chain, budget=2)
    assert _keys(found) == ["fx-chain:scatters"]
    assert found[0].rule == "kernel-scatter-budget"
    assert "3 scatter-family ops" in found[0].message
    assert _audit("fx-chain", chain, budget=3) == []


def test_step_audit_flags_device_reads():
    """The reference's host-callback case: ``.item()`` and a
    boolean-mask index each read the device inside a step."""
    def item(s, j):
        s["x"].add_(s["x"].sum().item())

    found = _audit("fx-item", item)
    assert _keys(found) == ["fx-item:device-read:_local_scalar_dense"]
    assert found[0].rule == "kernel-purity" and found[0].gating
    assert "3 time(s)" in found[0].message

    def mask(s, j):
        y = s["x"][s["x"] >= 0]
        s["x"].add_(y.sum())

    assert _keys(_audit("fx-mask", mask)) == [
        "fx-mask:device-read:bool-mask-index"]

    def pure(s, j):
        s["x"].add_(torch.where(s["x"] >= 0, 1.0, 0.0))
        s["ys"]["out"].index_copy_(0, torch.tensor([j]), s["x"][None])

    assert _audit("fx-pure", pure) == []


def test_step_audit_counts_a_kernel_wrapper_as_one_call():
    """On CPU tensors the segment sum's plain version runs under
    ``work.uncounted()``: the step counts one ``kernel:segment_sum`` and
    none of the plain version's ops (its ``scatter_add_``)."""
    from repro_torch.kernels.segment_sum import segment_sum
    vals = torch.ones((2, 5), dtype=torch.float64)
    ids = torch.tensor([[0, 1, 1, 2, 9]] * 2, dtype=torch.int32)

    s = _carry()

    def step(j):
        s["x"].copy_(segment_sum(vals, ids, 4)[0])

    rec = S.record_run("fx-kernel", step, s, 2)
    assert rec.ops["kernel:segment_sum"] == 2
    assert "scatter_add_" not in rec.ops and rec.max_scatters == 0
    assert S.audit_record(rec) == []


def test_step_audit_warns_on_a_branch_no_step_took():
    rec = S.StepRecord(label="fx-branch", missed=("drift:post",))
    found = S.audit_record(rec)
    assert _keys(found) == ["fx-branch:branch:drift:post"]
    assert found[0].severity == WARNING and not found[0].gating


def test_static_hashability_audit():
    class Bad:
        __hash__ = None
    assert S.audit_static(Bad(), "fx-bad") != []
    assert S.audit_static((1, 2, "ok"), "fx-ok") == []


# ------------------------------------------------------------- clean tree

def test_clean_tree_static_rules_above_baseline():
    """contracts + rng rules on the real tree: nothing gates."""
    findings = run_rules(_ctx(), STATIC_RULES)
    entries = [e for e in load_baseline() if e.rule in STATIC_RULES]
    result = match(findings, entries)
    gating = [f for f in result.new if f.gating]
    assert gating == [], [f.render() for f in gating]
    assert result.stale == [], result.stale


def test_clean_tree_step_rules_above_baseline(step_findings):
    """The step audit over every distinct step of the registry x the
    default policies and the oracle: nothing gates, no branch is left
    unaudited, and every step rule's baseline entry still matches."""
    entries = [e for e in load_baseline() if e.rule in STEP_RULES]
    result = match(step_findings, entries)
    gating = [f for f in result.new if f.gating]
    assert gating == [], [f.render() for f in gating]
    assert result.new == [], [f.render() for f in result.new]
    assert result.stale == [], result.stale
    # the documented read is the capacity plane's, and only there
    reads = [f.key for f in result.suppressed if f.rule == "kernel-purity"]
    assert reads and all(":cap[" in k and k.endswith(":_local_scalar_dense")
                         for k in reads)
    assert not any(k.startswith("perf_aware") for k in reads)


def test_step_audit_subset_matches_baseline():
    """Fast smoke: the client-plane scenarios exercise the budget rule
    against the committed baseline, under the full grid's labels."""
    findings = S.audit_steps(scenarios=["retry-storm",
                                        "breaker-saves-retry-storm"],
                             device="cpu")
    allowed = {e.fingerprint for e in load_baseline()}
    gating = [f for f in findings
              if f.gating and f.fingerprint not in allowed]
    assert gating == [], [f.render() for f in gating]
    assert any(f.rule == "kernel-scatter-budget" for f in findings)


def test_scatter_counts_are_the_baselined_measurements():
    """Each baselined unroll's justification states the count the audit
    measures now (the client scenarios reach all six steps)."""
    counts = S.scatter_counts(["retry-storm", "breaker-saves-retry-storm",
                               "correlated-outage"], device="cpu")
    pinned = [e for e in load_baseline() if e.rule == "kernel-scatter-budget"]
    assert len(pinned) == 6
    for e in pinned:
        label = e.key.removesuffix(":scatters")
        assert counts[label] > S.DEFAULT_SCATTER_BUDGET, label
        assert f"Measured {counts[label]} scatter-family ops" \
            in e.justification, label
    assert all(n <= S.DEFAULT_SCATTER_BUDGET for label, n in counts.items()
               if f"{label}:scatters" not in {e.key for e in pinned})


def test_baseline_entries_are_justified_and_loadable():
    entries = load_baseline()
    assert entries, "the committed baseline carries the pinned sites"
    for e in entries:
        assert len(e.justification.strip()) > 40, e
    assert {e.rule for e in entries} == {
        "rng-raw-constructor", "kernel-purity", "kernel-scatter-budget"}


def test_baseline_loader_rejects_empty_justification(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "r", "path": "p", "key": "k", "justification": "  "}]}))
    with pytest.raises(ValueError, match="justification"):
        bl.load_baseline(p)


def test_baseline_match_reports_stale_entries():
    f = Finding("r", ERROR, "p", "k", "m")
    live = bl.BaselineEntry("r", "p", "k", "pinned")
    dead = bl.BaselineEntry("r", "p", "gone", "fix landed")
    result = match([f], [live, dead])
    assert result.new == [] and result.suppressed == [f]
    assert result.stale == [dead]


# ------------------------------------------------------------ consistency

def test_field_coverage_consistent_with_supports():
    """``supports()`` accepts every registered (scenario, policy); every
    knob a registered scenario sets is then read by the lowering."""
    from dataclasses import fields

    from repro_torch.core.campaign import compiled_coverage
    from repro_torch.core.scenarios import get_scenario, scenario_names
    from repro_torch.core.simulator import SimConfig

    assert compiled_coverage() == []
    cov = C.field_coverage(_ctx())
    default = SimConfig()
    touched = set()
    for name in scenario_names():
        cfg = get_scenario(name).compile()
        for f in fields(SimConfig):
            if getattr(cfg, f.name) != getattr(default, f.name):
                touched.add(f.name)
    assert len(touched) >= 10
    for fname in sorted(touched):
        qual = f"SimConfig.{fname}"
        assert cov[qual].get(C.READ), qual
        assert qual not in C.REFUSED, qual


def test_linter_coverage_agrees_with_the_contract_tests_reading():
    """The linter's parity reading is ``tests/test_torch_contracts.py``'s:
    the same scopes, and no field of the reference's serial path is
    uncovered in either; the linter covers every field besides."""
    import test_torch_contracts as T

    assert [(s.path, s.default, dict(s.overrides)) for s in T.PORT_SCOPES] \
        == [(s.path, s.default, dict(s.overrides))
            for s in C.DEFAULT_SPEC.scopes]
    assert (T.READ, T.NAMED, T.BODY) == (C.READ, C.NAMED, C.BODY)
    cov = C.field_coverage(_ctx())
    for cls, path in C.DEFAULT_SPEC.config_classes.items():
        assert T._uncovered(T.PORT_SCOPES, cls, path) == []
        serial = {f"{cls}.{f}" for f in T._serial_reads(cls)}
        assert serial <= set(cov), cls
        assert all(cov[q].get(C.READ) for q in serial), cls
    assert C.uncovered(_ctx()) == []


def test_deleting_a_read_trips_the_parity_rule(tmp_path):
    """On a copy of the port's core with the closed loop's
    ``retrain_every_s`` reads renamed away, the parity rule fires for
    exactly that field (the real tree stays clean)."""
    for ms in C.DEFAULT_SPEC.scopes:
        dst = tmp_path / ms.path
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / ms.path, dst)
    online = tmp_path / "src/repro_torch/core/online.py"
    mutated = re.sub(r"\.retrain_every_s\b", ".retrain_every_s_DELETED",
                     online.read_text())
    assert mutated != online.read_text()
    online.write_text(mutated)
    found = C.analyze_contracts(_ctx(tmp_path))
    assert [f.key for f in found] == ["SimConfig.retrain_every_s"]
    assert "never read" in found[0].message


# -------------------------------------------------------------------- cli

def test_cli_json_report_on_clean_tree(tmp_path, capsys):
    from repro_torch.analysis.cli import main
    out = tmp_path / "report.json"
    rc = main(["--format", "json", "--output", str(out),
               "--rules", ",".join(STATIC_RULES)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True
    assert report["counts"]["gating"] == 0
    assert report["counts"]["baselined"] == 3
    printed = json.loads(capsys.readouterr().out)
    assert printed == report


def test_cli_gates_without_baseline(capsys):
    """--no-baseline re-exposes the pinned generator sites (the gate is
    real, not vacuous)."""
    from repro_torch.analysis.cli import main
    rc = main(["--no-baseline", "--rules", "rng-raw-constructor"])
    text = capsys.readouterr().out
    assert rc == 1 and "FAIL: 3 gating" in text


def test_rule_catalog_lists_seven_rules_in_three_families(capsys):
    from repro_torch.analysis.cli import main
    assert main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 7
    names = {ln.split()[0]: ln.split()[1] for ln in lines}
    assert names == {
        "parity-read-coverage": "[contracts]",
        "scenario-field-mapping": "[contracts]",
        "rng-raw-constructor": "[rng]", "rng-stream-uniqueness": "[rng]",
        "kernel-purity": "[step]", "kernel-scatter-budget": "[step]",
        "kernel-static-hashable": "[step]"}


def test_cli_step_rules_use_the_baseline(capsys):
    """The step rules through the CLI: exit 0 above the baseline, with
    the capacity plane's reads and the client plane's unrolls baselined
    as errors (without the baseline they gate)."""
    from repro_torch.analysis.cli import main
    assert main(["--rules", ",".join(STEP_RULES), "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"] == {"gating": 0, "advisory": 0, "baselined": 22,
                                "stale_baseline": 0}
    assert all(f["severity"] == ERROR for f in report["baselined"])
