"""The port's contracts with the reference, checked statically.

1. Field coverage, after ``repro.analysis.contracts``: every field of
   ``SimConfig`` that the reference's serial path reads is read by the
   port's core (``repro_torch/core``) or named by
   ``simulator.unlowered``, whose features ``supports`` refuses.  A
   ``ScenarioSpec`` field of the reference is a field of the port's
   spec and compiles onto a field of the port's ``SimConfig``.
2. RNG streams, after ``repro.analysis.rng_audit``: no raw generator is
   built in ``repro_torch/core`` outside ``core/rng.py``; every stream
   name the port uses is a literal, maps to the same generator identity
   as in the reference (so both draw the same numbers) and to an
   identity no other name has.

Both run on the CPU from the sources alone: nothing of the port is
imported but its ``rng_seed``.
"""
from repro.analysis.contracts import (SERIAL, SHARED,
                                      ContractSpec, ModuleScope,
                                      analyze_scenario_mapping,
                                      collect_reads, dataclass_fields,
                                      field_coverage)
from repro.analysis.registry import AnalysisContext
from repro.analysis.rng_audit import (collect_stream_names,
                                      find_raw_constructors)
from repro.core.rng import rng_seed as ref_rng_seed
from repro_torch.core.rng import rng_seed

CTX = AnalysisContext()
PORT_CORE = "src/repro_torch/core"
PORT_SIM = f"{PORT_CORE}/simulator.py"
READ, NAMED, BODY = "read", "named", "class-body"

#: where the port reads a config field: every module of its core; the
#: reads inside ``unlowered`` only name a refused feature, and the
#: config classes' own bodies read nothing at run time
PORT_SCOPES = tuple(
    ModuleScope(f"{PORT_CORE}/{m}.py", READ,
                {"unlowered": NAMED, "SimConfig": BODY}
                if m == "simulator" else {"ScenarioSpec": BODY}
                if m == "scenarios" else {})
    for m in ("simulator", "simcore", "online", "campaign", "scenarios"))


def _serial_reads():
    """SimConfig fields the reference's serial path reads."""
    cov = field_coverage(CTX)
    return {q.split(".", 1)[1] for q, by in cov.items()
            if q.startswith("SimConfig.")
            and (by.get(SERIAL) or by.get(SHARED))}


def _uncovered(scopes):
    reads = collect_reads(CTX, scopes)
    return sorted(f for f in _serial_reads()
                  if not reads.get(f, {}).get(READ)
                  and not reads.get(f, {}).get(NAMED))


def test_every_serial_simconfig_field_is_read_or_named_unlowered():
    assert len(_serial_reads()) >= 30
    assert _uncovered(PORT_SCOPES) == []


def test_coverage_check_finds_a_field_nobody_reads():
    """Without the fleet module the closed loop's knobs go unread: the
    check has teeth."""
    scopes = tuple(s for s in PORT_SCOPES if not s.path.endswith("online.py"))
    missing = _uncovered(scopes)
    assert "retrain_every_s" in missing and "online_warmup_s" in missing


def test_named_fields_are_the_unlowered_planes():
    reads = collect_reads(CTX, PORT_SCOPES)
    named = {f for f, by in reads.items() if by.get(NAMED)}
    only_named = {f for f in named if not reads[f].get(READ)}
    assert only_named == {"capacity", "preempt", "resilience", "trace"}


def test_config_and_scenario_fields_match_the_reference():
    for cls, ref_mod, port_mod in (
            ("SimConfig", "src/repro/core/simulator.py", PORT_SIM),
            ("ScenarioSpec", "src/repro/core/scenarios.py",
             f"{PORT_CORE}/scenarios.py")):
        assert dataclass_fields(CTX.parse(port_mod), cls) \
            == dataclass_fields(CTX.parse(ref_mod), cls), cls
    spec = ContractSpec(config_classes={"SimConfig": PORT_SIM}, scopes=(),
                        scenario_module=f"{PORT_CORE}/scenarios.py")
    assert analyze_scenario_mapping(CTX, spec) == []


def _port_core_modules():
    return sorted(str(p.relative_to(CTX.root))
                  for p in CTX.path(PORT_CORE).glob("*.py")
                  if p.name != "rng.py")


def test_no_raw_rng_constructor_in_the_port_core():
    mods = _port_core_modules()
    assert f"{PORT_CORE}/simcore.py" in mods
    assert find_raw_constructors(CTX, modules=mods) == []


def test_port_streams_are_literal_unique_and_the_references():
    literal, dynamic = collect_stream_names(CTX, root_rel="src/repro_torch")
    assert [d for d in dynamic if not d[1].endswith("core/rng.py")] == []
    names = sorted({n for n, _, _ in literal})
    assert {"topology", "noise", "arrival", "noise_streamed", "churn",
            "drift", "policy"} <= set(names)
    seen = {}
    for name in names:
        probe = tuple(rng_seed(s, name) for s in (0, 12345))
        assert probe == tuple(ref_rng_seed(s, name) for s in (0, 12345)), \
            name
        assert probe not in seen, (name, seen.get(probe))
        seen[probe] = name
