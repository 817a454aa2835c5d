"""The port's contracts with the reference, checked statically.

1. Field coverage, after ``repro.analysis.contracts``: every field of
   ``SimConfig``, ``CapacityConfig``, ``ResilienceConfig`` and
   ``TraceConfig`` that the reference's serial path reads is read by the
   port's core (``repro_torch/core``); ``simulator.unlowered``, whose
   reads would only name a refused feature, names none.  A field read
   only by a config class's own property counts as read where the port
   reads the property.  A ``ScenarioSpec`` field of the reference is a
   field of the port's spec and compiles onto a field of the port's
   ``SimConfig``.
2. RNG streams, after ``repro.analysis.rng_audit``: no raw generator is
   built in ``repro_torch/core`` outside ``core/rng.py``; every stream
   name the port uses is a literal, maps to the same generator identity
   as in the reference (so both draw the same numbers) and to an
   identity no other name has.

Both run on the CPU from the sources alone: nothing of the port is
imported but its ``rng_seed``.
"""
import ast

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
PORT_CAP = f"{PORT_CORE}/capacity.py"
PORT_RES = f"{PORT_CORE}/resilience.py"
PORT_TEL = f"{PORT_CORE}/telemetry.py"
READ, NAMED, BODY = "read", "named", "class-body"

#: where the port reads a config field: every module of its core; the
#: reads inside ``unlowered`` only name a refused feature, and the
#: config classes' own bodies read nothing at run time
_BODIES = {"simulator": "SimConfig", "scenarios": "ScenarioSpec",
           "capacity": "CapacityConfig", "resilience": "ResilienceConfig",
           "telemetry": "TraceConfig"}
PORT_SCOPES = tuple(
    ModuleScope(f"{PORT_CORE}/{m}.py", READ,
                dict({"unlowered": NAMED} if m == "simulator" else {},
                     **({_BODIES[m]: BODY} if m in _BODIES else {})))
    for m in ("simulator", "simcore", "online", "campaign", "scenarios",
              "capacity", "resilience", "telemetry"))
#: the client-side resilience knobs and the correlated outage, the last
#: resilience fields the core lowered
CLIENT_SIDE = {"timeout_s", "max_retries", "backoff_base_s", "backoff_mult",
               "backoff_jitter", "breaker_threshold", "breaker_cooldown_s",
               "outage_group"}


def _serial_reads(cls="SimConfig"):
    """Fields of the reference's ``cls`` that its serial path reads."""
    cov = field_coverage(CTX)
    return {q.split(".", 1)[1] for q, by in cov.items()
            if q.startswith(f"{cls}.")
            and (by.get(SERIAL) or by.get(SHARED))}


def _property_reads(path, cls):
    """field -> the properties of the port's ``cls`` that read it."""
    out = {}
    for node in CTX.parse(path).body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and any(
                        getattr(d, "id", None) == "property"
                        for d in fn.decorator_list):
                    for n in ast.walk(fn):
                        if isinstance(n, ast.Attribute):
                            out.setdefault(n.attr, set()).add(fn.name)
    return out


def _uncovered(scopes, cls="SimConfig", path=PORT_SIM):
    reads = collect_reads(CTX, scopes)
    props = _property_reads(path, cls)

    def covered(f):
        by = reads.get(f, {})
        return by.get(READ) or by.get(NAMED) or any(
            reads.get(p, {}).get(READ) for p in props.get(f, ()))
    return sorted(f for f in _serial_reads(cls) if not covered(f))


def test_every_serial_simconfig_field_is_read_or_named_unlowered():
    assert len(_serial_reads()) >= 30
    assert _uncovered(PORT_SCOPES) == []


def test_every_serial_capacity_field_is_read_by_the_core():
    fields = _serial_reads("CapacityConfig")
    assert len(fields) == 15 and "initial_replicas" in fields
    assert _uncovered(PORT_SCOPES, "CapacityConfig", PORT_CAP) == []
    # read through the ``initial`` property alone
    assert "initial_replicas" in _uncovered(
        PORT_SCOPES, "CapacityConfig", PORT_SIM)


def test_resilience_faults_are_read_and_client_side_named():
    """Every serial-read resilience field, the client-side knobs and the
    correlated outage included, is read by the core; none is only
    named."""
    reads = collect_reads(CTX, PORT_SCOPES)
    fields = _serial_reads("ResilienceConfig")
    assert fields == CLIENT_SIDE | {"gray", "staleness"}
    for f in sorted(fields):
        assert reads[f].get(READ), f
        assert not reads[f].get(NAMED), f
    assert _uncovered(PORT_SCOPES, "ResilienceConfig", PORT_RES) == []


def test_every_serial_trace_field_is_read_by_the_core():
    fields = _serial_reads("TraceConfig")
    assert fields == {"sample_every"}
    assert _uncovered(PORT_SCOPES, "TraceConfig", PORT_TEL) == []
    # the core's own read, not the config class's body
    scopes = tuple(s for s in PORT_SCOPES
                   if not s.path.endswith("simcore.py"))
    assert _uncovered(scopes, "TraceConfig", PORT_TEL) == ["sample_every"]


def test_coverage_check_finds_a_field_nobody_reads():
    """Without the fleet module the closed loop's knobs go unread: the
    check has teeth."""
    scopes = tuple(s for s in PORT_SCOPES if not s.path.endswith("online.py"))
    missing = _uncovered(scopes)
    assert "retrain_every_s" in missing and "online_warmup_s" in missing


def test_named_fields_are_the_unlowered_planes():
    reads = collect_reads(CTX, PORT_SCOPES)
    sim_fields = set(dataclass_fields(CTX.parse(PORT_SIM), "SimConfig"))
    named = {f for f, by in reads.items() if by.get(NAMED)}
    only_named = {f for f in named & sim_fields if not reads[f].get(READ)}
    assert only_named == set()
    assert named == set()


def test_config_and_scenario_fields_match_the_reference():
    for cls, ref_mod, port_mod in (
            ("SimConfig", "src/repro/core/simulator.py", PORT_SIM),
            ("ScenarioSpec", "src/repro/core/scenarios.py",
             f"{PORT_CORE}/scenarios.py"),
            ("CapacityConfig", "src/repro/core/capacity.py", PORT_CAP),
            ("ResilienceConfig", "src/repro/core/resilience.py",
             PORT_RES),
            ("TraceConfig", "src/repro/core/telemetry.py", PORT_TEL)):
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
            "drift", "policy", "preempt", "fault"} <= set(names)
    seen = {}
    for name in names:
        probe = tuple(rng_seed(s, name) for s in (0, 12345))
        assert probe == tuple(ref_rng_seed(s, name) for s in (0, 12345)), \
            name
        assert probe not in seen, (name, seen.get(probe))
        seen[probe] = name
