"""Committed baseline for pinned findings (the reference's
``analysis/baseline.py``).

The baseline is a JSON file of entries ``{rule, path, key,
justification}``.  A finding whose fingerprint ``(rule, path, key)``
matches an entry is *suppressed* (reported, but not gating); everything
else gates.  Entries are matched by stable keys, never line numbers, so
edits elsewhere in a file do not churn the baseline.

A new violation should be *fixed*; only behaviour pinned for a reason
(a stream the tests are calibrated on, a documented host read, a
measured unroll) goes in the baseline, and every entry carries a
non-empty ``justification`` saying why.  Entries that no longer match
any finding are reported as *stale* so the baseline shrinks as the debt
is paid; stale entries warn but do not gate.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.findings import Finding

#: The committed baseline shipping with the package.
DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")

_VERSION = 1


@dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    key: str
    justification: str

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.key)

    def to_json(self) -> Dict[str, str]:
        return {"rule": self.rule, "path": self.path, "key": self.key,
                "justification": self.justification}


@dataclass(frozen=True)
class MatchResult:
    new: List[Finding]              # not in the baseline: these gate
    suppressed: List[Finding]       # matched a baseline entry
    stale: List[BaselineEntry]      # the entry matched no finding


def load_baseline(path: Path = DEFAULT_BASELINE) -> List[BaselineEntry]:
    """Load and validate a baseline file.  A missing file is an empty
    baseline; malformed entries or empty justifications are errors (a
    suppression without a reason defeats the point of the file)."""
    if not Path(path).exists():
        return []
    doc = json.loads(Path(path).read_text())
    if doc.get("version") != _VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{doc.get('version')!r} (want {_VERSION})")
    entries: List[BaselineEntry] = []
    seen = set()
    for i, raw in enumerate(doc.get("entries", [])):
        missing = {"rule", "path", "key", "justification"} - set(raw)
        if missing:
            raise ValueError(f"baseline {path}: entry {i} missing {missing}")
        if not str(raw["justification"]).strip():
            raise ValueError(f"baseline {path}: entry {i} "
                             f"({raw['rule']}:{raw['key']}) has an empty "
                             "justification: explain why it is pinned")
        e = BaselineEntry(raw["rule"], raw["path"], raw["key"],
                          raw["justification"])
        if e.fingerprint in seen:
            raise ValueError(f"baseline {path}: duplicate entry "
                             f"{e.fingerprint}")
        seen.add(e.fingerprint)
        entries.append(e)
    return entries


def match(findings: Sequence[Finding],
          entries: Sequence[BaselineEntry]) -> MatchResult:
    by_fp = {e.fingerprint: e for e in entries}
    new, suppressed, hit = [], [], set()
    for f in findings:
        if f.fingerprint in by_fp:
            suppressed.append(f)
            hit.add(f.fingerprint)
        else:
            new.append(f)
    stale = [e for e in entries if e.fingerprint not in hit]
    return MatchResult(new=new, suppressed=suppressed, stale=stale)


def write_baseline(findings: Sequence[Finding], path: Path,
                   justification: str = "TODO: justify this pin") -> None:
    """Write a baseline covering ``findings`` (to bootstrap one; each
    placeholder justification is then written by hand)."""
    doc = {"version": _VERSION,
           "entries": [{"rule": f.rule, "path": f.path, "key": f.key,
                        "justification": justification}
                       for f in sorted(set(findings))]}
    Path(path).write_text(json.dumps(doc, indent=2) + "\n")
