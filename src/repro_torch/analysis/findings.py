"""Finding / severity primitives shared by every analysis rule (the
reference's ``analysis/findings.py``).

A finding's identity for baseline matching is its *fingerprint*,
``(rule, path, key)``, which leaves the line number out so that an
unrelated edit above a pinned site does not invalidate its baseline
entry.  ``key`` is therefore a stable symbol (qualified name + ordinal,
config field name, step label), never a position.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

#: Severity ladder.  ``error`` gates; ``warning`` is reported but does not
#: gate (where the analysis cannot *prove* a violation, e.g. a non-literal
#: rng stream name or a step branch the audit never ran); ``info``
#: narrates.
SEVERITIES = ("error", "warning", "info")

ERROR, WARNING, INFO = SEVERITIES


@dataclass(frozen=True, order=True)
class Finding:
    rule: str         # registered rule name, e.g. "rng-raw-constructor"
    severity: str     # one of SEVERITIES
    path: str         # repo-relative posix path ("" for repo-wide findings)
    key: str          # stable identity within (rule, path); line-free
    message: str      # human-readable description
    line: int = 0     # informational only, not part of the fingerprint

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.key)

    @property
    def gating(self) -> bool:
        return self.severity == ERROR

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "key": self.key,
                "message": self.message, "line": self.line}

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else "<repo>"
        return f"{self.severity:7s} {self.rule:24s} {loc}  {self.key}\n" \
               f"        {self.message}"
