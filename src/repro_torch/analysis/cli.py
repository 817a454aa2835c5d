"""``python -m repro_torch.analysis``: run the port's contract linter.

The exit status is 0 if and only if no *gating* finding survives the
baseline: a finding gates when its severity is ``error`` and its
fingerprint is not in the committed baseline.  Warnings and baselined
findings are reported but never fail the run, and stale baseline entries
(matching no current finding) are listed so the baseline shrinks over
time.  The step audit runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import baseline as bl
from repro_torch.analysis.registry import (AnalysisContext, load_rules,
                                           run_rules)


def _text_report(result: bl.MatchResult, out) -> None:
    gating = [f for f in result.new if f.gating]
    advisory = [f for f in result.new if not f.gating]
    for f in gating:
        print(f.render(), file=out)
    if advisory:
        print(f"\n-- {len(advisory)} non-gating finding(s):", file=out)
        for f in advisory:
            print(f.render(), file=out)
    if result.suppressed:
        print(f"\n-- {len(result.suppressed)} baselined finding(s) "
              "(suppressed):", file=out)
        for f in result.suppressed:
            print(f"   {f.rule}  {f.path}  {f.key}", file=out)
    for e in result.stale:
        print(f"\nstale baseline entry (fix landed? remove it): "
              f"{e.rule}  {e.path}  {e.key}", file=out)
    verdict = "FAIL" if gating else "OK"
    print(f"\n{verdict}: {len(gating)} gating, {len(advisory)} advisory, "
          f"{len(result.suppressed)} baselined, {len(result.stale)} stale "
          "baseline entries", file=out)


def _json_report(result: bl.MatchResult) -> dict:
    gating = [f for f in result.new if f.gating]
    return {
        "ok": not gating,
        "counts": {"gating": len(gating),
                   "advisory": len(result.new) - len(gating),
                   "baselined": len(result.suppressed),
                   "stale_baseline": len(result.stale)},
        "findings": [f.to_json() for f in result.new],
        "baselined": [f.to_json() for f in result.suppressed],
        "stale_baseline": [e.to_json() for e in result.stale],
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static parity / rng / step-purity contract linter "
                    "for the PyTorch port's simulation core")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--baseline", type=Path, default=bl.DEFAULT_BASELINE,
                   help="baseline JSON (default: the committed one)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (report every finding raw)")
    p.add_argument("--output", type=Path, default=None,
                   help="also write the JSON report to this path")
    p.add_argument("--write-baseline", type=Path, default=None,
                   help="write a baseline covering all current gating "
                        "findings to this path (justifications are "
                        "placeholders to be written by hand)")
    args = p.parse_args(argv)

    if args.list_rules:
        for name, r in sorted(load_rules().items()):
            print(f"{name:24s} [{r.family}]  {r.description}")
        return 0

    names = args.rules.split(",") if args.rules else None
    ctx = AnalysisContext()
    findings = run_rules(ctx, names)

    if args.write_baseline is not None:
        bl.write_baseline([f for f in findings if f.gating],
                          args.write_baseline)
        print(f"wrote {args.write_baseline}", file=sys.stderr)

    entries = [] if args.no_baseline else bl.load_baseline(args.baseline)
    if names is not None:
        # a rule subset must not mark the rest of the baseline stale
        entries = [e for e in entries if e.rule in names]
    result = bl.match(findings, entries)

    report = _json_report(result)
    if args.output is not None:
        args.output.write_text(json.dumps(report, indent=2) + "\n")
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        _text_report(result, sys.stdout)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
