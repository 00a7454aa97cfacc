"""CLI for the hot-path lint sweep: ``python -m repro_torch.analysis``.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu   # here
    PYTHONPATH=src python -m repro_torch.analysis                # the card

Exit code 0 iff no finding outside the baseline and, on a full sweep, no
stale suppression. See DESIGN.md §6.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import entrypoints, source_lint, trace_lint
from .runner import load_baseline, render, run_lint

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Lint every hot path of the port (dispatch traces + "
                    "source AST + the kernels' ptxas reports) against the "
                    "invariants in DESIGN.md §6.")
    ap.add_argument("--device", choices=entrypoints.DEVICES, default="cuda",
                    help="where the entry points run (default cuda, as "
                         "every entry point of the port; cpu runs the "
                         "plain versions)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression file (default src/repro_torch/"
                         "analysis/lint_baseline.json; 'none' disables)")
    ap.add_argument("--json", metavar="PATH", dest="json_path",
                    help="also write the report as JSON ('-' for stdout)")
    ap.add_argument("--entry", action="append", default=None,
                    help="only entry points whose name contains this "
                         "substring (repeatable)")
    ap.add_argument("--rule", action="append", default=None,
                    help="only this rule name (repeatable)")
    ap.add_argument("--source-only", action="store_true",
                    help="skip the trace sweep")
    ap.add_argument("--list", action="store_true",
                    help="list entry points and rules, then exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="no per-entry progress lines")
    args = ap.parse_args(argv)

    if args.list:
        print(f"entry points ({args.device}):")
        for ep in entrypoints.iter_entry_points(args.device):
            print(f"  {ep.name}  tags={','.join(sorted(ep.tags))}")
        print("trace rules:")
        for rule in trace_lint.TRACE_RULES.values():
            print(f"  {rule.name}: {rule.doc}")
        print("source rules:")
        for srule in source_lint.SOURCE_RULES.values():
            print(f"  {srule.name}: {srule.doc}")
        print("the reference's rules without a counterpart:")
        for name, why in source_lint.NO_COUNTERPART.items():
            print(f"  {name}: {why}")
        return 0

    if args.rule:
        known = set(trace_lint.TRACE_RULES) | set(source_lint.SOURCE_RULES)
        unknown = [r for r in args.rule if r not in known]
        if unknown:
            ap.error(f"unknown rule(s): {', '.join(unknown)} "
                     f"(see --list)")
    if args.device == "cuda" and not args.source_only:
        import torch
        if not torch.cuda.is_available():
            ap.error("no CUDA device: pass --device cpu to sweep the plain "
                     "versions, or --source-only")

    baseline = {}
    if args.baseline and args.baseline.lower() != "none":
        if os.path.exists(args.baseline):
            baseline = load_baseline(args.baseline)
        elif args.baseline != DEFAULT_BASELINE:
            ap.error(f"baseline file not found: {args.baseline}")

    progress = None if args.quiet else (
        lambda msg: print(msg, file=sys.stderr, flush=True))
    report = run_lint(
        device=args.device, entry_filter=args.entry,
        rule_filter=args.rule, do_trace=not args.source_only,
        baseline=baseline, progress=progress)

    if args.json_path == "-":
        print(json.dumps(report.to_dict(), indent=2))
    else:
        if args.json_path:
            with open(args.json_path, "w") as f:
                json.dump(report.to_dict(), f, indent=2)
                f.write("\n")
        print(render(report))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
