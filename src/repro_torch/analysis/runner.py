"""Sweep driver — the port of ``repro/analysis/runner.py`` (DESIGN §6):
the entry-point matrix × the trace rules, plus the source rules, with
baseline suppression and report rendering.

The baseline (``analysis/lint_baseline.json``, the reference's format)
records INTENTIONAL violations — a stable finding key plus a one-line
reason each — so the exit code means "no NEW violations". A trace key is
in a sweep's scope only when it names an entry of that sweep (the
device's matrix, plus any entries the caller adds), so one file serves the
CPU sweep, the card's, and the card's full-width paths in
``chip_smoke.py``. A suppression in scope that matches nothing fails a
full sweep (stale), and is a warning on a filtered one.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import entrypoints, source_lint, trace_lint
from .source_lint import Finding


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]                      # new, unsuppressed
    suppressed: List[Tuple[Finding, str]]        # (finding, reason)
    stale_baseline: List[str]                    # keys matching nothing
    n_entries: int
    n_trace_rules: int
    n_source_rules: int
    n_source_files: int
    elapsed_s: float
    partial: bool = False                        # filtered sweep — stale
                                                 # keys may just be unswept
    device: str = "cuda"

    @property
    def ok(self) -> bool:
        # a stale suppression on a FULL sweep fails: it is a fixed
        # violation whose reason now misleads, or a key drifted out from
        # under its suppression
        return not self.findings and not (self.stale_baseline
                                          and not self.partial)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "device": self.device,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [{**f.to_dict(), "justification": why}
                           for f, why in self.suppressed],
            "stale_baseline": list(self.stale_baseline),
            "n_entries": self.n_entries,
            "n_trace_rules": self.n_trace_rules,
            "n_source_rules": self.n_source_rules,
            "n_source_files": self.n_source_files,
            "elapsed_s": round(self.elapsed_s, 2),
        }


def load_baseline(path: str) -> Dict[str, str]:
    """{finding key -> one-line reason} from the suppression file."""
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for item in data.get("suppressions", []):
        key, why = item["key"], item.get("reason", "")
        if not why:
            raise ValueError(
                f"baseline entry {key!r} has no justification — every "
                f"intentional violation must say why (DESIGN §6)")
        out[key] = why
    return out


def in_scope(key: str, entry_names) -> bool:
    """Whether a baseline key can match a sweep over ``entry_names``:
    source keys (``rule::src/...``) always; a trace key (``rule::entry``
    or ``lint-error::entry::rule``) when its entry is one of them."""
    where = key.split("::")[1] if "::" in key else ""
    return where.startswith("src/") or where in entry_names


def run_lint(*, device: str = "cuda",
             entry_filter: Optional[Sequence[str]] = None,
             rule_filter: Optional[Sequence[str]] = None,
             do_trace: bool = True, do_source: bool = True,
             baseline: Optional[Dict[str, str]] = None,
             extra_entries: Sequence = (),
             progress=None) -> LintReport:
    """The full sweep on ``device``. ``entry_filter``: substrings selecting
    entry points; ``rule_filter``: rule names (both engines);
    ``baseline``: key -> reason map splitting findings into new vs
    suppressed; ``extra_entries``: entries beyond the matrix (the card's
    full-width paths, ``entrypoints.adopt_entry``)."""
    t0 = time.monotonic()
    eps = entrypoints.iter_entry_points(device) + list(extra_entries)
    names = {ep.name for ep in eps}
    baseline = {k: v for k, v in (baseline or {}).items()
                if in_scope(k, names)}
    raw: List[Finding] = []
    n_entries = n_trace_rules = n_source_rules = n_source_files = 0

    if do_trace:
        rules = [r for r in trace_lint.TRACE_RULES.values()
                 if rule_filter is None or r.name in rule_filter]
        n_trace_rules = len(rules)
        if rules:
            if entry_filter:
                eps = [ep for ep in eps
                       if any(s in ep.name for s in entry_filter)]
            n_entries = len(eps)
            for ep in eps:
                if progress:
                    progress(f"  lint {ep.name}")
                raw.extend(trace_lint.lint_entry(ep, rules=rules))

    if do_source:
        src_rules = [r.name for r in source_lint.SOURCE_RULES.values()
                     if rule_filter is None or r.name in rule_filter]
        n_source_rules = len(src_rules)
        if src_rules:
            files = list(source_lint.iter_src_files())
            n_source_files = len(files)
            if progress:
                progress(f"  lint {n_source_files} source files")
            raw.extend(source_lint.lint_sources(files, rules=src_rules))

    new: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    seen_keys = set()
    for f in raw:
        seen_keys.add(f.key)
        if f.key in baseline:
            suppressed.append((f, baseline[f.key]))
        else:
            new.append(f)
    stale = sorted(k for k in baseline if k not in seen_keys)
    partial = bool(entry_filter or rule_filter
                   or not do_trace or not do_source)
    return LintReport(
        findings=new, suppressed=suppressed, stale_baseline=stale,
        n_entries=n_entries, n_trace_rules=n_trace_rules,
        n_source_rules=n_source_rules, n_source_files=n_source_files,
        elapsed_s=time.monotonic() - t0, partial=partial, device=device)


def render(report: LintReport) -> str:
    lines = []
    if not report.ok:
        parts = []
        if report.findings:
            parts.append(f"{len(report.findings)} finding(s) not in the "
                         f"baseline")
        if report.stale_baseline and not report.partial:
            parts.append(f"{len(report.stale_baseline)} stale baseline "
                         f"suppression(s)")
        lines.append("lint_hotpath: FAIL — " + "; ".join(parts))
        for f in report.findings:
            lines.append(f"  [{f.rule}] {f.where}")
            lines.append(f"      {f.detail}")
            lines.append(f"      key: {f.key}")
    else:
        lines.append("lint_hotpath: OK")
    if report.suppressed:
        lines.append(f"  {len(report.suppressed)} baselined finding(s):")
        for f, why in report.suppressed:
            lines.append(f"    [{f.rule}] {f.where} — {why}")
    for key in report.stale_baseline:
        tag = ("WARNING (filtered sweep — may just be unswept)"
               if report.partial else "FAIL")
        lines.append(f"  {tag} stale baseline entry (delete it): {key}")
    lines.append(
        f"  swept {report.n_entries} entry point(s) on {report.device} x "
        f"{report.n_trace_rules} trace rule(s) + {report.n_source_files} "
        f"source file(s) x {report.n_source_rules} source rule(s) in "
        f"{report.elapsed_s:.1f}s")
    return "\n".join(lines)
