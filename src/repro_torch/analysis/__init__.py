"""Static and traced analysis of the port's hot path — the counterpart of
``repro/analysis`` (DESIGN.md §6).

Two engines over one finding/rule vocabulary:

  * ``trace_lint`` — rules over the DISPATCH TRACE of one call of every
    entry point in ``entrypoints.iter_entry_points(device)`` (the port
    compiles nothing, so its artifact is the aten ops a step dispatches),
    and over the kernels' ``ptxas -v`` reports on the card;
  * ``source_lint`` — rules over the SOURCE AST (host syncs in hot
    modules, deprecated names, branches on tensors).

Run the sweep with ``python -m repro_torch.analysis --device cpu`` here,
or without ``--device`` on the card; intentional violations live in
``analysis/lint_baseline.json`` with one-line reasons.
"""

from .source_lint import (  # noqa: F401
    Finding, NO_COUNTERPART, SOURCE_RULES, SourceRule, is_hot, lint_sources,
)
from .trace_lint import (  # noqa: F401
    KernelResources, Rule, StepTrace, TRACE_RULES, Target, TensorMeta,
    TraceEvent, demangle, lint_entry, parse_ptxas, resolve_rules,
    trace_call,
)
from .entrypoints import (  # noqa: F401
    CANON_BATCH, CANON_MEMORY_BITS, EntryPoint, Prepared, adopt_entry,
    get_entry, iter_entry_points,
)
from .runner import (  # noqa: F401
    LintReport, load_baseline, render, run_lint,
)
