"""Dispatch-trace lint engine — the port's counterpart of
``repro/analysis/hlo_lint.py`` (DESIGN §6).

The reference lints the COMPILED artifact of each jitted hot path. The
port compiles nothing: a step is a run of eager aten ops around a few
hand-written kernel launches. Its artifact is therefore the **dispatch
trace of one call**: every aten op that a ``TorchDispatchMode`` sees, with
the shapes, dtypes, devices and storages of its tensors. The trace is
taken the same way on the CPU and on the card:

* on the CPU each kernel wrapper runs its plain version inside
  ``kernels.scope.plain_region``; the trace records the region as one
  kernel event and skips the ops inside it (a plain version's full-filter
  work is one launch on the card);
* on the card a launch goes through ``ctypes`` and is never dispatched,
  and the call runs a second time under
  ``torch.cuda.set_sync_debug_mode("error")``, which refuses every
  device-to-host copy and stream synchronisation.

So both traces hold the glue the card runs. Rules, mapped from the
reference's:

=============================  ==============================
``hlo_lint``                   here
=============================  ==============================
no-filter-sized-reduce         no-filter-sized-reduce
state-donated-and-aliased      state-updated-in-place
no-scan-carry-copy             no-state-sized-copy
no-host-transfer-in-scan       no-host-sync-in-step
no-f64-upcast                  no-f64-upcast
single-dispatch-no-retrace     single-dispatch-no-retrace
pallas-vmem-budget             kernel-resource-budget
=============================  ==============================

``kernel-resource-budget`` reads the ``ptxas -v`` report of each source in
``kernels/csrc/`` (``kernels/build.py`` keeps it beside the library) and
holds it to the budget model in ``kernels/common.py``: no spill, and
static shared memory per block within the limit and equal to the model.
It runs on the card only; its parser is tested on a recorded report.

A ``Target`` wraps one entry point and takes its trace once, however many
rules read it. Findings carry a stable key (``rule::entry-name``) that the
baseline (``analysis/lint_baseline.json``) suppresses with a reason.
"""

from __future__ import annotations

import dataclasses
import re
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .source_lint import Finding

# ----------------------------------------------------------- the trace //


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """One tensor of a traced op: what the rules read, never its values."""
    shape: Tuple[int, ...]
    dtype: str
    device: str
    storage: int           # the data pointer of its untyped storage

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One dispatched aten op (``op`` as ``aten.name.overload``), or with
    ``kernel=True`` one kernel's plain region (``op`` its name).
    ``inplace``: the op's schema writes an argument. ``masked``: an
    indexing op took a boolean mask, so its output shape depends on the
    data."""
    op: str
    inputs: Tuple[TensorMeta, ...] = ()
    outputs: Tuple[TensorMeta, ...] = ()
    kernel: bool = False
    inplace: bool = False
    masked: bool = False

    @property
    def name(self) -> str:
        """The op's base name: ``sum`` for ``aten.sum.dim_IntList``."""
        parts = self.op.split(".")
        return parts[1] if len(parts) > 2 else parts[-1]

    @property
    def overload(self) -> str:
        parts = self.op.split(".")
        return parts[2] if len(parts) > 2 else ""


@dataclasses.dataclass
class StepTrace:
    """What one call of an entry point did. ``leaves_in`` / ``leaves_out``
    (donated entries): (label, storage pointer) of each state leaf before
    and after the call. ``sync_errors``: what the card's sync check
    refused (empty on the CPU)."""
    events: List[TraceEvent]
    leaves_in: Optional[List[Tuple[str, int]]] = None
    leaves_out: Optional[List[Tuple[str, int]]] = None
    sync_errors: List[str] = dataclasses.field(default_factory=list)


_INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_")


def _metas(obj) -> Tuple[TensorMeta, ...]:
    import torch
    from torch.utils._pytree import tree_flatten
    out = []
    for x in tree_flatten(obj)[0]:
        if isinstance(x, torch.Tensor):
            out.append(TensorMeta(tuple(x.shape), str(x.dtype).replace(
                "torch.", ""), str(x.device),
                x.untyped_storage().data_ptr()))
    return tuple(out)


def _has_mask(args) -> bool:
    import torch
    idx = args[1] if len(args) > 1 else None
    return isinstance(idx, (list, tuple)) and any(
        isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
        for t in idx)


def _tracer():
    """A ``TorchDispatchMode`` recording every op dispatched outside a
    plain region; ``kernel(name)`` records a region. Built on first use:
    importing this module imports no torch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..kernels import scope

    class DispatchTrace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.events: List[TraceEvent] = []

        def kernel(self, name: str) -> None:
            self.events.append(TraceEvent(name, kernel=True))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if scope.depth() == 0:
                op = str(func)
                self.events.append(TraceEvent(
                    op, _metas((args, kwargs)), _metas(out),
                    inplace=func._schema.is_mutable,
                    masked=(op.split(".")[1] in _INDEXING
                            and _has_mask(args))))
            return out

    return DispatchTrace()


def _where(exc: BaseException) -> str:
    """The innermost frame of the port's own code in ``exc``'s traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename.replace("\\", "/")
              and "/analysis/" not in f.filename.replace("\\", "/")]
    if not frames:
        return "?"
    f = frames[-1]
    path = f.filename.replace("\\", "/")
    return f"{path[path.rfind('repro_torch'):]}:{f.lineno} ({f.name})"


def trace_call(prepared, device: str) -> StepTrace:
    """Run ``prepared.run()`` once under the dispatch trace (and, on the
    card, once more under the sync check); the state leaves' storages
    before and after the traced run."""
    from ..kernels import scope

    def ptrs():
        if prepared.leaves is None:
            return None
        return [(label, t.untyped_storage().data_ptr())
                for label, t in prepared.leaves()]

    leaves_in = ptrs()
    tracer = _tracer()
    with scope.observing(tracer.kernel), tracer:
        prepared.run()
    trace = StepTrace(tracer.events, leaves_in, ptrs())
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prepared.run()
        except RuntimeError as e:
            first = str(e).strip().splitlines()[0] if str(e).strip() else ""
            trace.sync_errors.append(f"{first} at {_where(e)}")
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
    return trace


# -------------------------------------------------------------- ptxas //


@dataclasses.dataclass(frozen=True)
class KernelResources:
    """One kernel of a ``ptxas -v`` report."""
    name: str              # demangled: ``counter_merge_apply<32>``
    registers: int
    shared: int            # static shared memory per block, bytes
    spill_stores: int
    spill_loads: int
    stack: int


_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")


def _source_name(s: str, i: int) -> Tuple[str, int]:
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    n = int(s[i:j])
    return s[j:j + n], j + n


def _template_args(s: str, i: int) -> Tuple[List[str], int]:
    """``I...E`` of literal arguments (``Lb1E``, ``Li32E``) at s[i]."""
    args, i = [], i + 1
    while i < len(s) and s[i] != "E":
        if s[i] != "L":
            raise ValueError(f"template argument at {s[i:]!r}")
        end = s.index("E", i)
        kind, value = s[i + 1], s[i + 2:end]
        args.append({"b": {"0": "false", "1": "true"}.get(value, value)}
                    .get(kind, value.replace("n", "-")))
        i = end + 1
    return args, i + 1


def demangle(mangled: str) -> str:
    """The kernel name of an Itanium-mangled ``__global__`` function of
    ``csrc/``: its last name, with literal template arguments —
    ``_ZN..._GLOBAL__N_...19counter_merge_applyILi32EEEv...`` ->
    ``counter_merge_apply<32>``. Anything it cannot read comes back as
    it is."""
    s = mangled
    try:
        if not s.startswith("_Z"):
            return s
        i, nested = 2, s.startswith("_ZN")
        if nested:
            i = 3
        name, args = "", []
        while i < len(s) and s[i].isdigit():
            part, i = _source_name(s, i)
            if not part.startswith("_GLOBAL__N"):
                name, args = part, []
            if i < len(s) and s[i] == "I":
                args, i = _template_args(s, i)
            if not nested:
                break
        if not name:
            return s
        return f"{name}<{', '.join(args)}>" if args else name
    except (ValueError, IndexError):
        return s


def parse_ptxas(log: str) -> List[KernelResources]:
    """Every kernel of an ``nvcc -Xptxas -v`` report, in report order."""
    out: List[KernelResources] = []
    cur: Optional[dict] = None

    def flush():
        if cur is not None and "registers" in cur:
            out.append(KernelResources(**cur))

    for line in log.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            flush()
            # "registers" arrives last, with the "Used ..." line
            cur = dict(name=demangle(m.group(1)), shared=0, spill_stores=0,
                       spill_loads=0, stack=0)
            continue
        if cur is None:
            continue
        m = _FRAME_RE.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
            continue
        m = _USED_RE.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM_RE.search(line)
            cur["shared"] = int(s.group(1)) if s else 0
    flush()
    return out


# ---------------------------------------------------------------- target //


class Target:
    """One entry point's artifact — its step trace, or for a kernel entry
    its ``ptxas`` report — taken lazily and at most once however many
    rules read it. Tests build synthetic targets with ``trace=`` /
    ``ptxas_log=`` to exercise the rules without running an entry."""

    def __init__(self, entry, *, trace: Optional[StepTrace] = None,
                 ptxas_log: Optional[str] = None):
        self.entry = entry
        self._trace = trace
        self._log = ptxas_log

    def trace(self) -> StepTrace:
        if self._trace is None:
            prepared = self.entry.build()
            try:
                self._trace = trace_call(prepared, self.entry.device)
            finally:
                if prepared.close is not None:
                    prepared.close()
        return self._trace

    def ptxas_log(self) -> str:
        if self._log is None:
            self._log = self.entry.build()
        return self._log

    def kernels(self) -> List[KernelResources]:
        return parse_ptxas(self.ptxas_log())


# ------------------------------------------------------------------ rules //


@dataclasses.dataclass(frozen=True)
class Rule:
    """One pluggable invariant of a traced entry. ``applies_to`` gates on
    the entry's tags and config (an inapplicable rule is neither a pass
    nor a failure); ``check`` reads the Target and returns findings."""
    name: str
    doc: str
    applies_to: Callable[..., bool]
    check: Callable[[Target], List[Finding]]


TRACE_RULES: Dict[str, Rule] = {}


def _register(rule: Rule) -> Rule:
    if rule.name in TRACE_RULES:
        raise ValueError(f"duplicate rule {rule.name!r}")
    TRACE_RULES[rule.name] = rule
    return rule


def _find(rule: str, where: str, detail: str) -> List[Finding]:
    return [Finding(rule, where, detail)]


def _glue(t: Target) -> List[TraceEvent]:
    return [e for e in t.trace().events if not e.kernel]


def _is_step(ep) -> bool:
    return "kernel" not in ep.tags


# -- no-filter-sized-reduce ------------------------------------------------
# The paper's constant-per-element contract (DESIGN §3.1): load tracking is
# incremental, so the glue of a step reduces over nothing as large as the
# filter. Applies where the entry's config separates the thresholds.

REDUCE_OPS = ("sum", "nansum", "mean", "prod", "any", "all", "amax", "amin",
              "aminmax", "max", "min", "argmax", "argmin", "count_nonzero",
              "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
              "logsumexp", "norm", "linalg_vector_norm", "std", "var")


def _reduce_applies(ep) -> bool:
    return (_is_step(ep) and bool(ep.extra.get("filter_elems"))
            and ep.extra.get("separable", False))


def _reduce_check(t: Target) -> List[Finding]:
    w = t.entry.extra["filter_elems"]
    big = sorted({f"{e.op} over {max(x.numel for x in e.inputs)}"
                  for e in _glue(t)
                  if e.name in REDUCE_OPS and e.overload != "other"
                  and e.inputs and max(x.numel for x in e.inputs) >= w})
    if big:
        return _find("no-filter-sized-reduce", t.entry.name,
                     f"reduction over >= {w} elements (the filter): "
                     f"{big} — O(s) work crept into the step")
    return []


_register(Rule(
    "no-filter-sized-reduce",
    "a step's glue reduces over no tensor as large as the filter "
    "(incremental load tracking, DESIGN §3.1)",
    _reduce_applies, _reduce_check))


# -- state-updated-in-place ------------------------------------------------
# The port's donation: after a donated call every state leaf — filter
# planes, position, load, rng key, the swbf ring, the elastic router —
# lives in the storage it came in with, or the call copies it.

def _inplace_applies(ep) -> bool:
    return "donated" in ep.tags


def _inplace_check(t: Target) -> List[Finding]:
    tr = t.trace()
    moved = [label for (label, a), (_, b) in zip(tr.leaves_in or [],
                                                 tr.leaves_out or [])
             if a != b]
    if moved:
        return _find(
            "state-updated-in-place", t.entry.name,
            f"state leaves in new storage after the call: "
            f"{', '.join(moved)} — each call allocates them anew instead "
            f"of updating the donated state in place")
    return []


_register(Rule(
    "state-updated-in-place",
    "after a donated call every state leaf (planes, position, load, rng, "
    "ring, router) keeps the storage it came in with (DESIGN §3.5)",
    _inplace_applies, _inplace_check))


# -- no-state-sized-copy ---------------------------------------------------
# The PR-4 trap's counterpart: an out-of-place op in a stream step that
# creates a tensor as large as the filter (clone, copy, cat, zeros, a
# plain ``&``/``|``) moves O(s) bytes per batch. In-place ops and views
# create nothing.

def _copy_applies(ep) -> bool:
    return "stream" in ep.tags and bool(ep.extra.get("filter_elems"))


def _copy_check(t: Target) -> List[Finding]:
    w = t.entry.extra["filter_elems"]
    big = set()
    for e in _glue(t):
        if e.inplace:
            continue
        src = {x.storage for x in e.inputs}
        for x in e.outputs:
            if x.numel >= w and x.storage not in src:
                big.add(f"{e.op} -> {x.dtype}{list(x.shape)}")
    if big:
        return _find(
            "no-state-sized-copy", t.entry.name,
            f"out-of-place ops creating >= {w} elements (the filter) in "
            f"the stream step: {sorted(big)}")
    return []


_register(Rule(
    "no-state-sized-copy",
    "no out-of-place op in a stream step creates a tensor as large as the "
    "filter — no per-batch state copy (the PR-4 trap, DESIGN §3.7)",
    _copy_applies, _copy_check))


# -- no-host-sync-in-step --------------------------------------------------

SYNC_OPS = ("_local_scalar_dense", "item", "is_nonzero", "equal",
            "allclose", "nonzero", "argwhere", "masked_select", "unique",
            "_unique", "_unique2", "unique_dim", "unique_consecutive",
            "unique_dim_consecutive")


def _sync_check(t: Target) -> List[Finding]:
    tr = t.trace()
    hits = sorted({e.op for e in _glue(t)
                   if e.name in SYNC_OPS or e.masked
                   or (e.name == "repeat_interleave"
                       and e.overload.startswith("Tensor"))})
    problems = []
    if hits:
        problems.append(f"ops that read values or shapes on the host: "
                        f"{hits}")
    if tr.sync_errors:
        problems.append(f"refused under set_sync_debug_mode('error'): "
                        f"{tr.sync_errors}")
    if problems:
        return _find("no-host-sync-in-step", t.entry.name,
                     "; ".join(problems) + " — a host sync in the step "
                     "serialises the stream")
    return []


_register(Rule(
    "no-host-sync-in-step",
    "a step reads nothing on the host: no scalar read, no op with a "
    "data-dependent shape, and on the card nothing that "
    "set_sync_debug_mode('error') refuses (DESIGN §6)",
    _is_step, _sync_check))


# -- no-f64-upcast ---------------------------------------------------------

_F64 = ("float64", "complex128")


def _f64_check(t: Target) -> List[Finding]:
    n = sum(1 for e in _glue(t) for x in e.inputs + e.outputs
            if x.dtype in _F64)
    if n:
        ops = sorted({e.op for e in _glue(t)
                      for x in e.inputs + e.outputs if x.dtype in _F64})
        return _find(
            "no-f64-upcast", t.entry.name,
            f"{n} float64/complex128 tensors in the trace ({ops}) — a "
            f"Python float or np.float64 leaked into the step's math")
    return []


_register(Rule(
    "no-f64-upcast",
    "a step carries no float64/complex128 tensor (the card's f64 rate is "
    "a fraction of f32; the repo's math is int/f32)",
    _is_step, _f64_check))


# -- single-dispatch-no-retrace --------------------------------------------

def _retrace_check(t: Target) -> List[Finding]:
    return [Finding("single-dispatch-no-retrace", t.entry.name, p)
            for p in t.entry.retrace_probe()]


_register(Rule(
    "single-dispatch-no-retrace",
    "repeating a same-shaped call leaves the width/stream counters "
    "unchanged and loads no new kernel library (DESIGN §3.5)",
    lambda ep: ep.retrace_probe is not None, _retrace_check))


# -- kernel-resource-budget ------------------------------------------------

def _budget_check(t: Target) -> List[Finding]:
    from ..kernels.common import (SHARED_BYTES_PER_BLOCK_LIMIT,
                                  block_shared_bytes)
    kernels = t.kernels()
    if not kernels:
        return _find("kernel-resource-budget", t.entry.name,
                     "no kernel in the ptxas report (was it built with "
                     "-Xptxas -v?)")
    problems = []
    for r in kernels:
        if r.spill_stores or r.spill_loads:
            problems.append(f"{r.name} spills {r.spill_stores} B stored / "
                            f"{r.spill_loads} B loaded")
        if r.shared > SHARED_BYTES_PER_BLOCK_LIMIT:
            problems.append(f"{r.name} uses {r.shared} B shared per block, "
                            f"over {SHARED_BYTES_PER_BLOCK_LIMIT}")
        try:
            want = block_shared_bytes(r.name)
        except KeyError:
            problems.append(f"{r.name} is not in kernels/common.py's model")
            continue
        if r.shared != want:
            problems.append(f"{r.name} uses {r.shared} B shared per block, "
                            f"the model says {want}")
    if problems:
        return _find("kernel-resource-budget", t.entry.name,
                     "; ".join(problems))
    return []


_register(Rule(
    "kernel-resource-budget",
    "every kernel in csrc/ spills nothing and its static shared memory per "
    "block stays within kernels.common's limit and equals its model, from "
    "ptxas -v (card only; DESIGN §3.4)",
    lambda ep: "kernel" in ep.tags, _budget_check))


# ----------------------------------------------------------------- driver //


def resolve_rules(rules=None) -> List[Rule]:
    """Normalize a rule selection (None = all, else names or Rule objects)."""
    if rules is None:
        return list(TRACE_RULES.values())
    return [TRACE_RULES[r] if isinstance(r, str) else r for r in rules]


def lint_entry(entry, rules: Optional[Sequence] = None, *,
               target: Optional[Target] = None) -> List[Finding]:
    """Run every applicable rule against one entry point. A rule that
    raises becomes a ``lint-error`` finding (a hot path that cannot even
    run is itself a violation worth surfacing, not a crash)."""
    target = Target(entry) if target is None else target
    findings: List[Finding] = []
    for rule in resolve_rules(rules):
        try:
            if not rule.applies_to(entry):
                continue
            findings.extend(rule.check(target))
        except Exception as e:  # noqa: BLE001 — surface, don't crash the sweep
            findings.append(Finding(
                "lint-error", f"{entry.name}::{rule.name}",
                f"{type(e).__name__}: {e}"))
    return findings
