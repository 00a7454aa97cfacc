"""Source/AST lint engine — the port of ``repro/analysis/source_lint.py``
(DESIGN §6), in torch idioms.

The trace rules (``trace_lint``) show what one step dispatches; these
rules keep the source conventions that make that true as the code grows:

  * ``no-host-sync-in-hot-path`` — ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.synchronize()`` (``torch.cuda``'s, a
    stream's, an event's) and ``np.asarray``/``np.array`` in a HOT
    module: each reads a tensor on the host, which waits for the card and
    serialises the stream. Metrics are read out in ``dedup/metrics.py``,
    deliberately outside the hot set.
  * ``no-deprecated-shim-import`` — ``kernels/fused_step.py`` and
    ``kernels/fused_counter_step.py`` are deprecated names; port code
    imports ``kernels.fused_template``.
  * ``no-python-branch-on-tensor`` — an ``if``/``while`` in a hot module
    on a local assigned from a ``torch.`` call. In eager PyTorch that
    branch is ``bool(tensor)``, a host sync (the reference's rule,
    ``no-python-branch-on-tracer``, catches the same branch as a trace
    error). Heuristic, with the reference's safe idioms — identity tests,
    static attributes (``.shape``, ``.dtype``, ``.device``, ``.dim()``,
    ...) and names re-bound to host values are not tracked — and two of
    its own: ``isinstance`` and ``len``, which read no value.

The reference's ``compat-choke-point`` has no counterpart: the port has no
``compat.py`` and touches no JAX-version-sensitive surface.

Pure stdlib (ast + os): importable without torch, so the source sweep
stays fast and runs anywhere. A copy of the reference's engine, not an
import of it.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
SRC_ROOT = os.path.join(REPO_ROOT, "src", "repro_torch")
PACKAGE = "repro_torch"

# modules on the per-element dispatch path — the reference's set, plus the
# port's own modules on the same path (its threefry and its uint32 word
# algebra); dedup/metrics.py stays outside, the sanctioned read-out point
HOT_MODULES = (
    "core/batched.py", "core/packed.py", "core/engine.py",
    "core/hashing.py", "core/sketch.py", "core/state.py",
    "core/prng.py", "core/u32.py",
    "dedup/sharded.py", "dedup/pipeline.py", "kernels/",
)

SHIM_MODULES = ("fused_step", "fused_counter_step")
SHIM_EXEMPT = ("kernels/fused_step.py", "kernels/fused_counter_step.py")

HOST_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy", "synchronize")
NUMPY_SYNC_ATTRS = ("asarray", "array")

# calls whose result is a tensor; the listed torch callables return host
# values (devices, dtypes info, sizes, process-group facts)
TENSOR_CALL_PREFIXES = ("torch.",)
HOST_CALL_PREFIXES = ("torch.device", "torch.Size", "torch.iinfo",
                      "torch.finfo", "torch.cuda.", "torch.distributed.",
                      "torch.is_", "torch.get_", "torch.are_")

# attribute reads that never read a tensor's values — branching on them is
# fine
STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "type", "is_cuda",
                "layout", "size", "dim", "numel", "element_size",
                "is_contiguous", "stride", "data_ptr", "nbytes")
# builtins that read a tensor's type or length, never its values
TYPE_ONLY_CALLS = ("isinstance", "len")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation. ``where`` is the entry-point name (trace rules)
    or ``path::token`` (source rules); the ``key`` is the stable identity
    the baseline suppresses — free of line numbers and sizes, so unrelated
    edits do not churn it."""
    rule: str
    where: str
    detail: str

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.where}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "where": self.where,
                "detail": self.detail, "key": self.key}


@dataclasses.dataclass(frozen=True)
class SourceRule:
    """One source convention. ``check(relpath, tree, text, hot)`` returns
    findings; ``hot`` says whether the file is on the hot-path set."""
    name: str
    doc: str
    check: Callable[[str, ast.AST, str, bool], List[Finding]]


SOURCE_RULES: Dict[str, SourceRule] = {}

# the reference's rules that have no counterpart here, and why
NO_COUNTERPART = {
    "compat-choke-point": "no counterpart: the port has no compat.py and "
                          "no JAX-version-sensitive surface",
}


def _register(rule: SourceRule) -> SourceRule:
    if rule.name in SOURCE_RULES:
        raise ValueError(f"duplicate rule {rule.name!r}")
    SOURCE_RULES[rule.name] = rule
    return rule


# ------------------------------------------------------------- ast helpers


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` from the Attribute chain, None if the
    root is not a plain Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _numpy_aliases(tree: ast.AST) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "numpy":
                    out.add(alias.asname or "numpy")
    return out


# ------------------------------------------------------------------- rules


def _check_host_sync(relpath: str, tree: ast.AST, text: str, hot: bool
                     ) -> List[Finding]:
    if not hot:
        return []
    np_aliases = _numpy_aliases(tree)
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            continue
        dotted = dotted_name(fn) or f"?.{fn.attr}"
        root = dotted.split(".", 1)[0]
        if fn.attr in HOST_SYNC_ATTRS:
            findings.append(Finding(
                "no-host-sync-in-hot-path", f"{relpath}::{dotted}",
                f"line {node.lineno}: `{dotted}()` reads the card on the "
                f"host in a hot module — it waits for every queued step; "
                f"read out via dedup/metrics.py instead (DESIGN §7)"))
        elif root in np_aliases and fn.attr in NUMPY_SYNC_ATTRS:
            findings.append(Finding(
                "no-host-sync-in-hot-path", f"{relpath}::{dotted}",
                f"line {node.lineno}: `{dotted}(...)` on a tensor copies it "
                f"to the host in a hot module (DESIGN §7)"))
    return findings


_register(SourceRule(
    "no-host-sync-in-hot-path",
    "no .item()/.tolist()/.cpu()/.numpy()/.synchronize()/np.asarray in "
    "hot modules — metrics read out device-side (DESIGN §7)",
    _check_host_sync))


def _check_shim_import(relpath: str, tree: ast.AST, text: str, hot: bool
                       ) -> List[Finding]:
    rel = relpath.replace(os.sep, "/")
    if rel.endswith(SHIM_EXEMPT):
        return []
    findings = []
    for node in ast.walk(tree):
        mod = None
        if isinstance(node, ast.ImportFrom) and node.module:
            mod = node.module
        elif isinstance(node, ast.Import):
            mod = ",".join(a.name for a in node.names)
        if mod and any(s in mod for s in SHIM_MODULES):
            findings.append(Finding(
                "no-deprecated-shim-import", f"{relpath}::{mod}",
                f"line {node.lineno}: imports deprecated kernel name module "
                f"`{mod}` — use kernels.fused_template (DESIGN §3.8)"))
    return findings


_register(SourceRule(
    "no-deprecated-shim-import",
    "port code imports kernels.fused_template, not the fused_step/"
    "fused_counter_step deprecated names (DESIGN §3.8)",
    _check_shim_import))


def _value_names(test: ast.AST) -> List[ast.Name]:
    """Name nodes whose VALUE the branch test consumes: identity checks
    (``x is None``) and static-attribute reads (``x.shape[0]``,
    ``x.dim()``) read no tensor value and are skipped."""
    if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return []
    out: List[ast.Name] = []

    def rec(n: ast.AST):
        if isinstance(n, ast.Attribute) and n.attr in STATIC_ATTRS:
            return
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in TYPE_ONLY_CALLS:
            return
        if isinstance(n, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            return
        if isinstance(n, ast.Name):
            out.append(n)
        for c in ast.iter_child_nodes(n):
            rec(c)
    rec(test)
    return out


def _is_tensor_call(val: ast.AST) -> bool:
    if not isinstance(val, ast.Call):
        return False
    dotted = dotted_name(val.func) or ""
    return (dotted.startswith(TENSOR_CALL_PREFIXES)
            and not dotted.startswith(HOST_CALL_PREFIXES))


def _check_tensor_branch(relpath: str, tree: ast.AST, text: str, hot: bool
                         ) -> List[Finding]:
    if not hot:
        return []
    findings = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        tensors: set = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if _is_tensor_call(node.value):
                    tensors.add(name)
                    continue
                # any other re-binding makes the name host-valued again
                tensors.discard(name)
        if not tensors:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            kind = "if" if isinstance(node, ast.If) else "while"
            for leaf in _value_names(node.test):
                if leaf.id in tensors:
                    findings.append(Finding(
                        "no-python-branch-on-tensor",
                        f"{relpath}::{fn.name}/{leaf.id}",
                        f"line {node.lineno}: Python `{kind}` on "
                        f"`{leaf.id}`, which is assigned from a torch call "
                        f"in `{fn.name}` — branching on a tensor reads it "
                        f"on the host (bool(tensor)), a sync per step"))
                    break
    return findings


_register(SourceRule(
    "no-python-branch-on-tensor",
    "no Python if/while on locals assigned from torch calls in hot modules "
    "— bool(tensor) is a host sync (heuristic)",
    _check_tensor_branch))


# ------------------------------------------------------------------ driver


def iter_src_files() -> Iterable[str]:
    for dirpath, dirs, files in os.walk(SRC_ROOT):
        dirs.sort()
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _relpath(path: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), REPO_ROOT)
    if rel.startswith(".."):
        rel = os.path.basename(path)
    return rel.replace(os.sep, "/")


def is_hot(relpath: str) -> bool:
    rel = relpath.replace(os.sep, "/")
    for mod in HOT_MODULES:
        tail = f"{PACKAGE}/{mod}"
        if mod.endswith("/"):
            if f"/{tail}" in f"/{rel}":
                return True
        elif rel.endswith(tail):
            return True
    return False


def lint_sources(paths: Optional[Sequence[str]] = None,
                 rules: Optional[Sequence[str]] = None,
                 hot: Optional[bool] = None) -> List[Finding]:
    """Sweep ``src/repro_torch`` (or explicit ``paths``) with every source
    rule. ``hot`` overrides hot-module classification (tests pass hot=True
    to run the hot-only rules against a scratch file)."""
    selected = ([SOURCE_RULES[r] for r in rules] if rules is not None
                else list(SOURCE_RULES.values()))
    findings: List[Finding] = []
    for path in (paths if paths is not None else iter_src_files()):
        rel = _relpath(path)
        with open(path, errors="replace") as f:
            text = f.read()
        try:
            tree = ast.parse(text)
        except SyntaxError as e:
            findings.append(Finding("lint-error", rel,
                                    f"SyntaxError: {e}"))
            continue
        file_hot = is_hot(rel) if hot is None else hot
        for rule in selected:
            findings.extend(rule.check(rel, tree, text, file_hot))
    return findings
