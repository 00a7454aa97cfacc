"""Per-device step analysis — the port of ``repro.launch.analysis``:
cost, memory and collective bytes of one run of a step, under the
reference's record keys.

``analyze_step(step_fn, args)`` runs the step once, with its arguments as
they are (DTensors on a mesh, plain tensors on one device; real, or fake
under ``FakeTensorMode`` on a fake process group, which is how the dry
run plans a 256-rank mesh on one host), under three counting modes:

  * ``cost`` — ``flops`` from ``torch.utils.flop_counter``'s formulas (an
    einsum that arrives whole, as torch 2.11 hands DTensor's, by
    ``einsum_flops``) and
    ``bytes_accessed``, the operand plus result bytes of every aten op
    that is not a view or a collective. An eager step has no fusion, so
    every op boundary touches device memory: the reference's own rule for
    post-fusion HLO. ``bytes_by_op`` and ``flops_by_op`` split them by
    aten op (``"aten.clone"``, ...); the bytes of ``aten.copy_``,
    ``aten.clone`` and ``aten._to_copy`` together are the reference's
    ``essential_by_op["copy"]`` (``copy_bytes``).
  * ``memory`` — ``argument_size_in_bytes`` and ``output_size_in_bytes``
    (each storage once; ``alias_size_in_bytes`` the outputs that are
    arguments), and ``temp_size_in_bytes``: the peak that
    ``torch.distributed._tools.mem_tracker.MemTracker`` sees above the
    arguments.
  * ``collectives_bytes`` / ``collectives_counts`` — by the reference's
    names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``; ``total``): counts from
    ``torch.distributed.tensor.debug.CommDebugMode``, bytes the result
    bytes of each collective (a c10d op's output tensors, its first
    argument). A redistribution from one split dimension to another
    (DTensor's ``shard_dim_alltoall``) counts as the one all-to-all of
    its local result that the card runs, on any mesh: on a CPU mesh
    DTensor runs it as an all-gather and a chunk (gloo has no
    all-to-all), and none of that is counted. ``collectives_by_op``
    splits the bytes by the DTensor op dispatched last before each
    collective (the op whose redistribution it is; ``"step"`` before
    any), {op: {kind: bytes}}.

Every mode lets DTensor run first and counts the local ops and the
collectives it turns each op into, so every number is per device, as the
reference's compiled per-device module gives it. The reference's
``loop_aware_analysis`` and its HLO-text parsers have no counterpart:
they rebuild trip counts of scanned loops that XLA's cost analysis counts
once, while these counters see every op that runs.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
# the aten ops whose bytes are the reference's essential_by_op["copy"]
COPY_OPS = ("aten.copy_", "aten.clone", "aten._to_copy")


def collective_kind(name: str):
    """The reference's name of a collective op (``c10d.allreduce_``,
    ``_c10d_functional.all_gather_into_tensor``, ...), or None."""
    flat = name.replace("_", "")
    for pat, kind in (("allgather", "all-gather"),
                      ("reducescatter", "reduce-scatter"),
                      ("allreduce", "all-reduce"),
                      ("alltoall", "all-to-all"),
                      ("broadcast", "broadcast")):
        if pat in flat:
            return kind
    return None


def _tensors(x) -> list:
    """Every tensor of a tree: dicts, lists and tuples (NamedTuples
    too), dataclasses (``FilterState``), modules (their parameters and
    buffers)."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters()) + list(x.buffers())
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _storage_bytes(x) -> dict:
    """{storage: bytes} of every tensor of a tree, each storage once."""
    out = {}
    for t in _tensors(x):
        t = _local(t)
        st = t.untyped_storage()
        out[st._cdata] = max(out.get(st._cdata, 0), st.nbytes())
    return out


def einsum_flops(equation: str, shapes) -> int:
    """2 x the multiply-adds of ``torch.einsum(equation, *operands)`` of
    these shapes, contracted left to right as torch lowers it: a step
    that sums a letter both sides hold is a bmm over the letters it keeps
    and sums; a step that sums none is an elementwise product, which
    ``torch.utils.flop_counter`` counts as none; a letter one side holds
    and no later term needs is summed first, for none. Where an einsum
    reaches the counters whole (torch 2.11 hands DTensor's local einsums
    to a dispatch mode undecomposed; 2.13 lowers them to bmm first), its
    flops are counted from this. No ellipsis."""
    import math
    lhs, arrow, out = equation.replace(" ", "").partition("->")
    terms = lhs.split(",")
    if not arrow:
        letters = "".join(terms)
        out = "".join(sorted(c for c in set(letters)
                             if letters.count(c) == 1))
    size = {c: int(n) for t, shp in zip(terms, shapes)
            for c, n in zip(t, shp)}
    flops, cur = 0, set(terms[0])
    for i, term in enumerate(terms[1:], 1):
        later = set(out).union(*terms[i + 1:])
        both, union = cur & set(term), cur | set(term)
        if both - later:          # a contraction: a bmm; else a broadcast mul
            flops += 2 * math.prod(size[c] for c in both | (union & later))
        cur = union & later
    return flops


def _is_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class _Propagating:
    """The depth of DTensor's sharding propagation while a step is
    counted (``_as_propagation``): DTensor runs an op on fake tensors of
    the global shapes to learn the output's, which under an outer
    ``FakeTensorMode`` (the dry run; torch 2.11 runs it under any fake
    mode it finds) the counters would otherwise take for the step's own
    ops."""

    def __init__(self):
        self.depth = 0


@contextlib.contextmanager
def _as_propagation(cls, name: str, propagating: _Propagating):
    """For the duration, ``cls.name`` (a method or a static method) runs
    as propagation: nothing it runs is counted."""
    raw = vars(cls)[name]
    fn = raw.__func__ if isinstance(raw, staticmethod) else raw

    def uncounted(*args, **kwargs):
        propagating.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            propagating.depth -= 1

    setattr(cls, name, staticmethod(uncounted)
            if isinstance(raw, staticmethod) else uncounted)
    try:
        yield
    finally:
        setattr(cls, name, raw)


@contextlib.contextmanager
def _propagation_uncounted(propagating: _Propagating):
    """DTensor's two propagations that run ops, uncounted: an op's output
    metadata (``ShardingPropagator._propagate_tensor_meta_non_cached``)
    and a composite op's placements learned from its decomposition at
    the global shapes on a one-rank mesh
    (``DecompShardingStrategy.propagate_strategy``; torch 2.13 uses it
    for an einsum that reaches DTensor whole)."""
    from torch.distributed.tensor._decompositions import \
        DecompShardingStrategy
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    with _as_propagation(ShardingPropagator,
                         "_propagate_tensor_meta_non_cached", propagating), \
            _as_propagation(DecompShardingStrategy, "propagate_strategy",
                            propagating):
        yield


def _call_site() -> str:
    """The innermost frame of the port's model, data or optimizer code on
    the stack (not the placement's or the analysis's own), as
    ``models/layers.py:459 weighted_xent``; "step" where there is none."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    skip = (os.path.join(root, "launch"), os.path.join(root, "train",
                                                       "steps.py"))
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(root) and not name.startswith(skip):
            return (f"{os.path.relpath(name, root)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "step"


def _mem_tracker(propagating: _Propagating, by_op: bool = False):
    """A ``MemTracker`` that leaves DTensor's shape propagation out.
    ``by_op``: it also keeps, at each new peak, the bytes then live of
    each storage made in the step by the aten op and the port's line that
    made it (``peak_by_op``; the arguments are left out)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.weak import WeakIdKeyDictionary

    class Tracker(MemTracker):
        peak_by_op: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if propagating.depth and not _is_dtensor(types):
                return func(*args, **(kwargs or {}))
            if by_op and not _is_dtensor(types):
                self._op = f"{func.overloadpacket} @ {_call_site()}"
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _track(self, reftype, t):
            super()._track(reftype, t)
            if by_op:
                st = t.untyped_storage()
                if st not in self._made_by:
                    self._made_by[st] = self._op

        def _update_peak_stats(self, peak_state):
            before = dict(self._peak_mem)
            super()._update_peak_stats(peak_state)
            if by_op and self._peak_mem != before:
                live = defaultdict(int)
                for st, (winfo, _) in list(self._WINFO.items()):
                    site = self._made_by.get(st)
                    if site is not None:
                        live[site] += winfo.mem_consumed
                self.peak_by_op = dict(live)

    mt = Tracker()
    mt._made_by, mt._op = WeakIdKeyDictionary(), "step"
    return mt


class _OpCounter(TorchDispatchMode):
    """flops, bytes of every op, and result bytes of every collective, on
    local tensors (a DTensor op is left to DTensor, which comes back with
    its local ops and collectives)."""

    def __init__(self, propagating: _Propagating):
        super().__init__()
        self.propagating = propagating
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.by_op = defaultdict(int)
        self.flops_by_op = defaultdict(int)
        self.coll = defaultdict(int)
        self.coll_by_op = defaultdict(lambda: defaultdict(int))
        self.owner = "step"

    def __enter__(self):
        # DTensor works out an op's output placement by running it under a
        # fake mode of its own: only ops under the entry's mode are counted
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        if _is_dtensor(types):
            if not self.propagating.depth:
                self.owner = str(func.overloadpacket)
            return NotImplemented
        kwargs = kwargs or {}
        if self._arrives_whole(func):
            # a composite op (``matmul``, ...) that inference mode hands
            # over undecomposed: its pieces are counted, as autograd's
            # lowering hands them over elsewhere
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                self.propagating.depth or \
                active_fake_mode() is not self._fake_on_entry:
            return out
        name = func._schema.name
        kind = collective_kind(name)
        if kind is not None:
            # the result: a functional collective's output, a c10d op's
            # first argument (its output tensors)
            res = out if name.startswith("_c10d_functional") or \
                name.startswith("c10d_functional") else args[0]
            self.add_collective(kind, _nbytes(_tensors(res)))
            return out
        if "wait_tensor" in name or func.is_view or \
                func.namespace != "aten":
            return out                # no memory touched (``prim.device``)
        packet = func.overloadpacket
        flops = 0
        if packet in self.registry:
            flops = self.registry[packet](*args, **kwargs, out_val=out)
        elif packet is torch.ops.aten.einsum:
            flops = einsum_flops(args[0], [t.shape for t in args[1]])
        if flops:
            self.flops += flops
            self.flops_by_op[str(packet)] += flops
        nb = _nbytes(_tensors(args)) + _nbytes(_tensors(kwargs)) \
            + _nbytes(_tensors(out))
        self.bytes += nb
        self.by_op[str(packet)] += nb
        return out

    def _arrives_whole(self, func) -> bool:
        """``func`` a CompositeImplicitAutograd op that has no flop formula
        of its own (``aten.einsum`` is counted by ``einsum_flops``)."""
        if not isinstance(func, torch._ops.OpOverload) or \
                func.namespace != "aten" or \
                func.overloadpacket in self.registry or \
                func.overloadpacket is torch.ops.aten.einsum:
            return False
        return torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)

    def add_collective(self, kind: str, nbytes: int) -> None:
        self.coll[kind] += nbytes
        self.coll_by_op[self.owner][kind] += nbytes


def _by_kind(counts) -> dict:
    out = defaultdict(int)
    for op, n in counts.items():
        kind = collective_kind(str(op)) or str(op)
        out[kind] += int(n)
    return dict(out)


def copy_bytes(cost: dict) -> int:
    """The bytes of a record's copies (``COPY_OPS``): the reference's
    ``essential_by_op["copy"]``."""
    return sum(cost.get("bytes_by_op", {}).get(op, 0) for op in COPY_OPS)


@contextlib.contextmanager
def _alltoall_as_the_card_runs_it(propagating, mt, counter, comm):
    """For the duration, DTensor's ``shard_dim_alltoall`` (a Shard(i) ->
    Shard(j) redistribution) runs with nothing of it counted and is
    then recorded as one all-to-all of its local result: count, bytes,
    and the result's memory. ``Shard._to_new_shard_dim`` calls it by its
    name in ``placement_types``."""
    from torch.distributed.tensor import placement_types
    orig = placement_types.shard_dim_alltoall
    key = torch.ops._dtensor.shard_dim_alltoall

    def counted(*args, **kwargs):
        counts = dict(comm.comm_counts)
        propagating.depth += 1
        try:
            out = orig(*args, **kwargs)
        finally:
            propagating.depth -= 1
            comm.comm_counts.clear()
            comm.comm_counts.update(counts)
        comm.comm_counts[key] += 1
        counter.add_collective("all-to-all", _nbytes([out]))
        mt.track_external(out)
        return out

    placement_types.shard_dim_alltoall = counted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def analyze_step(step_fn, args, peak_by_op: bool = False) -> dict:
    """Run ``step_fn(*args)`` once and count it, per device. -> {"cost",
    "memory", "collectives_bytes", "collectives_counts", "run_s",
    "outputs"} (the step's outputs, for the caller to use or drop).
    ``peak_by_op``: ``memory["peak_by_op"]`` holds the temp live at the
    peak by the op and line that made it ({"aten.exp @
    models/layers.py:458 weighted_xent": bytes}, largest first)."""
    from torch.distributed.tensor.debug import CommDebugMode
    arg_st = _storage_bytes(args)
    propagating = _Propagating()
    mt = _mem_tracker(propagating, peak_by_op)
    mt.track_external(*_tensors(args))
    counter = _OpCounter(propagating)
    comm = CommDebugMode()
    t0 = time.perf_counter()
    with mt, comm, counter, _propagation_uncounted(propagating), \
            _alltoall_as_the_card_runs_it(propagating, mt, counter, comm):
        out = step_fn(*args)
    run_s = time.perf_counter() - t0
    peak = max((snap["Total"] for snap in
                mt.get_tracker_snapshot("peak").values()), default=0)
    out_st = _storage_bytes(out)
    coll_bytes = dict(counter.coll)
    coll_bytes["total"] = sum(coll_bytes.values())
    counts = _by_kind(comm.get_comm_counts())
    memory = {
        "argument_size_in_bytes": sum(arg_st.values()),
        "output_size_in_bytes": sum(out_st.values()),
        "alias_size_in_bytes": sum(b for s, b in out_st.items()
                                   if s in arg_st),
        "temp_size_in_bytes": max(0, peak - sum(arg_st.values()))}
    if peak_by_op:
        memory["peak_by_op"] = dict(sorted(mt.peak_by_op.items(),
                                           key=lambda kv: -kv[1]))
    return {
        "cost": {"flops": float(counter.flops),
                 "bytes_accessed": float(counter.bytes),
                 "bytes_by_op": dict(counter.by_op),
                 "flops_by_op": dict(counter.flops_by_op)},
        "memory": memory,
        "collectives_bytes": coll_bytes,
        "collectives_by_op": {op: dict(k) for op, k in
                              counter.coll_by_op.items()},
        "collectives_counts": counts,
        "run_s": run_s,
        "outputs": out,
    }
