"""Train steps — the port of ``repro.train.steps``.

``make_train_step`` builds a (params, opt_state, batch, weights) ->
(params, opt_state, metrics) function with optional gradient
accumulation: the batch is split into ``accum_steps`` microbatches, each
one's gradients (in the param dtype, as autograd gives them) are added
into a buffer of ``accum_dtype`` (fp32 by default) — never summed in
bf16 in ``.grad`` — and the result is ``loss / accum`` and ``grads /
accum`` in fp32. Each microbatch's loss normalises by its own weight sum;
weights of None are ones. The params are updated in place
(``optim.apply_updates``); the reference donates them instead.

Loss weights flow in from the dedup pipeline (the paper's technique
gating what the optimizer sees).

``jit_sharded`` places a step on a ``DeviceMesh``: its arguments become
DTensors under their partition specs (``distributed.sharding``), and
DTensor's sharding propagation turns every op into its local form plus
the collectives it needs — the counterpart of the reference's jit with
named shardings, where XLA's SPMD partitioner does that. There, an
accumulating step takes each microbatch from the rows every rank holds
(``_microbatches``), so that each rank computes its share of it.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import inspect
import math
import threading
from typing import Callable

import torch
from torch import nn

from ..distributed.sharding import PartitionSpec, placements, shard_extent
from ..optim import OptimizerConfig, OptState, apply_updates


def batch_leading(batch) -> int:
    """The leading (batch) size of a tensor or of a dict of tensors'
    first leaf, in the reference's tree order."""
    while isinstance(batch, dict):
        batch = batch[sorted(batch)[0]]
    return batch.shape[0]


def _row_split_dims(x) -> list:
    """The mesh dimensions that split a DTensor's rows (dim 0), in mesh
    order; [] for a plain tensor or one whose rows are whole."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return []
    return [j for j, pl in enumerate(x.placements)
            if type(pl) is Shard and pl.dim % x.ndim == 0]


def _microbatches(x: torch.Tensor, accum: int) -> list:
    """``x``'s rows as ``accum`` microbatches of consecutive rows, as
    ``x[i * mb:(i + 1) * mb]`` gives them. A DTensor whose rows are split
    over D ranks gives DTensors split in the same way, each rank holding
    mb / D rows of every microbatch, so that every rank computes its
    share of each one (a slice of the split dimension would gather the
    whole batch to every rank). The rows travel once, in one all-to-all
    per mesh dimension that splits them; on a one-rank split none moves.

    Rank r (its index over those mesh dimensions, in mesh order) holds
    rows [r L, (r + 1) L), L = n / D, as ``accum`` blocks of c = mb / D
    rows; block k = r accum + q is rows [k c, (k + 1) c) of microbatch
    k // D, and belongs to rank k % D. Each rank sends its blocks in a
    (D, m, c, ...) buffer, m = ceil(accum / D): block q in row k % D,
    slot q // D (zeros where a rank has no block for another). The buffer
    travels one mesh dimension at a time (``all_to_all_single`` over that
    dimension's group, its row axis split into the dimensions' sizes),
    after which row s holds what rank s sent, and rank a reads block
    k = i D + a of microbatch i from row k // accum, slot (k % accum) //
    D. It is an explicit collective and not a DTensor redistribution,
    which on a CPU mesh would run as an all-gather."""
    from torch.distributed.tensor import DTensor
    n = x.shape[0]
    mb = n // accum
    dims = _row_split_dims(x)
    if not dims:
        return [x[i * mb:(i + 1) * mb] for i in range(accum)]
    mesh = x.device_mesh
    d = math.prod(mesh.size(j) for j in dims)
    if n % d or mb % d:
        raise ValueError(f"{accum} microbatches of {n} rows do not split "
                         f"evenly over the {d} ranks that split the rows")
    c = mb // d
    coord = mesh.get_coordinate()
    rank = 0
    for j in dims:
        rank = rank * mesh.size(j) + coord[j]
    local = x.to_local()
    rest, g_rest = tuple(local.shape[1:]), tuple(x.shape[1:])

    def as_dtensor(t, pls, shape):
        return DTensor.from_local(t, mesh, pls, run_check=False, shape=shape,
                                  stride=_contiguous_strides(shape))

    if d == 1:
        return [as_dtensor(local[i * c:(i + 1) * c], x.placements,
                           (mb,) + g_rest) for i in range(accum)]
    from torch.distributed import _functional_collectives as funcol
    m = -(-accum // d)
    buf = local.new_zeros((d, m, c) + rest)
    for q in range(accum):
        buf[(rank * accum + q) % d, q // d] = local[q * c:(q + 1) * c]
    sizes = [mesh.size(j) for j in dims]
    buf = buf.view(*sizes, m, c, *rest)
    for t, j in enumerate(dims):
        sent = buf.movedim(t, 0).contiguous()
        got = funcol.wait_tensor(funcol.all_to_all_single(
            sent, None, None, (mesh, j)))
        buf = got.movedim(0, t)
    recv = buf.reshape(d, m, c, *rest)
    out = []
    for i in range(accum):
        k = i * d + rank
        out.append(as_dtensor(recv[k // accum, (k % accum) // d],
                              x.placements, (mb,) + g_rest))
    return out


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def _split_batch(batch, accum: int) -> list:
    """A batch (a tensor or a dict of them) as ``accum`` microbatches."""
    if isinstance(batch, dict):
        parts = {k: _split_batch(v, accum) for k, v in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(accum)]
    return _microbatches(batch, accum)


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    accum_steps: int = 1, accum_dtype=None):
    """loss_fn(params, batch, weights) -> scalar loss; ``params`` is a
    module (``models.layers.Params``) whose parameters the step trains.

    ``accum_dtype``: dtype of the gradient-accumulation buffer (fp32 by
    default; bf16 halves it, the update still runs on fp32 moments)."""

    def train_step(params, opt_state, batch, weights=None):
        named = list(params.named_parameters())
        tensors = [p for _, p in named]

        def grads_of(loss):
            return torch.autograd.grad(loss, tensors, allow_unused=True,
                                       materialize_grads=True)

        if accum_steps == 1:
            loss = loss_fn(params, batch, weights)
            grads = dict(zip((n for n, _ in named), grads_of(loss)))
        else:
            acc_dt = accum_dtype or torch.float32
            n = batch_leading(batch)
            if n % accum_steps:
                raise ValueError(f"a batch of {n} does not split into "
                                 f"{accum_steps} microbatches")
            device = tensors[0].device
            if weights is None:
                weights = torch.ones((n,), dtype=torch.float32,
                                     device=device)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            # ``new_zeros``: a placed param's buffer is a DTensor placed
            # as the param is, so the in-place adds stay DTensor ops
            acc = [p.new_zeros(p.shape, dtype=acc_dt) for p in tensors]
            for mb_batch, mb_weights in zip(
                    _split_batch(batch, accum_steps),
                    _microbatches(weights, accum_steps)):
                l_i = loss_fn(params, mb_batch, mb_weights)
                for a, g in zip(acc, grads_of(l_i)):
                    a.add_(g.to(acc_dt))
                loss = loss + l_i.detach()
            loss = loss / accum_steps
            # in place where the buffer is already fp32 (or wider, a
            # float64 referee's): g / accum either way
            grads = {name: a.to(torch.promote_types(a.dtype, torch.float32)
                                ).div_(accum_steps)
                     for (name, _), a in zip(named, acc)}
            del acc
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


# --------------------------------------------------------- jit_sharded --- //

def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _place(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh`` placed by ``spec``; a DTensor is
    redistributed where its placement differs. Every rank holds the whole
    of a plain ``t`` (the same seed and data), so each keeps its own
    shard and nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    want = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == want else t.redistribute(mesh,
                                                                    want)
    kw = ({"src_data_rank": None} if "src_data_rank" in
          inspect.signature(distribute_tensor).parameters else {})
    return distribute_tensor(t, mesh, want, **kw)


def _place_params(mod: nn.Module, specs, mesh, in_place: bool) -> nn.Module:
    """A ``Params`` tree with every parameter a DTensor under its leaf's
    spec (a stacked ``layers`` leaf's per-layer tensors under the spec
    without its leading L entry). ``in_place``: the module itself is
    changed; otherwise a copy of its structure that shares its tensors."""
    from ..models.layers import module_leaves
    if not in_place:
        mod = copy.deepcopy(mod, memo={id(p): p for p in mod.parameters()})
    for lf in module_leaves(mod):
        spec = _spec_at(specs, lf.path)
        if lf.stacked:
            if spec and spec[0] is not None:
                raise ValueError(f"{lf.path}: the stacked L axis is "
                                 f"sharded ({spec})")
            spec = PartitionSpec(*spec[1:])
        for key, t in zip(lf.keys, lf.tensors):
            owner, _, name = key.rpartition(".")
            placed = _place(t.detach(), spec, mesh)
            if placed is not t:
                setattr(mod.get_submodule(owner), name,
                        nn.Parameter(placed, requires_grad=t.requires_grad))
    return mod


def _place_tree(x, specs, mesh, in_place: bool):
    """An argument placed by its spec tree: a ``Params`` module, an
    ``OptState``, a dict or list of tensors, a tensor or ``None``. A 0-d
    tensor under ``P()`` stays as it is: the port keeps its step counters
    on the host, replicated by construction."""
    if x is None or specs is None:
        return x
    if isinstance(x, nn.Module):
        return _place_params(x, specs, mesh, in_place)
    if isinstance(x, OptState):
        return OptState(*(_place_tree(a, s, mesh, in_place)
                          for a, s in zip(x, specs)))
    if isinstance(x, dict):
        return {k: _place_tree(v, specs[k], mesh, in_place)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(specs,
                                                        PartitionSpec):
        return type(x)(_place_tree(v, s, mesh, in_place)
                       for v, s in zip(x, specs))
    if x.dim() == 0 and not any(specs):
        return x
    return _place(x, specs, mesh)


_RULES = []


def _register_rules() -> None:
    """Public sharding rules (``register_sharding``) for ops where
    DTensor's own rule does not fit the port's steps, registered once per
    process (DTensor's registry is global):

      * ``aten.gather`` along a sharded dimension (``weighted_xent``'s
        gold logit over a vocab split across "model"): DTensor's rule
        gives a masked partial whose mask does not fit the output, so the
        gathered dimension is replicated (an all-gather, which the
        analysis counts), other dimensions stay split;
      * ``aten.constant_pad_nd`` (``flash_sdpa``'s padding of its query
        and key blocks): torch 2.11's rule gives its output one
        placement whatever the mesh's rank; the rule here keeps each
        dimension that is not padded split as it was.

    The ops that need more than a placement rule go to handlers that
    ``_sharding_handlers`` installs only while a placed step runs."""
    if _RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.gather.default)
    def gather_rule(x, dim, index, sparse_grad=False):
        dim %= x.ndim
        out = [([Replicate()], [Replicate(), None, Replicate()])]
        out += [([Shard(d)], [Shard(d), None, Shard(d)])
                for d in range(x.ndim) if d != dim]
        return out

    @register_sharding(aten.constant_pad_nd.default)
    def pad_rule(x, pad, *rest):
        padded = {x.ndim - 1 - i // 2 for i, p in enumerate(pad) if p}
        tail = [None] * (1 + len(rest))
        out = [([Replicate()], [Replicate()] + tail)]
        out += [([Shard(d)], [Shard(d)] + tail)
                for d in range(x.ndim) if d not in padded]
        return out

    _RULES.extend((gather_rule, pad_rule))


def _handlers() -> dict:
    """{aten op: handler} for the ops DTensor's dispatch gets wrong for
    the port's steps:

      * ``aten.index_put_`` into a DTensor split along an indexed
        dimension (the decode cache's slot write, its batch over "data"
        and its sequence over "model"): DTensor has no in-place rule for
        it, so ``_sharded_index_put`` writes each rank's own entries;
      * ``aten.embedding`` from a table split by rows (the vocab over
        "model"): DTensor leaves the rows a masked partial sum whose mask
        it frees at its first reduction, so a second reader of the same
        rows (the residual and the norm of the first layer) fails;
        ``_reduced_embedding`` reduces them at once (the all-reduce of
        the looked-up rows that the reference's partitioner makes);
      * the bitwise operators ``&``, ``|`` and ``^`` (``aten.__and__``
        and the others; the attention masks, the wide crosses): DTensor
        takes them for in-place ops by their trailing underscore, and
        under inference mode returns the first operand unchanged, so they
        run as ``bitwise_and`` / ``bitwise_or`` / ``bitwise_xor``;
      * ``aten.view`` / ``aten._unsafe_view``: DTensor's view rule is
        strict, and refuses a view that would need its input
        redistributed (GQA's 32 query heads over "model" 16 regrouped as
        8 KV heads x 4; the flattening of a strided shard in the gradient
        of deepseek's MoE groups); ``_view_or_gather`` redistributes the
        input as DTensor's rule for a reshape asks first."""
    aten = torch.ops.aten
    out = {aten.index_put_.default: _sharded_index_put,
           aten.embedding.default: _reduced_embedding,
           aten.view.default: _view_or_gather,
           aten._unsafe_view.default: _view_or_gather}
    for name, fn in (("__and__", torch.bitwise_and),
                     ("__or__", torch.bitwise_or),
                     ("__xor__", torch.bitwise_xor)):
        for overload in ("Tensor", "Scalar"):
            out[getattr(getattr(aten, name), overload)] = functools.partial(
                _as_function, fn)
    return out


# DTensor's dispatcher keeps one table of op handlers for the process. The
# handlers are in it while any placed step runs (a count of the steps that
# do); the lock guards the count and each handler's own pass-through
# (``_dispatch_unhandled``), which takes the handler out of the table for
# one op. It is held for that op alone, never across a step: a step's
# backward runs its ops on autograd's device thread while the step's own
# thread waits for it.
_HANDLERS_LOCK = threading.RLock()
_HANDLERS_USERS = [0]
_HANDLERS_SAVED: dict = {}
_MISSING = object()


@contextlib.contextmanager
def _sharding_handlers():
    """``_handlers()`` in DTensor's table of op handlers for the duration,
    what was there before put back when the last placed step ends: other
    users of DTensor in the process see its own dispatch."""
    from torch.distributed.tensor import DTensor
    table = DTensor._op_dispatcher._custom_op_handlers
    with _HANDLERS_LOCK:
        if not _HANDLERS_USERS[0]:
            ours = _handlers()
            _HANDLERS_SAVED.update(
                (op, table.get(op, _MISSING)) for op in ours)
            table.update(ours)
        _HANDLERS_USERS[0] += 1
    try:
        yield
    finally:
        with _HANDLERS_LOCK:
            _HANDLERS_USERS[0] -= 1
            if not _HANDLERS_USERS[0]:
                for op, h in _HANDLERS_SAVED.items():
                    if h is _MISSING:
                        table.pop(op, None)
                    else:
                        table[op] = h
                _HANDLERS_SAVED.clear()


def _dispatch_unhandled(op_call, args, kwargs):
    """``op_call`` through DTensor's own dispatch, past the handler
    installed for it here: the handler is out of the table for this op
    (under ``_HANDLERS_LOCK``, so that no other thread's op of the same
    kind runs past its handler meanwhile; an op of the same kind that
    DTensor runs inside this one gets DTensor's own dispatch too)."""
    from torch.distributed.tensor import DTensor
    table = DTensor._op_dispatcher._custom_op_handlers
    with _HANDLERS_LOCK:
        handler = table.pop(op_call, None)
        try:
            return op_call(*args, **kwargs)
        finally:
            if handler is not None:
                table[op_call] = handler


def _as_function(fn, op_call, args, kwargs):
    """``op_call`` as the out-of-place function ``fn``."""
    return fn(*args, **kwargs)


def _reduced_embedding(op_call, args, kwargs):
    """``aten.embedding`` with any partial sum in its output reduced."""
    from torch.distributed.tensor import Replicate
    out = _dispatch_unhandled(op_call, args, kwargs)
    if any(pl.is_partial() for pl in out.placements):
        out = out.redistribute(placements=[
            Replicate() if pl.is_partial() else pl for pl in out.placements])
    return out


def _resolved(shape, numel: int) -> tuple:
    """A view's shape with its -1 (if any) worked out."""
    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = numel // math.prod(
            s for s in shape if s != -1)
    return tuple(shape)


def _splits(pl) -> bool:
    return not (pl.is_replicate() or pl.is_partial())


def _local_numel(shape, pls, mesh_sizes):
    """Elements of each rank's shard of a tensor of ``shape`` under
    ``pls``; None where a split does not divide its dimension."""
    parts = [1] * len(shape)
    for j, pl in enumerate(pls):
        if _splits(pl):
            parts[pl.dim % len(shape)] *= mesh_sizes[j]
    if any(s % n for s, n in zip(shape, parts)):
        return None
    return math.prod(s // n for s, n in zip(shape, parts))


def _view_placements(x, shape) -> tuple:
    """The placements ``x`` must have for DTensor to view it as
    ``shape``: DTensor's own rule for a reshape (``view_groups`` and
    ``propagate_shape_and_sharding`` without strictness), which demotes
    to ``Replicate`` each split that the view cannot keep (a dimension
    split into factors the mesh does not divide, a split dimension
    flattened behind another). That rule checks a dimension split over
    two mesh dimensions (the batch over ("pod", "data")) against each
    mesh dimension alone; where the shards it gives the output do not
    hold the input's elements, the input's innermost split is demoted too,
    until they do."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._ops._view_ops import (
        propagate_shape_and_sharding, view_groups)
    in_shape = tuple(x.shape)
    out_shape = _resolved(shape, x.numel())
    rule = view_groups(in_shape, out_shape)
    sizes = tuple(x.device_mesh.shape)
    src = list(x.placements)
    while True:
        want, out = propagate_shape_and_sharding(
            src, in_shape, rule, sizes, strict_view=False)
        n_in = _local_numel(in_shape, want, sizes)
        if n_in is None or n_in == _local_numel(out_shape, out, sizes):
            return tuple(want)
        src[max(j for j, pl in enumerate(src) if _splits(pl))] = Replicate()


def _view_fits(sizes, strides, new_sizes) -> bool:
    """Whether a tensor of ``sizes`` laid out by ``strides`` can be viewed
    as ``new_sizes`` (``new_sizes`` with no -1): torch's own test
    (``computeStride``), which cuts each run of dimensions that are laid
    out one after another into whole new dimensions."""
    if not sizes or 0 in sizes:
        return True
    view_d = len(new_sizes) - 1
    base = strides[-1]
    t_numel = v_numel = 1
    for d in range(len(sizes) - 1, -1, -1):
        t_numel *= sizes[d]
        if d == 0 or (sizes[d - 1] != 1
                      and strides[d - 1] != t_numel * base):
            while view_d >= 0 and (v_numel < t_numel
                                   or new_sizes[view_d] == 1):
                v_numel *= new_sizes[view_d]
                view_d -= 1
            if v_numel != t_numel:
                return False
            if d > 0:
                base = strides[d - 1]
                t_numel = v_numel = 1
    return view_d == -1


def _view_or_gather(op_call, args, kwargs):
    """A view of a DTensor whose input first takes the placements that
    DTensor's rule for a reshape gives it (``_view_placements``: an
    all-gather of each split the view cannot keep, which the analysis
    counts), and whose local tensor is first made contiguous where it is
    not and may not take the view: a split shard, or a whole one whose
    own strides do not fit it (``_view_fits``) — a permuted local tensor
    (an einsum's operand before its flattening) cannot take a view that
    the DTensor's strides allow."""
    from torch.distributed.tensor import DTensor
    x = args[0]
    if any(_splits(pl) for pl in x.placements):
        want = _view_placements(x, args[1])
        if want != tuple(x.placements):
            x = x.redistribute(placements=want)
    local = x._local_tensor
    if not local.is_contiguous() and (
            any(_splits(pl) for pl in x.placements)
            or not _view_fits(local.shape, local.stride(),
                              _resolved(args[1], x.numel()))):
        x = DTensor.from_local(local.contiguous(), x.device_mesh,
                               x.placements, run_check=False, shape=x.shape,
                               stride=x.stride())
    return _dispatch_unhandled(op_call, (x, *args[1:]), kwargs)


def _sharded_index_put(op_call, args, kwargs):
    """``self.index_put_(indices, values)`` (no accumulate) where ``self``
    is a DTensor split along an indexed dimension: the indices and values
    made whole (all-gathers of a few entries), each index shifted into
    this rank's shard, and the entries outside it written as duplicates
    of an entry inside it (or, with none inside, of the value already at
    the shard's first position), so every write stays a plain local
    ``index_put_`` with no data-dependent shape. Any other case goes to
    DTensor's own dispatch."""
    from torch.distributed.tensor import DTensor, Shard
    self_, indices, values = args[:3]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                          False)
    split = {pl.dim % self_.ndim for pl in self_.placements
             if isinstance(pl, Shard)}
    if (accumulate or any(i is None for i in indices)
            or not split & set(range(len(indices)))):
        return _dispatch_unhandled(op_call, args, kwargs)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    local = self_._local_tensor
    shape = self_.shape
    mesh = self_.device_mesh
    lshape, offset = shard_extent(shape, self_.placements, mesh.mesh.shape,
                                  mesh.get_coordinate())
    idx = torch.broadcast_tensors(*(whole(i).long() for i in indices))
    n, lead = len(idx), idx[0].dim()
    vals = whole(values).to(local.dtype).expand(*idx[0].shape, *shape[n:])
    for d in range(n, self_.ndim):               # the value's own shard
        vals = vals.narrow(lead + d - n, offset[d], lshape[d])
    inside, li = None, []
    for d, t in enumerate(idx):
        t = torch.where(t < 0, t + shape[d], t) - offset[d]
        ok = (t >= 0) & (t < lshape[d])
        inside = ok if inside is None else inside & ok
        li.append(t.reshape(-1))
    inside = inside.reshape(-1)
    vals = vals.reshape(-1, *vals.shape[lead:])
    any_in = inside.any()
    # index tensors of one entry throughout: a 0-d index would be read
    # back to the host as a Python int
    first = inside.to(torch.int8).argmax().reshape(1)
    pivot = [torch.where(any_in, t.index_select(0, first), 0) for t in li]
    pivot_val = torch.where(any_in, vals.index_select(0, first),
                            local[tuple(pivot)])
    keep = inside.reshape(-1, *([1] * (vals.dim() - 1)))
    local.index_put_(tuple(torch.where(inside, t, p)
                           for t, p in zip(li, pivot)),
                     torch.where(keep, vals, pivot_val))
    return self_


@contextlib.contextmanager
def _replicate_plain_tensors():
    """Tensors the step makes itself (positions, ones, index ranges) are
    the same on every rank: DTensor takes them as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def jit_sharded(step_fn: Callable, mesh, in_specs, out_specs=None,
                donate_argnums=(0, 1)):
    """``step_fn`` placed on ``mesh`` (a ``DeviceMesh``): -> a callable
    that places each argument as DTensors by its spec tree in
    ``in_specs`` (one per positional argument; ``None`` leaves one as it
    is), runs ``step_fn`` on them and returns its outputs placed by
    ``out_specs``, or as the step left them. Its ``place(*args)`` does the
    placement alone and ``placed(*args)`` the rest, for a caller that
    measures the step apart from its placement (``launch.analysis``).

    A donated ``Params`` argument is placed in place — its parameters
    become DTensors of the same values, and the step updates them in
    place as ``make_train_step`` does; any other is placed on a copy of
    its structure. A step that runs under ``torch.inference_mode()`` (the
    serving steps) is called inside it, so that its arguments are placed
    as inference tensors. An op that DTensor has no sharding rule for raises,
    naming the op: nothing runs on unsharded local copies. The handlers of
    ``_handlers()`` are in DTensor's dispatch only while ``place`` or
    ``placed`` runs."""
    in_specs = tuple(in_specs)
    donated = set(donate_argnums)
    _register_rules()

    def place(*args):
        if len(args) > len(in_specs):
            raise TypeError(f"{len(args)} arguments, {len(in_specs)} specs")
        with _sharding_handlers():
            return tuple(_place_tree(a, s, mesh, i in donated)
                         for i, (a, s) in enumerate(zip(args, in_specs)))

    def placed(*args):
        with _sharding_handlers(), _replicate_plain_tensors():
            out = step_fn(*args)
            if out_specs is not None:
                out = _place_tree(out, out_specs, mesh, True)
        return out

    def run(*args):
        return placed(*place(*args))

    run.place, run.placed = place, placed
    return run
