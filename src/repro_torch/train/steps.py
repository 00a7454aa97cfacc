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
every op becomes its local form plus the collectives it needs — the
counterpart of the reference's jit with named shardings, where XLA's
SPMD partitioner does that. The port places the ops of the model steps
itself (``_handlers``, ``plan_einsum``), the same on every torch it was
checked against; DTensor's own sharding propagation places the rest.
Under ``jit_sharded`` an accumulating step takes each microbatch from
the rows every rank holds (``_microbatches``), so that each rank
computes its share of it.
"""

from __future__ import annotations

import collections
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
                    accum_steps: int = 1, accum_dtype=None,
                    update_fn: Callable = None):
    """loss_fn(params, batch, weights) -> scalar loss; ``params`` is a
    module (``models.layers.Params``) whose parameters the step trains.

    ``accum_dtype``: dtype of the gradient-accumulation buffer (fp32 by
    default; bf16 halves it, the update still runs on fp32 moments).
    ``update_fn(opt_cfg, params, grads, opt_state)`` -> (params,
    opt_state, metrics): the update, ``apply_updates`` by default (the
    dry run's per-layer count takes the gradients instead)."""
    update_fn = update_fn or apply_updates

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
        params, opt_state, metrics = update_fn(opt_cfg, params, grads,
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
# {the port's line: times}: each gather whose gathered dimension is split,
# which the public gather rule replicates (DTensor caches a rule's answer
# by the operands' shapes and placements: a line counts once a placement)
GATHER_REPLICATED = collections.Counter()


def _register_rules() -> None:
    """Public sharding rules (``register_sharding``) for ops where
    DTensor's own rule does not fit the port's steps, registered once per
    process (DTensor's registry is global):

      * ``aten.gather`` (the MoE sort dispatch's reads): the gathered
        dimension whole, other dimensions that the operands share may
        stay split; a partial sum gathered by a whole index stays one (a
        gather is linear: the MoE combine reads the experts' partial
        outputs, reduced once at the residual add). A gather along a
        split dimension would replicate it (an all-gather, which the
        analysis counts): the loss head's gold logit over a vocab split
        across "model" is ``placed_gather`` instead, and each time the
        rule sees a split gathered dimension it records the port's line
        that called it in ``GATHER_REPLICATED`` (the model steps leave
        it empty);
      * ``aten.constant_pad_nd`` (``flash_sdpa``'s padding of its query
        and key blocks): torch 2.11's rule gives its output one
        placement whatever the mesh's rank; the rule here keeps each
        dimension that is not padded split as it was;
      * ``aten.scatter`` and ``aten.scatter_add`` (the sort dispatch's
        expert buffer and combine, the backward of ``aten.gather``):
        each dimension other than the scattered one that the three
        operands share whole may stay split in all three, a local
        scatter per rank (the group axis of the MoE dispatch over
        "data"), as the gather rule keeps it for the gather; partial
        sums of ``self`` and ``src`` by a whole index stay one.

    The ops that need more than a placement rule go to handlers that
    ``_sharding_handlers`` installs only while a placed step runs."""
    if _RULES:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.gather.default)
    def gather_rule(x, dim, index, sparse_grad=False):
        dim %= x.ndim
        if any(isinstance(pl, Shard) and pl.dim % x.ndim == dim
               for pl in x.placements):
            from ..launch.analysis import _call_site
            GATHER_REPLICATED[_call_site()] += 1
        out = [([Replicate()], [Replicate(), None, Replicate()]),
               ([Partial()], [Partial(), None, Replicate()])]
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

    def scatter_rule(x, dim, index, src, *rest):
        dim %= x.ndim
        tail = [None] * len(rest)
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()]
                + tail),
               ([Partial()], [Partial(), None, Replicate(), Partial()]
                + tail)]
        out += [([Shard(d)], [Shard(d), None, Shard(d), Shard(d)] + tail)
                for d in range(x.ndim)
                if d != dim and x.shape[d] == index.shape[d] == src.shape[d]]
        return out

    for op in (aten.scatter.src, aten.scatter_add.default):
        register_sharding(op)(scatter_rule)
    _RULES.extend((gather_rule, pad_rule, scatter_rule))


def _pointwise_ops() -> tuple:
    """The elementwise aten ops that ``_pointwise`` places: what the
    model steps run on DTensors (the attention's masks and online
    softmax, the norms, RoPE, SwiGLU, the loss, the optimizer's update,
    their gradients)."""
    aten = torch.ops.aten
    names = ("add.Tensor", "add_.Tensor", "sub.Tensor", "sub_.Tensor",
             "mul.Tensor", "mul_.Tensor", "div.Tensor", "div_.Tensor",
             "mul.Scalar", "div.Scalar", "where.self", "where.ScalarOther",
             "where.ScalarSelf", "masked_fill.Scalar", "masked_fill_.Scalar",
             "masked_fill.Tensor", "masked_fill_.Tensor", "maximum.default",
             "minimum.default", "eq.Tensor", "ne.Tensor", "gt.Tensor",
             "ge.Tensor", "lt.Tensor", "le.Tensor", "eq.Scalar",
             "ne.Scalar", "gt.Scalar", "ge.Scalar", "lt.Scalar",
             "le.Scalar", "bitwise_and.Tensor", "bitwise_and_.Tensor",
             "bitwise_or.Tensor", "bitwise_or_.Tensor",
             "bitwise_xor.Tensor", "bitwise_not.default",
             "logical_not.default", "exp.default", "neg.default",
             "rsqrt.default", "sqrt.default", "cos.default", "sin.default",
             "silu.default", "silu_backward.default", "sigmoid.default",
             "tanh.default", "relu.default", "threshold_backward.default",
             "pow.Tensor_Scalar", "clamp.default", "abs.default",
             "log.default", "reciprocal.default", "remainder.Scalar",
             "_to_copy.default")
    return tuple(getattr(getattr(aten, n.split(".")[0]), n.split(".")[1])
                 for n in names)


POINTWISE_OPS = _pointwise_ops()


def _handlers() -> dict:
    """{aten op: handler} for the ops whose placement the port decides
    itself, the same on every torch it was checked against, rather than
    through DTensor's own per-version strategy (torch 2.11 has none, or a
    wrong one, for several of them):

      * ``aten.index_select`` (``gnn.gather_rows``: node states by edge,
        table rows by id), ``aten.index_add`` / ``index_add_`` (the GNN's
        scatter-sum and the gather's backward) and ``aten.index_put`` /
        ``index_put_`` (the decode cache's slot writes, an indexing's
        backward with ``accumulate``): ``_sharded_index_select``,
        ``_sharded_index_add``, ``_sharded_index_put``, each a local op
        per rank between explicit redistributions;
      * ``aten.matmul`` where it reaches DTensor whole (under inference
        mode; autograd lowers it otherwise): ``_planned_matmul``, the
        einsum it is on ``plan_einsum``'s plan (the models' einsums call
        ``placed_einsum`` themselves, ``models.layers.einsum``);
      * ``aten.embedding`` (the token embedding: rows over "model", a
        big model's features over "data"): ``_sharded_embedding``, the
        index_select it is, so that the looked-up rows keep the ids'
        batch split (DTensor's own rule leaves them split by features
        where the table is, and every later op of the step then holds
        the whole batch) and the rows' partial sums over a split vocab
        are reduced at once (the all-reduce of the looked-up rows that
        the reference's partitioner makes);
      * the bitwise operators ``&``, ``|`` and ``^`` (``aten.__and__``
        and the others; the attention masks, the wide crosses): DTensor
        takes them for in-place ops by their trailing underscore, and
        under inference mode returns the first operand unchanged, so they
        run as ``bitwise_and`` / ``bitwise_or`` / ``bitwise_xor``; and
        ``&=`` / ``|=`` / ``^=`` (``aten.__iand__``, ...; the sliding
        window's mask) as ``bitwise_and_`` and the others, which torch
        2.13 would first try to propagate through their decomposition,
        fail, and keep the failure's traceback (every tensor of its
        frames) until the collector runs;
      * ``aten.view`` / ``aten._unsafe_view`` / ``aten.reshape`` (the
        last under inference mode, which hands it over whole): DTensor's
        view rule is strict, and refuses a view that would need its input
        redistributed (the flattening of a strided shard in the gradient
        of deepseek's MoE groups), and torch 2.11's dispatch of some views
        of a split dimension gives the local op the global shape;
        ``_view_or_gather`` redistributes the input as DTensor's rule for
        a reshape asks and views each rank's part itself;
      * ``aten.slice`` / ``aten.slice_backward`` (MLA's nope / rope
        split, the attention's key blocks, a token batch's inputs and
        labels, their gradients): DTensor gathers the dimension a slice
        cuts where it is split, each torch its own way;
        ``_sharded_slice`` / ``_sharded_slice_backward`` keep a split
        that each rank's part gives its share of
        (``_slice_keeps_split``), and otherwise move it to another
        dimension (an all-to-all) before a local slice;
      * ``aten.select`` / ``aten.select_backward`` (RoPE's even and odd
        lanes, a layer of a stacked cache): a local select, the selected
        dimension gathered only where it is split;
      * ``aten.cat`` / ``aten.stack`` (RoPE's pairs, the Q blocks of the
        blocked attention, MLA's key): ``_joined``, the result split as
        its largest operand along the other dimensions;
      * ``aten.softmax`` (the decode attention's and the router's, which
        inference mode hands over whole): ``_softmax``, the ``_softmax``
        it lowers to, whose rule DTensor has on every torch; torch 2.13
        would first try to propagate through its decomposition, fail and
        keep the failure's traceback, and with it every tensor of the
        frames it holds, until the collector runs;
      * ``aten.logsumexp`` (the loss head's normaliser over a vocab
        split across "model"): ``_sharded_logsumexp``, a local max and a
        local sum of ``exp`` on each rank's slice, combined across the
        split by a max and then a sum all-reduce of one value a row;
        autograd's backward of it, ``grad * exp(x - result)``, is
        elementwise and stays on each rank's slice (DTensor would gather
        the logits whole over the vocab, and its backward with them);
      * ``aten.new_zeros`` / ``new_empty`` / ``new_ones`` / ``new_full``
        (the MoE sort dispatch's expert buffer and combine, the backward
        of a gather or a scatter): ``_new_factory``, which keeps each
        split of ``self`` along a dimension the new shape has at the
        same size (the groups over "data"), where DTensor makes every
        tensor of a new shape whole on every rank (deepseek's prefill
        buffer of all its groups' experts);
      * the elementwise ops of ``POINTWISE_OPS`` (masks, the online
        softmax, norms, RoPE, SwiGLU, the loss, the optimizer, their
        gradients): ``_pointwise``, which decides where a partial sum is
        reduced and which operand's split the result takes; DTensor's
        rules for them differ between torch 2.11 and 2.13, and every op
        after them follows.

    None of them reads data, and no shape depends on it: they run on the
    dry run's fake tensors as on real ones. Each runs as the unplaced
    step runs its op where every rank holds every operand whole
    (``_on_whole_operands``)."""
    aten = torch.ops.aten
    out = {aten.index_put_.default: _sharded_index_put,
           aten.index_put.default: _sharded_index_put,
           aten.index_add.default: _sharded_index_add,
           aten.index_add_.default: _sharded_index_add,
           aten.index_select.default: _sharded_index_select,
           aten.matmul.default: _planned_matmul,
           aten.embedding.default: _sharded_embedding,
           aten.view.default: _view_or_gather,
           aten._unsafe_view.default: _view_or_gather,
           aten.reshape.default: _view_or_gather,
           aten.cat.default: _joined,
           aten.stack.default: _joined,
           aten.slice.Tensor: _sharded_slice,
           aten.slice_backward.default: _sharded_slice_backward,
           aten.select.int: _sharded_select,
           aten.select_backward.default: _sharded_select_backward,
           aten.softmax.int: _softmax,
           aten.logsumexp.default: _sharded_logsumexp,
           aten.new_zeros.default: _new_factory,
           aten.new_empty.default: _new_factory,
           aten.new_ones.default: _new_factory,
           aten.new_full.default: _new_factory}
    for op in POINTWISE_OPS:
        out[op] = _pointwise
    for name, fn in (("__and__", torch.bitwise_and),
                     ("__or__", torch.bitwise_or),
                     ("__xor__", torch.bitwise_xor),
                     ("__iand__", torch.Tensor.bitwise_and_),
                     ("__ior__", torch.Tensor.bitwise_or_),
                     ("__ixor__", torch.Tensor.bitwise_xor_)):
        for overload in ("Tensor", "Scalar"):
            out[getattr(getattr(aten, name), overload)] = functools.partial(
                _as_function, fn)
    return {op: functools.partial(_on_whole_operands, h)
            for op, h in out.items()}


def _whole_mesh(args, kwargs):
    """The mesh of the DTensors among an op's operands (in a list too)
    where every rank holds each of them whole: the mesh has one rank, or
    every placement is ``Replicate``. None otherwise, or where there is
    no DTensor."""
    from torch.distributed.tensor import DTensor
    mesh = None
    for a in (*args, *kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, DTensor):
                mesh = t.device_mesh
                if mesh.size() > 1 and not all(
                        pl.is_replicate() for pl in t.placements):
                    return None
    return mesh


def _local(a):
    from torch.distributed.tensor import DTensor
    if isinstance(a, (list, tuple)):
        return type(a)(_local(t) for t in a)
    return a._local_tensor if isinstance(a, DTensor) else a


@functools.lru_cache(maxsize=None)
def _writes_first(op_call) -> bool:
    """Whether ``op_call`` writes its first argument in place."""
    args = op_call._schema.arguments
    info = args[0].alias_info if args else None
    return info is not None and info.is_write


def _on_whole_operands(handler, op_call, args, kwargs):
    """``handler``'s op where every rank holds every operand whole
    (``_whole_mesh``: a one-rank mesh, or nothing split nor a partial
    sum): the op on each rank's local tensors, as the unplaced step runs
    it, its result whole (``self`` of an in-place op, as it was placed);
    ``handler`` itself otherwise. The placement there is moot, and
    working it out on the host costs more than the op on the card."""
    from torch.distributed.tensor import Replicate
    mesh = _whole_mesh(args, kwargs)
    if mesh is None:
        return handler(op_call, args, kwargs)
    out = op_call(*_local(args), **{k: _local(v) for k, v in kwargs.items()})
    if _writes_first(op_call):
        return args[0]
    return _wrap(out, mesh, [Replicate()] * mesh.ndim, out.shape,
                 out.stride())


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


def _softmax(op_call, args, kwargs):
    """``aten.softmax(x, dim, dtype)`` as the ``_softmax`` it lowers to."""
    x, dim = args[:2]
    dtype = args[2] if len(args) > 2 else kwargs.get("dtype")
    if dtype is not None:
        x = x.to(dtype)
    return torch.ops.aten._softmax.default(x, dim, False)


def _as_function(fn, op_call, args, kwargs):
    """``op_call`` as the out-of-place function ``fn``."""
    return fn(*args, **kwargs)


def _sharded_embedding(op_call, args, kwargs):
    """``aten.embedding(table, ids)`` as ``_sharded_index_select`` of the
    ids' rows, shaped as the ids (its backward stays autograd's
    ``embedding_dense_backward``)."""
    table, ids = args[:2]
    mesh = _mesh_of(table, ids)
    ids = _as_dtensor(ids, mesh)
    rows = _sharded_index_select(torch.ops.aten.index_select.default,
                                 (table, 0, ids.reshape(-1)), {})
    return rows.view(*ids.shape, table.shape[-1])


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
    """(the placements ``x`` must have to be viewed as ``shape``, the
    view's placements then): DTensor's own rule for a reshape
    (``view_groups`` and ``propagate_shape_and_sharding`` without
    strictness), which demotes to ``Replicate`` each split that the view
    cannot keep (a dimension split into factors the mesh does not
    divide, a split dimension flattened behind another). That rule checks
    a dimension split over two mesh dimensions (the batch over ("pod",
    "data")) against each mesh dimension alone; where the shards it gives
    the output do not hold the input's elements, the input's innermost
    split is demoted too, until they do."""
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
            return tuple(want), tuple(out)
        src[max(j for j, pl in enumerate(src) if _splits(pl))] = Replicate()


def _view_strides(sizes, strides, new_sizes):
    """The strides of a view as ``new_sizes`` (no -1) of a tensor of
    ``sizes`` laid out by ``strides``, or None where it has none (a
    reshape copies): torch's own ``computeStride``, which cuts each run
    of dimensions laid out one after another into whole new dimensions.
    Worked out here rather than by viewing a meta tensor, which the
    dry run's analysis would count as an op."""
    new_sizes = tuple(new_sizes)
    if not sizes:
        return (1,) * len(new_sizes)
    if 0 in sizes:
        return tuple(strides) if tuple(sizes) == new_sizes else \
            _contiguous_strides(new_sizes)
    out = [0] * len(new_sizes)
    view_d = len(new_sizes) - 1
    base = strides[-1]
    t_numel = v_numel = 1
    for d in range(len(sizes) - 1, -1, -1):
        t_numel *= sizes[d]
        if d == 0 or (sizes[d - 1] != 1
                      and strides[d - 1] != t_numel * base):
            while view_d >= 0 and (v_numel < t_numel
                                   or new_sizes[view_d] == 1):
                out[view_d] = v_numel * base
                v_numel *= new_sizes[view_d]
                view_d -= 1
            if v_numel != t_numel:
                return None
            if d > 0:
                base = strides[d - 1]
                t_numel = v_numel = 1
    return tuple(out) if view_d == -1 else None


def _view_or_gather(op_call, args, kwargs):
    """A view (``view``, ``_unsafe_view``, or a ``reshape`` that
    inference mode hands over whole) of a DTensor, run by the port
    itself: the input first takes the placements that DTensor's rule for
    a reshape gives it (``_view_placements``: an all-gather of each
    split the view cannot keep, which the analysis counts), then each
    rank views its part as its share of the result. The local part is
    first made contiguous where it cannot take that view
    (``_view_strides``: a permuted local tensor — an einsum's operand before
    its flattening — or a split shard); a ``view`` of a DTensor whose own
    strides allow it keeps them. DTensor's own dispatch of a view
    differs between torch 2.11 and 2.13 (2.11 gives some views of a
    split dimension the global shape as the local one)."""
    from torch.distributed.tensor import Shard
    x = args[0]
    shape = _resolved(args[1], x.numel())
    if any(isinstance(pl, Shard) and type(pl) is not Shard
           for pl in x.placements):
        return _dispatch_unhandled(op_call, args, kwargs)
    want = out_p = tuple(x.placements)
    if any(_splits(pl) for pl in want):
        want, out_p = _view_placements(x, shape)
    if any(isinstance(pl, Shard) and type(pl) is not Shard for pl in out_p):
        return _dispatch_unhandled(op_call, args, kwargs)
    x = _placed_as(x, want)
    mesh = x.device_mesh
    lshape, _ = _extent(shape, out_p, mesh)
    local = x._local_tensor
    if _view_strides(tuple(local.shape), local.stride(), lshape) is None:
        local = local.contiguous()
    # a reshape that copies: contiguous
    stride = _view_strides(tuple(x.shape), x.stride(), shape) or \
        _contiguous_strides(shape)
    return _wrap(local.view(lshape), mesh, out_p, shape, stride)


def _joined(op_call, args, kwargs):
    """``aten.cat(tensors, dim)`` and ``aten.stack(tensors, dim)`` on
    DTensors, per mesh dimension: the operands are joined along ``dim``
    whole (a split of it gathered); along the other dimensions the
    result is split as the largest operand is split there, the others
    cut or moved to that split (the placement ``_pointwise`` gives a
    binary op); partial sums of one kind stay one. DTensor's own rules
    differ between torch versions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    stack = op_call.overloadpacket is torch.ops.aten.stack
    tensors = list(args[0])
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    mesh = _mesh_of(*tensors)
    ts = [_as_dtensor(t, mesh) for t in tensors]
    if any(type(pl) not in (Shard, Replicate, Partial)
           for t in ts for pl in t.placements) or \
            len({t.ndim for t in ts}) != 1:
        return _dispatch_unhandled(op_call, args, kwargs)
    nd = ts[0].ndim
    dim %= nd + 1 if stack else nd
    want = [list(t.placements) for t in ts]
    out_p = []
    for j in range(mesh.ndim):
        pj = [t.placements[j] for t in ts]
        if all(pl.is_partial() for pl in pj) and \
                len({pl.reduce_op for pl in pj}) == 1:
            out_p.append(pj[0])
            continue
        split = [(t.numel(), -n, pl.dim % nd) for n, (t, pl) in
                 enumerate(zip(ts, pj)) if isinstance(pl, Shard)
                 and (stack or pl.dim % nd != dim)]
        k = max(split)[2] if split else None
        for w in want:
            w[j] = Replicate() if k is None else Shard(k)
        out_p.append(Replicate() if k is None else
                     Shard(k + (stack and k >= dim)))
    ts = [_placed_as(t, w) for t, w in zip(ts, want)]
    local = op_call([t._local_tensor for t in ts], dim)
    shape = list(ts[0].shape)
    if stack:
        shape.insert(dim, len(ts))
    else:
        shape[dim] = sum(t.shape[dim] for t in ts)
    return _wrap(local, mesh, out_p, shape)


# ----------------------------------------- the port's own placements --- //

def _norm_slice(n: int, start, end, step) -> tuple:
    """(start, end, step) of ``x[start:end:step]`` along a dimension of
    ``n``, with Python's clamping and negative indices resolved."""
    start = 0 if start is None else start
    end = n if end is None else end
    start = min(max(start + n if start < 0 else start, 0), n)
    end = min(max(end + n if end < 0 else end, start), n)
    return start, end, step


def _slice_keeps_split(n: int, parts: int, start: int, end: int,
                       step: int) -> bool:
    """Whether ``x[start:end:step]`` along a dimension of ``n`` split
    evenly in ``parts`` is every rank's own ``[start:n/parts:step]`` of
    its part, the parts in rank order: the step divides the part's size,
    the start falls below the step, and the slice runs to the end (the
    whole dimension at step 1; the even lanes of each rank's pairs)."""
    if n % parts:
        return False
    count = -(-(end - start) // step)
    return (n // parts) % step == 0 and start < step and \
        count == n // step


def split_mesh_dims(x, dim: int) -> list:
    """The mesh dimensions whose placement splits dimension ``dim`` of
    ``x`` (a plain split or a strided one; none for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return []
    return [j for j, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and pl.dim % x.ndim == dim]


def _moved_split(x, dim: int):
    """``x`` with every split of ``dim`` moved to the largest other
    dimension that no mesh dimension splits and that the moved splits
    divide (an all-to-all of each rank's part), or gathered where there
    is none (an all-gather)."""
    from torch.distributed.tensor import Replicate, Shard
    nd, mesh = x.ndim, x.device_mesh
    split = split_mesh_dims(x, dim)
    parts = math.prod(mesh.size(j) for j in split)
    taken = {pl.dim % nd for pl in x.placements if isinstance(pl, Shard)}
    free = [d for d in range(nd) if d not in taken
            and x.shape[d] % parts == 0 and x.shape[d] >= parts]
    to = max(free, key=lambda d: (x.shape[d], -d)) if free else None
    return _placed_as(x, [(Replicate() if to is None else Shard(to))
                          if j in split else pl
                          for j, pl in enumerate(x.placements)])


def _sliced_split(x, dim: int, n: int, start: int, end: int, step: int):
    """-> (x placed for a slice along ``dim`` of a dimension of ``n``, the
    local (start, end) of the slice, the local size of ``dim``): a split
    of ``dim`` that the slice keeps (``_slice_keeps_split``) stays; any
    other split of ``dim`` is moved to another dimension
    (``_moved_split``)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    split = split_mesh_dims(x, dim)
    parts = math.prod(mesh.size(j) for j in split)
    if split and all(type(x.placements[j]) is Shard for j in split) and \
            _slice_keeps_split(n, parts, start, end, step):
        return x, (start, n // parts), n // parts
    if split:
        x = _moved_split(x, dim)
    return x, (start, end), n


def _sharded_slice(op_call, args, kwargs):
    """``aten.slice(x, dim, start, end, step)`` on a DTensor: a local
    slice that keeps every placement along a dimension no mesh dimension
    splits, and along a split one where each rank's part gives its share
    of the slice (``_slice_keeps_split``: the odd lanes of a split
    head_dim); otherwise that dimension's split is first moved to another
    dimension (an all-to-all) or, where none can take it, gathered (an
    all-gather; both counted by the analysis), and the slice is local. A
    partial sum stays one: a slice is linear."""
    x = args[0]
    dim, start, end, step = (list(args[1:]) + [0, None, None, 1][
        len(args) - 1:])[:4]
    dim, start, end, step = (kwargs.get("dim", dim),
                             kwargs.get("start", start),
                             kwargs.get("end", end), kwargs.get("step", step))
    dim %= x.ndim
    n = x.shape[dim]
    start, end, step = _norm_slice(n, start, end, step)
    x, (l0, l1), _ = _sliced_split(x, dim, n, start, end, step)
    out = torch.ops.aten.slice.Tensor(x._local_tensor, dim, l0, l1, step)
    shape, stride = list(x.shape), list(x.stride())
    shape[dim] = max(0, -(-(end - start) // step))
    stride[dim] *= step
    return _wrap(out, x.device_mesh, x.placements, shape, stride)


def _sharded_slice_backward(op_call, args, kwargs):
    """``aten.slice_backward(grad, sizes, dim, start, end, step)`` (the
    gradient of a slice: zeros of ``sizes`` holding ``grad`` at the
    slice) on a DTensor ``grad``, placed as ``_sharded_slice`` places
    the slice: a local ``slice_backward`` into each rank's part, every
    placement kept, where the slice keeps a split of ``dim`` or no mesh
    dimension splits it; otherwise ``grad``'s split of ``dim`` is first
    moved to another dimension, or gathered where none can take it."""
    g, sizes, dim, start, end, step = args[:6]
    dim %= len(sizes)
    n = sizes[dim]
    start, end, step = _norm_slice(n, start, end, step)
    g, (l0, l1), local_n = _sliced_split(g, dim, n, start, end, step)
    lsizes = list(g._local_tensor.shape)
    lsizes[dim] = local_n
    out = torch.ops.aten.slice_backward.default(g._local_tensor, lsizes, dim,
                                                l0, l1, step)
    return _wrap(out, g.device_mesh, g.placements, sizes)


def _sharded_select(op_call, args, kwargs):
    """``aten.select(x, dim, index)`` on a DTensor: a local select where
    no mesh dimension splits ``dim`` (each split of a later dimension
    moves down one), else ``dim`` gathered first."""
    from torch.distributed.tensor import Replicate, Shard
    x, dim, index = args[:3]
    nd = x.ndim
    dim %= nd
    if any(isinstance(pl, Shard) and type(pl) is not Shard
           for pl in x.placements):
        return _dispatch_unhandled(op_call, args, kwargs)
    x = _placed_as(x, [Replicate() if isinstance(pl, Shard)
                       and pl.dim % nd == dim else pl
                       for pl in x.placements])
    pls = [Shard(pl.dim % nd - 1) if isinstance(pl, Shard)
           and pl.dim % nd > dim else pl for pl in x.placements]
    out = torch.ops.aten.select.int(x._local_tensor, dim, index)
    shape = list(x.shape)
    stride = list(x.stride())
    del shape[dim], stride[dim]
    return _wrap(out, x.device_mesh, pls, shape, stride)


def _sharded_select_backward(op_call, args, kwargs):
    """``aten.select_backward(grad, sizes, dim, index)`` on a DTensor
    ``grad``: a local ``select_backward`` into each rank's part, ``dim``
    whole and each split of ``grad`` moved up one past it."""
    from torch.distributed.tensor import Shard
    g, sizes, dim, index = args[:4]
    nd = len(sizes)
    dim %= nd
    if any(isinstance(pl, Shard) and type(pl) is not Shard
           for pl in g.placements):
        return _dispatch_unhandled(op_call, args, kwargs)
    pls = [Shard(pl.dim % g.ndim + (pl.dim % g.ndim >= dim))
           if isinstance(pl, Shard) else pl for pl in g.placements]
    local = g._local_tensor
    lsizes = list(local.shape)
    lsizes.insert(dim, sizes[dim])
    out = torch.ops.aten.select_backward.default(local, lsizes, dim, index)
    return _wrap(out, g.device_mesh, pls, sizes)


def _kept_partial(op_call, args, pj: dict, pos: list, in_place: bool):
    """Where an elementwise op's result can stay the partial sum an
    operand is on one mesh dimension (``pj``: the tensor operands'
    placements there, by position) -> (that placement, whether only the
    mesh dimension's first rank applies the op), or None where the
    partial sum must be reduced first:

      * ``add`` / ``sub`` of two partial sums of one kind, sum or avg (a
        sum of maxima is no maximum of sums);
      * ``add`` / ``sub`` of a partial avg, max or min and a whole
        operand or a number (each rank's part moves by the same amount);
        of a partial sum, only in place, where the first rank alone adds
        it (every rank adding it would add it once a rank; out of place
        the sum is reduced first, as DTensor's own rule does);
      * ``mul`` of a partial sum by a whole operand or a number, and
        ``div`` of one by them."""
    aten = torch.ops.aten
    packet = op_call.overloadpacket
    partial = [i for i in pos if pj[i].is_partial()]
    if not partial or len({pj[i].reduce_op for i in partial}) != 1:
        return None
    kind = pj[partial[0]].reduce_op
    whole = all(pj[i].is_replicate() for i in pos if i not in partial)
    if packet in (aten.add, aten.add_, aten.sub, aten.sub_):
        both = len(partial) == 2 and all(
            isinstance(a, torch.Tensor) for a in args[:2])
        if both:
            return (pj[partial[0]], False) if kind in ("sum", "avg") \
                else None
        if partial != [0] or not whole:
            return None
        if kind in ("avg", "max", "min"):
            return pj[0], False
        return (pj[0], True) if in_place and kind == "sum" else None
    if packet in (aten.mul, aten.mul_, aten.div, aten.div_) and \
            len(partial) == 1 and kind == "sum" and whole and (
                partial[0] == pos[0] or packet in (aten.mul, aten.mul_)):
        return pj[partial[0]], False
    return None


def _pointwise(op_call, args, kwargs):
    """An elementwise op (unary, binary, ``where``, ``masked_fill``; in
    place or not) on DTensors, on a placement the port chooses, per mesh
    dimension, the same on every torch:

      * a partial sum stays one where the op is linear in it
        (``_kept_partial``: added to another of its kind, moved by a
        whole amount, scaled by one);
      * otherwise a partial sum is reduced first, into the split the
        result takes there (a reduce-scatter), or whole (an all-reduce)
        where the result is not split;
      * the result is split along the dimension of the largest operand
        split there (the first such operand on a tie; an in-place op's
        along ``self``'s), whole where no operand is split; each other
        operand is cut to it (free where it is whole, an all-to-all
        where it is split along another dimension) or, where it is
        broadcast along that dimension, made whole.

    DTensor's own rules for these ops differ between torch 2.11 and 2.13
    (which operand's placement wins, when a partial sum is reduced and
    how), and every later op of a step follows them. An operand with a
    placement other than a plain split, whole or partial sum (a masked
    or strided one), and an in-place op on a partial sum that must be
    reduced, take DTensor's own dispatch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    in_place = op_call._schema.name.endswith("_")
    if in_place and not isinstance(args[0], DTensor):
        return _dispatch_unhandled(op_call, args, kwargs)
    pos = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    mesh = _mesh_of(*(args[i] for i in pos))
    ops = {i: _as_dtensor(args[i], mesh) for i in pos}
    if any(type(pl) not in (Shard, Replicate, Partial)
           for t in ops.values() for pl in t.placements):
        return _dispatch_unhandled(op_call, args, kwargs)
    shape = tuple(torch.broadcast_shapes(*(t.shape for t in ops.values())))
    ond = len(shape)

    def aligned(t, k):      # t's dimension at the result's k, if not broadcast
        d = k - (ond - t.ndim)
        return d if d >= 0 and t.shape[d] == shape[k] else None

    want = {i: list(t.placements) for i, t in ops.items()}
    out_p, lead = [], []
    for j in range(mesh.ndim):
        pj = {i: t.placements[j] for i, t in ops.items()}
        kept = _kept_partial(op_call, args, pj, pos, in_place)
        if kept is not None:
            out_p.append(kept[0])
            if kept[1]:
                lead.append(j)
            continue
        if in_place:
            target = pj[pos[0]]
            if target.is_partial():
                return _dispatch_unhandled(op_call, args, kwargs)
            k = None if target.is_replicate() else \
                target.dim % ops[pos[0]].ndim + ond - ops[pos[0]].ndim
        else:
            split = [(ops[i].numel(), -n, pj[i].dim % ops[i].ndim
                      + ond - ops[i].ndim) for n, i in enumerate(pos)
                     if isinstance(pj[i], Shard)]
            k = max(split)[2] if split else None
        out_p.append(Replicate() if k is None else Shard(k))
        for i, t in ops.items():
            d = None if k is None else aligned(t, k)
            want[i][j] = Replicate() if d is None else Shard(d)
    ops = {i: _placed_as(t, want[i]) for i, t in ops.items()}
    if in_place and any(mesh.get_coordinate()[j] for j in lead):
        return args[0]              # the first rank of each ``lead`` adds it
    local = list(args)
    for i, t in ops.items():
        local[i] = t._local_tensor
    out = op_call(*local, **kwargs)
    if in_place:
        return args[0]
    return _wrap(out, mesh, out_p, shape)


def _as_dtensor(t, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (every rank
    holds the same: the step made it); a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _mesh_of(*xs):
    from torch.distributed.tensor import DTensor
    return next(x.device_mesh for x in xs if isinstance(x, DTensor))


def _plain_placements(t) -> list:
    """``t``'s placements with each split that is not a plain ``Shard``
    (a ``_StridedShard``, left by a view that flattened a split
    dimension behind another) as ``Replicate``: the handlers below work
    out offsets for plain splits only."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if isinstance(pl, Shard) and type(pl) is not Shard
            else pl for pl in t.placements]


def _placed_as(t, pls):
    """``t`` redistributed to ``pls`` (the collectives DTensor runs for
    it, which the analysis counts), or ``t`` where it is placed so. With
    no graph to record (inference mode), a ``t`` that requires grad (a
    parameter) is redistributed detached: torch 2.11's autograd would
    detach the result in place, an op DTensor has no strategy for
    there."""
    pls = tuple(pls)
    if tuple(t.placements) == pls:
        return t
    if t.requires_grad and not torch.is_grad_enabled():
        t = t.detach()
    return t.redistribute(t.device_mesh, pls)


def _wrap(local, mesh, pls, shape, stride=None):
    """A DTensor of global ``shape`` (laid out by ``stride``, contiguous
    by default) from each rank's ``local`` part, made as DTensor's own
    dispatch makes its results: the handlers run below autograd, where
    ``DTensor.from_local``'s autograd function only costs time."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    shape = torch.Size(shape)
    stride = _contiguous_strides(shape) if stride is None else tuple(stride)
    spec = DTensorSpec(mesh, tuple(pls), TensorMeta(shape, stride,
                                                    local.dtype))
    return DTensor(local, spec, requires_grad=local.requires_grad)


def _split_dim(pl, ndim: int):
    """The tensor dimension a placement splits, or None."""
    from torch.distributed.tensor import Shard
    return pl.dim % ndim if isinstance(pl, Shard) else None


def _extent(shape, pls, mesh) -> tuple:
    """(local shape, global offset) of this rank's part of a tensor of
    ``shape`` under ``pls`` (a partial part is whole)."""
    return shard_extent(tuple(shape), pls, tuple(mesh.shape),
                        mesh.get_coordinate())


def _own_rows(idx, dim: int, lshape, offset):
    """Global indices into dimension ``dim`` as indices into this rank's
    part (``offset``, ``lshape``): -> (local indices, where one falls
    outside the part 0, whether it falls inside)."""
    t = idx - offset[dim]
    inside = (t >= 0) & (t < lshape[dim])
    return torch.where(inside, t, 0), inside


def _along(mask, dim: int, ndim: int):
    """A 1-D mask shaped to broadcast along ``dim`` of an ``ndim`` tensor."""
    return mask.reshape([-1 if d == dim else 1 for d in range(ndim)])


def _sharded_logsumexp(op_call, args, kwargs):
    """``aten.logsumexp(x, dim, keepdim)`` on a DTensor: a partial sum of
    ``x`` reduced first (the op is not linear); where no mesh dimension
    splits a reduced dimension, the op on each rank's part; otherwise, as
    torch computes it, the max m of each rank's slice combined across the
    split (a max all-reduce), then the sum of ``exp(x - m)`` of each
    slice combined likewise (a sum all-reduce), and ``log`` of it plus m
    (m taken as 0 where it is infinite). The result is whole over the
    mesh dimensions that split a reduced dimension and split as ``x``
    over the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    nd = x.ndim
    dims = [dims] if isinstance(dims, int) else list(dims)
    if not dims or any(type(pl) not in (Shard, Replicate, Partial)
                       for pl in x.placements):
        return _dispatch_unhandled(op_call, args, kwargs)
    dims = sorted({d % nd for d in dims})
    mesh = x.device_mesh
    x = _placed_as(x, [Replicate() if pl.is_partial() else pl
                       for pl in x.placements])
    red = [j for j, pl in enumerate(x.placements)
           if isinstance(pl, Shard) and pl.dim % nd in dims]
    shape = [1 if d in dims else n for d, n in enumerate(x.shape)]
    kept = [Replicate() if j in red else pl
            for j, pl in enumerate(x.placements)]
    local = x._local_tensor
    if red:
        def combined(t, op):
            part = _wrap(t, mesh, [Partial(op) if j in red else pl
                                   for j, pl in enumerate(kept)], shape)
            return _placed_as(part, kept)._local_tensor

        m = combined(local.amax(dims, keepdim=True), "max")
        total = combined(torch.exp(local - m).sum(dims, keepdim=True),
                         "sum")
        out = torch.log(total) + torch.where(m.abs() == math.inf, 0, m)
    else:
        out = torch.logsumexp(local, dims, keepdim=True)
    if not keepdim:
        out = out.squeeze(dims)
        shape = [n for d, n in enumerate(x.shape) if d not in dims]
        kept = [Shard(pl.dim % nd - sum(d < pl.dim % nd for d in dims))
                if isinstance(pl, Shard) else pl for pl in kept]
    return _wrap(out, mesh, kept, shape)


def _new_factory(op_call, args, kwargs):
    """``self.new_zeros(size)`` (``new_empty``, ``new_ones``,
    ``new_full``) on a DTensor: the new tensor is split over each mesh
    dimension where ``self`` is split along a dimension that the new
    shape has at the same size and the split divides (the MoE groups'
    axis over "data"), and whole over the others; each rank makes its own
    part. Any placement of a constant holds the same values; this one
    keeps the work on it where ``self``'s is."""
    from torch.distributed.tensor import Replicate, Shard
    self_ = args[0]
    size = tuple(args[1])
    mesh = self_.device_mesh
    pls, parts = [], [1] * len(size)
    for j, pl in enumerate(_plain_placements(self_)):
        d = _split_dim(pl, self_.ndim)
        ok = d is not None and d < len(size) and \
            size[d] == self_.shape[d] and \
            size[d] % (parts[d] * mesh.size(j)) == 0
        if ok:
            parts[d] *= mesh.size(j)
        pls.append(Shard(d) if ok else Replicate())
    lshape, _ = _extent(size, pls, mesh)
    out = op_call(self_._local_tensor, list(lshape), *args[2:], **kwargs)
    return _wrap(out, mesh, pls, size)


def _gather_plan(x, dim: int, index):
    """(x's placements, the index's, the result's, the mesh dimensions
    that split ``dim``) of ``placed_gather``, per mesh dimension: where
    ``x`` splits ``dim`` the index whole and the result a partial sum;
    where ``x`` splits another dimension that the index has at the same
    size, the index split alike and the result too; anywhere else all
    three whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    nd = x.ndim
    xp, ip = _plain_placements(x), _plain_placements(index)
    out_p, masked = [], []
    for j in range(len(xp)):
        xd = _split_dim(xp[j], nd)
        if xd == dim:
            ip[j] = Replicate()
            out_p.append(Partial())
            masked.append(j)
        elif xd is not None and x.shape[xd] == index.shape[xd]:
            ip[j] = Shard(xd)
            out_p.append(Shard(xd))
        else:
            xp[j] = ip[j] = Replicate()
            out_p.append(Replicate())
    return xp, ip, out_p, masked


def _gather_local(shape, mesh, dim: int, index, xp, masked) -> tuple:
    """(each rank's index into its part, under ``xp``, of a tensor of
    ``shape`` along ``dim``, whether it falls in that part): the index
    shifted by the part's offset where ``masked`` mesh dimensions split
    ``dim``, an index outside the part 0."""
    li = index._local_tensor.long()
    if not masked:
        return li, None
    lshape, off = _extent(shape, xp, mesh)
    t = li - off[dim]
    inside = (t >= 0) & (t < lshape[dim])
    return torch.where(inside, t, 0), inside


class _PlacedGather(torch.autograd.Function):
    """``torch.gather(x, dim, index)`` on a split ``x`` (the loss head's
    gold logit, its batch split over "data", its vocab over "model"):
    where ``x`` splits ``dim``, each rank reads the entries that fall in
    its slice and zeros elsewhere, a partial sum over those mesh
    dimensions, reduced where it is used (``_gather_plan``). The
    backward adds the gradient into zeros of each rank's part of ``x``
    at the entries it read, ``x``'s placement, where autograd's own
    backward of a gather makes zeros of ``x``'s whole shape on every
    rank."""

    @staticmethod
    def forward(ctx, x, dim, index):
        from torch.distributed.tensor import Replicate
        xp, ip, out_p, masked = _gather_plan(x, dim, index)
        x = _placed_as(x, xp)
        index = _placed_as(_as_dtensor(index, x.device_mesh), ip)
        li, inside = _gather_local(x.shape, x.device_mesh, dim, index, xp,
                                   masked)
        out = x._local_tensor.gather(dim, li)
        if inside is not None:
            out = torch.where(inside, out, 0)
        ctx.save_for_backward(index)
        ctx.dim, ctx.xp, ctx.masked = dim, xp, masked
        ctx.x_meta = (tuple(x.shape), x.device_mesh)
        ctx.grad_p = [Replicate() if pl.is_partial() else pl for pl in out_p]
        return _wrap(out, x.device_mesh, out_p, index.shape)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        shape, mesh = ctx.x_meta
        dim, xp = ctx.dim, ctx.xp
        g = _placed_as(_as_dtensor(grad, mesh), ctx.grad_p)._local_tensor
        li, inside = _gather_local(shape, mesh, dim, index, xp, ctx.masked)
        if inside is not None:
            g = torch.where(inside, g, 0)
        lshape, _ = _extent(shape, xp, mesh)
        out = g.new_zeros(lshape).scatter_add_(dim, li, g)
        return _wrap(out, mesh, xp, shape), None, None


def placed_gather(x, dim: int, index):
    """``torch.gather(x, dim, index)``; on a DTensor ``x`` split over more
    than one rank (and no partial sum), ``_PlacedGather`` — what
    ``models.layers.gather`` runs on DTensors. Anywhere else the gather
    runs as it is (its placement the public gather rule's)."""
    if _replicated((x,)) or any(pl.is_partial() for pl in x.placements):
        return torch.gather(x, dim, index)
    return _PlacedGather.apply(x, dim % x.ndim, index)


class _PlacedEmbedding(torch.autograd.Function):
    """``embedding(table, ids)`` on DTensors (the token embedding: rows
    over "model", a big model's features over "data", the ids split by
    batch): the lookup is ``_sharded_embedding``'s. The backward adds
    the gradient rows of each rank's ids that fall in its slice of the
    table's rows into zeros of that slice only (``_sharded_index_add``),
    a partial sum over the batch axes reduced into the table's own
    placement, where autograd's ``embedding_dense_backward`` makes the
    whole (vocab, d) gradient on every rank and reduces it before the
    split cuts it."""

    @staticmethod
    def forward(ctx, table, ids):
        mesh = _mesh_of(table, ids)
        ids = _as_dtensor(ids, mesh)
        ctx.save_for_backward(ids)
        ctx.table = (tuple(table.shape), tuple(_plain_placements(table)),
                     mesh)
        return _sharded_embedding(torch.ops.aten.embedding.default,
                                  (table, ids), {})

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        shape, pls, mesh = ctx.table
        grad = _as_dtensor(grad, mesh)
        lshape, _ = _extent(shape, pls, mesh)
        zeros = _wrap(grad._local_tensor.new_zeros(lshape), mesh, pls, shape)
        out = _sharded_index_add(
            torch.ops.aten.index_add.default,
            (zeros, 0, ids.reshape(-1), grad.reshape(-1, shape[-1])), {})
        return out, None


def placed_embedding(table, ids):
    """``torch.nn.functional.embedding(ids, table)``; on DTensors
    ``_PlacedEmbedding`` (what ``models.layers.embedding`` runs), on a
    one-rank mesh or a whole table the op itself."""
    if _replicated((table, ids)):
        return torch.nn.functional.embedding(ids, table)
    return _PlacedEmbedding.apply(table, ids)


def _combine_plan(out_e):
    """(the placements of ``placed_combine``'s pair tensors, of its
    result, the mesh dimensions that split the slots) for experts'
    outputs ``out_e`` (n, S, d), per mesh dimension: where ``out_e``
    splits the slots, the pairs whole and the result split along its
    features; where it splits the groups, everything split alike; where
    it splits the features, the pairs whole and the result split alike;
    anywhere else all whole (a partial sum of ``out_e`` made whole
    first)."""
    from torch.distributed.tensor import Replicate, Shard
    pair_p, out_p, slots = [], [], []
    for j, pl in enumerate(_plain_placements(out_e)):
        d = _split_dim(pl, 3)
        if d == 1:
            slots.append(j)
        pair_p.append(Shard(0) if d == 0 else Replicate())
        out_p.append(Replicate() if d is None else Shard(0 if d == 0 else 2))
    return pair_p, out_p, slots


class _PlacedCombine(torch.autograd.Function):
    """``layers.combine`` on experts' outputs whose slots are split over
    some mesh dimensions (deepseek-v2-236b's 160 experts over "model"):
    each rank reads the pairs whose slot falls in its slice, writes
    each of its slots' token and weight (a slot no pair holds: token 0,
    weight 0), adds its slots' weighted outputs into its tokens — a
    partial sum — and reduces the sums into a split of the features (a
    reduce-scatter). The (pairs, d) tensor of the plain combine is never
    made. The backward gathers the features of the gradient, reads each
    own slot's token's gradient, and gives the outputs' gradient on each
    rank's slots and the weights' as a partial sum over the slots'
    split, reduced into the weights' placement."""

    @staticmethod
    def forward(ctx, out_e, slot, tok, w, keep, x):
        from torch.distributed.tensor import Partial, Replicate
        mesh = out_e.device_mesh
        pair_p, out_p, slots = _combine_plan(out_e)
        oe_p = [Replicate() if pl.is_partial() else pl
                for pl in _plain_placements(out_e)]
        out_e = _placed_as(out_e, oe_p)
        ls, lt, lw, lk = (
            _placed_as(_as_dtensor(t, mesh), pair_p)._local_tensor
            for t in (slot, tok, w, keep))
        lw = (lw * lk).to(x.dtype)
        oe = out_e._local_tensor
        n, s_l = oe.shape[:2]
        _, off = _extent(out_e.shape, oe_p, mesh)
        t = ls - off[1]
        at = torch.where((t >= 0) & (t < s_l), t, s_l)
        # each own slot's token and weight; the spare column s_l takes the
        # pairs of the other ranks' slots and the dropped ones
        tok_s = lt.new_zeros((n, s_l + 1)).scatter_(1, at, lt)[:, :s_l]
        w_s = lw.new_zeros((n, s_l + 1)).scatter_(1, at, lw)[:, :s_l]
        rows = tok_s[..., None].expand(oe.shape)
        part = oe.new_zeros((n, x.shape[1], oe.shape[2])).scatter_add_(
            1, rows, oe * w_s[..., None])
        ctx.save_for_backward(oe, tok_s, w_s, at, lk)
        ctx.plan = (mesh, slots, tuple(oe_p), tuple(pair_p),
                    tuple(out_e.shape), tuple(slot.shape), w.dtype,
                    [Replicate() if j in slots else pl
                     for j, pl in enumerate(out_p)])
        shape = (x.shape[0], x.shape[1], out_e.shape[2])
        part_p = [Partial() if j in slots else pl
                  for j, pl in enumerate(out_p)]
        return _placed_as(_wrap(part, mesh, part_p, shape), out_p)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Partial
        (mesh, slots, oe_p, pair_p, oe_shape, pair_shape, w_dtype,
         grad_p) = ctx.plan
        oe, tok_s, w_s, at, lk = ctx.saved_tensors
        g = _placed_as(_as_dtensor(grad, mesh), grad_p)._local_tensor
        g_s = g.gather(1, tok_s[..., None].expand(oe.shape))
        d_oe = g_s * w_s[..., None]
        d_ws = (g_s * oe).sum(-1)
        n, s_l = d_ws.shape
        d_w = torch.cat([d_ws, d_ws.new_zeros((n, 1))], 1).gather(1, at)
        # as autograd gives it through (w * keep).to(x.dtype)
        d_w = _wrap(d_w.to(w_dtype) * lk, mesh,
                    [Partial() if j in slots else pl
                     for j, pl in enumerate(pair_p)], pair_shape)
        return (_wrap(d_oe, mesh, oe_p, oe_shape), None, None,
                _placed_as(d_w, pair_p), None, None)


def placed_combine(out_e, slot, tok, w, keep, x):
    """``layers.combine`` on DTensors: ``_PlacedCombine`` where the
    experts' outputs split their slots over more than one rank; anywhere
    else the plain combine, placed by the rules of its ops."""
    from ..models.layers import _combined
    if _replicated((out_e,)) or not any(
            _split_dim(pl, 3) == 1 for pl in _plain_placements(out_e)):
        return _combined(out_e, slot, tok, w, keep, x)
    return _PlacedCombine.apply(out_e, slot, tok, w, keep, x)


def _group_plan(x, n: int):
    """(the mesh dimension, k) where ``x``'s rows, viewed as ``n`` groups,
    lie k ranks to a group within one mesh dimension: the rows split over
    D ranks (their mesh dimensions in mesh order, rank r holding the r-th
    of D blocks of rows), D = n k with k > 1, and k dividing the size of
    the innermost of those dimensions, so that each group's k ranks are
    consecutive along it. None otherwise (each rank's rows are whole
    groups, or a group's ranks do not lie in one dimension)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return None
    dims = _row_split_dims(x)
    if not dims:
        return None
    mesh = x.device_mesh
    d = math.prod(mesh.size(j) for j in dims)
    if n >= d or d % n or x.shape[0] % d or mesh.size(dims[-1]) % (d // n):
        return None
    return dims[-1], d // n


def _group_ranks(mesh, j: int, k: int) -> tuple:
    """(this rank's position among its group's k ranks along mesh
    dimension ``j``, the coordinates along ``j`` of the other k - 1)."""
    q = mesh.get_coordinate()[j]
    pos, base = q % k, q - q % k
    return pos, [base + i for i in range(k) if i != pos]


def _exchange(mesh, j: int, peers, send: list):
    """``send[i]`` (rows) to ``peers[i]`` along mesh dimension ``j``, one
    ``all_to_all_single`` over that dimension with nothing for the other
    ranks -> the rows each peer sent, in ``peers``' order."""
    from torch.distributed import _functional_collectives as funcol
    size = [0] * mesh.size(j)
    for p, t in zip(peers, send):
        size[p] = t.shape[0]
    buf = torch.cat(send) if len(send) > 1 else send[0].contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(buf, size, size,
                                                      (mesh, j)))
    return list(got.split([size[p] for p in peers]))


def _shifted(pls, by: int, ndim: int) -> list:
    """Placements with each split of a dimension past the first moved
    ``by`` dimensions (the first keeps its split)."""
    from torch.distributed.tensor import Shard
    return [Shard(pl.dim % ndim + by) if isinstance(pl, Shard)
            and pl.dim % ndim else pl for pl in pls]


def _rows_placed(t, rows: set, whole: set):
    """``t`` split along its first dimension over the mesh dimensions
    ``rows`` (in mesh order), and over no other mesh dimension along a
    dimension of ``whole``."""
    from torch.distributed.tensor import Replicate, Shard
    pls = [Shard(0) if j in rows else
           Replicate() if _split_dim(pl, t.ndim) in whole else pl
           for j, pl in enumerate(_plain_placements(t))]
    return _placed_as(t, pls)


class _GroupRows(torch.autograd.Function):
    """``x`` (T, ...) with its rows split over D ranks, as the D groups of
    g = T k / D rows (D, g, ...) that its ranks compute, one a rank: the
    k ranks of a group (``_group_plan``) exchange their blocks of rows
    (one all-to-all along the mesh dimension they share), so that each
    holds its group whole, the k copies of a group split over its k
    ranks. The backward sends each copy's gradient rows back to the rank
    that holds them and adds them there."""

    @staticmethod
    def forward(ctx, x, j, k):
        mesh = x.device_mesh
        rows = set(_row_split_dims(x))
        x = _rows_placed(x, rows, {0})
        pos, peers = _group_ranks(mesh, j, k)
        local = x._local_tensor
        got = _exchange(mesh, j, peers, [local] * len(peers))
        got.insert(pos, local)
        d = math.prod(mesh.size(i) for i in rows)
        ctx.plan = (mesh, j, k, rows, tuple(x.shape))
        shape = (d, x.shape[0] * k // d) + tuple(x.shape[1:])
        return _wrap(torch.cat(got)[None], mesh,
                     _shifted(x.placements, 1, x.ndim), shape)

    @staticmethod
    def backward(ctx, grad):
        mesh, j, k, rows, shape = ctx.plan
        grad = _rows_placed(_as_dtensor(grad, mesh), rows, {0, 1})
        pos, peers = _group_ranks(mesh, j, k)
        parts = grad._local_tensor[0].chunk(k)
        got = _exchange(mesh, j, peers, [parts[p % k] for p in peers])
        out = parts[pos]
        for t in got:
            out = out + t
        return (_wrap(out, mesh, _shifted(grad.placements, -1, grad.ndim),
                      shape), None, None)


class _UngroupRows(torch.autograd.Function):
    """The rows of ``_GroupRows``' groups back in the batch's placement:
    each rank keeps the block of its group's rows that it held (no
    collective); the backward puts each rank's gradient rows into zeros
    of its group."""

    @staticmethod
    def forward(ctx, y, j, k, rows):
        mesh = y.device_mesh
        y = _rows_placed(y, rows, {0, 1})
        pos, _ = _group_ranks(mesh, j, k)
        local = y._local_tensor[0].chunk(k)[pos]
        ctx.plan = (mesh, j, k, rows, tuple(y.shape))
        shape = (y.shape[0] * y.shape[1] // k,) + tuple(y.shape[2:])
        return _wrap(local, mesh, _shifted(y.placements, -1, y.ndim), shape)

    @staticmethod
    def backward(ctx, grad):
        mesh, j, k, rows, shape = ctx.plan
        grad = _rows_placed(_as_dtensor(grad, mesh), rows, {0})
        pos, _ = _group_ranks(mesh, j, k)
        g = grad._local_tensor
        out = g.new_zeros((1, k * g.shape[0]) + tuple(g.shape[1:]))
        out[0, pos * g.shape[0]:(pos + 1) * g.shape[0]] = g
        return (_wrap(out, mesh, _shifted(grad.placements, 1, grad.ndim),
                      shape), None, None, None)


def placed_groups(fn, x, n: int):
    """``fn(x.reshape(n, g, ...)).reshape(x.shape)`` (each group of g rows
    of ``x`` through ``fn``, which treats the leading axis as a batch
    axis: the MoE's routing groups); on a DTensor whose rows are split
    over more ranks than there are groups (deepseek-v2-236b's 16 groups
    of a microbatch over the multi mesh's 32 batch ranks), each rank runs
    ``fn`` on the one group its rows belong to (``_GroupRows``) and keeps
    its own rows of the result (``_UngroupRows``), where a view of the
    rows as n groups would hold several groups whole on every rank. A
    group's rows, its routing and its outputs are those of the unplaced
    step."""
    plan = _group_plan(x, n)
    if plan is None:
        return fn(x.reshape(n, -1, *x.shape[1:])).reshape(x.shape)
    j, k = plan
    rows = set(_row_split_dims(x))
    return _UngroupRows.apply(fn(_GroupRows.apply(x, j, k)), j, k, rows)


def _sharded_index_select(op_call, args, kwargs):
    """``self.index_select(dim, index)`` on DTensors, per mesh dimension:

      * index split, ``self``'s rows whole there: each rank looks up its
        own indices; the output is split as the index is;
      * ``self``'s rows split (a table over "model"), the index whole
        there: each rank looks up the rows it holds, zeros for the
        others, and the partial sums are reduced at once (the all-reduce
        of the looked-up rows that the reference's partitioner makes);
      * both split (a graph's node states and its edges over the same
        mesh dimensions): whichever of ``self`` and the index-and-output
        moves fewer bytes is made whole first, the node states for a
        graph (an all-gather), the ids for a table;
      * ``self`` split along another dimension (a big model's table by
        features over "data"): the output split as ``self`` is, or,
        where the index is split there too, ``self`` made whole there (an
        FSDP gather), the output split as the index is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    self_, dim, index = args[:3]
    mesh = _mesh_of(self_, index)
    self_, index = _as_dtensor(self_, mesh), _as_dtensor(index, mesh)
    nd = self_.ndim
    dim %= nd
    sp, ip = _plain_placements(self_), _plain_placements(index)
    row_bytes = self_.numel() // max(1, self_.shape[dim]) * \
        self_.element_size()
    gather_self = self_.numel() * self_.element_size() <= \
        index.numel() * (row_bytes + index.element_size())
    out_p = []
    for j in range(mesh.ndim):
        if sp[j].is_partial():
            sp[j] = Replicate()
        s_dim = _split_dim(sp[j], nd)
        i_split = isinstance(ip[j], Shard)
        if s_dim == dim and i_split:
            if gather_self:
                sp[j] = Replicate()
            else:
                ip[j] = Replicate()
        elif s_dim is not None and s_dim != dim and i_split:
            sp[j] = Replicate()
        s_dim = _split_dim(sp[j], nd)
        out_p.append(Partial() if s_dim == dim else sp[j] if s_dim is not None
                     else Shard(dim) if isinstance(ip[j], Shard)
                     else Replicate())
    self_n, index_n = _placed_as(self_, sp), _placed_as(index, ip)
    local, li = self_n._local_tensor, index_n._local_tensor.long()
    shape = list(self_.shape)
    shape[dim] = index.shape[0]
    if any(_split_dim(pl, nd) == dim for pl in sp):
        lshape, off = _extent(self_.shape, sp, mesh)
        li, inside = _own_rows(li, dim, lshape, off)
        out = torch.where(_along(inside, dim, nd),
                          local.index_select(dim, li), 0)
    else:
        out = local.index_select(dim, li)
    out = _wrap(out, mesh, out_p, shape)
    return _placed_as(out, [Replicate() if pl.is_partial() else pl
                            for pl in out_p])


def _sharded_index_add(op_call, args, kwargs):
    """``self.index_add(dim, index, source, alpha)`` (and ``index_add_``)
    on DTensors, per mesh dimension:

      * source rows (and the index) split along ``dim`` (a split graph's
        edges, a split batch's looked-up rows): each rank adds its rows
        into zeros whole along ``dim``, a partial sum, reduced into
        ``self``'s placement at once (an all-reduce, or a reduce-scatter
        where ``self`` is split) — the collective that the reference's
        partitioner makes for a ``segment_sum`` over split rows;
      * ``self``'s rows split (a table's gradient over "model"), source
        whole there: each rank adds the entries whose index falls in its
        rows, zeros at its first row for the others;
      * ``self`` and source split alike along another dimension: a local
        ``index_add``;
    any other placement is first redistributed into one of these (the
    index and the source are what move)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    in_place = op_call is torch.ops.aten.index_add_.default
    self_, dim, index, src = args[:4]
    alpha = args[4] if len(args) > 4 else kwargs.get("alpha", 1)
    mesh = _mesh_of(self_, index, src)
    self_, index, src = (_as_dtensor(t, mesh) for t in (self_, index, src))
    nd = self_.ndim
    dim %= nd
    sp, xp, ip, wp = (_plain_placements(self_), _plain_placements(src),
                      [], [])
    for j in range(mesh.ndim):
        if sp[j].is_partial():
            if in_place:
                raise NotImplementedError(
                    f"{op_call} into a partial sum ({self_.placements})")
            sp[j] = Replicate()
        s, x = sp[j], xp[j]
        x_dim = _split_dim(x, nd)
        if x_dim == dim or x.is_partial():
            w = Partial()
        elif x_dim is not None and (s == x or (s.is_replicate()
                                               and not in_place)):
            s = w = x
        else:
            s_dim = _split_dim(s, nd)
            x = s if s_dim is not None and s_dim != dim else Replicate()
            w = s
        sp[j], xp[j] = s, x
        wp.append(w)
        ip.append(Shard(0) if _split_dim(x, nd) == dim else Replicate())
    self_n = _placed_as(self_, sp)
    if in_place and self_n is not self_:
        raise NotImplementedError(f"{op_call} into {self_.placements}")
    li = _placed_as(index, ip)._local_tensor.long()
    ls = _placed_as(src, xp)._local_tensor
    if alpha != 1:
        ls = ls * alpha
    lshape, off = _extent(self_.shape, wp, mesh)
    if any(_split_dim(pl, nd) == dim for pl in wp):
        li, inside = _own_rows(li, dim, lshape, off)
        ls = torch.where(_along(inside, dim, nd), ls, 0)
    if not any(pl.is_partial() for pl in wp):
        if in_place:
            self_n._local_tensor.index_add_(dim, li, ls)
            return self_
        return _wrap(self_n._local_tensor.index_add(dim, li, ls), mesh, sp,
                     self_.shape)
    part = _wrap(ls.new_zeros(lshape).index_add_(dim, li, ls), mesh, wp,
                 self_.shape)
    part = _placed_as(part, sp)
    return self_n.add_(part) if in_place else self_n + part


def _sharded_index_put(op_call, args, kwargs):
    """``self.index_put(indices, values, accumulate)`` (and
    ``index_put_``) on DTensors, for indices of one run of dimensions
    (leading ``None``s allowed), per mesh dimension:

      * ``self`` split along a dimension that is not indexed: the values
        split alike, the indices whole, a local write;
      * ``self`` split along an indexed dimension (the decode cache's
        batch over "data", its sequence over "model"): the indices and
        values made whole (all-gathers of a few entries), each index
        shifted into this rank's part, and an entry outside it written as
        a zero added (``accumulate``) or as a duplicate of an entry
        inside it (or, with none inside, of the value already at the
        part's first position);
      * with ``accumulate``, values split along the indexed entries (an
        indexing's backward over a split batch): each rank adds its
        entries into zeros, a partial sum reduced into ``self``'s
        placement;
      * anything else: the values and indices made whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    aten = torch.ops.aten
    in_place = op_call is aten.index_put_.default
    self_, indices, values = args[:3]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                          False)
    idx = list(indices)
    while idx and idx[-1] is None:
        idx.pop()
    lead = 0
    while lead < len(idx) and idx[lead] is None:
        lead += 1
    block = idx[lead:]
    if not block or any(t is None for t in block):
        raise NotImplementedError(
            f"{op_call}: indices other than one run of dimensions")
    mesh = _mesh_of(self_, values, *block)
    self_, values = _as_dtensor(self_, mesh), _as_dtensor(values, mesh)
    block = [_as_dtensor(t, mesh) for t in block]
    nd, r = self_.ndim, len(block)
    bshape = tuple(torch.broadcast_shapes(*(t.shape for t in block)))
    nb = len(bshape)
    shape = tuple(self_.shape)
    vshape = shape[:lead] + bshape + shape[lead + r:]
    if tuple(values.shape) != vshape:
        values = values.expand(vshape)
    nv = len(vshape)

    def indexed(d):
        return lead <= d < lead + r

    def vdim(d):                    # a dimension of self's in the values
        return d if d < lead else d - r + nb

    even = all(tuple(t.shape) == bshape for t in block)
    sp, vp = _plain_placements(self_), _plain_placements(values)
    ip, wp = [], []
    for j in range(mesh.ndim):
        if sp[j].is_partial():
            if in_place:
                raise NotImplementedError(
                    f"{op_call} into a partial sum ({self_.placements})")
            sp[j] = Replicate()
        s, v = sp[j], vp[j]
        s_dim, v_dim = _split_dim(s, nd), _split_dim(v, nv)
        i, w = Replicate(), s
        if s_dim is not None:
            v = Shard(vdim(s_dim)) if not indexed(s_dim) else Replicate()
        elif accumulate and even and v_dim is not None and \
                lead <= v_dim < lead + nb:
            i, w = Shard(v_dim - lead), Partial()
        elif accumulate and v.is_partial():
            w = Partial()
        elif v_dim is not None and not lead <= v_dim < lead + nb \
                and not in_place:
            s = w = Shard(v_dim if v_dim < lead else v_dim - nb + r)
        else:
            v = Replicate()
        sp[j], vp[j] = s, v
        ip.append(i)
        wp.append(w)
    self_n = _placed_as(self_, sp)
    if in_place and self_n is not self_:
        raise NotImplementedError(f"{op_call} into {self_.placements}")
    lv = _placed_as(values, vp)._local_tensor.to(self_.dtype)
    li = list(torch.broadcast_tensors(
        *(_placed_as(t, ip)._local_tensor.long() for t in block)))
    lshape, off = _extent(shape, wp, mesh)
    inside = None
    for p, t in enumerate(li):
        d = lead + p
        t = torch.where(t < 0, t + shape[d], t)
        if any(_split_dim(pl, nd) == d for pl in wp):
            t, ok = _own_rows(t, d, lshape, off)
            inside = ok if inside is None else inside & ok
        li[p] = t
    if inside is not None and accumulate:
        li = [torch.where(inside, t, 0) for t in li]
        lv = torch.where(inside.reshape((1,) * lead + inside.shape
                                        + (1,) * (nv - lead - nb)), lv, 0)
    if any(pl.is_partial() for pl in wp):
        buf = lv.new_zeros(lshape)
        aten.index_put_.default(buf, [None] * lead + li, lv, True)
        part = _placed_as(_wrap(buf, mesh, wp, shape), sp)
        return self_n.add_(part) if in_place else self_n + part
    local = self_n._local_tensor if in_place else \
        self_n._local_tensor.clone()
    if inside is not None and not accumulate:
        if lead:
            raise NotImplementedError(
                f"{op_call}: a write into a split indexed dimension "
                f"behind {lead} whole ones")
        # index tensors of one entry throughout: a 0-d index would be
        # read back to the host as a Python int
        inside = inside.reshape(-1)
        li = [t.reshape(-1) for t in li]
        lv = lv.reshape(-1, *lv.shape[nb:])
        any_in = inside.any()
        first = inside.to(torch.int8).argmax().reshape(1)
        pivot = [torch.where(any_in, t.index_select(0, first), 0)
                 for t in li]
        pivot_val = torch.where(any_in, lv.index_select(0, first),
                                local[tuple(pivot)])
        keep = inside.reshape(-1, *([1] * (lv.dim() - 1)))
        li = [torch.where(inside, t, p) for t, p in zip(li, pivot)]
        lv = torch.where(keep, lv, pivot_val)
    aten.index_put_.default(local, [None] * lead + li, lv, accumulate)
    return self_ if in_place else _wrap(local, mesh, sp, shape)


def _einsum_terms(equation: str, n: int) -> tuple:
    """(input terms, output term) of an explicit einsum equation of ``n``
    operands, each letter once per term, no ellipsis."""
    lhs, arrow, out_t = equation.replace(" ", "").partition("->")
    terms = lhs.split(",")
    if not arrow or "." in equation or len(terms) != n or \
            any(len(set(t)) != len(t) for t in terms + [out_t]):
        raise NotImplementedError(f"einsum {equation!r} on DTensors")
    return terms, out_t


def plan_einsum(equation: str, operands):
    """``torch.einsum(equation, *operands)`` on DTensors, on a plan the
    port makes itself, per mesh dimension: of the letters some operand
    holds split there (and every operand holds at one size), the one
    whose plan moves the fewest bytes stays split in every operand that
    holds it, so that no rank computes another's share. An operand whole
    there is cut for free; one split on another letter moves by an
    all-to-all (holding the letter) or an all-gather; a partial sum is reduced; a summed letter leaves
    the output a partial sum, whose reduction counts as its bytes. An
    operand that is a partial sum passes through as a partial output
    where no other operand is placed on that mesh dimension. Each rank
    then runs the einsum on its parts. DTensor would place the einsum's
    lowering (views and ``bmm``) instead, each torch version its own
    way, and a view keeps a split only on the outer dimension it
    flattens: the heads behind a split batch are gathered and every
    "model" rank computes all of them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    operands = list(operands)
    terms, out_t = _einsum_terms(equation, len(operands))
    mesh = _mesh_of(*operands)
    ops = [_as_dtensor(o, mesh) for o in operands]
    pls = [_plain_placements(o) for o in ops]
    sizes = {}
    for t, o in zip(terms, ops):
        for c, n in zip(t, o.shape):
            sizes.setdefault(c, set()).add(n)
    nbytes = [o.numel() * o.element_size() for o in ops]
    out_bytes = math.prod(max(sizes[c]) for c in out_t) * max(
        o.element_size() for o in ops)
    out_p = []
    for j in range(mesh.ndim):
        placed = [i for i, p in enumerate(pls) if not p[j].is_replicate()]
        if len(placed) == 1 and pls[placed[0]][j].is_partial():
            out_p.append(Partial())
            continue
        n = mesh.size(j)

        def cost(letter):
            c = 0 if letter in out_t else out_bytes
            for t, p, b in zip(terms, pls, nbytes):
                d = _split_dim(p[j], len(t))
                if p[j].is_partial():
                    c += b
                elif d is not None and t[d] != letter:
                    c += b / n if letter in t else b * (n - 1) / n
            return c

        candidates = list(dict.fromkeys(
            t[d] for t, p in zip(terms, pls)
            for d in [_split_dim(p[j], len(t))]
            if d is not None and len(sizes[t[d]]) == 1))
        letter = min(candidates, key=cost) if candidates else ""
        for t, p in zip(terms, pls):
            p[j] = Shard(t.index(letter)) if letter and letter in t \
                else Replicate()
        out_p.append(Replicate() if not letter else
                     Shard(out_t.index(letter)) if letter in out_t
                     else Partial())
    local = torch.einsum(equation, *(_placed_as(o, p)._local_tensor
                                     for o, p in zip(ops, pls)))
    return _wrap(local, mesh, out_p, [max(sizes[c]) for c in out_t])


class _PlannedEinsum(torch.autograd.Function):
    """``plan_einsum`` with its backward: each operand's gradient the
    einsum of the output's gradient with the other operands, on the same
    kind of plan (a letter that only that operand holds is summed in the
    forward, so its gradient is the same along it)."""

    @staticmethod
    def forward(ctx, equation, *operands):
        ctx.terms, ctx.out_t = _einsum_terms(equation, len(operands))
        ctx.save_for_backward(*operands)
        return plan_einsum(equation, operands)

    @staticmethod
    def backward(ctx, grad):
        ops, terms, out_t = ctx.saved_tensors, ctx.terms, ctx.out_t
        grads = []
        for i, t in enumerate(terms):
            if not ctx.needs_input_grad[1 + i]:
                grads.append(None)
                continue
            others = [j for j in range(len(terms)) if j != i]
            present = set(out_t).union(*(terms[j] for j in others))
            kept = "".join(c for c in t if c in present)
            g = plan_einsum(",".join([out_t] + [terms[j] for j in others])
                            + "->" + kept, [grad] + [ops[j] for j in others])
            if kept != t:
                for d, c in enumerate(t):
                    if c not in present:
                        g = g.unsqueeze(d)
                g = g.expand(ops[i].shape)
            grads.append(g)
        return (None, *grads)


def _replicated(operands) -> bool:
    """Whether no operand is split or a partial sum over more than one
    rank."""
    from torch.distributed.tensor import DTensor
    return all(not isinstance(o, DTensor) or all(
        pl.is_replicate() or o.device_mesh.size(j) == 1
        for j, pl in enumerate(o.placements)) for o in operands)


def placed_einsum(equation: str, *operands):
    """``plan_einsum``, differentiable where autograd records (a placed
    train step) — what ``models.layers.einsum`` runs on DTensors. Where
    nothing is split (a one-rank mesh) there is nothing to plan: the
    einsum runs as the unplaced step runs it, gradients and all, so the
    two agree bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate
    grad = torch.is_grad_enabled() and any(o.requires_grad for o in operands)
    if _replicated(operands):
        if grad:
            return torch.einsum(equation, *operands)
        # a whole einsum would reach DTensor undecomposed, which torch
        # 2.13 first tries to propagate through its decomposition and
        # fails (keeping the failure's frames until the collector runs):
        # every rank holds all of each operand, so it runs on them
        mesh = _mesh_of(*operands)
        local = torch.einsum(equation, *(o._local_tensor if isinstance(
            o, DTensor) else o for o in operands))
        return _wrap(local, mesh, [Replicate()] * mesh.ndim, local.shape)
    if grad:
        return _PlannedEinsum.apply(equation, *operands)
    return plan_einsum(equation, operands)


def _matmul_equation(a, b) -> str:
    """``a @ b`` as an einsum equation: ``b`` a matrix or a vector, or a
    batch of matrices of ``a``'s batch shape."""
    letters = "abcdefghijlopqrstuvwxyz"          # none of m, k, n
    if a.dim() == 0 or b.dim() == 0 or b.dim() > 2 and (
            a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2]):
        raise NotImplementedError(
            f"matmul of {tuple(a.shape)} and {tuple(b.shape)} on DTensors")
    batch = letters[:max(a.dim(), b.dim()) - 2]
    ta = batch[:a.dim() - 2] + ("mk" if a.dim() > 1 else "k")
    tb = (batch if b.dim() > 2 else "") + ("kn" if b.dim() > 1 else "k")
    to = batch + ("m" if a.dim() > 1 else "") + ("n" if b.dim() > 1 else "")
    return f"{ta},{tb}->{to}"


def placed_matmul(a, b):
    """``a @ b`` as ``placed_einsum`` of the einsum it is — what
    ``models.layers.matmul`` runs on DTensors (as ``a @ b`` where nothing
    is split)."""
    if _replicated((a, b)):
        return a @ b
    return placed_einsum(_matmul_equation(a, b), a, b)


def _planned_matmul(op_call, args, kwargs):
    """``a @ b`` where it reaches DTensor whole (inference mode), on
    ``plan_einsum``'s plan."""
    return plan_einsum(_matmul_equation(*args[:2]), args[:2])


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
