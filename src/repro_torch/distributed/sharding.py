"""Sharding rules — the port of ``repro.distributed.sharding``: logical
param / activation axes -> partition specs on a mesh, plus the elastic
rebalance's ring permute (DESIGN §4.4) that the sharded dedup service
(``dedup/sharded.py``) runs to move router buckets between ranks.

Mesh: ("pod", "data", "model") multi-pod or ("data", "model") single-pod.
The batch shards over ("pod", "data"); tensor-parallel dims over "model";
FSDP (when enabled) additionally shards d_model dims over "data".

Divisibility-aware, as in the reference: every rule is a preference chain
— GQA KV heads shard over "model" when n_kv % model == 0, otherwise the
head_dim shards, otherwise nothing; MoE experts shard over "model" when
divisible (deepseek's 160), else the expert FFN dim (mixtral's 8). The
same logic picks the KV-cache specs for serving.

A spec is a ``PartitionSpec`` (``P``): one entry per tensor dimension, a
mesh-axis name, a tuple of names (the dimension split over those axes,
the first the major one) or ``None``, equal entry for entry to the
reference's ``jax.sharding.PartitionSpec``. The spec functions read only
the mesh's axis names and sizes, so they take a ``DeviceMesh`` or a plain
``MeshAxes`` record alike, and a tree of shapes — ``meta`` tensors — never
live arrays, so the 236B config costs nothing to plan. ``placements``
turns a spec into DTensor placements on a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist


def ring_schedule(n_shards: int):
    """The static one-step ring rotation over ``n_shards`` ranks: rank i
    sends to i + 1 (mod n). ``rebalance_collect`` drives the whole state
    around this ring ``n_shards - 1`` times and lets each rank keep what the
    new router table says it owns — data-dependent selection over a
    data-independent schedule."""
    return [(i, (i + 1) % n_shards) for i in range(n_shards)]


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped trees: a
    ``FilterState`` (its fields), a NamedTuple, a tuple or list, a tensor;
    ``None`` stays ``None``."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t):
        return type(t)(*(tree_map(fn, *(getattr(x, f.name) for x in trees))
                         for f in dataclasses.fields(t)))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"not a tree of tensors: {type(t).__name__}")


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _ring_shift(tree, ids, group, n_shards: int):
    """Every leaf of ``tree`` and ``ids`` one step around the ring: sent to
    rank ``me + 1``, received from ``me - 1`` (one ``batch_isend_irecv``)."""
    me = dist.get_rank(group)
    pairs = ring_schedule(n_shards)
    dst = _global_rank(group, pairs[me][1])
    src = _global_rank(group, next(i for i, j in pairs if j == me))
    leaves = tree_leaves(tree) + [ids]
    recv = [torch.empty_like(x) for x in leaves]
    ops = []
    for x, r in zip(leaves, recv):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    it = iter(recv[:-1])
    return tree_map(lambda _: next(it), tree), recv[-1]


def rebalance_collect(tree, slot_ids: torch.Tensor, want_ids: torch.Tensor,
                      group, n_shards: int):
    """For each local bucket slot, the state of the bucket the new router
    assignment places there, from whichever rank holds it now.

    ``tree``: a tree of per-slot leaves (a ``FilterState``), leading axis
    the local slots (b_r). ``slot_ids``: (b_r,) int32 — the bucket id each
    local slot holds now. ``want_ids``: (b_r,) int32 — the bucket id each
    must hold after the re-partition (from the replicated new assignment,
    so every rank computes the same global permutation). ``group`` is the
    process group (``None``: the default one).

    The own slab first, then ``n_shards - 1`` ring rotations: rotation r
    visits rank ``me - r``'s original slots, and a bucket id lives on
    exactly one rank, so every wanted slot is filled exactly once. Paid only
    when the load trigger fires."""
    def take(acc, visiting, ids):
        hit = want_ids[:, None] == ids[None, :]              # (b_r, b_r)
        found = hit.any(dim=1)
        idx = hit.to(torch.int32).argmax(dim=1)              # first hit

        def leaf(a, v):
            cand = v.index_select(0, idx)
            mask = found.reshape((-1,) + (1,) * (cand.dim() - 1))
            return torch.where(mask, cand, a)

        return tree_map(leaf, acc, visiting)

    acc = take(tree, tree, slot_ids)                         # own slab first
    rotating, ids = tree, slot_ids
    for _ in range(n_shards - 1):
        rotating, ids = _ring_shift(rotating, ids, group, n_shards)
        acc = take(acc, rotating, ids)
    return acc


# ------------------------------------------------------- specs and meshes --- //

class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh-axis name, a tuple of names
    or ``None``; missing trailing entries mean ``None``. A one-name tuple
    is that name and an empty one ``None``, as jax's spec normalises them.
    A tuple subclass, so it compares entry for entry with the reference's
    spec, and tree walks tell it from a tuple of subtrees by its type."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple):
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class MeshAxes(NamedTuple):
    """A mesh's axis names and sizes (``shape``, a dict as
    ``jax.sharding.Mesh`` gives it), with no devices or process group:
    what the spec functions read."""
    axis_names: tuple
    shape: dict


def mesh_axes(mesh) -> MeshAxes:
    """The names and sizes of a ``DeviceMesh``, of a ``MeshAxes`` or of
    anything else with ``axis_names`` and a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshAxes(tuple(names), dict(zip(names, mesh.mesh.shape)))
    return MeshAxes(tuple(mesh.axis_names),
                    {a: int(mesh.shape[a]) for a in mesh.axis_names})


def batch_axes(mesh) -> tuple:
    names = mesh_axes(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(axis_size(mesh, n) for n in name)
    ax = mesh_axes(mesh)
    return int(ax.shape[name]) if name in ax.axis_names else 1


def _pick(mesh, dim: int, prefs: Sequence):
    """First mesh axis (or axis tuple) in prefs that divides dim; None if
    nothing fits."""
    for a in prefs:
        if a is None:
            return None
        if dim % axis_size(mesh, a) == 0 and axis_size(mesh, a) > 1:
            return a
    return None


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` where the spec names that axis at tensor dimension d,
    else ``Replicate()``. A tuple entry shards one dimension over several
    mesh dimensions, the first named the major one; DTensor splits a
    dimension over mesh dimensions in mesh order, so a tuple out of mesh
    order, an axis named twice or an axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axes(mesh).axis_names
    out = [Replicate() for _ in names]
    used = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names or a in used:
                raise ValueError(f"spec {spec}: axis {a!r} is not on the "
                                 f"mesh {names} or is named twice")
            used.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {axes} is out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_extent(shape, placements, sizes, coord) -> tuple:
    """(local shape, global offset) of the shard at mesh coordinate
    ``coord`` of a tensor of ``shape`` under DTensor ``placements`` on a
    mesh of ``sizes``: each ``Shard(d)`` splits dimension d as DTensor
    does (``torch.chunk``'s ceiling), mesh dimension by mesh
    dimension."""
    from torch.distributed.tensor import Shard
    size, off = list(shape), [0] * len(shape)
    for pl, n, c in zip(placements, sizes, coord):
        if isinstance(pl, Shard):
            d = pl.dim % len(shape)
            chunk = -(-size[d] // n)
            start = min(c * chunk, size[d])
            size[d] = max(0, min(chunk, size[d] - start))
            off[d] += start
    return tuple(size), tuple(off)


def shard_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """The first rank's local shape of a tensor of ``shape`` placed by
    ``placements(spec, mesh)``."""
    ax = mesh_axes(mesh)
    sizes = [ax.shape[a] for a in ax.axis_names]
    return shard_extent(shape, placements(spec, mesh), sizes,
                        [0] * len(sizes))[0]


def map_specs(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and lists whose leaves
    are specs (or shapes) — the reference's ``jax.tree.map`` over a spec
    tree; ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _ref_leaves(params_shape):
    """(reference path, reference shape) of every leaf of a ``Params``
    tree (``models.layers.module_leaves``)."""
    from ..models.layers import module_leaves
    return [(lf.path, lf.ref_shape) for lf in module_leaves(params_shape)]


def shape_tree(params_shape):
    """The reference's tree of leaf shapes of a ``Params`` tree."""
    from ..models.layers import ref_tree
    return ref_tree(_ref_leaves(params_shape))


def _leaf_name(path) -> str:
    """The reference's ``path[-1].key``, or ``str`` of a list index's
    key (``[0]``)."""
    last = path[-1]
    return f"[{last}]" if isinstance(last, int) else last


# --------------------------------------------------------- transformer --- //

def transformer_param_specs(cfg, mesh, params_shape, fsdp: bool = False):
    """Spec tree of a ``Params`` tree (``meta`` tensors serve), in the
    reference's tree structure and leaf names: a stacked ``layers`` leaf's
    spec has the reference's leading ``None`` for its L axis."""
    model = "model"
    fsdp_axis = "data" if fsdp else None
    from ..models.layers import ref_tree

    def _dim(shape, i):
        return shape[i] if i < len(shape) else 1

    def _param_spec(name, shape):
        d_spec = _pick(mesh, _dim(shape, 0), [fsdp_axis])  # d_model dims
        if name in ("embed",):
            return (_pick(mesh, shape[0], [model]),
                    _pick(mesh, shape[1], [fsdp_axis]))
        if name in ("lm_head",):
            return (_pick(mesh, shape[0], [fsdp_axis]),
                    _pick(mesh, shape[1], [model]))
        if name in ("wq",) and len(shape) == 3:
            return (d_spec, _pick(mesh, shape[1], [model]), None)
        if name in ("wk", "wv"):
            kv = _pick(mesh, shape[1], [model])
            if kv is None:  # shard head_dim instead
                return (d_spec, None, _pick(mesh, shape[2], [model]))
            return (d_spec, kv, None)
        if name == "wo":
            if len(shape) == 3:
                return (_pick(mesh, shape[0], [model]), None, d_spec)
            return (_pick(mesh, shape[0], [model]), d_spec)
        if name in ("wq_a", "wkv_a"):
            return (d_spec, None)
        if name in ("wq_b", "wkv_b"):
            return (None, _pick(mesh, shape[1], [model]), None)
        if name in ("w_gate", "w_up", "w_down"):
            if len(shape) == 3:  # MoE expert-stacked (E, d, f) / (E, f, d)
                e = _pick(mesh, shape[0], [model])
                if e is not None:
                    return (e, _pick(mesh, shape[1], [fsdp_axis]), None)
                # experts not divisible -> TP inside the expert FFN dim
                ff_dim = 2 if name in ("w_gate", "w_up") else 1
                spec = [None, None, None]
                spec[ff_dim] = _pick(mesh, shape[ff_dim], [model])
                return tuple(spec)
            if name in ("w_gate", "w_up"):
                return (d_spec, _pick(mesh, shape[1], [model]))
            return (_pick(mesh, shape[0], [model]), d_spec)
        # the router, norms, biases, everything small: replicate
        return tuple(None for _ in shape)

    def leaf_spec(path, shape):
        stacked = "layers" in path           # the scanned stack's L axis
        spec = _param_spec(_leaf_name(path), shape[1:] if stacked else shape)
        return P(None, *spec) if stacked else P(*spec)

    return ref_tree((path, leaf_spec(path, shape))
                    for path, shape in _ref_leaves(params_shape))


def transformer_batch_specs(mesh):
    b = batch_axes(mesh)
    return {"tokens": P(b, None), "weights": P(b)}


def transformer_cache_specs(cfg, mesh, cache_shape):
    """KV-cache specs for decode (``cache_shape``: {leaf: a tensor or a
    (shape, dtype) pair}, as ``transformer.cache_spec`` gives it): batch
    over the data axes; KV heads, the sequence or head_dim (GQA), or the
    sequence or latent dim (MLA) over model."""
    b = batch_axes(mesh)

    def leaf(name, x):
        shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x[0])
        if name in ("k", "v"):          # (L, B, S, Kv, hd)
            kv = _pick(mesh, shape[3], ["model"])
            if kv is not None:
                return P(None, b, None, kv, None)
            # Kv < model axis: a sequence-parallel cache before head_dim
            # sharding, which would all-gather the cache every step
            seq = _pick(mesh, shape[2], ["model"])
            if seq is not None:
                return P(None, b, seq, None, None)
            return P(None, b, None, None, _pick(mesh, shape[4], ["model"]))
        if name in ("ckv", "kpe"):      # (L, B, S, c)
            seq = _pick(mesh, shape[2], ["model"])
            if seq is not None:
                return P(None, b, seq, None)
            return P(None, b, None, _pick(mesh, shape[3], ["model"]))
        if name == "kpos":
            return P(None, b, None)
        return P(*(None for _ in shape))

    return {name: leaf(name, x) for name, x in cache_shape.items()}


# ----------------------------------------------------------------- gnn --- //

def gnn_param_specs(mesh, params_shape):
    """MeshGraphNet params are ~1M — replicate everything."""
    from ..models.layers import ref_tree
    return ref_tree((path, P(*(None for _ in shape)))
                    for path, shape in _ref_leaves(params_shape))


def gnn_batch_specs(mesh, shard_graph_over_model: bool = False):
    """Nodes / edges shard over the batch axes (full-batch cells
    additionally spread over "model" — graph partitioning by index
    range)."""
    axes = batch_axes(mesh)
    if shard_graph_over_model:
        axes = axes + ("model",)
    return {
        "nodes": P(axes, None), "edges": P(axes, None),
        "src": P(axes), "dst": P(axes),
        "edge_mask": P(axes), "node_mask": P(axes),
        "targets": P(axes, None),
    }


# -------------------------------------------------------------- recsys --- //

def recsys_param_specs(mesh, params_shape):
    """Embedding tables row-shard over "model"; small dense towers
    replicate."""
    from ..models.layers import ref_tree

    def leaf_spec(path, shape):
        joined = "/".join("" if isinstance(k, int) else k for k in path)
        if "table_" in joined or "wide" in joined:
            row = _pick(mesh, shape[0], ["model"])
            return P(row, *(None for _ in shape[1:]))
        return P(*(None for _ in shape))

    return ref_tree((path, leaf_spec(path, shape))
                    for path, shape in _ref_leaves(params_shape))


def recsys_batch_specs(mesh, retrieval: bool = False):
    b = batch_axes(mesh)
    specs = {"dense": P(b, None), "sparse_ids": P(b, None), "labels": P(b)}
    if retrieval:
        # 1 query replicated; 1M candidates shard over the batch axes
        # (1e6 is not divisible by 256/512; 16/32-way splits evenly)
        specs = {"dense": P(), "sparse_ids": P(),
                 "candidates": P(b, None)}
    return specs


# ---------------------------------------------------------- optimizer ---- //

def zero_shard_spec(param_spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """ZeRO-1: shard optimizer moments over "data" on the first dim the
    param spec leaves unsharded (and that divides). Falls back to the
    param spec."""
    data = "data"
    if data not in mesh_axes(mesh).axis_names or axis_size(mesh, data) == 1:
        return param_spec

    def _uses_data(e):
        return e == data or (isinstance(e, tuple) and data in e)

    if any(_uses_data(e) for e in param_spec):   # FSDP already on "data"
        return param_spec
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % axis_size(mesh, data) == 0 and dim > 1:
            entries[i] = data
            return P(*entries)
    return param_spec
