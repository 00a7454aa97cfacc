"""The elastic-rebalance permute schedule (DESIGN §4.4) — the port of
``repro.distributed.sharding.ring_schedule`` and ``rebalance_collect`` over
``torch.distributed``, which the sharded dedup service
(``dedup/sharded.py``) runs to move router buckets between ranks. The
reference's model-spec functions of the same file are not ported here.
"""

from __future__ import annotations

import dataclasses

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
