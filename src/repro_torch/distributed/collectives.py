"""Distributed-optimization utilities — the port of
``repro.distributed.collectives``: int8-compressed gradient sync with
error feedback, and a two-level all-reduce.

``compressed_psum`` quantizes each gradient locally, all-reduces the
int32 accumulators against an all-reduce-max'd scale, and dequantizes
(Seide et al.; Dettmers); error feedback keeps the quantization noise from
accumulating across steps. The reference's docstring counts int8 on the
wire, but what it sums is the int32 accumulators, 4 bytes a value as
fp32's; the port keeps the reference's arithmetic, so it sends the same.

Each runs over a ``torch.distributed`` process group (``None``: the
default one; a ``DeviceMesh``'s dimension is ``mesh.get_group(name)``),
where the reference names a ``shard_map`` axis. The arithmetic is the
reference's, in its order — ``gf / gscale``, ``round`` (half to even in
both), the int32 sum, ``* gscale / n`` — so the result equals it bit for
bit; the collectives' sums are of integers (or, for ``hierarchical_psum``,
in the backend's order).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true fp32 quotient: CUDA computes a tensor over a
    Python number as a product with its reciprocal, so ``b`` goes in as a
    tensor on ``a``'s device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (q int8, scale () fp32)."""
    xf = x.to(torch.float32)
    amax = xf.abs().max()
    scale = _div(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _flatten(tree):
    """The tensor leaves of a tree of dicts (sorted keys, as a jax tree
    orders them), lists and tuples, and a function that rebuilds it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        leaves = [x for p, _ in parts for x in p]

        def build(it):
            return {k: rb(it) for k, (_, rb) in zip(keys, parts)}
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        leaves = [x for p, _ in parts for x in p]

        def build(it):
            return type(tree)(rb(it) for _, rb in parts)
    else:
        return [tree], lambda it: next(it)
    return leaves, build


def compressed_psum(grads, group=None, error_state=None):
    """int8-compressed mean-all-reduce of a gradient tree over ``group``.

    -> (synced gradients fp32, new error state): the error state carries
    each leaf's quantization residual (error feedback) and has the
    gradients' structure; ``None`` starts from zero."""
    n = dist.get_world_size(group)

    def one(g, err):
        gf = g.to(torch.float32)
        if err is not None:
            gf = gf + err
        q, scale = quantize_int8(gf)
        new_err = gf - dequantize_int8(q, scale)
        # the scales differ per rank, so the dequantized values are summed
        # as integers against the all-reduced maximum scale
        gscale = scale.clone()
        dist.all_reduce(gscale, op=dist.ReduceOp.MAX, group=group)
        total = torch.round(gf / gscale).to(torch.int32).contiguous()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return _div(total.to(torch.float32) * gscale, n), new_err

    flat_g, build = _flatten(grads)
    flat_e = ([None] * len(flat_g) if error_state is None
              else _flatten(error_state)[0])
    pairs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (build(iter(o for o, _ in pairs)),
            build(iter(e for _, e in pairs)))


def hierarchical_psum(x: torch.Tensor, inner_group,
                      outer_group: Optional[object] = None) -> torch.Tensor:
    """Two-level all-reduce: inside the pod first (NVLink), then across
    pods — the multi-pod gradient-sync pattern. ``x`` is not changed."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=inner_group)
    if outer_group is not None:
        dist.all_reduce(x, group=outer_group)
    return x
