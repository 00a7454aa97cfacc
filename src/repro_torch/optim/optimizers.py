"""Optimizers — the port of ``repro.optim.optimizers``: AdamW with
decoupled weight decay, global-norm clipping and a warmup-cosine schedule;
SGD-momentum. Plain functions on tensors, not ``torch.optim.AdamW`` (which
keeps its moments in the param dtype and rounds differently).

What they take, and the reference's tree they keep:

  * ``params`` — the port's ``Params`` module tree (``models.layers``; a
    ``ModuleList`` holds what the reference stacks on a leading L axis,
    a ``LayerList`` what it keeps in a Python list).
    Updated in place (the reference returns a new tree from donated
    buffers) and returned.
  * ``grads`` — {parameter name (``named_parameters``): gradient}. Any
    dtype: the update runs in fp32.
  * ``OptState(step, m, v)`` — ``m`` and ``v`` are nested dicts in the
    reference's structure and leaf names (``layers/attn/wq`` one (L, d,
    H, hd) fp32 tensor, each layer's moment a view of it), so a checkpoint
    names them as the reference does. They are fp32 for fp32 and bf16
    params alike; a float64 tree (the referee of an fp32 run) keeps float64
    moments and updates in float64. sgd's ``v`` is the reference's tree
    of () zeros, unused.
    ``step`` is a () int32 tensor on the host: the schedule and the bias
    corrections are fp32 scalars computed there, so an update waits on
    nothing from the card.

Weight decay follows the reference's rule ``p.ndim >= 2`` on ITS leaf: a
stacked (L, d) norm scale is decayed; the model's (d,) ``final_norm`` and
the norms of deepseek's unstacked ``dense_layers`` are not — decided by
the reference's rank, never by the port's per-layer (d,) tensor. No
quotient is written ``scalar / tensor``: torch evaluates that as a
reciprocal and a product, not the reference's quotient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple

import torch

from ..models.layers import Leaf, module_leaves, ref_tree


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"              # adamw | sgd
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9            # sgd
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32, on the host
    m: object            # the reference's tree (fp32+): adam m / sgd momentum
    v: object            # the reference's tree (fp32+): adam v / unused (sgd)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The update's dtype: fp32, or the param's where that is wider."""
    return torch.promote_types(dtype, torch.float32)


def _leaf(tree, lf: Leaf) -> torch.Tensor:
    for k in lf.path:
        tree = tree[k]
    return tree


def _views(tree, lf: Leaf) -> List[torch.Tensor]:
    """The per-tensor pieces of a state leaf: a stacked leaf's layer
    views, or the leaf itself."""
    t = _leaf(tree, lf)
    return list(t.unbind(0)) if lf.stacked else [t]


def _layers_split(t: torch.Tensor) -> bool:
    """Whether a stacked state leaf is a DTensor split along its L axis
    (ZeRO-1 over "data" where the layer count divides): its layers live
    on different ranks, so it is updated whole, not through per-layer
    views, and the updated layers are gathered back to their params."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and Shard(0) in t.placements


def _gather_layers(t: torch.Tensor) -> torch.Tensor:
    """A DTensor split along dim 0 made whole along it (an all-gather:
    ZeRO-1's gather of the updated params)."""
    from torch.distributed.tensor import Replicate, Shard
    return t.redistribute(placements=[Replicate() if pl == Shard(0) else pl
                                      for pl in t.placements])


def init_opt_state(cfg: OptimizerConfig, params) -> OptState:
    leaves = module_leaves(params)

    def zeros(lf: Leaf, shape=None):
        t = lf.tensors[0]
        return torch.zeros(lf.ref_shape if shape is None else shape,
                           dtype=_wide(t.dtype), device=t.device)

    m = ref_tree((lf.path, zeros(lf)) for lf in leaves)
    v = ref_tree((lf.path, zeros(lf) if cfg.kind == "adamw" else
                  zeros(lf, ())) for lf in leaves)
    return OptState(step=torch.zeros((), dtype=torch.int32), m=m, v=v)


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in fp32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _flat(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (or float64 for
    float64 leaves; a tree of tensors, or a list of them)."""
    leaves = _flat(tree)
    sq = torch.stack([torch.linalg.vector_norm(x.to(_wide(x.dtype))) ** 2
                      for x in leaves])
    return torch.sqrt(sq.sum())


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(torch.full_like(gnorm, max_norm)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most ``max_norm``, fp32, in
    the same structure; the norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)

    def clip(t):
        if isinstance(t, dict):
            return {k: clip(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(clip(v) for v in t)
        return t.to(_wide(t.dtype)) * scale

    return clip(grads), gn


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState):
    """-> (params updated in place, new state, {"grad_norm", "lr"}). The
    moments are updated in place too; the step counter is new."""
    if cfg.kind not in ("adamw", "sgd"):
        raise ValueError(cfg.kind)
    leaves = module_leaves(params)
    gs = [[grads[key] for key in lf.keys] for lf in leaves]
    gnorm = global_norm(gs)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    lr_f = float(lr)                       # an fp32 value, exactly
    if cfg.kind == "adamw":
        b1, b2 = cfg.betas
        s = step.to(torch.float32)
        bc1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), s))
        bc2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), s))

        def update(p, g, m, v, decay):
            # the reference's expressions, evaluated in its order; the
            # in-place forms round as the out-of-place ones and keep the
            # temporaries of an embedding-sized leaf to a few
            g = g.to(m.dtype) * scale
            m.mul_(b1).add_((1 - b1) * g)
            t = (1 - b2) * g
            v.mul_(b2).add_(t.mul_(g))
            del g, t
            delta = m / bc1
            delta.div_(torch.sqrt(v / bc2).add_(cfg.eps))
            p32 = p.to(m.dtype)
            if decay:
                delta.add_(cfg.weight_decay * p32)
            return p32.sub_(delta.mul_(lr_f))
    else:
        def update(p, g, m, v, decay):
            m.mul_(cfg.momentum).add_(g.to(m.dtype) * scale)
            return p.to(m.dtype).sub_(lr_f * m)

    for lf, g_list in zip(leaves, gs):
        decay = cfg.kind == "adamw" and cfg.weight_decay \
            and len(lf.ref_shape) >= 2
        if lf.stacked and _layers_split(_leaf(state.m, lf)):
            new = update(torch.stack(lf.tensors), torch.stack(g_list),
                         _leaf(state.m, lf), _leaf(state.v, lf), decay)
            for p, row in zip(lf.tensors, _gather_layers(new).unbind(0)):
                p.copy_(row)
            continue
        vs = (_views(state.v, lf) if cfg.kind == "adamw"
              else [None] * len(lf.tensors))       # sgd keeps no v
        for p, g, m, v in zip(lf.tensors, g_list, _views(state.m, lf), vs):
            p.copy_(update(p, g, m, v, decay))
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
