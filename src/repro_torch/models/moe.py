"""Mixture-of-Experts FFN of the port — the counterpart of
``repro.models.moe``: a softmax router, top-k, renormalized combine
weights (Mixtral-style), optional shared experts (DeepSeek-V2) run
densely, and the reference's two dispatches, selected per config:

  * ``einsum`` — GShard-style one-hot dispatch and combine tensors
    (tokens, E, capacity), the classic formulation;
  * ``sort`` — token copies stably sorted by expert, written into an
    (E, C, d) buffer, one grouped einsum per weight, added back to their
    tokens (``scatter_add``).

Both drop the (token, slot) pairs past an expert's capacity
``max(4, ceil(T·k·cf / E))`` over the T tokens routed together, and
drop the same pairs: the queue order is the (token, slot) order. With
``group_size`` g the tokens route in T/g independent groups (the
reference's ``vmap``); here the group is a leading batch axis of every
dispatch tensor.

The reference computes all of this with jnp einsums, sorts and scatters
outside any Pallas kernel; so does the port, with torch ops. No step
waits on the host: the counts are a ``scatter_add``, never a
``bincount`` (which reads its input's maximum back on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .layers import (Params, _wide, combine, einsum, fan_in_init, in_groups,
                     matmul, swiglu_apply, swiglu_init)


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_model: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # 0 -> n_shared * d_ff_expert
    capacity_factor: float = 1.25
    dispatch: str = "einsum"      # einsum | sort
    group_size: int = 0           # 0 = one group; else dispatch per group


def moe_init(gen, cfg: MoEConfig, dtype, device=None) -> Params:
    """The router in fp32 (d, E); the experts stacked, (E, d, f) /
    (E, f, d); ``shared`` a swiglu of n_shared · f where there is one."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = Params(router=fan_in_init(gen, (d, E), torch.float32, device),
               w_gate=fan_in_init(gen, (E, d, f), dtype, device),
               w_up=fan_in_init(gen, (E, d, f), dtype, device),
               w_down=fan_in_init(gen, (E, f, d), dtype, device))
    if cfg.n_shared:
        fs = cfg.d_ff_shared or cfg.n_shared * cfg.d_ff_expert
        p["shared"] = swiglu_init(gen, d, fs, dtype, device)
    return p


def _route(params, x, cfg: MoEConfig):
    """x (..., T, d) -> top-k ids (..., T, k) int64, weights (..., T, k)
    in fp32 (or x's dtype where that is wider).

    ``lax.top_k`` orders equal probabilities by the lower expert id.
    ``torch.topk`` promises no order among ties, so the top k are the
    first k of a stable descending sort: the same ids in the same order,
    ties included."""
    logits = matmul(_wide(x), _wide(params["router"]))        # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :cfg.top_k], ids[..., :cfg.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return ids, w


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts)
    return max(4, c)


def _experts(params, xin):
    """(n, E, C, d) expert inputs -> (n, E, C, d) outputs: every expert's
    swiglu on its C slots, one grouped einsum per weight."""
    g = torch.nn.functional.silu(
        einsum("necd,edf->necf", xin, params["w_gate"]))
    u = einsum("necd,edf->necf", xin, params["w_up"])
    return einsum("necf,efd->necd", g * u, params["w_down"])


# ------------------------------------------------ einsum (GShard) path -- //

def _moe_einsum(params, x, cfg: MoEConfig):
    """x (n, T, d): n groups of T tokens -> (n, T, d)."""
    n, T, d = x.shape
    E, C, k = cfg.n_experts, _capacity(T, cfg), cfg.top_k
    ids, w = _route(params, x, cfg)                           # (n,T,k)
    onehot = (ids[..., None] == torch.arange(E, device=x.device)
              ).to(torch.int32)                               # (n,T,k,E)
    # position of each (token, slot) within its expert queue
    pos = torch.cumsum(onehot.reshape(n, T * k, E), dim=1).reshape(
        n, T, k, E) * onehot - 1
    keep = (pos >= 0) & (pos < C)
    # the reference's one_hot(where(keep, pos, -1), C): a -1 is a zero row
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)) \
        & keep[..., None]                                     # (n,T,k,E,C)
    disp = einsum("ntke,ntkec->ntec", onehot.to(x.dtype),
                        pos_oh.to(x.dtype))
    wide = w.dtype
    comb = einsum("ntke,ntkec,ntk->ntec", onehot.to(wide),
                        pos_oh.to(wide), w).to(x.dtype)
    xin = einsum("ntec,ntd->necd", disp, x)             # all-to-all
    out_e = _experts(params, xin)
    return einsum("ntec,necd->ntd", comb, out_e)        # all-to-all


# --------------------------------------------------- sort-based path --- //

def _moe_sort(params, x, cfg: MoEConfig):
    """x (n, T, d): n groups of T tokens -> (n, T, d). The group axis n is
    a batch dimension of every op, as the reference's ``vmap`` has it:
    each group's tokens are gathered, its (E·C + 1, d) buffer written and
    its tokens' outputs added back along dim 1, so that a split of the
    groups (over "data") stays a split through the dispatch. The experts'
    outputs go back to their tokens through ``layers.combine``: on a mesh
    that splits the experts over "model", each rank adds its own slots'
    outputs into its tokens, and the partial sums are reduced once."""
    n, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    ids, w = _route(params, x, cfg)                           # (n,T,k)
    flat_e = ids.reshape(n, T * k)
    flat_w = w.reshape(n, T * k)
    # a stable sort keeps each expert's queue in (token, slot) order, so
    # the pairs past its capacity are the reference's
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.gather(flat_e, 1, order)
    t_sorted = order // k                        # repeat(arange(T), k)[order]
    w_sorted = torch.gather(flat_w, 1, order)
    # the buffers are made with ``new_zeros`` (their source's tensor type),
    # so under ``jit_sharded`` they are DTensors and each write is a
    # DTensor op whose result DTensor places itself
    counts = flat_e.new_zeros((n, E)).scatter_add(1, flat_e,
                                                  torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(T * k, device=x.device) - torch.gather(
        starts, 1, e_sorted)
    keep = rank < C
    # the reference writes a dropped pair to slot E·C with mode="drop":
    # here one spare row per group takes them and is never read
    slot = torch.where(keep, e_sorted * C + rank, E * C)      # (n,T*k)
    rows = (n, T * k, d)
    tok = t_sorted[..., None].expand(rows)
    buf = x.new_zeros((n, E * C + 1, d)).scatter(
        1, slot[..., None].expand(rows), torch.gather(x, 1, tok))
    xin = buf[:, :E * C].reshape(n, E, C, d)
    out_e = _experts(params, xin).reshape(n, E * C, d)
    return combine(out_e, slot, t_sorted, w_sorted, keep, x)


# ----------------------------------------------------------- public ---- //

def moe_apply(params, x, cfg: MoEConfig):
    """x (..., d) -> (..., d). Shared experts (if any) added densely.

    With ``group_size`` g, where T > g and g divides T, tokens route
    independently inside T/g groups (GShard's grouping): the dispatch and
    capacity tensors are (g, E, C_g) per group instead of (T, E, C). On a
    mesh each rank computes the groups its rows belong to
    (``layers.in_groups``)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    fn = {"einsum": _moe_einsum, "sort": _moe_sort}[cfg.dispatch]
    g = cfg.group_size
    if g and T > g and T % g == 0:
        out = in_groups(lambda xg: fn(params, xg, cfg), xt, T // g)
    else:
        out = fn(params, xt[None], cfg)[0]
    if cfg.n_shared:
        out = out + swiglu_apply(params["shared"], xt)
    return out.reshape(x.shape)
