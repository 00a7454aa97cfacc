"""Shared neural-net layers of the port — the counterpart of
``repro.models.layers``: what the LMs run (serving, and the training
objective ``weighted_xent``) and what GNN and recsys run (``layernorm``,
``mlp_init`` / ``mlp_apply``, ``zeros_init`` / ``ones_init``).

Conventions, as in the reference:
  * init fns take an explicit ``torch.Generator`` and return a tensor on
    its device; on the ``meta`` device (``gen=None``) they allocate nothing,
    which is how ``TransformerConfig.param_count`` counts a 236B tree;
  * compute dtype is the caller's (bf16 by default), reductions and
    softmax in fp32 — or in the compute dtype where that is wider, so a
    float64 model is float64 throughout (the referee of an fp32 run);
  * every matmul is an einsum in the reference's own layout and axis
    names, so the converter (``repro_torch.convert``) moves weights across
    with no transposes.

The reference computes attention and every matmul as jnp einsums outside
any Pallas kernel; the port computes them with ``torch.einsum`` in the
reference's blocked form (``flash_sdpa``), not through a library
attention.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

_NEG = torch.finfo(torch.float32).min


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in its own dtype where that is wider: the
    reference's ``astype(jnp.float32)`` for every dtype it trains in."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Params(nn.Module):
    """One node of the reference's param tree as a module: tensors become
    trainable parameters and nodes submodules under the reference's leaf
    names, and ``p["wq"]`` reads as it does in the reference
    (``state_dict`` keys such as ``layers.0.attn.wq``). Serving runs under
    ``torch.inference_mode()``, so it records no graph."""

    def __init__(self, **children):
        super().__init__()
        for name, value in children.items():
            self[name] = value

    def __setitem__(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            self.register_parameter(name, nn.Parameter(value))
        elif isinstance(value, nn.Module):
            self.add_module(name, value)
        else:
            raise TypeError(f"{name}: a tensor or a module, not "
                            f"{type(value).__name__}")

    def __getitem__(self, name: str):
        return getattr(self, name)


class LayerList(nn.ModuleList):
    """Layers the reference keeps in a Python list (deepseek's
    ``dense_layers``, an MLP's layers), not stacked: each layer's
    parameters are leaves of their own under its index
    (``dense_layers/0/attn/norm``), where a plain ``ModuleList`` is one
    stacked leaf per name. A Python list of bare tensors (an MLP's
    ``ws``, xDeepFM's ``cin``) is an ``nn.ParameterList``, one leaf per
    index (``enc_node/ws/0``)."""


class Leaf(NamedTuple):
    """One leaf of the reference's param tree: its path (a list's index
    an int), the port's tensors that make it (one, or one per layer of a
    leaf the reference stacks on a leading L axis) and their names in the
    port's module."""
    path: Tuple[Union[str, int], ...]
    tensors: List[torch.Tensor]
    keys: list
    stacked: bool

    @property
    def ref_shape(self) -> tuple:
        """The leaf's shape in the reference's tree."""
        lead = (len(self.tensors),) if self.stacked else ()
        return lead + tuple(self.tensors[0].shape)


def _leaves_of(mod: nn.Module, path: tuple, prefix: str):
    for name, p in mod.named_parameters(recurse=False):
        yield Leaf(path + (name,), [p], [prefix + name], False)
    for name, sub in mod.named_children():
        if isinstance(sub, nn.ParameterList):
            for i, p in enumerate(sub):
                yield Leaf(path + (name, i), [p], [f"{prefix}{name}.{i}"],
                           False)
        elif isinstance(sub, LayerList):
            for i, m in enumerate(sub):
                yield from _leaves_of(m, path + (name, i),
                                      f"{prefix}{name}.{i}.")
        elif isinstance(sub, nn.ModuleList):
            per = [list(_leaves_of(m, path + (name,), f"{prefix}{name}.{i}."))
                   for i, m in enumerate(sub)]
            for group in zip(*per):
                yield Leaf(group[0].path, [g.tensors[0] for g in group],
                           [g.keys[0] for g in group], True)
        else:
            yield from _leaves_of(sub, path + (name,), f"{prefix}{name}.")


def module_leaves(mod: nn.Module) -> List[Leaf]:
    """The reference's leaves of a ``Params`` tree, in its tree order
    (sorted keys at every level, a list's items in order): a
    ``ModuleList`` of like modules is one stacked leaf per parameter
    name, as the reference's scanned ``layers``; a ``LayerList`` is its
    Python list of unstacked layers."""
    return sorted(_leaves_of(mod, (), ""), key=lambda lf: lf.path)


def ref_tree(items) -> dict:
    """The reference's nested tree of (path, value) pairs: dicts, and a
    list where the keys are a list's indices (``dense_layers``)."""
    out: dict = {}
    for path, value in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


def rebuild_params(template: nn.Module, tensors: dict) -> nn.Module:
    """A new ``Params`` tree shaped as ``template`` over ``tensors`` (the
    port's parameter name -> tensor)."""
    def build(mod, prefix):
        if isinstance(mod, nn.ParameterList):
            return nn.ParameterList(tensors[f"{prefix}{i}"]
                                    for i in range(len(mod)))
        if isinstance(mod, nn.ModuleList):
            return type(mod)(build(m, f"{prefix}{i}.")
                             for i, m in enumerate(mod))
        out = Params()
        for name, _ in mod.named_parameters(recurse=False):
            out[name] = tensors[prefix + name]
        for name, sub in mod.named_children():
            out[name] = build(sub, f"{prefix}{name}.")
        return out
    return build(template, "")


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or anything numpy names (the
    reference's ``jnp.bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, np.dtype(dtype).name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"no torch dtype for {dtype!r}")
    return out


def tensor_batch(batch: dict, device=None) -> dict:
    """A batch of numpy arrays (the data modules' output) as tensors on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``), each
    keeping its dtype; a tensor is moved, not copied, where it already
    lies there."""
    from ..core.device import resolve_device
    device = resolve_device(device)
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


# ----------------------------------------------------------------- init -- //


def normal_init(gen: Optional[torch.Generator], shape, dtype, stddev=0.02,
                device=None) -> torch.Tensor:
    """N(0, stddev) drawn in fp32 from ``gen`` on its device, cast to
    ``dtype``; ``gen=None`` on the ``meta`` device only (shapes, no data)."""
    if gen is None:
        if torch.device(device or "cpu").type != "meta":
            raise ValueError("normal_init needs a generator off the meta "
                             "device")
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return x.normal_(0.0, stddev, generator=gen).to(dtype)


def fan_in_init(gen: Optional[torch.Generator], shape, dtype,
                device=None) -> torch.Tensor:
    """LeCun-normal on the penultimate axis (matmul contracting dim)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(fan_in), device)


def zeros_init(gen: Optional[torch.Generator], shape, dtype, device=None
               ) -> torch.Tensor:
    """Zeros on ``device`` (the generator's where none is given); no draw."""
    return torch.zeros(shape, dtype=dtype,
                       device=gen.device if device is None else device)


def ones_init(gen: Optional[torch.Generator], shape, dtype, device=None
              ) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype,
                      device=gen.device if device is None else device)


# ----------------------------------------------------------------- norm -- //


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm in fp32 (``_wide``), cast back to x.dtype."""
    xf = _wide(x)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * _wide(scale)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in fp32 (``_wide``) over the last axis, the biased
    variance under ``rsqrt``, cast back to x.dtype."""
    xf = _wide(x)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * _wide(scale) + _wide(bias)).to(x.dtype)


# ----------------------------------------------------------------- rope -- //


def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The rotation frequencies in ``dtype`` (fp32, as the reference's;
    a float64 model's in float64, where the rounding of each device's fp32
    power would be the largest difference between two float64 runs)."""
    # the base stays a Python scalar: a tensor made from it on the card
    # would be a host-to-device copy, a host wait in every layer
    exps = torch.arange(0, head_dim, 2, dtype=dtype, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x (..., S, H, D) with positions (..., S) — rotates pairs (even, odd),
    interleaved as the reference does (not the half-split form). The
    even and odd lanes are the two columns of x viewed as (..., D/2, 2),
    not strided slices: the same values, and on a DTensor whose D is
    split (a KV head_dim over "model") the view keeps the split where
    each rank holds whole pairs, where a strided slice would gather D."""
    d = x.shape[-1]
    wide = torch.promote_types(x.dtype, torch.float32)
    freqs = rope_freqs(d, theta, x.device, wide)          # (D/2,)
    angles = positions[..., None].to(wide) * freqs        # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    pairs = x.reshape(*x.shape[:-1], d // 2, 2)           # (..., D/2, 2)
    x1 = _wide(pairs[..., 0])
    x2 = _wide(pairs[..., 1])
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------ attention -- //


def einsum(equation: str, *operands) -> torch.Tensor:
    """``torch.einsum``; on DTensors (a step placed by
    ``train.jit_sharded``) the port's own plan,
    ``train.steps.placed_einsum``, which places the whole einsum and
    its gradients the same way on every torch, where autograd would
    first lower it to views and ``bmm`` for DTensor to place."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(o, DTensor) for o in operands):
        from ..train.steps import placed_einsum
        return placed_einsum(equation, *operands)
    return torch.einsum(equation, *operands)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; on DTensors the einsum it is, on the port's own plan
    (``einsum``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor) or isinstance(b, DTensor):
        from ..train.steps import placed_matmul
        return placed_matmul(a, b)
    return a @ b


def gather(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather``; on DTensors the port's own placement,
    ``train.steps.placed_gather``: along a split dimension each rank
    reads its own slice, where DTensor would gather it whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        from ..train.steps import placed_gather
        return placed_gather(x, dim, index)
    return torch.gather(x, dim, index)


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as an embedding lookup; on DTensors the port's own
    placement, ``train.steps.placed_embedding``, whose backward adds each
    rank's gradient rows into its own slice of the table, where
    autograd's would make the whole table's gradient on every rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(table, DTensor) or isinstance(ids, DTensor):
        from ..train.steps import placed_embedding
        return placed_embedding(table, ids)
    return torch.nn.functional.embedding(ids, table)


def combine(out_e: torch.Tensor, slot: torch.Tensor, tok: torch.Tensor,
            w: torch.Tensor, keep: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """The MoE sort dispatch's combine: (n, S, d) expert outputs, each of
    n groups' (token, slot) pairs (n, P) at ``slot`` (S for a dropped
    pair, ``keep`` False: read as slot 0 with weight 0), times its
    weight ``w``, added into its token ``tok`` of the group's tokens
    ``x`` (n, T, d), whose shape the result takes. On DTensors whose
    slots are split (the experts over "model") the port's own placement,
    ``train.steps.placed_combine``: each rank adds its own slots' outputs
    into their tokens, where a gather along the split slots would move
    the experts' outputs."""
    from torch.distributed.tensor import DTensor
    if isinstance(out_e, DTensor):
        from ..train.steps import placed_combine
        return placed_combine(out_e, slot, tok, w, keep, x)
    return _combined(out_e, slot, tok, w, keep, x)


def _combined(out_e, slot, tok, w, keep, x):
    rows = (*slot.shape, out_e.shape[-1])
    src = torch.where(keep, slot, 0)[..., None].expand(rows)
    gathered = torch.gather(out_e, 1, src) * (w * keep).to(x.dtype)[
        ..., None]
    return x.new_zeros(x.shape).scatter_add(1, tok[..., None].expand(rows),
                                            gathered)


def in_groups(fn, x: torch.Tensor, n: int) -> torch.Tensor:
    """``fn`` over ``x``'s rows viewed as ``n`` groups (a leading batch
    axis of what ``fn`` computes), viewed back as ``x``'s rows; on a
    DTensor the port's own placement, ``train.steps.placed_groups``,
    under which each rank computes the group its rows belong to, where
    a view would hold several groups whole on every rank when the
    groups are fewer than the ranks that split the rows."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        from ..train.steps import placed_groups
        return placed_groups(fn, x, n)
    return fn(x.reshape(n, -1, *x.shape[1:])).reshape(x.shape)


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """(..., Sq, Sk) bool mask: causal, optionally sliding-window."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return m


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query scaled dot-product attention (naive — materializes the
    score matrix; for short Sq, e.g. decode).

    q (B, Sq, Kv, G, D), k (B, Sk, Kv, D), v (B, Sk, Kv, Dv), mask
    (B, Sq, Sk) -> (B, Sq, Kv, G, Dv). Softmax in fp32; masked scores are
    fp32's most negative finite value, as in the reference.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = _wide(einsum("bqhgd,bkhd->bhgqk", q, k)) * scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], _NEG)
    probs = torch.softmax(scores, dim=-1)
    return einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int] = None, scale: Optional[float] = None,
               q_block: int = 1024, k_block: int = 1024) -> torch.Tensor:
    """Block-chunked attention: online softmax over KV blocks, a loop over
    Q blocks (the reference's two ``lax.scan``s). Never materializes more
    than a (B, Kv, G, q_block, k_block) tile, and under autograd keeps none
    of them for the backward pass (each Q block is checkpointed).

    q (B, Sq, Kv, G, D); k (B, Sk, Kv, D); v (B, Sk, Kv, Dv); q_pos (B, Sq),
    k_pos (B, Sk) int32 (negative k_pos = invalid/padding). Causal: attends
    where k_pos <= q_pos (and within ``window`` if given).
    """
    B, Sq, Kv, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if Sq <= q_block and Sk <= k_block:
        mask = attention_scores_mask(q_pos, k_pos, window) & (
            k_pos >= 0)[:, None, :]
        return sdpa(q, k, v, mask, scale=scale)

    qb = min(q_block, Sq)
    kb = min(k_block, Sk)
    pad_q = (-Sq) % qb
    pad_k = (-Sk) % kb
    F = torch.nn.functional
    q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    q_pos_p = F.pad(q_pos, (0, pad_q), value=0)
    k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    k_pos_p = F.pad(k_pos, (0, pad_k), value=-1)
    nq, nk = (Sq + pad_q) // qb, (Sk + pad_k) // kb
    wide = torch.promote_types(q.dtype, torch.float32)

    def q_block(qi, qpi, k, v):
        """One Q block's online softmax over every KV block."""
        m = torch.full((B, Kv, G, qb), _NEG, dtype=wide, device=q.device)
        l = torch.zeros((B, Kv, G, qb), dtype=wide, device=q.device)
        acc = torch.zeros((B, Kv, G, qb, Dv), dtype=wide, device=q.device)
        for j in range(nk):
            ki = k[:, j * kb:(j + 1) * kb]                # (B,kb,Kv,D)
            vi = v[:, j * kb:(j + 1) * kb]
            kpi = k_pos_p[:, j * kb:(j + 1) * kb]
            s = _wide(einsum("bqhgd,bkhd->bhgqk", qi, ki)) * scale
            msk = ((qpi[:, :, None] >= kpi[:, None, :])
                   & (kpi >= 0)[:, None, :])
            if window is not None:
                msk &= (qpi[:, :, None] - kpi[:, None, :]) < window
            s = s.masked_fill(~msk[:, None, None, :, :], _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + einsum(
                "bhgqk,bkhd->bhgqd", p.to(vi.dtype), vi).to(wide)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,Kv,G,qb,Dv)
        return out.permute(0, 3, 1, 2, 4)                 # (B,qb,Kv,G,Dv)

    # under autograd each Q block is recomputed in the backward pass, so
    # a layer keeps its Q, K and V, not every (q_block, k_block) score
    # tile: the same values, in the memory a blocked attention is for
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        from torch.utils.checkpoint import checkpoint
        run = functools.partial(checkpoint, q_block, use_reentrant=False)
    else:
        run = q_block
    outs = [run(q[:, i * qb:(i + 1) * qb], q_pos_p[:, i * qb:(i + 1) * qb],
                k, v) for i in range(nq)]
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


# ------------------------------------------------------------------ mlp -- //


def mlp_init(gen, dims, dtype, bias: bool = True, device=None) -> LayerList:
    """dims [d0, d1, ..., dn] — n linear layers, each ``Params(w[, b])``
    (the reference's list of {"w", "b"} dicts)."""
    layers = LayerList()
    for di, do in zip(dims[:-1], dims[1:]):
        p = Params(w=fan_in_init(gen, (di, do), dtype, device))
        if bias:
            p["b"] = zeros_init(gen, (do,), dtype, device)
        layers.append(p)
    return layers


def mlp_apply(layers, x: torch.Tensor, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len(layers)
    for i, p in enumerate(layers):
        x = x @ p["w"]
        if hasattr(p, "b"):
            x = x + p["b"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def swiglu_init(gen, d_model: int, d_ff: int, dtype, device=None
                ) -> Params:
    return Params(
        w_gate=fan_in_init(gen, (d_model, d_ff), dtype, device),  # d,df->f
        w_up=fan_in_init(gen, (d_model, d_ff), dtype, device),
        w_down=fan_in_init(gen, (d_ff, d_model), dtype, device))


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    g = torch.nn.functional.silu(matmul(x, p["w_gate"]))
    return matmul(g * matmul(x, p["w_up"]), p["w_down"])


# ------------------------------------------------ weighted cross entropy -- //


def weighted_xent(logits: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """logits (..., V) any float dtype, labels (...,) int, weights (...,) —
    the mean over weighted tokens, in fp32 (``_wide``). A weight of 0
    drops a record (the dedup pipeline's "drop" mode); the denominator is
    max(sum w, 1), so all-zero weights give a loss of 0. On logits whose
    vocab is split (a placed step) both reductions stay on each rank's
    slice: ``logsumexp`` as ``train.steps``' handler places it, the gold
    logit through ``gather``."""
    logits = _wide(logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    w = _wide(weights)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
