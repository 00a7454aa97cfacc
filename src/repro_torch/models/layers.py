"""Shared neural-net layers of the port — the counterpart of
``repro.models.layers`` (the parts the dense LM serving path runs).

Conventions, as in the reference:
  * init fns take an explicit ``torch.Generator`` and return a tensor on
    its device; on the ``meta`` device (``gen=None``) they allocate nothing,
    which is how ``TransformerConfig.param_count`` counts a 236B tree;
  * compute dtype is the caller's (bf16 by default), reductions and
    softmax in fp32;
  * every matmul is an einsum in the reference's own layout and axis
    names, so the converter (``repro_torch.convert``) moves weights across
    with no transposes.

The reference computes attention and every matmul as jnp einsums outside
any Pallas kernel; the port computes them with ``torch.einsum`` in the
reference's blocked form (``flash_sdpa``), not through a library
attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

_NEG = torch.finfo(torch.float32).min


class Params(nn.Module):
    """One node of the reference's param tree as a module: tensors become
    frozen parameters and nodes submodules under the reference's leaf
    names, and ``p["wq"]`` reads as it does in the reference
    (``state_dict`` keys such as ``layers.0.attn.wq``)."""

    def __init__(self, **children):
        super().__init__()
        for name, value in children.items():
            self[name] = value

    def __setitem__(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=False))
        elif isinstance(value, nn.Module):
            self.add_module(name, value)
        else:
            raise TypeError(f"{name}: a tensor or a module, not "
                            f"{type(value).__name__}")

    def __getitem__(self, name: str):
        return getattr(self, name)


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


# ----------------------------------------------------------------- norm -- //


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ----------------------------------------------------------------- rope -- //


def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    # the base stays a Python scalar: a tensor made from it on the card
    # would be a host-to-device copy, a host wait in every layer
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x (..., S, H, D) with positions (..., S) — rotates pairs (even, odd),
    interleaved as the reference does (not the half-split form)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (D/2,)
    angles = positions[..., None].float() * freqs         # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------ attention -- //


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
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int] = None, scale: Optional[float] = None,
               q_block: int = 1024, k_block: int = 1024) -> torch.Tensor:
    """Block-chunked attention: online softmax over KV blocks, a loop over
    Q blocks (the reference's two ``lax.scan``s). Never materializes more
    than a (B, Kv, G, q_block, k_block) tile.

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

    outs = []
    for i in range(nq):
        qi = q[:, i * qb:(i + 1) * qb]                    # (B,qb,Kv,G,D)
        qpi = q_pos_p[:, i * qb:(i + 1) * qb]             # (B,qb)
        m = torch.full((B, Kv, G, qb), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Kv, G, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Kv, G, qb, Dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            ki = k[:, j * kb:(j + 1) * kb]                # (B,kb,Kv,D)
            vi = v[:, j * kb:(j + 1) * kb]
            kpi = k_pos_p[:, j * kb:(j + 1) * kb]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki).float() * scale
            msk = ((qpi[:, :, None] >= kpi[:, None, :])
                   & (kpi >= 0)[:, None, :])
            if window is not None:
                msk &= (qpi[:, :, None] - kpi[:, None, :]) < window
            s = s.masked_fill(~msk[:, None, None, :, :], _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vi.dtype), vi).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,Kv,G,qb,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4))           # (B,qb,Kv,G,Dv)
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


# ------------------------------------------------------------------ mlp -- //


def swiglu_init(gen, d_model: int, d_ff: int, dtype, device=None
                ) -> Params:
    return Params(
        w_gate=fan_in_init(gen, (d_model, d_ff), dtype, device),  # d,df->f
        w_up=fan_in_init(gen, (d_model, d_ff), dtype, device),
        w_down=fan_in_init(gen, (d_ff, d_model), dtype, device))


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    g = torch.nn.functional.silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]
