"""The decoder-only transformer of the port — the counterpart of
``repro.models.transformer`` for the five LM archs: dense (codeqwen1.5,
qwen3, danube3) and MoE (mixtral, deepseek-v2) stacks; GQA or MLA
attention; full or sliding-window masks; qk-norm; RoPE; the
flash-chunked prefill, the KV cache and its SWA ring.

Entry points, as in the reference:
  init(cfg, seed, device)                     -> params (a ``Params`` module)
  forward(cfg, params, tokens, weights)       -> (loss, logits)     [train]
  prefill(cfg, params, tokens)                -> logits (B, S, V)   [serve]
  decode_step(cfg, params, cache, token, pos) -> (logits, cache)    [serve]

The params are one ``nn.Module`` per block under the reference's leaf
names (``embed``, ``layers.<i>.attn.wq``, ``layers.<i>.moe.w_gate``,
``dense_layers.<i>.ffn.w_up``, ``final_norm``, ``lm_head``), each weight
in the reference's einsum layout (``wq`` is (d, H, hd), ``wo`` (H, hd,
d), an expert stack (E, d, f)), so ``repro_torch.convert`` moves a JAX
param tree across with no transposes. The reference's stacked
``params["layers"]`` under ``lax.scan`` is a ``ModuleList`` walked by a
Python loop; its Python list ``params["dense_layers"]`` (deepseek's dense
first layer) a ``LayerList``, whose layers stay apart in its tree.
``forward`` is differentiable through autograd; ``cfg.remat`` maps the
reference's ``jax.checkpoint`` of the scanned layers onto
``torch.utils.checkpoint`` (``"full"``: recompute the whole layer;
``"dots"``: a selective policy that keeps the matmuls with no batch
dimension, ``dots_with_no_batch_dims_saveable``). Serving runs under
``torch.inference_mode()``, so it records no graph and never remats.
``decode_step`` writes the cache in place (the reference's
``.at[b, slot].set`` on a donated buffer) and returns the same dict.

KV caches: GQA keeps (k, v) per layer; SWA a ring of ``window`` slots;
MLA the compressed latent (``ckv``, ``kpe``). With ``cfg.mla_absorb``
decode folds the queries into latent space and never re-materializes
per-head K/V; without it decode expands the latent (the naive form).
An MoE layer routes the tokens of one call together, so a token's
experts can depend on its batch mates through the capacity
(``models.moe``), as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
from torch import nn

from ..core.device import resolve_device
from .layers import (_NEG, LayerList, Params, _wide, apply_rope,
                     as_torch_dtype, attention_scores_mask, einsum,
                     embedding, fan_in_init, flash_sdpa, matmul, normal_init, rmsnorm,
                     sdpa, swiglu_apply, swiglu_init, weighted_xent)
from .moe import MoEConfig, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Field for field the reference's config (``dtype`` a torch dtype; any
    dtype numpy names is taken), so ``TransformerConfig(**asdict(ref))``
    crosses whole."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    attention: str = "full"                # full | swa
    window: int = 4096
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mla_absorb: bool = False
    # --- MoE ---
    n_experts: int = 0                     # 0 -> dense FFN
    moe_top_k: int = 2
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_dispatch: str = "einsum"
    moe_group_size: int = 8192
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    # --- numerics / execution ---
    dtype: Any = torch.bfloat16
    remat: str = "none"                    # none | full | dots (training)
    attn_q_block: int = 1024               # flash-chunked attention tiles
    attn_k_block: int = 1024
    gqa_expand_kv: bool = False            # expand K/V to H heads pre-attn

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sliding_window(self) -> Optional[int]:
        return self.window if self.attention == "swa" else None

    @property
    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            n_experts=self.n_experts, top_k=self.moe_top_k,
            d_model=self.d_model, d_ff_expert=self.d_ff_expert or self.d_ff,
            n_shared=self.n_shared_experts,
            d_ff_shared=self.n_shared_experts * (self.d_ff_expert
                                                 or self.d_ff),
            capacity_factor=self.capacity_factor, dispatch=self.moe_dispatch,
            group_size=self.moe_group_size)

    def param_count(self) -> int:
        """Total parameter count, from the param tree built on the ``meta``
        device (no allocation)."""
        params = _build(self, None, torch.device("meta"))
        return sum(p.numel() for p in params.parameters())

    def active_param_count(self) -> int:
        """MoE: params touched per token (routed top-k + shared + non-FFN)."""
        if not self.is_moe:
            return self.param_count()
        per_expert = 3 * self.d_model * (self.d_ff_expert or self.d_ff)
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = n_moe_layers * (self.n_experts - self.moe_top_k) \
            * per_expert
        return self.param_count() - inactive


# ------------------------------------------------------------- attention -- //

def _attn_init(cfg: TransformerConfig, gen, device) -> Params:
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = Params(norm=torch.ones((d,), dtype=torch.float32, device=device))
    if cfg.use_mla:
        c, r, nope, vd = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                          cfg.v_head_dim)
        if cfg.q_lora_rank:
            p["wq_a"] = fan_in_init(gen, (d, cfg.q_lora_rank), cfg.dtype,
                                    device)
            p["q_norm"] = torch.ones((cfg.q_lora_rank,), dtype=torch.float32,
                                     device=device)
            p["wq_b"] = fan_in_init(gen, (cfg.q_lora_rank, H, nope + r),
                                    cfg.dtype, device)
        else:
            p["wq"] = fan_in_init(gen, (d, H, nope + r), cfg.dtype, device)
        p["wkv_a"] = fan_in_init(gen, (d, c + r), cfg.dtype, device)
        p["kv_norm"] = torch.ones((c,), dtype=torch.float32, device=device)
        p["wkv_b"] = fan_in_init(gen, (c, H, nope + vd), cfg.dtype, device)
        p["wo"] = fan_in_init(gen, (H, vd, d), cfg.dtype, device)
        return p
    for name, shape in (("wq", (d, H, hd)), ("wk", (d, Kv, hd)),
                        ("wv", (d, Kv, hd)), ("wo", (H, hd, d))):
        p[name] = fan_in_init(gen, shape, cfg.dtype, device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def _gqa_qkv(p, cfg: TransformerConfig, x, positions, f: int = 1):
    """-> q (B,S,Kv·f,G/f,hd), k (B,S,Kv,hd), v (B,S,Kv,hd): the query
    heads grouped by KV head, each group cut into ``f`` (``_gqa_factor``;
    1 but under a mesh)."""
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = einsum("bsd,dhe->bshe", x, p["wq"])         # (B,S,H,hd)
    k = einsum("bsd,dke->bske", x, p["wk"])
    v = einsum("bsd,dke->bske", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    return q.reshape(B, S, Kv * f, H // Kv // f, hd), k, v


def _gqa_factor(cfg: TransformerConfig, wq) -> int:
    """How many parts each KV head's query group is cut into for the
    attention under a mesh: on a DTensor ``wq`` whose heads are split m
    ways ("model") where m divides the query heads but not the KV heads,
    the least f that divides the group G = H / Kv and makes Kv·f a
    multiple of m; then q is viewed as Kv·f groups of G/f heads, which
    keeps the heads' split, and K and V are expanded f times
    (``_repeat_kv``), so that each rank computes the scores of its own
    query heads only (the reference's partitioner tiles one mesh axis
    over the KV heads and the group, which DTensor cannot). 1 on a plain
    tensor, where the KV heads divide the split, where a split of them is
    strided, or where no such f exists (the step then runs as before:
    q's view gathers its heads)."""
    from torch.distributed.tensor import Shard
    from ..train.steps import split_mesh_dims
    split = split_mesh_dims(wq, 1)
    if not split or any(type(wq.placements[j]) is not Shard for j in split):
        return 1
    return gqa_factor(cfg.n_heads, cfg.n_kv_heads,
                      math.prod(wq.device_mesh.size(j) for j in split))


def gqa_factor(n_heads: int, n_kv_heads: int, m: int) -> int:
    """The least f with G = n_heads / n_kv_heads divisible by f and
    n_kv_heads · f by m, where m divides the query heads and not the KV
    heads; 1 otherwise (``_gqa_factor``)."""
    G = n_heads // n_kv_heads
    if m == 1 or n_kv_heads % m == 0 or n_heads % m:
        return 1
    return next((f for f in range(2, G + 1)
                 if G % f == 0 and n_kv_heads * f % m == 0), 1)


def _repeat_kv(t, f: int, like):
    """K or V (B,S,Kv,hd) on a mesh as (B,S,Kv·f,hd), each KV head
    repeated f times in place (head j of the result is head j // f),
    split over the mesh dimensions that split ``like``'s (q's) heads
    plainly (a strided split of them is left to the attention's einsum):
    its head_dim and heads are first gathered (once a layer), and each
    rank then looks up its own heads (``index_select`` by an index split
    as q's heads are, the port's own placement)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..train.steps import split_mesh_dims
    mesh, nd = t.device_mesh, t.ndim
    whole = [Replicate() if isinstance(pl, Shard) and pl.dim % nd >= 2
             else pl for pl in t.placements]
    t = t.redistribute(mesh, whole)
    n = t.shape[2] * f
    split = [j for j in split_mesh_dims(like, 2)
             if type(like.placements[j]) is Shard]
    idx = torch.arange(n, device=t.device) // f
    parts = math.prod(mesh.size(j) for j in split)
    rank = 0
    for j in split:
        rank = rank * mesh.size(j) + mesh.get_coordinate()[j]
    local = idx.view(parts, n // parts)[rank]
    idx = DTensor.from_local(
        local, mesh, [Shard(0) if j in split else Replicate()
                      for j in range(mesh.ndim)], run_check=False,
        shape=(n,), stride=(1,))
    return torch.index_select(t, 2, idx)


def _expand_kv(cfg: TransformerConfig, q, k, v):
    """GQA -> MHA view: each KV head replicated across its query group
    (``cfg.gqa_expand_kv``) — a pure layout change."""
    B, S, Kv, G, hd = q.shape
    H = Kv * G
    idx = torch.arange(H, device=q.device) // G
    return q.reshape(B, S, H, 1, hd), k[:, :, idx, :], v[:, :, idx, :]


def _mla_q(p, cfg: TransformerConfig, x, positions):
    """-> q_nope (B,S,H,nope), q_pe (B,S,H,rope)."""
    if cfg.q_lora_rank:
        q = rmsnorm(matmul(x, p["wq_a"]), p["q_norm"])
        q = einsum("bsl,lhe->bshe", q, p["wq_b"])
    else:
        q = einsum("bsd,dhe->bshe", x, p["wq"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_pe = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_pe


def _mla_latent(p, cfg: TransformerConfig, x, positions):
    """-> c_kv (B,S,c) normalized latent, k_pe (B,S,rope) shared-rope
    key."""
    kv = matmul(x, p["wkv_a"])                           # (B,S,c+r)
    c_kv = rmsnorm(kv[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_pe = apply_rope(kv[..., None, cfg.kv_lora_rank:],   # 1 shared "head"
                      positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_pe


def _mla_kv_heads(p, cfg: TransformerConfig, c_kv, k_pe):
    """Per-head K/V materialized from the latent (train, prefill, naive
    decode): k (B,S,H,nope+rope), v (B,S,H,vd)."""
    nope = cfg.qk_nope_dim
    kvb = einsum("bsc,che->bshe", c_kv, p["wkv_b"])  # (B,S,H,nope+vd)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    H = k_nope.shape[2]
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        *k_pe.shape[:2], H, k_pe.shape[-1])], dim=-1)
    return k, v


def _mla_scale(cfg: TransformerConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def _mla_attention(p, cfg: TransformerConfig, x, positions, k_positions,
                   c_kv, k_pe, mask):
    """Full (un-absorbed) MLA attention: the naive decode form."""
    q_nope, q_pe = _mla_q(p, cfg, x, positions)
    q = torch.cat([q_nope, q_pe], dim=-1)                 # (B,Sq,H,nope+r)
    k, v = _mla_kv_heads(p, cfg, c_kv, k_pe)
    B, Sq, H = q.shape[:3]
    ctx = sdpa(q.reshape(B, Sq, H, 1, -1), k, v, mask,
               scale=_mla_scale(cfg))
    ctx = ctx.reshape(B, Sq, H, cfg.v_head_dim)
    return einsum("bqhv,hvd->bqd", ctx, p["wo"])


def _mla_attention_absorbed(p, cfg: TransformerConfig, x, positions, c_kv,
                            k_pe, mask):
    """Absorbed MLA decode: scores and values in latent space, no per-head
    K/V materialized over the cache."""
    q_nope, q_pe = _mla_q(p, cfg, x, positions)
    nope = cfg.qk_nope_dim
    w_k = p["wkv_b"][..., :nope]                          # (c,H,nope)
    w_v = p["wkv_b"][..., nope:]                          # (c,H,vd)
    q_lat = einsum("bqhn,chn->bqhc", q_nope, w_k)
    scores = _wide(einsum("bqhc,bkc->bhqk", q_lat, c_kv)
                   + einsum("bqhr,bkr->bhqk", q_pe, k_pe)
                   ) * _mla_scale(cfg)
    scores = scores.masked_fill(~mask[:, None, :, :], _NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = einsum("bhqk,bkc->bqhc", probs, c_kv)
    ctx = einsum("bqhc,chv->bqhv", ctx_lat, w_v)
    return einsum("bqhv,hvd->bqd", ctx, p["wo"])


def _attn_apply(p, cfg: TransformerConfig, x, positions):
    """Self-attention over the in-context sequence (train, prefill)
    through the flash-chunked path."""
    B, S = x.shape[:2]
    if cfg.use_mla:
        c_kv, k_pe = _mla_latent(p, cfg, x, positions)
        q_nope, q_pe = _mla_q(p, cfg, x, positions)
        q = torch.cat([q_nope, q_pe], dim=-1)             # (B,S,H,nope+r)
        k, v = _mla_kv_heads(p, cfg, c_kv, k_pe)
        ctx = flash_sdpa(q.reshape(B, S, cfg.n_heads, 1, -1), k, v,
                         positions, positions, cfg.sliding_window,
                         _mla_scale(cfg), cfg.attn_q_block, cfg.attn_k_block)
        ctx = ctx.reshape(B, S, cfg.n_heads, cfg.v_head_dim)
        return einsum("bqhv,hvd->bqd", ctx, p["wo"])
    f = _gqa_factor(cfg, p["wq"])
    q, k, v = _gqa_qkv(p, cfg, x, positions, f)
    if f > 1:
        k, v = _repeat_kv(k, f, q), _repeat_kv(v, f, q)
    if cfg.gqa_expand_kv:
        q, k, v = _expand_kv(cfg, q, k, v)
    out = flash_sdpa(q, k, v, positions, positions, cfg.sliding_window,
                     None, cfg.attn_q_block, cfg.attn_k_block)
    out = out.reshape(B, S, cfg.n_heads, cfg.hd)
    return einsum("bshe,hed->bsd", out, p["wo"])


# ------------------------------------------------------------- layer ----- //

def _layer_init(cfg: TransformerConfig, gen, device, moe: bool) -> Params:
    p = Params(attn=_attn_init(cfg, gen, device),
               ffn_norm=torch.ones((cfg.d_model,), dtype=torch.float32,
                                   device=device))
    if moe:
        p["moe"] = moe_init(gen, cfg.moe_cfg, cfg.dtype, device)
    else:
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device)
    return p


def _ffn_apply(p, cfg: TransformerConfig, h, moe: bool):
    if moe:
        return moe_apply(p["moe"], h, cfg.moe_cfg)
    return swiglu_apply(p["ffn"], h)


def _layer_apply(p, cfg: TransformerConfig, x, positions, moe: bool):
    h = rmsnorm(x, p["attn"]["norm"])
    x = x + _attn_apply(p["attn"], cfg, h, positions)
    h = rmsnorm(x, p["ffn_norm"])
    return x + _ffn_apply(p, cfg, h, moe)


# ------------------------------------------------------------- model ----- //

def _build(cfg: TransformerConfig, gen, device) -> Params:
    """``layers`` the n_layers - first_dense_layers scanned layers (MoE
    where the config is), ``dense_layers`` the dense first ones, as in
    the reference's tree."""
    n_scan = cfg.n_layers - cfg.first_dense_layers
    p = Params(
        embed=normal_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype,
                          device=device),
        layers=nn.ModuleList(_layer_init(cfg, gen, device, cfg.is_moe)
                             for _ in range(n_scan)),
        final_norm=torch.ones((cfg.d_model,), dtype=torch.float32,
                              device=device),
        lm_head=fan_in_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype,
                            device))
    if cfg.first_dense_layers:
        p["dense_layers"] = LayerList(
            _layer_init(cfg, gen, device, False)
            for _ in range(cfg.first_dense_layers))
    return p


def init(cfg: TransformerConfig, seed: int = 0, device=None) -> Params:
    """Seeded params on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), drawn in a fixed order from one ``torch.Generator``
    on that device. The draws are the reference's distributions, not its
    numbers: to hold the two against each other, convert one side's tree
    (``repro_torch.convert.transformer_params_from_numpy``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return _build(cfg, gen, device)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the output of a matmul with no batch dimension — a 2-D ``mm``, or an
    einsum's ``bmm`` over a batch of one (the projections and the FFN) —
    and recompute everything else (attention's batched products
    included)."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _embed(params, tokens):
    """The embedding rows of ``tokens`` — ``embed[tokens]`` as an
    embedding lookup (``layers.embedding``), whose backward
    (``embedding_dense_backward``, or each rank's slice of it on a mesh)
    sums each row's gradient as the plain one does."""
    return embedding(params["embed"], tokens)


def _dense_layers(params):
    return getattr(params, "dense_layers", ())


def _stack_apply(cfg: TransformerConfig, params, x, positions):
    """The dense first layers, then the scanned ones; under autograd each
    scanned layer checkpointed as ``cfg.remat`` says (the reference's
    ``jax.checkpoint`` of the scan body; its dense first layers run
    outside the scan, unchecked)."""
    for lp in _dense_layers(params):
        x = _layer_apply(lp, cfg, x, positions, False)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    if remat not in ("full", "dots"):
        for lp in params["layers"]:
            x = _layer_apply(lp, cfg, x, positions, cfg.is_moe)
        return x
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    for lp in params["layers"]:
        x = checkpoint(_layer_apply, lp, cfg, x, positions, cfg.is_moe,
                       use_reentrant=False, **kw)
    return x


def forward(cfg: TransformerConfig, params, tokens, weights=None):
    """Training objective: next-token prediction with per-sequence loss
    weights (the dedup pipeline's output). tokens (B, S+1) int on the
    params' device, weights (B,) or None (ones) -> (loss () fp32, logits
    (B, S, V) in ``cfg.dtype``)."""
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    B, S = inp.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _embed(params, inp)
    x = _stack_apply(cfg, params, x, positions)
    x = rmsnorm(x, params["final_norm"])
    logits = einsum("bsd,dv->bsv", x, params["lm_head"])
    if weights is None:
        weights = torch.ones((B,), dtype=torch.float32,
                             device=tokens.device)
    loss = weighted_xent(logits, labels, weights[:, None].expand(B, S))
    return loss, logits


# ------------------------------------------------------------- serving --- //

def cache_spec(cfg: TransformerConfig, batch: int, max_seq: int) -> dict:
    """{leaf: (shape, dtype)} of the decode cache: per layer (stacked on a
    leading L axis over all n_layers, the dense first ones included) the
    keys and values, or MLA's latent ``ckv`` and shared-rope key ``kpe``,
    and their positions; an SWA config keeps a ring of
    ``min(max_seq, window)`` slots."""
    L = cfg.n_layers
    S = min(max_seq, cfg.window) if cfg.attention == "swa" else max_seq
    if cfg.use_mla:
        return {
            "ckv": ((L, batch, S, cfg.kv_lora_rank), cfg.dtype),
            "kpe": ((L, batch, S, cfg.qk_rope_dim), cfg.dtype),
            "kpos": ((L, batch, S), torch.int32),
        }
    return {
        "k": ((L, batch, S, cfg.n_kv_heads, cfg.hd), cfg.dtype),
        "v": ((L, batch, S, cfg.n_kv_heads, cfg.hd), cfg.dtype),
        "kpos": ((L, batch, S), torch.int32),
    }


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """Zero keys and values, ``kpos`` = -1 (empty slot)."""
    device = resolve_device(device)
    return {name: torch.full(shape, -1 if dtype == torch.int32 else 0,
                             dtype=dtype, device=device)
            for name, (shape, dtype) in cache_spec(cfg, batch,
                                                   max_seq).items()}


def _cache_slot(cfg: TransformerConfig, pos):
    """Ring-buffer slot for SWA; identity otherwise."""
    if cfg.attention == "swa":
        return pos % cfg.window
    return pos


def _layer_decode(cfg: TransformerConfig, p, cache_l: dict, x, pos,
                  moe: bool):
    """One layer of single-token decode; ``cache_l``'s (B, S, ...) leaves
    are views of the stacked cache, written in place."""
    B = x.shape[0]
    positions = pos[:, None]
    h = rmsnorm(x, p["attn"]["norm"])
    slot = _cache_slot(cfg, pos).long()                   # (B,)
    barange = torch.arange(B, device=x.device)
    kpos_l = cache_l["kpos"]
    kpos_l[barange, slot] = pos
    mask = attention_scores_mask(
        positions, kpos_l, cfg.sliding_window) & (kpos_l >= 0)[:, None, :]
    if cfg.use_mla:
        c_kv, k_pe = _mla_latent(p["attn"], cfg, h, positions)
        ckv_l, kpe_l = cache_l["ckv"], cache_l["kpe"]
        ckv_l[barange, slot] = c_kv[:, 0]
        kpe_l[barange, slot] = k_pe[:, 0]
        if cfg.mla_absorb:
            out = _mla_attention_absorbed(p["attn"], cfg, h, positions,
                                          ckv_l, kpe_l, mask)
        else:
            out = _mla_attention(p["attn"], cfg, h, positions, kpos_l,
                                 ckv_l, kpe_l, mask)
    else:
        k_l, v_l = cache_l["k"], cache_l["v"]
        q, k, v = _gqa_qkv(p["attn"], cfg, h, positions)
        k_l[barange, slot] = k[:, 0]
        v_l[barange, slot] = v[:, 0]
        if cfg.gqa_expand_kv:
            q, k_att, v_att = _expand_kv(cfg, q, k_l, v_l)
            out = sdpa(q, k_att, v_att, mask)
        else:
            out = sdpa(q, k_l, v_l, mask)
        out = out.reshape(B, 1, cfg.n_heads, cfg.hd)
        out = einsum("bshe,hed->bsd", out, p["attn"]["wo"])
    x = x + out
    h2 = rmsnorm(x, p["ffn_norm"])
    return x + _ffn_apply(p, cfg, h2, moe)


@torch.inference_mode()
def decode_step(cfg: TransformerConfig, params, cache: dict, token, pos):
    """One-token decode. token (B,) int32, pos (B,) int32 (the current
    position), on the params' device. -> (logits (B, V), cache): the cache
    is written in place and returned. The dense first layers take cache
    layers 0 .. first_dense_layers - 1, the scanned ones the rest."""
    x = _embed(params, token)[:, None, :]                 # (B,1,d)
    layers = [(lp, False) for lp in _dense_layers(params)] + [
        (lp, cfg.is_moe) for lp in params["layers"]]
    for i, (lp, moe) in enumerate(layers):
        x = _layer_decode(cfg, lp, {n: c[i] for n, c in cache.items()},
                          x, pos, moe)
    x = rmsnorm(x, params["final_norm"])
    return einsum("bsd,dv->bsv", x, params["lm_head"])[:, 0], cache


@torch.inference_mode()
def prefill(cfg: TransformerConfig, params, tokens):
    """Full forward returning logits; the cache for follow-on decode is
    written by ``decode_step``, as in the reference.
    tokens (B, S) -> logits (B, S, V)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _embed(params, tokens)
    x = _stack_apply(cfg, params, x, positions)
    x = rmsnorm(x, params["final_norm"])
    return einsum("bsd,dv->bsv", x, params["lm_head"])
