"""RecSys ranking models of the port — the counterpart of
``repro.models.recsys``: wide-deep, xDeepFM, DLRM-RM2, DCN-v2.

The hot path is the sparse embedding lookup over 10^6+-row tables, built
as in the reference from a row gather and a mean over each multi-hot bag
(no library EmbeddingBag), with two hooks that tie into the paper's
technique:

  * ``unique_gather`` (``repro_torch.dedup.pipeline``, on the device with
    no host wait): dedups repeated ids inside a batch before the gather;
  * the ``DedupPipeline`` itself filters fraudulent duplicate click
    records ahead of training — the paper's §1 motivating application —
    and its weights are ``loss_fn``'s.

All four models share the embedding substrate and differ in interaction:
concat (wide&deep), CIN (xDeepFM), pairwise-dot (DLRM), cross-net (DCN-v2).

The params are the reference's tree as ``Params`` modules: ``tables``
({``table_<i>``}), an MLP a ``LayerList`` of {``w``, ``b``}, xDeepFM's
``cin`` a ``ParameterList``, DCN-v2's ``cross`` a ``LayerList``. A gather
reads an out-of-range id as a jnp gather does (``gnn.gather_rows``: from
the end where negative, then clamped), on the device with no host check.
The wide tower's uint32 crosses are computed in int64 (torch's uint32 has
no ``>>``, ``%`` or ``<``); only their low 20 bits are kept, which int64's
wrap-around leaves exact. ``retrieval_scores``' top-k orders ties by the
lower index first, as ``jax.lax.top_k`` does, on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from ..dedup.pipeline import unique_gather
from .gnn import gather_rows
from .layers import (LayerList, Params, _wide, as_torch_dtype, einsum,
                     fan_in_init, mlp_apply, mlp_init, normal_init,
                     zeros_init)

WIDE_ROWS = 1 << 20            # the wide tower's shared hashed table
_GOLDEN = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    """Field for field the reference's config (``dtype`` a torch dtype;
    any dtype numpy names is taken)."""
    name: str
    interaction: str                   # concat | cin | dot | cross
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_sizes: tuple                 # per-field table rows
    mlp_dims: tuple                    # the deep tower
    bot_mlp_dims: tuple = ()           # DLRM bottom MLP over dense feats
    cin_dims: tuple = ()               # xDeepFM CIN layer widths
    n_cross_layers: int = 0            # DCN-v2
    multi_hot: int = 1                 # ids per field (bag size)
    dtype: Any = torch.float32
    dedup_gather: bool = False         # unique_gather ahead of table lookups

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))

    @property
    def d_sparse(self) -> int:
        return self.n_sparse * self.embed_dim


def default_vocab_sizes(n_sparse: int, base: int = 1_000_000) -> tuple:
    """Heterogeneous table sizes à la Criteo: a few huge, many small."""
    sizes = []
    for i in range(n_sparse):
        if i % 7 == 0:
            sizes.append(base * 10)
        elif i % 3 == 0:
            sizes.append(base)
        else:
            sizes.append(max(1000, base // 100))
    return tuple(sizes)


# ---------------------------------------------------------- embedding ---- //

def embedding_init(gen, cfg: RecSysConfig, device=None) -> Params:
    return Params(**{f"table_{i}": normal_init(
        gen, (v, cfg.embed_dim), cfg.dtype, stddev=1.0 / cfg.embed_dim ** 0.5,
        device=device) for i, v in enumerate(cfg.vocab_sizes)})


def embedding_bag(tables, ids: torch.Tensor, cfg: RecSysConfig
                  ) -> torch.Tensor:
    """ids (B, F) or (B, F, nnz) int -> (B, F, D).

    Multi-hot bags mean-reduce; the gather per field is take -> (optional)
    mean. With cfg.dedup_gather, duplicate ids in the batch collapse to
    one row fetch."""
    if ids.ndim == 2:
        ids = ids[..., None]
    B, F, nnz = ids.shape
    out = []
    for f in range(F):
        table = tables[f"table_{f}"]
        flat = ids[:, f, :].reshape(-1)
        if cfg.dedup_gather:
            uniq, inv = unique_gather(flat)
            rows = gather_rows(table, uniq)[inv.long()]
        else:
            rows = gather_rows(table, flat)
        out.append(rows.reshape(B, nnz, cfg.embed_dim).mean(1))
    return torch.stack(out, 1)                            # (B, F, D)


# ---------------------------------------------------------- interactions -- //

def _cin_init(gen, cfg: RecSysConfig, device) -> nn.ParameterList:
    """xDeepFM Compressed Interaction Network filters."""
    dims = [cfg.n_sparse] + list(cfg.cin_dims)
    return nn.ParameterList(
        fan_in_init(gen, (dims[i + 1], dims[i], cfg.n_sparse), cfg.dtype,
                    device) for i in range(len(cfg.cin_dims)))


def _cin_apply(ws, x0: torch.Tensor) -> torch.Tensor:
    """x0 (B, F, D) -> (B, sum(H_l)) sum-pooled feature maps.
    X^l_h = sum_{i,j} W^l_{h,i,j} (X^{l-1}_i ∘ X^0_j)  (xDeepFM Eq. 6)."""
    xl = x0
    pooled = []
    for w in ws:
        z = einsum("bhd,bfd->bhfd", xl, x0)         # outer product
        xl = einsum("bhfd,ohf->bod", z, w)
        pooled.append(xl.sum(-1))                         # sum over D
    return torch.cat(pooled, -1)


def _cross_init(gen, d: int, n_layers: int, dtype, device) -> LayerList:
    """DCN-v2 full-rank cross layers."""
    return LayerList(Params(w=fan_in_init(gen, (d, d), dtype, device),
                            b=zeros_init(gen, (d,), dtype, device))
                     for _ in range(n_layers))


def _cross_apply(layers, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for p in layers:
        x = x0 * (x @ p["w"] + p["b"]) + x               # x0 ⊙ (Wx+b) + x
    return x


def _dot_interaction(emb: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """DLRM: pairwise dots of the F+1 feature vectors, lower triangle in
    row-major order (``jnp.tril_indices(n, k=-1)``'s)."""
    z = torch.cat([bot[:, None, :], emb], 1)             # (B, F+1, D)
    dots = einsum("bid,bjd->bij", z, z)
    n = z.shape[1]
    ii, jj = torch.tril_indices(n, n, offset=-1, device=z.device)
    return dots[:, ii, jj]                                # (B, n(n-1)/2)


def wide_crosses(ids: torch.Tensor) -> torch.Tensor:
    """The wide tower's hashed crosses of adjacent field ids, (B, F-1)
    int64 in [0, 2^20): the reference's ``(a * 0x9E3779B9) ^ b`` in uint32,
    masked to 20 bits."""
    a = ids[:, :-1].long() & 0xFFFFFFFF
    b = ids[:, 1:].long() & 0xFFFFFFFF
    return ((a * _GOLDEN) ^ b) & (WIDE_ROWS - 1)


# ---------------------------------------------------------- the models --- //

def _build(cfg: RecSysConfig, gen, device) -> Params:
    params = Params(tables=embedding_init(gen, cfg, device))
    d_emb = cfg.d_sparse
    if cfg.interaction == "concat":                      # wide & deep
        params["deep"] = mlp_init(gen, [d_emb + cfg.n_dense, *cfg.mlp_dims,
                                        1], cfg.dtype, device=device)
        # wide tower: hashed cross features, one shared 2^20-row table
        params["wide"] = normal_init(gen, (WIDE_ROWS, 1), cfg.dtype,
                                     stddev=1e-3, device=device)
    elif cfg.interaction == "cin":                       # xDeepFM
        params["cin"] = _cin_init(gen, cfg, device)
        params["deep"] = mlp_init(gen, [d_emb + cfg.n_dense, *cfg.mlp_dims,
                                        1], cfg.dtype, device=device)
        params["linear"] = fan_in_init(gen, (sum(cfg.cin_dims), 1),
                                       cfg.dtype, device)
    elif cfg.interaction == "dot":                       # DLRM
        params["bot"] = mlp_init(gen, [cfg.n_dense, *cfg.bot_mlp_dims],
                                 cfg.dtype, device=device)
        n_f = cfg.n_sparse + 1
        d_int = n_f * (n_f - 1) // 2 + cfg.bot_mlp_dims[-1]
        params["top"] = mlp_init(gen, [d_int, *cfg.mlp_dims], cfg.dtype,
                                 device=device)
    elif cfg.interaction == "cross":                     # DCN-v2
        d0 = d_emb + cfg.n_dense
        params["cross"] = _cross_init(gen, d0, cfg.n_cross_layers,
                                      cfg.dtype, device)
        params["deep"] = mlp_init(gen, [d0, *cfg.mlp_dims], cfg.dtype,
                                  device=device)
        params["head"] = fan_in_init(gen, (d0 + cfg.mlp_dims[-1], 1),
                                     cfg.dtype, device)
    else:
        raise ValueError(cfg.interaction)
    return params


def init(cfg: RecSysConfig, seed: int = 0, device=None) -> Params:
    """Seeded params on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), drawn in a fixed order from one
    ``torch.Generator``: the reference's distributions, not its numbers
    (``repro_torch.convert.recsys_params_from_numpy`` carries a reference
    tree across)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return _build(cfg, gen, device)


def forward(cfg: RecSysConfig, params, batch: dict) -> torch.Tensor:
    """batch: dense (B, n_dense) float, sparse_ids (B, F[, nnz]) int,
    tensors on the params' device -> logits (B,)."""
    dense = batch["dense"].to(cfg.dtype)
    emb = embedding_bag(params["tables"], batch["sparse_ids"], cfg)
    B = dense.shape[0]
    flat = emb.reshape(B, -1)

    if cfg.interaction == "concat":
        deep = mlp_apply(params["deep"], torch.cat([flat, dense], -1))
        # wide: hash pairs of adjacent field ids into the shared table
        ids = batch["sparse_ids"]
        if ids.ndim == 3:
            ids = ids[..., 0]
        wide = gather_rows(params["wide"], wide_crosses(ids))[..., 0].sum(
            -1, keepdim=True)
        return (deep + wide)[:, 0]
    if cfg.interaction == "cin":
        cin = _cin_apply(params["cin"], emb)
        deep = mlp_apply(params["deep"], torch.cat([flat, dense], -1))
        return (cin @ params["linear"] + deep)[:, 0]
    if cfg.interaction == "dot":
        bot = mlp_apply(params["bot"], dense, final_act=True)
        inter = _dot_interaction(emb, bot)
        top_in = torch.cat([inter, bot], -1)
        return mlp_apply(params["top"], top_in)[:, 0]
    if cfg.interaction == "cross":
        x0 = torch.cat([flat, dense], -1)
        xc = _cross_apply(params["cross"], x0)
        xd = mlp_apply(params["deep"], x0, final_act=True)
        return (torch.cat([xc, xd], -1) @ params["head"])[:, 0]
    raise ValueError(cfg.interaction)


def loss_fn(cfg: RecSysConfig, params, batch: dict, weights=None
            ) -> torch.Tensor:
    """Weighted BCE in fp32 (``_wide``) — weights come from the
    click-fraud dedup stage; the denominator is max(sum w, 1)."""
    logits = _wide(forward(cfg, params, batch))
    y = batch["labels"].to(logits.dtype)
    w = (torch.ones_like(y) if weights is None
         else weights.to(logits.dtype))
    nll = (torch.clamp(logits, min=0) - logits * y
           + torch.log1p(torch.exp(-logits.abs())))
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def top_k(scores: torch.Tensor, k: int):
    """-> (values, indices (k,) int64) of the ``k`` largest of a 1-D
    ``scores``, in descending order and, among equal scores, ascending
    index — ``jax.lax.top_k``'s order, which ``torch.topk`` does not
    promise for ties. One ``topk`` of an int64 key: the fp32 score's
    order-preserving bits above the complement of the index
    (``Dedup.top_cells``' form)."""
    bits = scores.float().view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(scores.shape[0], device=scores.device)
    key = ordered * (1 << 32) + ((1 << 32) - 1 - pos)
    best = torch.topk(key, k).values
    idx = (1 << 32) - 1 - (best & 0xFFFFFFFF)
    return scores[idx], idx


def retrieval_scores(cfg: RecSysConfig, params, batch: dict):
    """retrieval_cand shape: one query against N candidates.

    Query tower: the model's own embeddings + dense tower compressed to
    D; candidates arrive as a precomputed (N, D) matrix. Batched dot +
    top-k — never a loop. -> (scores (N,), top scores (k,), top indices
    (k,)), k = min(100, N)."""
    dense = batch["dense"].to(cfg.dtype)                  # (1, n_dense)
    emb = embedding_bag(params["tables"], batch["sparse_ids"], cfg)
    q = emb.mean(1) + 0.0 * dense.sum(-1, keepdim=True)   # (1, D)
    cands = batch["candidates"].to(cfg.dtype)             # (N, D)
    scores = (cands @ q[0]).float()                       # (N,)
    k = min(100, cands.shape[0])
    top_scores, top_idx = top_k(scores, k)
    return scores, top_scores, top_idx
