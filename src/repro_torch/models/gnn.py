"""MeshGraphNet (Pfaff et al., arXiv:2010.03409) of the port — the
counterpart of ``repro.models.gnn``: an encode-process-decode GNN over an
edge index, built from a gather (``index_select``) and a scatter-sum
(``index_add``) — gather source/target node states, edge-MLP, scatter-sum
aggregate, node-MLP, residuals.

Graphs are fixed-shape padded: ``edge_mask`` zeroes contributions of
padding edges, ``node_mask`` zeroes loss on padding nodes.

The params are the reference's tree as ``Params`` modules: ``enc_node``,
``enc_edge`` and ``dec`` each {``ws``, ``bs`` (``ParameterList``s),
``ln_scale``, ``ln_bias``}; the reference's ``blocks``, vmapped into
stacked leaves and scanned, are a ``ModuleList`` of {``edge``, ``node``}
walked by a Python loop, one block per layer; ``remat == "full"``
checkpoints each block (``torch.utils.checkpoint``), the reference's
``jax.checkpoint`` of the scan body.

Indices follow the reference's semantics, on the device with no host
check: a gather clamps (``v[src]`` reads row N - 1 for src >= N, and a
negative index counts from the end, then clamps at 0), and the
scatter-sum drops a message whose ``dst`` lies outside [0, N)
(``jax.ops.segment_sum``). On CUDA the scatter-sum adds with atomics, so
its sums are not the CPU's bit for bit.

Config (assigned): n_layers=15, d_hidden=128, aggregator=sum,
mlp_layers=2.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from .layers import (Params, _wide, as_torch_dtype, fan_in_init, layernorm,
                     ones_init, zeros_init)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """Field for field the reference's config (``dtype`` a torch dtype;
    any dtype numpy names is taken)."""
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2          # hidden layers inside each MLP
    aggregator: str = "sum"
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3
    dtype: Any = torch.float32
    remat: str = "none"

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0 as a jnp gather reads it: a negative index
    counts from the end, and any index still outside [0, n) clamps."""
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *x.shape[1:])


def _mlp_ln_init(gen, d_in, d_hidden, d_out, n_hidden, dtype, device
                 ) -> Params:
    dims = [d_in] + [d_hidden] * n_hidden + [d_out]
    return Params(
        ws=nn.ParameterList(fan_in_init(gen, (dims[i], dims[i + 1]), dtype,
                                        device)
                            for i in range(len(dims) - 1)),
        bs=nn.ParameterList(zeros_init(gen, (dims[i + 1],), dtype, device)
                            for i in range(len(dims) - 1)),
        ln_scale=ones_init(gen, (d_out,), torch.float32, device),
        ln_bias=zeros_init(gen, (d_out,), torch.float32, device))


def _mlp_ln_apply(p, x: torch.Tensor) -> torch.Tensor:
    n = len(p["ws"])
    for i in range(n):
        x = x @ p["ws"][i] + p["bs"][i]
        if i < n - 1:
            x = torch.relu(x)
    return layernorm(x, p["ln_scale"], p["ln_bias"])


def _build(cfg: GNNConfig, gen, device) -> Params:
    d = cfg.d_hidden
    enc_node = _mlp_ln_init(gen, cfg.d_node_in, d, d, cfg.mlp_layers,
                            cfg.dtype, device)
    enc_edge = _mlp_ln_init(gen, cfg.d_edge_in, d, d, cfg.mlp_layers,
                            cfg.dtype, device)
    blocks = nn.ModuleList(
        Params(
            # edge MLP sees [e, v_src, v_dst]
            edge=_mlp_ln_init(gen, 3 * d, d, d, cfg.mlp_layers, cfg.dtype,
                              device),
            # node MLP sees [v, agg_e]
            node=_mlp_ln_init(gen, 2 * d, d, d, cfg.mlp_layers, cfg.dtype,
                              device))
        for _ in range(cfg.n_layers))
    # the decoder's LN keeps the reference's ones and zeros: it still
    # normalises over d_out, as the reference's does
    dec = _mlp_ln_init(gen, d, d, cfg.d_out, cfg.mlp_layers, cfg.dtype,
                       device)
    return Params(enc_node=enc_node, enc_edge=enc_edge, blocks=blocks,
                  dec=dec)


def init(cfg: GNNConfig, seed: int = 0, device=None) -> Params:
    """Seeded params on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), drawn in a fixed order from one
    ``torch.Generator``. The draws are the reference's distributions, not
    its numbers: to hold the two against each other, convert one side's
    tree (``repro_torch.convert.gnn_params_from_numpy``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return _build(cfg, gen, device)


def _process_block(p, v, e, src, dst_g, dst_s, edge_w, seg_w):
    """One message-passing layer: edge update -> scatter-sum -> node
    update, both residual (MeshGraphNet §A.1). ``dst_g`` is the gather's
    index, ``dst_s`` the scatter's (a dropped message's weight in
    ``seg_w`` is 0)."""
    vs = gather_rows(v, src)                              # (E, d)
    vd = gather_rows(v, dst_g)
    e_new = _mlp_ln_apply(p["edge"], torch.cat([e, vs, vd], -1))
    e = e + e_new * edge_w
    agg = torch.zeros_like(v).index_add(0, dst_s, e * seg_w)
    v_new = _mlp_ln_apply(p["node"], torch.cat([v, agg], -1))
    return v + v_new, e


def forward(cfg: GNNConfig, params, batch: dict) -> torch.Tensor:
    """batch: nodes (N, d_node_in), edges (E, d_edge_in), src/dst (E,)
    int, edge_mask (E,) bool, node_mask (N,) bool, tensors on the params'
    device -> per-node predictions (N, d_out)."""
    n_nodes = batch["nodes"].shape[0]
    v = _mlp_ln_apply(params["enc_node"], batch["nodes"].to(cfg.dtype))
    e = _mlp_ln_apply(params["enc_edge"], batch["edges"].to(cfg.dtype))
    src, dst, em = batch["src"], batch["dst"], batch["edge_mask"]
    edge_w = em[:, None].to(e.dtype)
    keep = (dst >= 0) & (dst < n_nodes)          # segment_sum drops the rest
    seg_w = (em & keep)[:, None].to(e.dtype)
    dst_s = torch.where(keep, dst, 0).long()
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    if remat:
        from torch.utils.checkpoint import checkpoint
    for bp in params["blocks"]:
        args = (bp, v, e, src, dst, dst_s, edge_w, seg_w)
        v, e = (checkpoint(_process_block, *args, use_reentrant=False)
                if remat else _process_block(*args))
    return _mlp_ln_apply(params["dec"], v)


def loss_fn(cfg: GNNConfig, params, batch: dict, weights=None
            ) -> torch.Tensor:
    """Masked MSE to per-node targets (N, d_out), in fp32 (``_wide``).
    ``weights`` (N,) lets the dedup pipeline drop duplicate streamed mesh
    updates."""
    pred = _wide(forward(cfg, params, batch))
    tgt = batch["targets"].to(pred.dtype)
    w = batch["node_mask"].to(pred.dtype)
    if weights is not None:
        w = w * weights.to(pred.dtype)
    err = ((pred - tgt) ** 2).sum(-1)
    return (err * w).sum() / torch.clamp(w.sum(), min=1.0)
