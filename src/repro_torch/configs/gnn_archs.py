"""The assigned GNN architecture, as data — the port's copy of
``repro.configs.gnn_archs``: MeshGraphNet [arXiv:2010.03409]."""

from __future__ import annotations

from ..models.gnn import GNNConfig
from .registry import GNNArch, register


@register("meshgraphnet")
def meshgraphnet() -> GNNArch:
    cfg = GNNConfig(
        name="meshgraphnet", n_layers=15, d_hidden=128, mlp_layers=2,
        aggregator="sum", d_edge_in=8, d_out=3, remat="full")
    return GNNArch("meshgraphnet", cfg)
