"""Model families of the port. The dense decoder (``transformer``) serves
on the card; MoE, MLA, GNN and recsys wait for their own slices."""

from . import layers, transformer

__all__ = ["layers", "transformer"]
