"""Model families of the port. The decoder-only transformer
(``transformer``: dense, MoE and MLA stacks, the five LM archs) and its
MoE FFN (``moe``) serve on the card; GNN and recsys wait for their own
slice."""

from . import layers, moe, transformer

__all__ = ["layers", "moe", "transformer"]
