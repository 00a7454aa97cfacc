"""Model families of the port: the decoder-only transformer
(``transformer``: dense, MoE and MLA stacks, the five LM archs) and its
MoE FFN (``moe``); MeshGraphNet (``gnn``); the four recsys rankers
(``recsys``: wide-deep, xDeepFM, DLRM-RM2, DCN-v2); and the layers they
share (``layers``)."""

from . import gnn, layers, moe, recsys, transformer

__all__ = ["gnn", "layers", "moe", "recsys", "transformer"]
