"""The paper's configurations over the port's ``DedupConfig``, and the
architecture registry (``get_arch``; the reference's ten ids: five LMs,
MeshGraphNet and four recsys rankers; ``all_cells``, its 40 cells)."""

from .paper_dedup import (MB, PAPER_DISTINCT_FRACS, PAPER_MEMORIES_MB,
                          PAPER_STREAM_SIZES, SCALE, paper_config,
                          scaled_config, scaled_stream)
from .registry import (GNNArch, LMArch, RecsysArch, ShapeCell, all_arch_ids,
                       all_cells, get_arch, pad_graph)

__all__ = ["MB", "PAPER_MEMORIES_MB", "PAPER_DISTINCT_FRACS",
           "PAPER_STREAM_SIZES", "SCALE", "paper_config", "scaled_config",
           "scaled_stream", "GNNArch", "LMArch", "RecsysArch", "ShapeCell",
           "all_arch_ids", "all_cells", "get_arch", "pad_graph"]
