"""The paper's configurations over the port's ``DedupConfig``, and the LM
architecture registry (``get_arch``; the five LM ids of the reference)."""

from .paper_dedup import (MB, PAPER_DISTINCT_FRACS, PAPER_MEMORIES_MB,
                          PAPER_STREAM_SIZES, SCALE, paper_config,
                          scaled_config, scaled_stream)
from .registry import LMArch, ShapeCell, all_arch_ids, get_arch

__all__ = ["MB", "PAPER_MEMORIES_MB", "PAPER_DISTINCT_FRACS",
           "PAPER_STREAM_SIZES", "SCALE", "paper_config", "scaled_config",
           "scaled_stream", "LMArch", "ShapeCell", "all_arch_ids",
           "get_arch"]
