"""The paper's configurations over the port's ``DedupConfig``."""

from .paper_dedup import (MB, PAPER_DISTINCT_FRACS, PAPER_MEMORIES_MB,
                          PAPER_STREAM_SIZES, SCALE, paper_config,
                          scaled_config, scaled_stream)

__all__ = ["MB", "PAPER_MEMORIES_MB", "PAPER_DISTINCT_FRACS",
           "PAPER_STREAM_SIZES", "SCALE", "paper_config", "scaled_config",
           "scaled_stream"]
