"""The de-duplication stage over the port's engine: ``DedupPipeline``, its
stream-quality metrics and the sharded service ``ShardedDedup``."""

from .metrics import (StreamMetrics, fpr_fnr, truth_from_stream,
                      windowed_truth_from_stream)
from .pipeline import DedupBatch, DedupPipeline, unique_gather
from .sharded import ShardedDedup, ShardedDedupConfig

__all__ = ["DedupPipeline", "DedupBatch", "unique_gather", "StreamMetrics",
           "fpr_fnr", "truth_from_stream", "windowed_truth_from_stream",
           "ShardedDedup", "ShardedDedupConfig"]
