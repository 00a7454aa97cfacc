"""The de-duplication stage over the port's engine: ``DedupPipeline`` and
its stream-quality metrics."""

from .metrics import (StreamMetrics, fpr_fnr, truth_from_stream,
                      windowed_truth_from_stream)
from .pipeline import DedupBatch, DedupPipeline, unique_gather

__all__ = ["DedupPipeline", "DedupBatch", "unique_gather", "StreamMetrics",
           "fpr_fnr", "truth_from_stream", "windowed_truth_from_stream"]
