"""Data plane of the port (numpy only): synthetic key streams, the LM
training corpus, graphs and the neighbor sampler, and CTR batches."""

from . import graphs, lm, recsys_data, streams

__all__ = ["graphs", "lm", "recsys_data", "streams"]
