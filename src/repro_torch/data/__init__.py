"""Data plane of the port (numpy only): synthetic key streams and the LM
training corpus."""

from . import lm, streams

__all__ = ["lm", "streams"]
