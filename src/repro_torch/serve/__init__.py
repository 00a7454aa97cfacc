"""Serving substrate of the port: request-level dedup, dynamic batching,
response cache, and the LM prefill / decode steps."""

from .cache import ResponseCache
from .engine import ServeSession, make_decode_step, make_prefill_step
from .frontend import (DEFAULT_BUCKETS, MicroBatchExecutor, ServeFrontend,
                       ServeResult, VERDICT_OK, VERDICT_RETRY,
                       replay_schedule, verdict_digest)

__all__ = [
    "ServeSession", "make_decode_step", "make_prefill_step",
    "ResponseCache", "MicroBatchExecutor", "ServeFrontend",
    "ServeResult", "DEFAULT_BUCKETS", "VERDICT_OK", "VERDICT_RETRY",
    "replay_schedule", "verdict_digest",
]
