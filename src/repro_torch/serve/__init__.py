"""Serving substrate of the port: request-level dedup, dynamic batching,
response cache. The reference's LM steps (``make_prefill_step``,
``make_decode_step``) wait for the port of the models (ROADMAP [14])."""

from .cache import ResponseCache
from .engine import ServeSession
from .frontend import (DEFAULT_BUCKETS, MicroBatchExecutor, ServeFrontend,
                       ServeResult, VERDICT_OK, VERDICT_RETRY,
                       replay_schedule, verdict_digest)

__all__ = [
    "ServeSession", "ResponseCache", "MicroBatchExecutor", "ServeFrontend",
    "ServeResult", "DEFAULT_BUCKETS", "VERDICT_OK", "VERDICT_RETRY",
    "replay_schedule", "verdict_digest",
]
