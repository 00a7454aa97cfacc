"""Distribution of the port (``repro.distributed``): the sharding rules —
partition specs of every model family on a mesh and the elastic
rebalance's ring permute (DESIGN §4.4) — and the collective utilities
(int8-compressed gradient sync, the two-level all-reduce)."""

from . import collectives, sharding
from .sharding import rebalance_collect, ring_schedule

__all__ = ["collectives", "sharding", "ring_schedule", "rebalance_collect"]
