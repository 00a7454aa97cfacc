"""The elastic rebalance's ring permute over ``torch.distributed`` (DESIGN
§4.4) — the part of the reference's ``repro.distributed`` that the sharded
dedup service runs."""

from .sharding import rebalance_collect, ring_schedule

__all__ = ["ring_schedule", "rebalance_collect"]
