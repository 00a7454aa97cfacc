"""Filter state — the port of ``repro.core.state`` (DESIGN §3.6).

``bits`` depends on ``cfg.effective_layout``, as in the reference:

* "dense8" (the reference's default): (n_rows, s) uint8, one byte per bit
  — per cell for sbf, holding the counter value. The paper's 1-bit
  variants keep k rows, sbf one row of cells;
* "planes": int32 tensors of uint32 BIT PATTERNS (``core.u32``), bit j of
  word w holding cell 32·w + j — bit for bit the JAX package's plane
  layout, so ``repro_torch.convert.state_to_numpy`` returns the same bytes
  as ``np.asarray(state.bits)`` in JAX:

  - the paper's 1-bit variants (rsbf, bsbf, bsbfsd, rlbsbf): (k, W), k
    rows of W = ceil(s/32) words;
  - the counter family (sbf, swbf, cms, hh): d bit-planes of one row of
    d-bit cells, the (d, 1, W) stack — cell j's value is
    sum_p plane[p] bit j << p. At d == 1 (sbf with Max = 1) the plane axis
    is squeezed to (1, W), as in the reference.

``position`` is the 1-indexed stream position ``i`` of the next element
(RSBF's insert probability is s/i), ``load`` the exact per-row count of set
bits — of nonzero cells for the counter family (DESIGN §3.1) — and ``rng``
the (2,) threefry key data (``core.prng``). ``ring`` is swbf's sliding
window (DESIGN §3.7): the last ``window`` batches' sorted insert-event
lists and the slot the next batch expires; ``None`` for every other
variant. All of it lives on the engine's device, so a stream of steps never
waits on the host. ``router`` is the elastic sharded service's bucket ->
shard table (DESIGN §4.4, ``dedup.sharded``); ``None`` everywhere else.

A tenant fleet (DESIGN §4.6, ``core.fleet``) stacks T such states on a
leading axis in one ``FilterState``: ``bits`` (T, ...), ``position`` (T,),
``load`` (T, k) or (T, 1), ``rng`` (T, 2), and the ring's ``events`` (T,
window, E) and ``slot`` (T,).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import prng
from .config import DedupConfig
from .device import resolve_device


class WindowRing(NamedTuple):
    """swbf's ring of the last ``window`` batches' insert events.

    ``events``: (window, E) int32 — each slot one batch's insert cells as a
    SORTED list padded with the sentinel 32·W; at expiry the slot is the
    subtract operand of the counter step (``core.batched``).
    ``slot``: () int32 — the next slot to expire and overwrite."""
    events: torch.Tensor
    slot: torch.Tensor


class RouterState(NamedTuple):
    """The elastic sharded path's key-range router table (DESIGN §4.4).
    The uint32 key space splits into ``n_buckets`` contiguous ranges; bucket
    ``g`` is a self-contained sub-filter that a load-triggered rebalance
    moves between ranks whole.

    ``assign``: (n_buckets,) int32 — bucket -> owner shard, replicated on
    every rank (each must route identically).
    ``n_rebalances``: () int32 — re-partitions fired so far."""
    assign: torch.Tensor
    n_rebalances: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class FilterState:
    """The engine's state. It behaves as the reference's pytree does:
    iterating it yields its leaves, and a ``ring`` or ``router`` that is
    None is no leaf, so a bitset state is the same four tensors as before
    either existed. ``_replace`` returns a copy with the named fields
    changed."""
    bits: torch.Tensor       # (k, s) uint8 | (k, W) | (d, 1, W) | (1, W)
                             #   int32 words
    position: torch.Tensor   # () int32 — 1-indexed next stream position
    load: torch.Tensor       # (k,) int32 — set bits (nonzero cells)
    rng: torch.Tensor        # (2,) int32 — threefry key data
    ring: Optional[WindowRing] = None   # swbf sliding-window ring (§3.7)
    router: Optional[RouterState] = None  # elastic shard router (§4.4)

    def __iter__(self):
        yield from (self.bits, self.position, self.load, self.rng)
        if self.ring is not None:
            yield self.ring
        if self.router is not None:
            yield self.router

    def _replace(self, **changes) -> "FilterState":
        return dataclasses.replace(self, **changes)

    @property
    def n_planes(self) -> int:
        """Bit-planes of the word layout (1 unless it holds counters)."""
        return self.bits.shape[0] if self.bits.dim() == 3 else 1


def bits_shape(cfg: DedupConfig) -> tuple:
    """The ``bits`` leaf's shape: (n_rows, s) on dense8; on the plane
    layout (d, n_rows, W) for d > 1 planes, else the squeezed (n_rows,
    W)."""
    if not cfg.is_planes:
        return (cfg.n_rows, cfg.s)
    d = cfg.n_planes
    return ((d, cfg.n_rows, cfg.s_words) if d > 1
            else (cfg.n_rows, cfg.s_words))


def bits_dtype(cfg: DedupConfig) -> torch.dtype:
    """uint8 cells on dense8, int32 words on the plane layout."""
    return torch.int32 if cfg.is_planes else torch.uint8


def init_ring(cfg: DedupConfig, event_capacity: int | None = None,
              device=None) -> WindowRing:
    """An empty sliding-window ring on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``). ``event_capacity`` is the widest per-step
    element count the ring must absorb (default ``cfg.batch_size``). A slot
    of sentinels decrements nothing, so the warm-up batches need no special
    case."""
    device = resolve_device(device)
    cap = cfg.batch_size if event_capacity is None else event_capacity
    return WindowRing(
        events=torch.full((cfg.window, cap * cfg.k), 32 * cfg.s_words,
                          dtype=torch.int32, device=device),
        slot=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_router(n_buckets: int, n_shards: int, device=None) -> RouterState:
    """The canonical block assignment on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``): bucket ``g`` starts on shard ``g //
    (n_buckets / n_shards)``, so contiguous key ranges stay contiguous per
    shard until the first load-triggered re-partition (DESIGN §4.4)."""
    if n_buckets % n_shards:
        raise ValueError(
            f"rebalance_buckets {n_buckets} must divide by the shard "
            f"count {n_shards}")
    device = resolve_device(device)
    per = n_buckets // n_shards
    return RouterState(
        assign=torch.arange(n_buckets, dtype=torch.int32,
                            device=device) // per,
        n_rebalances=torch.zeros((), dtype=torch.int32, device=device))


def init_state(cfg: DedupConfig, seed: int | None = None, device=None,
               event_capacity: int | None = None) -> FilterState:
    """An empty filter on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``; ``core.device``). ``event_capacity`` sizes swbf's ring."""
    cfg.validate()
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    ring = (init_ring(cfg, event_capacity, device)
            if cfg.variant == "swbf" else None)
    return FilterState(
        bits=torch.zeros(bits_shape(cfg), dtype=bits_dtype(cfg),
                         device=device),
        position=torch.ones((), dtype=torch.int32, device=device),
        load=torch.zeros((cfg.n_rows,), dtype=torch.int32, device=device),
        rng=prng.PRNGKey(seed, device=device),
        ring=ring,
    )


def state_memory_bytes(state: FilterState) -> int:
    leaves = [state.bits, state.position, state.load, state.rng]
    if state.ring is not None:
        leaves += list(state.ring)
    if state.router is not None:
        leaves += list(state.router)
    return sum(x.numel() * x.element_size() for x in leaves)
