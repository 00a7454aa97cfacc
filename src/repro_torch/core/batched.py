"""Batched engine — the port of ``repro.core.batched``.

Processes B stream elements per step (DESIGN §3.1):

  1. hash all B keys (``hash_positions``: the hashmix kernel on CUDA for
     the counter family and the dense8 layout; the bitset kernel hashes
     its keys itself),
  2. exact intra-batch first-occurrence detection by sorting the keys,
  3. draw the step's randomness from the state's threefry key,
  4. probe the batch-entry snapshot, decide per variant and update the
     filter and its exact load in one fused step
     (``kernels/fused_template.py``: the hand-written kernel on CUDA, its
     plain version on the CPU):
     * bitset family (rsbf, bsbf, bsbfsd, rlbsbf): deletions then
       insertions, R = (A & ~D) | I, insertions win;
     * counter family (sbf, swbf, cms, hh; DESIGN §3.6-§3.8): d-bit cells
       as bit-planes, saturating subtract (sbf decay runs, swbf's expiring
       ring slot) then set-to-Max (sbf) or saturating add.

Steps 2-3, and the counter family's sorted event lists, are plain PyTorch
on both devices, as they are XLA outside the Pallas call in the reference.
So is the whole step on the dense8 layout (one byte per cell, the
reference's default), which the reference runs in jnp only: its probes and
updates are gathers and scatters around the one hashmix launch.
``valid`` masks let ragged stream tails ride through fixed-width steps as
no-ops. A step updates ``state.bits`` in place and returns the new state
around the same tensor; the engine clones first where the caller keeps its
state (DESIGN §3.5).

Every step is written over a leading tenant axis (DESIGN §4.6): the state
stacked (T, ...), keys and valid (T, C), the draws from the (T, 2) keys in
one broadcast threefry evaluation, the event lists sorted per row, and one
launch of each kernel for all T rows. ``params_aware=True`` returns that
fleet step, ``step(state, keys, valid, tp)`` with ``TenantStepParams``
rows; otherwise the step takes one filter and runs it as a fleet of one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import prng, u32
from .config import DedupConfig
from .device import resolve_device
from .hashing import derive_seeds, hash_positions
from .packed import (clamped_run_counts, count_planes_from_sorted,
                     planes_nonzero, popcount, probe_cell_values,
                     run_heads_1d)
from .state import FilterState, WindowRing
from ..kernels import fused_template as _fused
from ..kernels.scope import plain_region


class BatchResult(NamedTuple):
    dup: torch.Tensor        # (B,) bool — reported duplicate
    inserted: torch.Tensor   # (B,) bool — element was inserted


class BatchRandomness(NamedTuple):
    """Pre-drawn randomness for one step; unused fields are zeros."""
    del_pos: torch.Tensor    # (B, k) int32 — candidate deletion positions
    u_bern: torch.Tensor     # (B,) f32    — RSBF phase-2 insertion bernoulli
    u_aux: torch.Tensor      # (B, k) f32  — RLBSBF per-row deletion uniforms
    which: torch.Tensor      # (B,) int32  — BSBFSD's single chosen row


BatchedStep = Callable[[FilterState, torch.Tensor, torch.Tensor],
                       Tuple[FilterState, BatchResult]]


class TenantStepParams(NamedTuple):
    """Per-tenant numeric knobs of one fleet step (DESIGN §4.6), (T,)
    int32 rows on the fleet's device. Only value-like knobs ride here;
    everything that shapes the state (k, d, s, W, ring length) stays
    fleet-wide. ``max_value`` keeps ``cfg.sbf_max``'s bit_length (d is
    fixed); ``window`` is at most the ring length ``cfg.window``."""
    max_value: torch.Tensor      # (T,) — sbf set-to-Max counter ceiling
    threshold: torch.Tensor      # (T,) — cms/hh verdict threshold
    window: torch.Tensor         # (T,) — swbf effective window (batches)


def _lift(state: FilterState) -> FilterState:
    """One filter's state as a fleet of one: a leading axis of 1 on every
    leaf, as views, so the step's in-place update reaches the filter."""
    ring = state.ring
    if ring is not None:
        ring = WindowRing(ring.events[None], ring.slot[None])
    return FilterState(state.bits[None], state.position[None],
                       state.load[None], state.rng[None], ring)


def _one_filter(fleet_step) -> BatchedStep:
    """The one-filter step ``(state, keys (B,), valid (B,))`` as the fleet
    step over T = 1 — the same code and the same kernel launches."""
    def step(state: FilterState, keys: torch.Tensor, valid: torch.Tensor):
        new, res = fleet_step(_lift(state), keys[None], valid[None])
        ring = new.ring
        if ring is not None:
            ring = WindowRing(ring.events[0], ring.slot[0])
        return (FilterState(state.bits, new.position[0], new.load[0],
                            new.rng[0], ring),
                BatchResult(res.dup[0], res.inserted[0]))
    return step


def intra_batch_seen(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., B) bool: True where an equal valid key occurs earlier in the
    same row of the batch. Sort each row, rank by binary search, elect the
    earliest lane per key with a scatter-min; invalid lanes share a
    sentinel key (DESIGN §3.1)."""
    b = keys.shape[-1]
    sk = torch.where(valid, u32.to_u64(keys), u32.MASK)
    sorted_k = torch.sort(sk, dim=-1).values
    rank = torch.searchsorted(sorted_k, sk)
    lane = torch.arange(b, dtype=torch.int64,
                        device=keys.device).expand(sk.shape)
    winner = torch.full(sk.shape, b, dtype=torch.int64, device=keys.device)
    winner.scatter_reduce_(-1, rank, lane, reduce="amin")
    return (winner.gather(-1, rank) != lane) & valid


def draw_randomness(cfg: DedupConfig, rng: torch.Tensor, b: int,
                    partitionable: bool = True
                    ) -> Tuple[torch.Tensor, BatchRandomness]:
    """Split the state key and draw every random input of one step, in the
    reference's frozen order: one 4-way split, del_pos from r_del, then the
    variant's extra draws. ``partitionable`` picks JAX's threefry counter
    layout (``core.prng``). A (T, 2) key draws (T, B, ...) in one
    evaluation, row t equal to the one-key draw with key t."""
    k, s, dev, part = cfg.k, cfg.s, rng.device, partitionable
    lead = tuple(rng.shape[:-1])
    keys = prng.split(rng, 4, part)
    rng, r_ins, r_del, r_aux = (keys[..., i, :] for i in range(4))
    del_pos = prng.randint(r_del, (b, k), 0, s, part)
    u_bern = (prng.uniform(r_ins, (b,), part) if cfg.variant == "rsbf"
              else torch.zeros(lead + (b,), dtype=torch.float32, device=dev))
    u_aux = (prng.uniform(r_aux, (b, k), part) if cfg.variant == "rlbsbf"
             else torch.zeros(lead + (b, k), dtype=torch.float32,
                              device=dev))
    which = (prng.randint(r_aux, (b,), 0, k, part) if cfg.variant == "bsbfsd"
             else torch.zeros(lead + (b,), dtype=torch.int32, device=dev))
    return rng, BatchRandomness(del_pos, u_bern, u_aux, which)


def make_decision_fn(cfg: DedupConfig):
    """Per-variant decision logic in float32, as the reference computes it.

    decide(vals, valid, seen, i_t, load, rnd) ->
        (dup (B,) bool, insert (B,) bool, del_mask (B, k) bool)
    """
    s, k = cfg.s, cfg.k
    # float32 constants as exact doubles; every division below divides two
    # full tensors, because a CPU-scalar divisor may become a multiply by
    # its reciprocal, which does not round as IEEE division does
    s_f = float(np.float32(s))
    p_star = float(np.float32(cfg.p_star))

    def decide(vals, valid, seen, i_t, load, rnd: BatchRandomness):
        # vals (..., B, k), the rest (..., B) with load (..., k): one
        # filter, or a fleet's rows with the tenant axis written out
        shape = vals.shape
        dup = ((vals == 1).all(dim=-1) | seen) & valid
        distinct = valid & ~dup
        if cfg.variant == "rsbf":
            i_f = i_t.to(torch.float32)
            p_ins = torch.full_like(i_f, s_f) / i_f
            ph1 = i_t <= s
            ph3 = p_ins <= p_star
            bern = rnd.u_bern < p_ins
            insert = torch.where(ph1, valid,
                                 torch.where(ph3, distinct, distinct & bern))
            ph2_del = ((~ph1) & (~ph3) & insert)[..., None]
            ph3_del = (ph3 & insert)[..., None] & (vals == 0)
            del_mask = torch.where(ph3[..., None], ph3_del,
                                   ph2_del.expand(shape))
        elif cfg.variant == "bsbf":
            insert = distinct
            del_mask = insert[..., None].expand(shape)
        elif cfg.variant == "bsbfsd":
            insert = distinct
            rows = torch.arange(k, dtype=torch.int32, device=valid.device)
            del_mask = insert[..., None] & (rnd.which[..., None] == rows)
        elif cfg.variant == "rlbsbf":
            insert = distinct
            load_f = load.to(torch.float32)
            p_del = (load_f / torch.full_like(load_f, s_f))[..., None, :]
            del_mask = insert[..., None] & (rnd.u_aux < p_del)
        else:
            raise ValueError(cfg.variant)
        return dup, insert, del_mask

    return decide


def sorted_enabled_positions(pos: torch.Tensor, mask: torch.Tensor,
                             sentinel: int) -> torch.Tensor:
    """(..., B, k) positions + enable mask -> (..., k, B) int64 ascending
    per row; disabled lanes carry ``sentinel`` (> any real position)."""
    p = torch.where(mask, pos.to(torch.int64), sentinel)
    return torch.sort(p.transpose(-1, -2), dim=-1).values


def load_delta_from_sorted(spi, pre_i, spd, pre_d, post_d, s: int
                           ) -> torch.Tensor:
    """Exact per-row load delta of R = (A & ~D) | I from the sorted insert /
    delete positions and their pre/post-update bits: gained = first
    inserts of clear bits; lost = first deletes of set bits that were not
    re-inserted (DESIGN §3.1)."""
    gained = (run_heads_1d(spi) & (spi < s) & (pre_i == 0)).sum(dim=-1)
    lost = (run_heads_1d(spd) & (spd < s) & (post_d == 0)
            & (pre_d == 1)).sum(dim=-1)
    return (gained - lost).to(torch.int32)


def _seeds(cfg: DedupConfig):
    """The probe seeds, and the block seeds of the blocked layout, as CPU
    int32 words, made once when a step is built: the plain versions read
    them there, and a kernel launch takes them into its argument block."""
    seeds = u32.from_numpy_u32(derive_seeds(cfg.seed, cfg.k, channel=0),
                               "cpu")
    bseeds = (u32.from_numpy_u32(derive_seeds(cfg.seed, cfg.k, channel=1),
                                 "cpu") if cfg.block_bits else None)
    return seeds, bseeds


def make_bitset_step(cfg: DedupConfig, spec, device=None,
                     partitionable: bool = True,
                     params_aware: bool = False) -> BatchedStep:
    """The bitset-family step (DESIGN §3.1/§3.8): rsbf, bsbf, bsbfsd and
    rlbsbf are this function under their specs, on either layout.
    ``params_aware=True`` returns the fleet step over the stacked state; it
    accepts the ``TenantStepParams`` and ignores them, as the reference
    does — the bitset decisions have no value-like knob."""
    cfg = cfg.validate()
    resolve_device(device)
    seeds, bseeds = _seeds(cfg)
    if not cfg.is_planes:
        step = _dense8_bitset_step(cfg, spec, seeds, bseeds, partitionable)
        return step if params_aware else _one_filter(step)

    def step(state: FilterState, keys: torch.Tensor, valid: torch.Tensor,
             tp: Optional[TenantStepParams] = None):
        b = keys.shape[-1]
        seen = intra_batch_seen(keys, valid)
        i_t = state.position[:, None] + torch.arange(
            b, dtype=torch.int32, device=keys.device)
        rng, rnd = spec.draw(cfg, state.rng, b, partitionable)
        # the kernel hashes the keys in its probe and insert launches
        dup, insert, load = _fused.bitset_step(
            cfg, state.bits, keys, rnd, valid, seen, i_t, state.load,
            seeds=seeds, block_seeds=bseeds)
        if cfg.debug_exact_load:
            load = popcount(state.bits)
        n_valid = valid.sum(dim=-1, dtype=torch.int32)
        new = FilterState(state.bits, state.position + n_valid, load, rng)
        return new, BatchResult(dup=dup, inserted=insert)

    return step if params_aware else _one_filter(step)


# --------------------------------------------------------- dense8 layout //
# One byte per bit (per cell for sbf): the reference's default layout. The
# reference runs it in jnp only (its Pallas backend needs the planes), so
# the port runs it in plain PyTorch on both devices, the probe positions
# from ``hash_positions`` — one hashmix launch per step on the card. The
# reference's scatters drop disabled lanes (``mode="drop"``, index s);
# here every lane scatters under a min or a max, and a disabled lane's
# value cannot change the cell it names — 1 (255 for sbf's cells) under a
# min, 0 under a max — so a pad lane never writes a cell, whatever index
# it carries, and no step waits on the host for a mask.

def _dense8_bitset_step(cfg: DedupConfig, spec, seeds, bseeds,
                        partitionable: bool):
    """The dense8 branch of the reference's ``make_bitset_step`` with the
    tenant axis written out: state.bits (T, k, s) uint8, keys and valid
    (T, B). Probe the snapshot, decide, clear the deletions, set the
    insertions (insertions win), and the exact load delta from the sorted
    positions' pre/post values."""
    s, k = cfg.s, cfg.k
    decide = spec.make_decide(cfg)
    sentinel = 32 * cfg.s_words

    def step(state: FilterState, keys: torch.Tensor, valid: torch.Tensor,
             tp: Optional[TenantStepParams] = None):
        t, b = keys.shape
        dev = keys.device
        bits = state.bits
        flat = bits.view(-1)
        # the flat index of cell (tenant, row, 0): (T, 1, k)
        base = ((torch.arange(t, device=dev)[:, None] * k
                 + torch.arange(k, device=dev)) * s)[:, None, :]
        pos = hash_positions(keys, seeds, s, cfg.block_bits, bseeds)
        vals = flat[base + pos]                                 # (T, B, k)
        seen = intra_batch_seen(keys, valid)
        i_t = state.position[:, None] + torch.arange(
            b, dtype=torch.int32, device=dev)
        rng, rnd = spec.draw(cfg, state.rng, b, partitionable)
        dup, insert, del_mask = decide(vals, valid, seen, i_t, state.load,
                                       rnd)
        ins_mask = insert[..., None].expand(t, b, k)
        spi = sorted_enabled_positions(pos, ins_mask, sentinel)  # (T, k, B)
        spd = sorted_enabled_positions(rnd.del_pos, del_mask, sentinel)
        rows = base.transpose(-1, -2)                           # (T, k, 1)

        def probe_sorted(sp):
            # sentinels clamp onto cell s - 1; the load mask drops them
            return flat[rows + torch.clamp(sp, max=s - 1)]

        pre_i, pre_d = probe_sorted(spi), probe_sorted(spd)
        flat.scatter_reduce_(0, (base + rnd.del_pos).reshape(-1),
                             (~del_mask).to(torch.uint8).reshape(-1),
                             reduce="amin")
        flat.scatter_reduce_(0, (base + pos).reshape(-1),
                             ins_mask.to(torch.uint8).reshape(-1),
                             reduce="amax")
        if cfg.debug_exact_load:
            load = bits.sum(dim=-1, dtype=torch.int32)
        else:
            load = state.load + load_delta_from_sorted(
                spi, pre_i, spd, pre_d, probe_sorted(spd), s)
        n_valid = valid.sum(dim=-1, dtype=torch.int32)
        new = FilterState(bits, state.position + n_valid, load, rng)
        return new, BatchResult(dup=dup, inserted=insert)

    return step


def _make_sbf_dense8_step(cfg: DedupConfig, device=None,
                          partitionable: bool = True) -> BatchedStep:
    """The reference's dense uint8 sbf branch (not spec-driven: it is the
    cross-check the plane steps are held against), one filter: state.bits
    (1, s) uint8 cells. Probe, decrement each valid element's run of P
    cells from its random start (wrapping), then set its k cells to Max.

    The reference builds a dense (s,) decrement array every step; the
    decrement of a cell is the number of runs covering it, so the step
    sorts the B·P run cells instead and writes ``max(cell - count, 0)``
    at each run head, the count clamped at Max (lossless: cells hold at
    most Max). Its load, which the reference recounts over all s cells,
    is the entry load plus the set cells that were zero, less the
    decremented cells that were nonzero and end at zero — the recount's
    value whenever the entry load was exact (``debug_exact_load``
    recounts)."""
    cfg = cfg.validate()
    resolve_device(device)
    seeds, bseeds = _seeds(cfg)
    s, p_run, cmax = cfg.s, cfg.sbf_p_effective, cfg.sbf_max
    np.uint8(cmax)           # refuses a Max past the cell's byte, as the
                             # reference does with the same words
    sentinel = 32 * cfg.s_words

    def step(state: FilterState, keys: torch.Tensor, valid: torch.Tensor):
        b = keys.shape[0]
        dev = keys.device
        cells = state.bits.view(-1)                             # (s,)
        pos = hash_positions(keys, seeds, s, cfg.block_bits, bseeds)
        dup = (cells[pos] > 0).all(dim=-1) & valid
        rng, start = draw_sbf_randomness(cfg, state.rng, b, partitionable)
        run = (start.to(torch.int64)[:, None]
               + torch.arange(p_run, device=dev)) % s
        spd = torch.sort(torch.where(valid[:, None], run, sentinel)
                         .reshape(-1)).values
        head, cnt = clamped_run_counts(spd, cmax)
        dec_live = head & (spd < s)
        dec_at = torch.clamp(spd, max=s - 1)
        sps = torch.sort(torch.where(valid[:, None], pos.to(torch.int64),
                                     sentinel).reshape(-1)).values
        set_live = run_heads_1d(sps) & (sps < s)
        set_at = torch.clamp(sps, max=s - 1)
        pre_dec = cells[dec_at].to(torch.int64)
        pre_set = cells[set_at]
        # in int64, then back: uint8 arithmetic would wrap below zero
        mid = torch.clamp(pre_dec - cnt, min=0)
        cells.scatter_reduce_(0, dec_at, torch.where(dec_live, mid, 255)
                              .to(torch.uint8), reduce="amin")
        cells.scatter_reduce_(0, set_at, torch.where(set_live, cmax, 0)
                              .to(torch.uint8), reduce="amax")
        if cfg.debug_exact_load:
            load = torch.count_nonzero(cells).to(torch.int32).reshape(1)
        else:
            gained = (set_live & (pre_set == 0)).sum(dtype=torch.int32)
            lost = (dec_live & (pre_dec > 0) & (cells[dec_at] == 0)
                    ).sum(dtype=torch.int32)
            load = state.load + (gained - lost)
        n_valid = valid.sum(dtype=torch.int32)
        new = FilterState(state.bits, state.position + n_valid, load, rng)
        return new, BatchResult(dup=dup, inserted=valid)

    return step


# ------------------------------------------------------- counter family //

class SbfBatchDeltas(NamedTuple):
    """One SBF batch's events (DESIGN §3.6): the sorted decrement and
    set-to-Max cells, and — when built — their run heads and the word
    deltas the plain step applies. The CUDA step reads only the sorted
    lists (its kernel finds the runs itself); the heads, ``count_planes``
    and ``set_delta`` are then None. A fleet's events carry a leading
    tenant axis, each row sorted on its own."""
    count_planes: Optional[torch.Tensor]  # (d, W) int32 — decrement counts
                                          #   per cell, clamped to Max
    set_delta: Optional[torch.Tensor]     # (W,) int32 — set-to-Max cells
    dec_sorted: torch.Tensor   # (B·P,) int64 sorted decrement cells
                               #   (sentinel 32·W for invalid lanes)
    dec_head: Optional[torch.Tensor]  # (B·P,) bool — first event per cell
    set_sorted: torch.Tensor   # (B·k,) int64 sorted set-to-Max cells
    set_head: Optional[torch.Tensor]  # (B·k,) bool — first event per cell


def _per_row(fn, *xs):
    """``fn`` of 1-D rows, applied to each row of the leading axes and
    stacked — the plane builders, which only the CPU's plain step reads."""
    if xs[0].dim() == 1:
        return fn(*xs)
    return torch.stack([_per_row(fn, *(x[i] for x in xs))
                        for i in range(xs[0].shape[0])])


def draw_sbf_randomness(cfg: DedupConfig, rng: torch.Tensor, b: int,
                        partitionable: bool = True):
    """SBF's per-batch randomness, in the reference's frozen order: one
    2-way split, then the decrement-run start cells ``randint(r, (B,), 0,
    s)`` — (T, B) for a fleet's (T, 2) keys."""
    keys = prng.split(rng, 2, partitionable)
    rng, r = keys[..., 0, :], keys[..., 1, :]
    return rng, prng.randint(r, (b,), 0, cfg.s, partitionable)


def sbf_event_deltas(cfg: DedupConfig, pos: torch.Tensor,
                     start: torch.Tensor, valid: torch.Tensor,
                     build_planes: bool = True) -> SbfBatchDeltas:
    """Batch events -> sorted event lists (and, with ``build_planes``, run
    heads and word deltas). Each valid element decrements the P contiguous
    cells from its random start, wrapping at s, and sets its k cells to
    Max: a cell's decrement is the number of runs covering it, read off the
    sorted list clamped to the fleet-wide ``cfg.sbf_max`` (lossless, since
    value <= Max). pos (..., B, k), start and valid (..., B)."""
    w = cfg.s_words
    sentinel = 32 * w
    lead = pos.shape[:-2]
    p_run = cfg.sbf_p_effective
    run = (start.to(torch.int64)[..., None]
           + torch.arange(p_run, device=pos.device)) % cfg.s   # (.., B, P)
    spd = torch.sort(torch.where(valid[..., None], run, sentinel)
                     .reshape(*lead, -1), dim=-1).values
    sps = torch.sort(torch.where(valid[..., None], pos.to(torch.int64),
                                 sentinel).reshape(*lead, -1),
                     dim=-1).values
    if not build_planes:
        return SbfBatchDeltas(None, None, spd, None, sps, None)

    def set_words(sp, head):
        # head-only single-bit masks are disjoint within a word: the sum is
        # the OR
        keep = head & (sp < sentinel)
        acc = torch.zeros((w,), dtype=torch.int64, device=sp.device)
        acc.index_add_(0, torch.where(keep, sp >> 5, 0),
                       torch.where(keep, 1 << (sp & 31), 0))
        return u32.to_i32(acc)

    with plain_region("counter_step"):
        set_head = run_heads_1d(sps)
        dec_head, cnt = clamped_run_counts(spd, cfg.sbf_max)
        count_planes = _per_row(
            lambda sp, h, c: count_planes_from_sorted(sp, h, c,
                                                      cfg.n_planes, w),
            spd, dec_head, cnt)
        return SbfBatchDeltas(count_planes,
                              _per_row(set_words, sps, set_head),
                              spd, dec_head, sps, set_head)


def sbf_planes_3d(bits: torch.Tensor) -> torch.Tensor:
    """A counter plane state as (d, 1, W) — Max == 1 squeezes d."""
    return bits if bits.dim() == 3 else bits[None]


def fleet_planes(bits: torch.Tensor) -> torch.Tensor:
    """A stacked counter state's ``bits`` — (T, d, 1, W), or (T, 1, W) at
    d == 1 — as the (T, d, W) view the counter step updates in place."""
    return bits[:, :, 0, :] if bits.dim() == 4 else bits


class CountBatchDeltas(NamedTuple):
    """One batch's insert/increment events (DESIGN §3.7/§3.8): the sorted
    list padded to the event width and — when built — its run heads and the
    per-cell multiplicities clamped to 2^d - 1 as bit-planes."""
    count_planes: Optional[torch.Tensor]  # (d, W) int32
    ins_sorted: torch.Tensor   # (E,) int64 sorted insert cells, sentinel
                               #   32·W padded to the event width
    ins_head: Optional[torch.Tensor]  # (E,) bool — first event per cell


def count_event_deltas(cfg: DedupConfig, pos: torch.Tensor,
                       valid: torch.Tensor, width: int,
                       build_planes: bool = True) -> CountBatchDeltas:
    """A batch's B·k insert positions -> the sorted event list padded with
    sentinels to ``width`` (B·k for cms/hh, the ring's event capacity for
    swbf) and, with ``build_planes``, its run heads and clamped count
    planes. pos (..., B, k) and valid (..., B) give one list per leading
    row."""
    w, d = cfg.s_words, cfg.n_planes
    sentinel = 32 * w
    flat = torch.where(valid[..., None], pos.to(torch.int64),
                       sentinel).reshape(*pos.shape[:-2], -1)
    if width < flat.shape[-1]:
        raise ValueError(
            f"{cfg.variant} step saw {flat.shape[-1]} events but the event "
            f"width is {width} — init the state with event_capacity >= the "
            f"step's element count (DESIGN §3.7)")
    if width > flat.shape[-1]:
        flat = torch.nn.functional.pad(flat, (0, width - flat.shape[-1]),
                                       value=sentinel)
    sp = torch.sort(flat, dim=-1).values
    if not build_planes:
        return CountBatchDeltas(None, sp, None)
    with plain_region("counter_step"):
        head, cnt = clamped_run_counts(sp, (1 << d) - 1)
        return CountBatchDeltas(
            _per_row(lambda x, h, c: count_planes_from_sorted(x, h, c, d, w),
                     sp, head, cnt), sp, head)


def _slot_index(ring: WindowRing) -> torch.Tensor:
    """Each row's current slot as a gather/scatter index over the ring's
    slot axis: (..., 1, E)."""
    e = ring.events.shape[-1]
    return ring.slot.to(torch.int64)[..., None, None].expand(
        *ring.slot.shape, 1, e)


def ring_expire_planes(cfg: DedupConfig, ring: WindowRing,
                       build_planes: bool = True):
    """The expiring slot's sorted event list -> (events int64, heads, count
    planes), the last two None without ``build_planes``: exactly what the
    arriving batch added, re-expanded (the list is already sorted, so no
    sort). A stacked ring (T, window, E) with slots (T,) gives each row's
    own expiring slot."""
    ev = ring.events.gather(-2, _slot_index(ring)).squeeze(-2)
    ev = ev.to(torch.int64)
    if not build_planes:
        return ev, None, None
    d, w = cfg.n_planes, cfg.s_words
    with plain_region("counter_step"):
        head, cnt = clamped_run_counts(ev, (1 << d) - 1)
        return ev, head, _per_row(
            lambda x, h, c: count_planes_from_sorted(x, h, c, d, w), ev,
            head, cnt)


def ring_push(ring: WindowRing, ev: CountBatchDeltas, window
              ) -> WindowRing:
    """Overwrite the expired slot with the arriving batch's event list and
    advance modulo ``window``: an int, or a fleet's (T,) tensor of
    per-tenant windows (the reference's third value-like seam, outside the
    kernel there too). Out of place: the ring is a few hundred kB, and a
    state the caller keeps must stay as it was (``Dedup.process``)."""
    events = ring.events.scatter(-2, _slot_index(ring),
                                 ev.ins_sorted.to(torch.int32)[..., None, :])
    return WindowRing(events, (ring.slot + 1) % window)


class CounterStepDeltas(NamedTuple):
    """A counter-family batch reduced to the step's operands (DESIGN §3.8),
    built per spec (``core.sketch``). The sorted event lists are what the
    CUDA kernel reads; the run heads (the plain step's exact load
    accounting) and the plane deltas (what the reference's jnp step
    applies) are built only for the plain step. ``None`` marks an op the
    sketch lacks (or heads and planes not built). Order: subtract, then
    set/add (insertions win). A fleet's operands carry a leading tenant
    axis."""
    sub_planes: Optional[torch.Tensor]   # (d, W) int32 decrement planes
    sub_events: Optional[torch.Tensor]   # (E,) int64 sorted decrement cells
    sub_heads: Optional[torch.Tensor]    # (E,) bool first event per cell
    add_planes: Optional[torch.Tensor]   # (d, W) int32 increment planes
    set_delta: Optional[torch.Tensor]    # (W,) int32 set-to-Max OR mask
    ins_events: torch.Tensor             # (E',) int64 sorted insert cells
    ins_heads: Optional[torch.Tensor]    # (E',) bool first event per cell
    ring_payload: Optional[CountBatchDeltas]  # swbf: this batch's ring slot


def make_counter_planes_step(cfg: DedupConfig, spec, device=None,
                             partitionable: bool = True,
                             params_aware: bool = False) -> BatchedStep:
    """The counter-family step (DESIGN §3.8) on the (d, W) bit-plane
    algebra, specialized by a ``SketchSpec``: probe (nonzero bit or d-bit
    value), the spec's decision, its events, and the exact nonzero-cell
    load. sbf, swbf, cms and hh are this function under their specs. The
    fused counter step (``kernels/fused_template.py::counter_step``) does
    the probe, decide and update; on CUDA no (d, W) delta plane is built.

    ``params_aware=True`` returns the fleet step over the stacked state,
    ``step(state, keys, valid, tp)``: the tenants' ``TenantStepParams``
    replace the config at the reference's three value-like seams — the
    cms/hh threshold and the sbf set-to-Max ceiling, read by the kernel
    from (T,) device rows, and the swbf ring's advance modulus. Every shape
    and every draw stays as it is, and the sbf events still clamp to the
    fleet-wide ``cfg.sbf_max``, as the reference's do."""
    cfg = cfg.validate()
    device = resolve_device(device)
    seeds, bseeds = _seeds(cfg)
    events_fn = spec.make_events(cfg)
    if spec.combine == "set":
        np.uint32(cfg.sbf_max)   # past 32 planes: the reference's refusal,
                                 # in its words
    # the one-filter step's knobs, as (1,) rows like a fleet's (Max as its
    # int32 bit pattern)
    one = TenantStepParams(
        *(_fused.int32_rows(v, 1, device)
          for v in (cfg.sbf_max, cfg.count_threshold, max(cfg.window, 1))))

    def step(state: FilterState, keys: torch.Tensor, valid: torch.Tensor,
             tp: Optional[TenantStepParams] = None):
        b = keys.shape[-1]
        planes = fleet_planes(state.bits)               # (T, d, W) view
        pos = hash_positions(keys, seeds, cfg.s, cfg.block_bits, bseeds)
        seen = intra_batch_seen(keys, valid) if spec.uses_seen else None
        if spec.draw is not None:
            rng, rnd = spec.draw(cfg, state.rng, b, partitionable)
        else:
            rng, rnd = state.rng, None
        ev = events_fn(state, pos, valid, rnd,
                       build_planes=keys.device.type == "cpu")
        knobs = tp if params_aware else one
        dup, load = _fused.counter_step(
            cfg, spec, planes, pos, valid, seen, state.load, ev,
            threshold=knobs.threshold, max_value=knobs.max_value)
        if cfg.debug_exact_load:
            load = popcount(planes_nonzero(planes.transpose(0, 1)))[:, None]
        ring = state.ring
        if ev.ring_payload is not None:
            ring = ring_push(ring, ev.ring_payload, knobs.window)
        n_valid = valid.sum(dim=-1, dtype=torch.int32)
        new = FilterState(state.bits, state.position + n_valid, load, rng,
                          ring)
        return new, BatchResult(dup=dup, inserted=valid)

    return step if params_aware else _one_filter(step)


def make_sbf_planes_step(cfg: DedupConfig, device=None,
                         partitionable: bool = True) -> BatchedStep:
    """SBF on the plane layout: the counter step under the "sbf" spec."""
    from .sketch import get_spec
    return make_counter_planes_step(cfg, get_spec("sbf"), device,
                                    partitionable)


def make_swbf_planes_step(cfg: DedupConfig, device=None) -> BatchedStep:
    """The sliding-window counting filter (DESIGN §3.7): the counter step
    under the "swbf" spec (it draws no randomness)."""
    from .sketch import get_spec
    return make_counter_planes_step(cfg, get_spec("swbf"), device)


def make_estimate_fn(cfg: DedupConfig, device=None):
    """Frequency read-out for the counter family (DESIGN §3.8):
    estimate(state, keys) -> (B,) int32, the MIN over the k probed d-bit
    cells. Read-only. Plain PyTorch on both devices (hashing aside): the
    reference has no kernel here."""
    cfg = cfg.validate()
    resolve_device(device)
    seeds, bseeds = _seeds(cfg)

    def estimate(state: FilterState, keys: torch.Tensor) -> torch.Tensor:
        planes = sbf_planes_3d(state.bits)[:, 0, :]
        pos = hash_positions(keys, seeds, cfg.s, cfg.block_bits, bseeds)
        return probe_cell_values(planes, pos).min(dim=1).values

    return estimate


def make_templated_step(cfg: DedupConfig, spec=None, device=None,
                        partitionable: bool = True,
                        params_aware: bool = False) -> BatchedStep:
    """Resolve the variant's ``SketchSpec`` and hand it to its family's
    generator (DESIGN §3.8). ``params_aware=True`` returns the fleet step
    ``(stacked state, keys (T, C), valid (T, C), TenantStepParams)``."""
    cfg = cfg.validate()
    if spec is None:
        from .sketch import get_spec
        spec = get_spec(cfg.variant)
    make = (make_counter_planes_step if spec.family == "counter"
            else make_bitset_step)
    return make(cfg, spec, device, partitionable, params_aware)


def make_batched_step(cfg: DedupConfig, device=None,
                      partitionable: bool = True) -> BatchedStep:
    """The engine's step for ``cfg`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; ``core.device``), dispatched as the
    reference does: dense8 sbf keeps its own branch (the cross-check, not
    a template instance), everything else is the sketch template on
    either layout. Like the reference's, it reads no ``n_tenants``: a
    fleet config runs here as one filter (``FleetDedup`` runs it as a
    fleet, DESIGN §4.6)."""
    cfg = cfg.validate()
    device = resolve_device(device)
    if cfg.variant == "sbf" and not cfg.is_planes:
        return _make_sbf_dense8_step(cfg, device, partitionable)
    return make_templated_step(cfg, device=device,
                               partitionable=partitionable)
