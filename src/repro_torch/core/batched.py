"""Batched engine, bitset family — the port of ``repro.core.batched``.

Processes B stream elements per step (DESIGN §3.1):

  1. hash all B keys (``hash_positions`` — the hashmix kernel on CUDA),
  2. exact intra-batch first-occurrence detection by sorting the keys,
  3. draw the step's randomness from the state's threefry key,
  4. probe the batch-entry snapshot, decide per variant, apply deletions
     then insertions (R = (A & ~D) | I, insertions win) and update the
     exact per-row load — the bitset step (``kernels/fused_template.py``:
     the hand-written kernel on CUDA, its plain version on the CPU).

Steps 1-3 are plain PyTorch on both devices, as they are XLA outside the
Pallas call in the reference. ``valid`` masks let ragged stream tails ride
through fixed-width steps as no-ops. A step updates ``state.bits`` in
place and returns the new state around the same tensor; the engine clones
first where the caller keeps its state (DESIGN §3.5).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from . import prng, u32
from .config import DedupConfig
from .device import resolve_device
from .hashing import derive_seeds, hash_positions
from .packed import popcount, run_heads
from .state import FilterState
from ..kernels import fused_template as _fused


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


def intra_batch_seen(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B,) bool: True where an equal valid key occurs earlier in the batch.
    Sort, rank by binary search, elect the earliest lane per key with a
    scatter-min; invalid lanes share a sentinel key (DESIGN §3.1)."""
    b = keys.shape[0]
    sk = torch.where(valid, u32.to_u64(keys), u32.MASK)
    sorted_k = torch.sort(sk).values
    rank = torch.searchsorted(sorted_k, sk)
    lane = torch.arange(b, dtype=torch.int64, device=keys.device)
    winner = torch.full((b,), b, dtype=torch.int64, device=keys.device)
    winner.scatter_reduce_(0, rank, lane, reduce="amin")
    return (winner[rank] != lane) & valid


def draw_randomness(cfg: DedupConfig, rng: torch.Tensor, b: int,
                    partitionable: bool = True
                    ) -> Tuple[torch.Tensor, BatchRandomness]:
    """Split the state key and draw every random input of one step, in the
    reference's frozen order: one 4-way split, del_pos from r_del, then the
    variant's extra draws. ``partitionable`` picks JAX's threefry counter
    layout (``core.prng``)."""
    k, s, dev, part = cfg.k, cfg.s, rng.device, partitionable
    rng, r_ins, r_del, r_aux = prng.split(rng, 4, part)
    del_pos = prng.randint(r_del, (b, k), 0, s, part)
    u_bern = (prng.uniform(r_ins, (b,), part) if cfg.variant == "rsbf"
              else torch.zeros((b,), dtype=torch.float32, device=dev))
    u_aux = (prng.uniform(r_aux, (b, k), part) if cfg.variant == "rlbsbf"
             else torch.zeros((b, k), dtype=torch.float32, device=dev))
    which = (prng.randint(r_aux, (b,), 0, k, part) if cfg.variant == "bsbfsd"
             else torch.zeros((b,), dtype=torch.int32, device=dev))
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
        b = valid.shape[0]
        dup = ((vals == 1).all(dim=1) | seen) & valid
        distinct = valid & ~dup
        if cfg.variant == "rsbf":
            i_f = i_t.to(torch.float32)
            p_ins = torch.full_like(i_f, s_f) / i_f
            ph1 = i_t <= s
            ph3 = p_ins <= p_star
            bern = rnd.u_bern < p_ins
            insert = torch.where(ph1, valid,
                                 torch.where(ph3, distinct, distinct & bern))
            ph2_del = ((~ph1) & (~ph3) & insert)[:, None]
            ph3_del = (ph3 & insert)[:, None] & (vals == 0)
            del_mask = torch.where(ph3[:, None], ph3_del,
                                   ph2_del.expand(b, k))
        elif cfg.variant == "bsbf":
            insert = distinct
            del_mask = insert[:, None].expand(b, k)
        elif cfg.variant == "bsbfsd":
            insert = distinct
            rows = torch.arange(k, dtype=torch.int32, device=valid.device)
            del_mask = insert[:, None] & (rnd.which[:, None] == rows[None, :])
        elif cfg.variant == "rlbsbf":
            insert = distinct
            load_f = load.to(torch.float32)
            p_del = (load_f / torch.full_like(load_f, s_f))[None, :]
            del_mask = insert[:, None] & (rnd.u_aux < p_del)
        else:
            raise ValueError(cfg.variant)
        return dup, insert, del_mask

    return decide


def sorted_enabled_positions(pos: torch.Tensor, mask: torch.Tensor,
                             sentinel: int) -> torch.Tensor:
    """(B, k) positions + enable mask -> (k, B) int64 ascending per row;
    disabled lanes carry ``sentinel`` (> any real position)."""
    p = torch.where(mask, pos.to(torch.int64), sentinel)
    return torch.sort(p.T, dim=-1).values


def load_delta_from_sorted(spi, pre_i, spd, pre_d, post_d, s: int
                           ) -> torch.Tensor:
    """Exact per-row load delta of R = (A & ~D) | I from the sorted insert /
    delete positions and their pre/post-update bits: gained = first
    inserts of clear bits; lost = first deletes of set bits that were not
    re-inserted (DESIGN §3.1)."""
    gained = (run_heads(spi) & (spi < s) & (pre_i == 0)).sum(dim=-1)
    lost = (run_heads(spd) & (spd < s) & (post_d == 0)
            & (pre_d == 1)).sum(dim=-1)
    return (gained - lost).to(torch.int32)


def make_bitset_step(cfg: DedupConfig, spec, device=None,
                     partitionable: bool = True) -> BatchedStep:
    """The bitset-family step (DESIGN §3.1/§3.8) on the plane layout:
    rsbf, bsbf, bsbfsd and rlbsbf are this function under their specs."""
    cfg = cfg.validate()
    device = resolve_device(device)
    seeds = u32.from_numpy_u32(derive_seeds(cfg.seed, cfg.k, channel=0),
                               device)
    bseeds = (u32.from_numpy_u32(derive_seeds(cfg.seed, cfg.k, channel=1),
                                 device) if cfg.block_bits else None)

    def step(state: FilterState, keys: torch.Tensor, valid: torch.Tensor):
        b = keys.shape[0]
        pos = hash_positions(keys, seeds, cfg.s, cfg.block_bits, bseeds)
        seen = intra_batch_seen(keys, valid)
        i_t = state.position + torch.arange(b, dtype=torch.int32,
                                            device=keys.device)
        rng, rnd = spec.draw(cfg, state.rng, b, partitionable)
        dup, insert, load = _fused.bitset_step(
            cfg, state.bits, pos, rnd, valid, seen, i_t, state.load)
        if cfg.debug_exact_load:
            load = popcount(state.bits)
        n_valid = valid.sum(dtype=torch.int32)
        new = FilterState(state.bits, state.position + n_valid, load, rng)
        return new, BatchResult(dup=dup, inserted=insert)

    return step


def make_templated_step(cfg: DedupConfig, spec=None, device=None,
                        partitionable: bool = True) -> BatchedStep:
    """Resolve the variant's ``SketchSpec`` and hand it to its family's
    generator — the bitset family in this slice (DESIGN §3.8)."""
    cfg = cfg.validate()
    if spec is None:
        from .sketch import get_spec
        spec = get_spec(cfg.variant)
    if spec.family != "bitset":
        raise NotImplementedError(
            f"the {spec.family} family arrives with the counter-step "
            f"kernel — ROADMAP Queue 1 item 5 and Queue 2 item 2")
    return make_bitset_step(cfg, spec, device, partitionable)


def make_batched_step(cfg: DedupConfig, device=None,
                      partitionable: bool = True) -> BatchedStep:
    """The engine's step for ``cfg`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; ``core.device``); refuses what this slice of
    the port does not run yet, naming the ROADMAP queue that brings it."""
    cfg = cfg.validate()
    device = resolve_device(device)
    if cfg.is_counter:
        raise NotImplementedError(
            f"{cfg.variant} is a counter-family sketch; it arrives with the "
            f"counter-step kernel — ROADMAP Queue 1 item 5 and Queue 2 "
            f"item 2")
    if not cfg.is_planes:
        raise NotImplementedError(
            "the dense8 layout and the sequential oracle are not ported "
            "yet — ROADMAP Queue 1 item 6; use packed=True or "
            "layout='planes'")
    if cfg.n_tenants > 1:
        raise NotImplementedError(
            "tenant fleets (n_tenants > 1) are not ported yet — ROADMAP "
            "Queue 1 item 8")
    if cfg.block_bits > 0 and device.type == "cuda":
        raise NotImplementedError(
            "the blocked layout (block_bits > 0) has no CUDA kernel yet — "
            "ROADMAP Queue 2 item 5")
    return make_templated_step(cfg, device=device,
                               partitionable=partitionable)
