"""Per-element (sequential) step functions — the oracle semantics, the port
of ``repro.core.variants``.

These follow the paper's pseudocode element at a time, including the
set/reset order inside each algorithm:

  * Algorithm 1 (RSBF):   phase 1 insert-all; phase 2 set-then-reset with
                          insert probability s/i; phase 3 reset-then-set
                          gated on the probed bit being 0.
  * Algorithm 2 (BSBF):   reset k random bits (one per filter) then set H.
  * Algorithm 3 (BSBFSD): reset 1 random bit in 1 random filter then set H.
  * Algorithm 4 (RLBSBF): per filter reset a random bit w.p. load/s, then
                          set H.
  * SBF (Deng & Rafiei):  probe K cells; decrement a contiguous run of P
                          cells from a random offset; set own K cells to
                          Max.

``core.engine.Dedup.run_stream_oracle`` loops this step over a stream on
the dense8 layout, as the reference scans it: the bit-exact reference the
batched paths are held against. The randomness is split per element from
the state's threefry key (``core.prng``), in the reference's order, so at
a batch of one the batched sbf step draws the same. Loads are exact: the
1-bit variants track them incrementally, sbf recounts its cells.

Each element touches at most two cells per row — its probe cell and its
deletion candidate — so both of RSBF's orders are evaluated on those two
cells and the one the phase picks is written, with no host decision and no
copy of the filter. The oracle updates ``state.bits`` in place; the engine
hands it a copy.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from . import prng
from .config import DedupConfig
from .batched import _seeds
from .hashing import hash_positions
from .state import FilterState

Step = Callable[[FilterState, torch.Tensor], Tuple[FilterState, torch.Tensor]]


def _write_two(bits, rows, pos, del_pos, final_p, final_d) -> None:
    """Write each row's probe cell and deletion cell. Where they are the
    same cell both values agree (the callers' formulas), so the write is
    deterministic."""
    bits.index_put_((torch.cat([rows, rows]), torch.cat([pos, del_pos])),
                    torch.cat([final_p, final_d]).to(torch.uint8))


def make_scan_step(cfg: DedupConfig, partitionable: bool = True) -> Step:
    """step(state, key) -> (state, dup): one element of the paper-order
    oracle on a dense8 state (bits (k, s) uint8, or (1, s) cells for sbf);
    ``key`` a 0-dim int32 word. ``partitionable`` picks JAX's threefry
    counter layout (``core.prng``)."""
    cfg = cfg.validate()
    if cfg.effective_layout != "dense8":
        raise ValueError("scan oracle runs on the dense8 layout")
    seeds, bseeds = _seeds(cfg)
    s, k, part = cfg.s, cfg.k, partitionable
    s_f = float(np.float32(s))

    def positions(key):
        return hash_positions(key, seeds, s, cfg.block_bits, bseeds)  # (k,)

    if cfg.variant == "sbf":
        p_run, cmax = cfg.sbf_p_effective, cfg.sbf_max
        np.uint8(cmax)

        def step(state: FilterState, key: torch.Tensor):
            dev = key.device
            cells = state.bits[0]
            pos = positions(key)
            dup = (cells[pos] > 0).all()
            keys = prng.split(state.rng, 2, part)
            rng, r = keys[0], keys[1]
            start = prng.randint(r, (), 0, s, part)
            run = (start.to(torch.int64)
                   + torch.arange(p_run, device=dev)) % s
            # a run longer than s repeats cells: each copy writes the same
            # value, the snapshot's minus one
            cells[run] = torch.clamp(cells[run].to(torch.int32) - 1,
                                     min=0).to(torch.uint8)
            cells[pos.to(torch.int64)] = cmax
            load = torch.count_nonzero(cells).to(torch.int32).reshape(1)
            return FilterState(state.bits, state.position + 1, load,
                               rng), dup

        return step

    rows = torch.arange(k)

    def probe(bits, r, p):
        return bits[r, p].to(torch.int32)                   # (k,) in {0, 1}

    if cfg.variant == "rsbf":
        p_star = float(np.float32(cfg.p_star))

        def step(state: FilterState, key: torch.Tensor):
            dev = key.device
            bits = state.bits
            r = rows.to(dev)
            pos = positions(key).to(torch.int64)
            vals = probe(bits, r, pos)
            dup = (vals == 1).all()
            distinct = ~dup
            i = state.position
            keys = prng.split(state.rng, 4, part)
            rng, r_ins, r_del, r_pick = (keys[j] for j in range(4))
            i_f = i.to(torch.float32)
            p_ins = torch.full_like(i_f, s_f) / i_f
            ph1 = i <= s
            ph3 = p_ins <= p_star
            bern = prng.uniform(r_ins, (), part) < p_ins
            insert = torch.where(ph1, True,
                                 torch.where(ph3, distinct, distinct & bern))
            if cfg.delete_set_bits_only:
                # phase-3 pseudocode: "find a bit which is set to 1, reset
                # it" — a weighted choice over each row's set bits
                u = prng.uniform(r_pick, (k,), part)
                csum = torch.cumsum(bits.to(torch.float32), dim=1)
                tgt = u[:, None] * csum[:, -1:]
                del_pos = (csum >= tgt).to(torch.uint8).argmax(dim=1)
            else:
                del_pos = prng.randint(r_del, (k,), 0, s, part).to(
                    torch.int64)
            ph2_del = (~ph1) & (~ph3) & insert
            ph3_del = ph3 & insert & (vals == 0)
            x = torch.where(ph3, ph3_del, ph2_del.expand(k))   # do_del
            ins = insert.expand(k)
            old_p, old_d = vals, probe(bits, r, del_pos)
            same = del_pos == pos
            # phase 2 sets H then resets; phase 3 (and phase 1, which
            # deletes nothing) resets then sets
            use3 = ph3 | ph1
            p2 = torch.where(x & same, 0, torch.where(ins, 1, old_p))
            d2 = torch.where(x, 0, torch.where(ins & same, 1, old_d))
            p3 = torch.where(ins, 1, torch.where(x & same, 0, old_p))
            d3 = torch.where(ins & same, 1, torch.where(x, 0, old_d))
            # the exact load delta of each order, as the reference computes
            # it
            pre2 = torch.where(ins & same, 1, old_d)
            after_del3 = torch.where(x & same, 0, old_p)
            ins_i, x_i = ins.to(torch.int32), x.to(torch.int32)
            dl2 = ins_i * (1 - old_p) - x_i * pre2
            dl3 = ins_i * (1 - after_del3) - x_i * old_d
            _write_two(bits, r, pos, del_pos, torch.where(use3, p3, p2),
                       torch.where(use3, d3, d2))
            load = state.load + torch.where(use3, dl3, dl2)
            return FilterState(bits, i + 1, load, rng), dup

        return step

    if cfg.variant in ("bsbf", "bsbfsd", "rlbsbf"):

        def step(state: FilterState, key: torch.Tensor):
            dev = key.device
            bits = state.bits
            r = rows.to(dev)
            pos = positions(key).to(torch.int64)
            vals = probe(bits, r, pos)
            dup = (vals == 1).all()
            distinct = ~dup
            keys = prng.split(state.rng, 3, part)
            rng, r_del, r_aux = keys[0], keys[1], keys[2]
            del_pos = prng.randint(r_del, (k,), 0, s, part).to(torch.int64)
            if cfg.variant == "bsbf":
                x = distinct.expand(k)
            elif cfg.variant == "bsbfsd":
                which = prng.randint(r_aux, (), 0, k, part)
                x = distinct & (r == which)
            else:  # rlbsbf
                u = prng.uniform(r_aux, (k,), part)
                load_f = state.load.to(torch.float32)
                x = distinct & (u < load_f / torch.full_like(load_f, s_f))
            ins = distinct.expand(k)
            # Algorithms 2-4: reset first, then set H
            old_d = probe(bits, r, del_pos)
            same = del_pos == pos
            set_pre = torch.where(x & same, 0, vals)
            _write_two(bits, r, pos, del_pos,
                       torch.where(ins, 1, set_pre),
                       torch.where(ins & same, 1, torch.where(x, 0, old_d)))
            load = (state.load + ins.to(torch.int32) * (1 - set_pre)
                    - x.to(torch.int32) * old_d)
            return FilterState(bits, state.position + 1, load, rng), dup

        return step

    raise ValueError(cfg.variant)
