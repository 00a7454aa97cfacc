"""Sketch specifications — the port of ``repro.core.sketch`` (DESIGN §3.8).

A ``SketchSpec`` names the ops that distinguish the stream sketches: probe
op, decision fn, event builder and randomness draw, plus the structural
flags the step generator and the fused counter step read. Two families:

* ``bitset`` — k independent 1-bit rows, update R = (A & ~D) | I (rsbf,
  bsbf, bsbfsd, rlbsbf; arXiv:1212.3964 §4);
* ``counter`` — d bit-planes of one row of d-bit saturating cells, update
  subtract then set or add (sbf §5, swbf DESIGN §3.7, cms/hh §3.8).

Each family shares one step and one kernel; a sketch is a row of the table
below.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .batched import (CounterStepDeltas, count_event_deltas, draw_randomness,
                      draw_sbf_randomness, make_decision_fn,
                      ring_expire_planes, sbf_event_deltas)
from .config import DedupConfig


@dataclass(frozen=True)
class SketchSpec:
    """One sketch = one row of this table.

    make_decide(cfg) -> decide:
      bitset family: decide(vals, valid, seen, i_t, load, rnd)
                       -> (dup, insert, del_mask)     [``make_decision_fn``]
      counter family: decide(vals, valid, seen) -> dup — ``vals`` (B, k)
        bool for probe="nonzero", int32 cell values for probe="value"; a
        thresholded sketch's decide also takes ``t=``, the count threshold
        (default ``cfg.count_threshold``; a fleet passes a tenant's).
    draw(cfg, rng, b, partitionable) -> (rng, rnd), or None when the sketch
      is deterministic (the rng then threads through untouched).
    make_events(cfg) -> events(state, pos, valid, rnd, build_planes=True)
      -> CounterStepDeltas (counter family only).
    """
    name: str
    family: str                  # "bitset" | "counter"
    probe: str                   # "bits" | "nonzero" | "value"
    uses_seen: bool              # intra-batch first-occurrence join needed?
    windowed: bool               # consumes/pushes the WindowRing?
    combine: str                 # insert op: "ornot" | "add" | "set"
    has_sub: bool                # has a subtract (decay/expiry) operand?
    make_decide: Callable[[DedupConfig], Callable]
    draw: Optional[Callable]
    make_events: Optional[Callable[[DedupConfig], Callable]] = None
    thresholded: bool = False    # decide takes a ``t=`` count threshold


# ---------------- counter-family decision fns ---------------------------- //
# ``vals != 0`` reads bool probe bits and int32 cell values alike.

def _decide_sbf(cfg: DedupConfig):
    def decide(vals, valid, seen):
        return (vals != 0).all(dim=-1) & valid
    return decide


def _decide_swbf(cfg: DedupConfig):
    def decide(vals, valid, seen):
        return ((vals != 0).all(dim=-1) | seen) & valid
    return decide


def _decide_cms(cfg: DedupConfig):
    t0 = cfg.count_threshold

    def decide(vals, valid, seen, t=t0):
        # count-min estimate >= threshold; at t == 1 this is counting-Bloom
        # membership (all k cells nonzero). ``t`` may be a 0-dim tensor (a
        # tenant's threshold)
        return ((vals.min(dim=-1).values >= t) | seen) & valid
    return decide


def _decide_hh(cfg: DedupConfig):
    t0 = cfg.count_threshold

    def decide(vals, valid, seen, t=t0):
        # heavy-hitter flag: long-run frequency only, so no ``seen`` join
        return (vals.min(dim=-1).values >= t) & valid
    return decide


# ---------------- counter-family event builders -------------------------- //

def _events_sbf(cfg: DedupConfig):
    def events(state, pos, valid, rnd,
               build_planes=True) -> CounterStepDeltas:
        ev = sbf_event_deltas(cfg, pos, rnd, valid, build_planes)
        return CounterStepDeltas(
            sub_planes=ev.count_planes, sub_events=ev.dec_sorted,
            sub_heads=ev.dec_head, add_planes=None, set_delta=ev.set_delta,
            ins_events=ev.set_sorted, ins_heads=ev.set_head,
            ring_payload=None)
    return events


def _events_swbf(cfg: DedupConfig):
    def events(state, pos, valid, rnd,
               build_planes=True) -> CounterStepDeltas:
        ev = count_event_deltas(cfg, pos, valid,
                                state.ring.events.shape[-1], build_planes)
        exp_events, exp_heads, expire = ring_expire_planes(
            cfg, state.ring, build_planes)
        return CounterStepDeltas(
            sub_planes=expire, sub_events=exp_events, sub_heads=exp_heads,
            add_planes=ev.count_planes, set_delta=None,
            ins_events=ev.ins_sorted, ins_heads=ev.ins_head,
            ring_payload=ev)
    return events


def _events_count(cfg: DedupConfig):
    def events(state, pos, valid, rnd,
               build_planes=True) -> CounterStepDeltas:
        # no decay, no window: arrivals only increment (clamped at the cap)
        ev = count_event_deltas(cfg, pos, valid, pos.shape[-2] * cfg.k,
                                build_planes)
        return CounterStepDeltas(
            sub_planes=None, sub_events=None, sub_heads=None,
            add_planes=ev.count_planes, set_delta=None,
            ins_events=ev.ins_sorted, ins_heads=ev.ins_head,
            ring_payload=None)
    return events


# ---------------- the registry ------------------------------------------- //

def _bitset(name: str) -> SketchSpec:
    return SketchSpec(name=name, family="bitset", probe="bits",
                      uses_seen=True, windowed=False, combine="ornot",
                      has_sub=True, make_decide=make_decision_fn,
                      draw=draw_randomness)


SKETCHES = {
    "rsbf": _bitset("rsbf"),
    "bsbf": _bitset("bsbf"),
    "bsbfsd": _bitset("bsbfsd"),
    "rlbsbf": _bitset("rlbsbf"),
    "sbf": SketchSpec(name="sbf", family="counter", probe="nonzero",
                      uses_seen=False, windowed=False, combine="set",
                      has_sub=True, make_decide=_decide_sbf,
                      draw=draw_sbf_randomness, make_events=_events_sbf),
    "swbf": SketchSpec(name="swbf", family="counter", probe="nonzero",
                       uses_seen=True, windowed=True, combine="add",
                       has_sub=True, make_decide=_decide_swbf,
                       draw=None, make_events=_events_swbf),
    "cms": SketchSpec(name="cms", family="counter", probe="value",
                      uses_seen=True, windowed=False, combine="add",
                      has_sub=False, make_decide=_decide_cms,
                      draw=None, make_events=_events_count,
                      thresholded=True),
    "hh": SketchSpec(name="hh", family="counter", probe="value",
                     uses_seen=False, windowed=False, combine="add",
                     has_sub=False, make_decide=_decide_hh,
                     draw=None, make_events=_events_count,
                     thresholded=True),
}


def get_spec(variant: str) -> SketchSpec:
    """The variant's registered ``SketchSpec``."""
    try:
        return SKETCHES[variant]
    except KeyError:
        raise ValueError(
            f"no sketch spec registered for variant {variant!r} — "
            f"known: {sorted(SKETCHES)}") from None
