"""Sketch specifications — the port of ``repro.core.sketch`` (DESIGN §3.8),
bitset rows only.

A ``SketchSpec`` names the ops that distinguish the stream sketches: the
decision fn and the randomness draw, under a family the step generator
dispatches on. The paper's four algorithms are one family (``bitset``:
k 1-bit rows, update R = (A & ~D) | I) and differ only in the decision
fn's variant switch, so they share one step and one kernel. The counter
family (sbf, swbf, cms, hh) arrives with the counter-step kernel
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .batched import draw_randomness, make_decision_fn
from .config import DedupConfig


@dataclass(frozen=True)
class SketchSpec:
    """One sketch = one row of the registry. The JAX package's spec also
    carries the counter family's probe, event and windowing flags; they
    arrive with that family."""
    name: str
    family: str                  # "bitset" | "counter"
    make_decide: Callable[[DedupConfig], Callable]
    draw: Optional[Callable]     # (cfg, rng, b, partitionable) -> (rng, rnd)


def _bitset(name: str) -> SketchSpec:
    return SketchSpec(name=name, family="bitset",
                      make_decide=make_decision_fn, draw=draw_randomness)


SKETCHES = {
    "rsbf": _bitset("rsbf"),
    "bsbf": _bitset("bsbf"),
    "bsbfsd": _bitset("bsbfsd"),
    "rlbsbf": _bitset("rlbsbf"),
}


def get_spec(variant: str) -> SketchSpec:
    """The variant's registered ``SketchSpec``."""
    try:
        return SKETCHES[variant]
    except KeyError:
        raise ValueError(
            f"no sketch spec registered for variant {variant!r} — "
            f"known: {sorted(SKETCHES)}") from None
