"""Filter state — the port of ``repro.core.state`` for the plane layout at
d = 1 (DESIGN §3.6), the only layout this slice of the port runs.

``bits`` is the (k, W) filter: k rows of W = ceil(s/32) words, 32 bits per
word, bit j of word w holding position 32·w + j — bit for bit the JAX
package's packed layout. Like every uint32 array of the port it is an
int32 tensor holding the uint32 bit pattern (``core.u32``), so
``repro_torch.convert.state_to_numpy`` returns the same bytes as
``np.asarray(state.bits)`` in JAX.

``position`` is the 1-indexed stream position ``i`` of the next element
(RSBF's insert probability is s/i), ``load`` the exact per-row count of set
bits (DESIGN §3.1), and ``rng`` the (2,) threefry key data — the explicit
generator of the randomized deletions (``core.prng``). All four live on the
engine's device, so a stream of steps never waits on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import prng
from .config import DedupConfig
from .device import resolve_device


class FilterState(NamedTuple):
    bits: torch.Tensor       # (k, W) int32 words
    position: torch.Tensor   # () int32 — 1-indexed next stream position
    load: torch.Tensor       # (k,) int32 — set bits per row
    rng: torch.Tensor        # (2,) int32 — threefry key data


def init_state(cfg: DedupConfig, seed: int | None = None,
               device=None) -> FilterState:
    """An empty filter on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``; ``core.device``)."""
    cfg.validate()
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    return FilterState(
        bits=torch.zeros((cfg.n_rows, cfg.s_words), dtype=torch.int32,
                         device=device),
        position=torch.ones((), dtype=torch.int32, device=device),
        load=torch.zeros((cfg.n_rows,), dtype=torch.int32, device=device),
        rng=prng.PRNGKey(seed, device=device),
    )


def state_memory_bytes(state: FilterState) -> int:
    return sum(x.numel() * x.element_size() for x in state)
