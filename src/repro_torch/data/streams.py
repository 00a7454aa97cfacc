"""Synthetic key streams matching the paper's experimental setup (Section
6) — the port's own copy of the generators it drives (numpy only, so the
same seed gives the JAX package's stream exactly).

  * ``controlled_distinct_stream`` — EXACTLY the target distinct fraction,
    with exact ground truth as a by-product;
  * ``zipf_stream`` — skewed key popularity (clickstream-like).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _fresh_ids(n: int, rng: np.random.Generator) -> np.ndarray:
    """n unique uint32 ids (random bijection slice)."""
    pool = rng.integers(0, 2 ** 32, size=int(n * 1.3) + 16, dtype=np.uint64)
    uniq = np.unique(pool)
    while uniq.size < n:
        extra = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64)
        uniq = np.unique(np.concatenate([uniq, extra]))
    out = uniq[rng.permutation(uniq.size)[:n]]
    return out.astype(np.uint32)


def controlled_distinct_stream(n: int, distinct_frac: float, seed: int = 0
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (keys (n,) uint32, truth_dup (n,) bool) with exactly
    round(n*distinct_frac) distinct elements (first element always new)."""
    rng = np.random.default_rng(seed)
    d = max(1, int(round(n * distinct_frac)))
    new_mask = np.zeros(n, dtype=bool)
    pos = rng.choice(n - 1, size=d - 1, replace=False) + 1 if d > 1 else []
    new_mask[0] = True
    new_mask[pos] = True
    fresh = _fresh_ids(d, rng)
    new_count = np.cumsum(new_mask)
    keys = np.empty(n, dtype=np.uint32)
    keys[new_mask] = fresh
    dup_pos = ~new_mask
    # duplicates re-draw uniformly from the prefix of already-emitted ids
    draw = (rng.random(dup_pos.sum()) * new_count[dup_pos]).astype(np.int64)
    keys[dup_pos] = fresh[draw]
    return keys, ~new_mask


def zipf_stream(n: int, universe: int, a: float = 1.3, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Skewed stream: key ranks ~ Zipf(a) clipped to the universe."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(a, size=n)
    ranks = np.minimum(ranks, universe) - 1
    keys = ((ranks.astype(np.uint64) * 0x9E3779B9) & 0xFFFFFFFF).astype(
        np.uint32)
    _, first = np.unique(keys, return_index=True)
    truth = np.ones(n, bool)
    truth[first] = False
    return keys, truth
