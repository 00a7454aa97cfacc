"""Synthetic key streams matching the paper's experimental setup (Section
6) — the port's own copy of ``repro.data.streams``, function for function.
The reference module is numpy only, and so is this copy: the same seed
gives the same stream exactly (``tests/test_torch_pipeline.py`` holds
them equal).

  * ``controlled_distinct_stream`` — EXACTLY the target distinct fraction,
    with exact ground truth as a by-product;
  * ``zipf_stream`` — skewed key popularity (clickstream-like);
  * ``zipf_range_stream`` — the same Zipf popularity with an
    order-preserving key map, so the skew shows as key-range density
    (DESIGN §4.4);
  * ``clickstream`` — sessionized zipf traffic with fraud-style duplicate
    bursts (the paper's §1 click-fraud application), its truth from the
    (user, item) pairs (``pair_truth``, ``key_collision_count``);
  * ``batched`` — a stream cut into batches.
"""

from __future__ import annotations

from typing import Iterator, Tuple

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


def zipf_range_stream(n: int, universe: int, a: float = 1.2, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Zipf(a) stream whose key map PRESERVES rank order: rank r becomes
    ``r * floor(2^32/universe)``, spreading the universe linearly over the
    uint32 key space. Low ranks are both the hottest AND (in any finite
    stream) the most densely *observed* ids, so contiguous key ranges carry
    wildly uneven distinct-key load — exactly the skew a range-partitioned
    router must rebalance (DESIGN §4.4). ``zipf_stream`` deliberately
    scrambles this locality with a multiplicative hash; this generator
    deliberately keeps it."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(a, size=n), universe) - 1
    stride = np.uint64((1 << 32) // universe)
    keys = ((ranks.astype(np.uint64) * stride) & np.uint64(0xFFFFFFFF)
            ).astype(np.uint32)
    _, first = np.unique(keys, return_index=True)
    truth = np.ones(n, bool)
    truth[first] = False
    return keys, truth


def pair_truth(users: np.ndarray, items: np.ndarray) -> np.ndarray:
    """Exact per-click ground truth from the (user, item) pairs THEMSELVES:
    True where the same pair occurred earlier. The 32-bit probe ``key`` is a
    lossy hash — deriving truth from it silently records a key collision
    between two distinct clicks as a true duplicate, corrupting FPR/FNR."""
    pairs = ((users.astype(np.uint64) << np.uint64(32))
             | items.astype(np.uint64))
    _, first = np.unique(pairs, return_index=True)
    truth = np.ones(pairs.size, bool)
    truth[first] = False
    return truth


def key_collision_count(users: np.ndarray, items: np.ndarray,
                        key: np.ndarray) -> int:
    """Number of extra distinct (user, item) pairs whose 32-bit key collides
    with another pair's — the ground-truth error the hashed key would have
    introduced (0 means key-derived truth happens to be exact)."""
    pairs = ((users.astype(np.uint64) << np.uint64(32))
             | items.astype(np.uint64))
    return int(np.unique(pairs).size - np.unique(key).size)


def clickstream(n: int, n_users: int = 10_000, n_items: int = 50_000,
                fraud_frac: float = 0.05, burst: int = 20, seed: int = 0):
    """Click records (user, item) with fraudulent duplicate bursts.

    -> (dict of arrays {user, item, key}, truth_dup, key_collisions). A
    fraud burst repeats one (user, item) click ``burst`` times — the
    paper's §1 detection target. ``truth_dup`` is derived from the
    (user, item) pairs (``pair_truth``) — NOT from the 32-bit probe key,
    whose collisions would corrupt the ground truth; ``key_collisions``
    reports how many distinct pairs the hashed key would have conflated
    (kept OUT of the record dict, whose values are per-record columns that
    consumers slice row-wise).
    """
    rng = np.random.default_rng(seed)
    n_bursts = max(1, int(n * fraud_frac / burst))
    n_organic = n - n_bursts * burst
    users = rng.integers(0, n_users, size=n_organic).astype(np.uint32)
    items = (np.minimum(rng.zipf(1.2, size=n_organic), n_items) - 1
             ).astype(np.uint32)
    # interleave fraud bursts
    bu = rng.integers(0, n_users, size=n_bursts).astype(np.uint32)
    bi = rng.integers(0, n_items, size=n_bursts).astype(np.uint32)
    users = np.concatenate([users] + [np.full(burst, u, np.uint32) for u in bu])
    items = np.concatenate([items] + [np.full(burst, i, np.uint32) for i in bi])
    perm = rng.permutation(users.size)
    users, items = users[perm], items[perm]
    key = ((users.astype(np.uint64) << 17) ^ items.astype(np.uint64))
    key = ((key * 0x9E3779B97F4A7C15) >> 32).astype(np.uint32)
    truth = pair_truth(users, items)
    return ({"user": users, "item": items, "key": key}, truth,
            key_collision_count(users, items, key))


def batched(keys: np.ndarray, batch: int) -> Iterator[np.ndarray]:
    for i in range(0, len(keys), batch):
        yield keys[i:i + batch]
