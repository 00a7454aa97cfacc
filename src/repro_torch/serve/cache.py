"""Vectorized bounded response cache (FIFO / LRU) for the serving path —
the port's own copy of ``repro.serve.cache``. The reference module is numpy
only, and so is this copy: the same lookups and admits leave the same keys,
values and eviction count (``tests/test_torch_serving.py`` holds them
equal under both policies). One difference: the keys are uint64, not
uint32, so that a tenant fleet's cache identity — the tenant id beside the
whole 32-bit key (``frontend.MicroBatchExecutor.cache_keys``) — is exact.
A uint32 key takes the same place among uint64 keys as among uint32 ones.

The cache keeps its keys as ONE sorted uint64 array so a whole micro-batch
is probed in a single ``np.searchsorted`` pass, admitted in a single sorted
merge, and evicted in a single ``np.argpartition`` pass — no per-key Python
on the batch path (DESIGN.md §5.2).

Eviction policies (the ``cache_policy`` knob):

  * ``"fifo"`` (default): evict the oldest ADMITTED entry; refreshing an
    existing key's response never renews its age and never evicts.
  * ``"lru"``: batch-granular recency — every probe hit and every admit
    stamps the entry with the current batch clock, so hot keys survive a
    zipf stream that would cycle them out of a FIFO cache.

Recency/age is batch-granular (one clock tick per lookup/admit call): ties
within one batch are broken arbitrarily, which is what keeps every pass
vectorized.

The mapping dunders (``len``/``iter``/``in``/``[]``) expose the cache as a
read-mostly dict of ``{integer key -> response}``; the batch path never
uses them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def _as_object_array(values: Sequence) -> np.ndarray:
    """(m,) object ndarray of per-key responses. Elementwise assignment —
    responses are often themselves equal-shaped ndarrays, which a plain
    ``np.asarray(..., object)`` would try to stack into a 2-D array."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


class ResponseCache:
    """Sorted-array response cache: one numpy pass per batch operation."""

    def __init__(self, capacity: int, policy: str = "fifo"):
        if policy not in ("fifo", "lru"):
            raise ValueError(f"cache_policy {policy!r}; one of ('fifo', 'lru')")
        self.capacity = int(capacity)
        self.policy = policy
        self._keys = np.empty(0, np.uint64)      # sorted — the probe index
        self._seq = np.empty(0, np.int64)        # admit (FIFO) / touch (LRU)
        self._vals = np.empty(0, object)         # aligned responses
        self._clock = 0                          # batch-granular tick
        self.n_evicted = 0

    # ------------------------------------------------------- batch path //
    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One-pass probe: ``(hit (B,) bool, values (B,) object)`` — values
        defined where hit. LRU stamps every hit with the current tick."""
        keys = np.asarray(keys, np.uint64)
        self._clock += 1
        vals = np.empty(keys.shape[0], dtype=object)
        if self._keys.size == 0:
            return np.zeros(keys.shape[0], bool), vals
        pos = np.searchsorted(self._keys, keys)
        pos = np.minimum(pos, self._keys.size - 1)
        hit = self._keys[pos] == keys
        vals[hit] = self._vals[pos[hit]]
        if self.policy == "lru" and hit.any():
            self._seq[pos[hit]] = self._clock
        return hit, vals

    def admit(self, keys: np.ndarray, values: Sequence) -> None:
        """Batch insert (sorted merge), then one argpartition eviction pass
        if over capacity. Within-batch duplicate keys keep the LAST value;
        refreshing an existing key updates its response in place (renewing
        its age under LRU only) and can never evict."""
        if self.capacity <= 0 or len(values) == 0:
            return
        keys = np.asarray(keys, np.uint64)
        self._clock += 1
        vals = _as_object_array(values)
        # unique keep-LAST: reverse before unique (which keeps first)
        uk, rev_idx = np.unique(keys[::-1], return_index=True)
        uvals = vals[::-1][rev_idx]
        if self._keys.size:
            pos = np.minimum(np.searchsorted(self._keys, uk),
                             self._keys.size - 1)
            exists = self._keys[pos] == uk
        else:
            pos = np.zeros(uk.shape[0], np.int64)
            exists = np.zeros(uk.shape[0], bool)
        if exists.any():
            self._vals[pos[exists]] = uvals[exists]
            if self.policy == "lru":
                self._seq[pos[exists]] = self._clock
        new_k, new_v = uk[~exists], uvals[~exists]
        if new_k.size:
            ins = np.searchsorted(self._keys, new_k)
            self._keys = np.insert(self._keys, ins, new_k)
            self._seq = np.insert(self._seq, ins, self._clock)
            merged = np.empty(self._vals.size + new_v.size, dtype=object)
            take_new = np.zeros(merged.size, bool)
            take_new[ins + np.arange(new_v.size)] = True
            merged[take_new] = new_v
            merged[~take_new] = self._vals
            self._vals = merged
        over = self._keys.size - self.capacity
        if over > 0:
            drop = np.argpartition(self._seq, over - 1)[:over]
            keep = np.ones(self._keys.size, bool)
            keep[drop] = False
            self._keys = self._keys[keep]       # mask keeps the sort order
            self._seq = self._seq[keep]
            self._vals = self._vals[keep]
            self.n_evicted += over

    # ----------------------------------------------- mapping interface //
    def get(self, key: int, default=None):
        hit, vals = self.lookup(np.asarray([key], np.uint64))
        return vals[0] if hit[0] else default

    def __getitem__(self, key: int):
        _MISSING = object()
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __setitem__(self, key: int, value) -> None:
        self.admit(np.asarray([key], np.uint64), [value])

    def __contains__(self, key: int) -> bool:
        hit, _ = self.lookup(np.asarray([key], np.uint64))
        return bool(hit[0])

    def __len__(self) -> int:
        return int(self._keys.size)

    def __iter__(self) -> Iterator[int]:
        return iter(int(k) for k in self._keys)
