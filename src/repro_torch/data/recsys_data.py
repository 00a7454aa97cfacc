"""RecSys data of the port — its own numpy copy of
``repro.data.recsys_data``, so the same seed gives the same arrays bit for
bit: CTR batches with a planted logistic model + hot-id skew.

Zipf-distributed sparse ids make intra-batch duplicate ids realistic (the
dedup_gather optimization's target), and fraud-style repeated click records
exercise the DedupPipeline exactly as the paper's §1 click-fraud application
describes. Labels follow a planted (random) logistic model over embedding
sums so training measurably learns.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class CTRStream:
    def __init__(self, n_dense: int, vocab_sizes: Sequence[int],
                 multi_hot: int = 1, zipf_a: float = 1.3,
                 dup_frac: float = 0.1, seed: int = 0):
        self.n_dense = n_dense
        self.vocab_sizes = list(vocab_sizes)
        self.multi_hot = multi_hot
        self.zipf_a = zipf_a
        self.dup_frac = dup_frac
        self.rng = np.random.default_rng(seed)
        # planted model: per-field id weight via hashing + dense weights
        self.w_dense = self.rng.normal(size=n_dense) * 0.3
        self._prev: list[dict] = []

    def _ids(self, batch: int) -> np.ndarray:
        F = len(self.vocab_sizes)
        cols = []
        for v in self.vocab_sizes:
            r = np.minimum(self.rng.zipf(self.zipf_a, size=(batch, self.multi_hot)), v) - 1
            cols.append(r)
        ids = np.stack(cols, axis=1).astype(np.int32)     # (B, F, nnz)
        return ids[..., 0] if self.multi_hot == 1 else ids

    def batch(self, batch: int) -> dict:
        dense = self.rng.normal(size=(batch, self.n_dense)).astype(np.float32)
        ids = self._ids(batch)
        flat = ids.reshape(batch, -1)
        id_sig = ((flat.astype(np.uint64) * 2654435761) & 0xFFFFFFFF
                  ).sum(axis=1)
        logit = dense @ self.w_dense + np.sin(id_sig % 97 / 97.0 * 6.28) * 1.5
        labels = (self.rng.random(batch) <
                  1 / (1 + np.exp(-logit))).astype(np.float32)
        key = ((id_sig * 0x9E3779B9) & 0xFFFFFFFF).astype(np.uint32)
        rec = {"dense": dense, "sparse_ids": ids, "labels": labels,
               "key": key}
        # inject replayed (fraud) records from recent batches
        if self._prev and self.dup_frac > 0:
            n_dup = int(batch * self.dup_frac)
            if n_dup:
                pool = self._prev[-1]
                take = self.rng.integers(0, pool["dense"].shape[0], n_dup)
                for f in ("dense", "sparse_ids", "labels", "key"):
                    rec[f][:n_dup] = pool[f][take]
        self._prev.append({k: v.copy() for k, v in rec.items()})
        self._prev = self._prev[-4:]
        return rec

    def stream(self, batch: int) -> Iterator[dict]:
        while True:
            yield self.batch(batch)


def candidates_matrix(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)
