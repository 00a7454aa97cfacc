"""LM training data — the port's copy of ``repro.data.lm`` (numpy only):
a synthetic corpus with learnable structure and injected duplicates.

Sequences are drawn from a fixed random bigram chain, so a ~100M model's
loss falls measurably within a few hundred steps, and a controllable
fraction of *exact duplicate documents* is injected so the dedup pipeline
has something real to remove. Record keys are FNV-1a of the token
sequence. Every array equals the reference's for the same arguments: the
same generator calls in the same order, nothing drawn another way.

The corpus holds two (vocab, vocab) float64 tables, ``probs`` and
``cum``: at vocab 32000 (the ``100m`` training preset) about 8.2 GB each
(the reference holds a third, its logits, while it builds them). Its init
derives them by blocks of rows on a thread pool, and ``sample`` reads one
row per token with a binary search where the reference gathers a (batch,
vocab) row block per token: the same tables and tokens, at a fraction of
the host time. The trainer times the draw apart from the device step.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


ROWS_PER_TASK = 64          # rows of the tables one init task derives


class BigramCorpus:
    def __init__(self, vocab: int, seed: int = 0, temperature: float = 1.0):
        """The reference's tables, value for value: one draw of the
        (vocab, vocab) logits, then each row's ``exp(logits - max)``
        normalised and its cumulative sum, in place and by blocks of rows
        on a thread pool (numpy's row-wise reductions give the same bits
        on a block as on the whole table; the ufuncs release the GIL)."""
        rng = np.random.default_rng(seed)
        self.probs = rng.normal(size=(vocab, vocab))
        self.cum = np.empty_like(self.probs)

        def rows(lo: int) -> None:
            p = self.probs[lo:lo + ROWS_PER_TASK]
            p *= 2.0
            p /= temperature
            p -= p.max(-1, keepdims=True)
            np.exp(p, out=p)
            p /= p.sum(-1, keepdims=True)
            np.cumsum(p, axis=-1, out=self.cum[lo:lo + ROWS_PER_TASK])

        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            list(pool.map(rows, range(0, vocab, ROWS_PER_TASK)))
        self.vocab = vocab
        self.rng = rng

    def sample(self, batch: int, seq: int) -> np.ndarray:
        """The reference's draws and tokens: each next token is the first
        index whose cumulative probability exceeds the uniform draw
        (``(u < cum[prev]).argmax()``, 0 where none does). A cumulative
        row never decreases, so that index is ``searchsorted(cum[prev], u,
        "right")``: one binary search per token, not a (batch, vocab)
        row gather and compare."""
        toks = np.empty((batch, seq), dtype=np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, size=batch)
        u = self.rng.random((batch, seq))
        for b in range(batch):
            row, ub, prev = toks[b], u[b], int(toks[b, 0])
            for t in range(1, seq):
                k = int(np.searchsorted(self.cum[prev], ub[t], side="right"))
                prev = 0 if k == self.vocab else k
                row[t] = prev
        return toks


def seq_keys(tokens: np.ndarray) -> np.ndarray:
    """uint32 record key per sequence (FNV-1a over the token bytes)."""
    b = np.ascontiguousarray(tokens.astype(np.int32))
    h = np.full(b.shape[0], 0x811C9DC5, dtype=np.uint64)
    for col in range(b.shape[1]):
        h = (h ^ b[:, col].astype(np.uint64)) * 0x01000193
        h &= 0xFFFFFFFF
    return h.astype(np.uint32)


def lm_batches(vocab: int, batch: int, seq: int, dup_frac: float = 0.3,
               seed: int = 0) -> Iterator[dict]:
    """Yields {"tokens": (B, S+1) int32, "key": (B,) uint32} with dup_frac of
    each batch replaced by replays of previously emitted sequences."""
    corpus = BigramCorpus(vocab, seed)
    rng = np.random.default_rng(seed + 1)
    seen: list[np.ndarray] = []
    while True:
        toks = corpus.sample(batch, seq + 1)
        if seen and dup_frac > 0:
            n_dup = int(batch * dup_frac)
            pool = np.concatenate(seen[-8:], axis=0)
            idx = rng.integers(0, pool.shape[0], size=n_dup)
            toks[:n_dup] = pool[idx]
            perm = rng.permutation(batch)
            toks = toks[perm]
        seen.append(toks.copy())
        yield {"tokens": toks, "key": seq_keys(toks)}
