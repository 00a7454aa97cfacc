"""LM training data — the port's copy of ``repro.data.lm`` (numpy only):
a synthetic corpus with learnable structure and injected duplicates.

Sequences are drawn from a fixed random bigram chain, so a ~100M model's
loss falls measurably within a few hundred steps, and a controllable
fraction of *exact duplicate documents* is injected so the dedup pipeline
has something real to remove. Record keys are FNV-1a of the token
sequence. Every array equals the reference's for the same arguments: the
same generator calls in the same order, nothing drawn another way.

The corpus holds three (vocab, vocab) float64 tables: at vocab 32000 (the
``100m`` training preset) about 8.2 GB each, and ``sample`` gathers a
(batch, vocab) row block per token. That host cost is the reference's and
is kept as it is; the trainer times it apart from the device step.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class BigramCorpus:
    def __init__(self, vocab: int, seed: int = 0, temperature: float = 1.0):
        rng = np.random.default_rng(seed)
        logits = rng.normal(size=(vocab, vocab)) * 2.0 / temperature
        self.probs = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs /= self.probs.sum(-1, keepdims=True)
        self.cum = np.cumsum(self.probs, axis=-1)
        self.vocab = vocab
        self.rng = rng

    def sample(self, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq), dtype=np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, size=batch)
        u = self.rng.random((batch, seq))
        for t in range(1, seq):
            c = self.cum[toks[:, t - 1]]
            toks[:, t] = (u[:, t:t + 1] < c).argmax(-1)
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
