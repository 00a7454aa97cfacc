"""The port's LM corpus (``repro_torch.data.lm``, numpy only) against
``repro.data.lm``: the same arrays, exactly, for the same arguments; and
the reference's two data tests mirrored on the port."""

import numpy as np
import pytest

from repro.data import lm as jlm
from repro_torch.data import lm as tlm
from repro_torch.data.lm import BigramCorpus, lm_batches, seq_keys


@pytest.mark.parametrize("vocab, seed", ((32, 0), (512, 3)))
def test_bigram_corpus_and_keys_equal_reference(vocab, seed):
    a, b = jlm.BigramCorpus(vocab, seed), tlm.BigramCorpus(vocab, seed)
    assert np.array_equal(a.probs, b.probs)
    assert np.array_equal(a.cum, b.cum)
    ta, tb = a.sample(6, 40), b.sample(6, 40)
    assert tb.dtype == np.int32 and np.array_equal(ta, tb)
    assert np.array_equal(jlm.seq_keys(ta), tlm.seq_keys(tb))
    assert tlm.seq_keys(tb).dtype == np.uint32


def test_sample_where_no_cumulative_exceeds_the_draw():
    """The port builds the tables by blocks of rows and draws each token by
    a binary search of the cumulative row where the reference compares the
    whole row: the same tables at any width and temperature; where no entry
    exceeds the uniform draw (a row whose rounding ends below 1; here
    planted: rows that end at 0.6 or 0) both give token 0, and otherwise
    the same tokens, over a wider vocab and a longer run."""
    a, b = jlm.BigramCorpus(2048, 7), tlm.BigramCorpus(2048, 7)
    assert np.array_equal(a.sample(16, 300), b.sample(16, 300))
    # the tables, built by blocks of rows, at a width no block divides
    c, d = (m.BigramCorpus(200, 1, temperature=0.7) for m in (jlm, tlm))
    assert np.array_equal(c.probs, d.probs) and np.array_equal(c.cum, d.cum)
    assert np.array_equal(c.sample(3, 50), d.sample(3, 50))
    for c in (a, b):
        c.cum = c.cum * 0.6
        c.cum[5] = 0.0
        c.cum[:, -1] = np.where(np.arange(2048) % 3 == 0, 1.0,
                                c.cum[:, -2])
    ta, tb = a.sample(16, 300), b.sample(16, 300)
    assert np.array_equal(ta, tb)
    assert (tb == 0).mean() > 0.2 and (tb[:, 1:] != 0).any()


@pytest.mark.parametrize("dup_frac", (0.0, 0.3, 0.5))
def test_lm_batches_equal_reference(dup_frac):
    ja = jlm.lm_batches(vocab=128, batch=8, seq=16, dup_frac=dup_frac,
                        seed=5)
    tb = tlm.lm_batches(vocab=128, batch=8, seq=16, dup_frac=dup_frac,
                        seed=5)
    for _ in range(3):
        x, y = next(ja), next(tb)
        assert sorted(x) == sorted(y) == ["key", "tokens"]
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


# ------------------------------------------ the reference's tests, mirrored //

def test_bigram_corpus_learnable_structure():
    c = BigramCorpus(vocab=32, seed=0)
    toks = c.sample(64, 50)
    # empirical bigram dist should beat uniform in log-likelihood
    ll_model, ll_unif = 0.0, 0.0
    for b in range(64):
        for t in range(1, 50):
            ll_model += np.log(c.probs[toks[b, t - 1], toks[b, t]] + 1e-9)
            ll_unif += np.log(1 / 32)
    assert ll_model > ll_unif


def test_lm_batches_inject_exact_duplicates():
    it = lm_batches(vocab=64, batch=16, seq=20, dup_frac=0.5, seed=0)
    b1 = next(it)
    b2 = next(it)
    k1, k2 = set(b1["key"].tolist()), b2["key"].tolist()
    n_replayed = sum(1 for k in k2 if k in k1)
    assert n_replayed >= 4
    # keys identify content: equal keys -> equal token rows
    kmap = {}
    for row, k in zip(b1["tokens"], b1["key"]):
        kmap[int(k)] = row
    for row, k in zip(b2["tokens"], b2["key"]):
        if int(k) in kmap:
            assert np.array_equal(row, kmap[int(k)])
    assert seq_keys(b2["tokens"]).tolist() == k2
