"""The port's packed word algebra and the batch pieces of the bitset step
(intra-batch join, per-variant decisions) against the JAX package, exactly,
on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JConfig
from repro.core import batched as jb
from repro.core import packed as jp
from repro_torch.core import DedupConfig, packed, u32
from repro_torch.core import batched as tb

BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")


def _w(a):
    return u32.from_numpy_u32(a, "cpu")


# ------------------------------------------------------------- word algebra //
def test_packed_word_ops_match_reference():
    r = np.random.default_rng(0)
    s, k = 1000, 3
    w = (s + 31) // 32
    bits8 = r.integers(0, 2, (k, s)).astype(np.uint8)
    words = np.asarray(jp.pack_bits(jnp.asarray(bits8)))
    assert np.array_equal(u32.to_numpy_u32(packed.pack_bits(
        torch.from_numpy(bits8))), words)
    assert np.array_equal(packed.unpack_bits(_w(words), s).numpy(), bits8)
    pos = r.integers(0, s, (300, k)).astype(np.int32)
    wi, m = jp.split_pos(jnp.asarray(pos))
    twi, tm = packed.split_pos(torch.from_numpy(pos))
    assert np.array_equal(twi.numpy(), np.asarray(wi))
    assert np.array_equal(u32.to_numpy_u32(tm), np.asarray(m))
    assert np.array_equal(
        packed.probe_packed(_w(words), torch.from_numpy(pos)).numpy(),
        np.asarray(jp.probe_packed(jnp.asarray(words), jnp.asarray(pos))))
    sentinel = 32 * w
    sp = np.sort(np.where(r.random((k, 300)) < 0.8, pos.T, sentinel), -1)
    assert np.array_equal(
        packed.probe_sorted_packed(_w(words), torch.from_numpy(sp)).numpy(),
        np.asarray(jp.probe_sorted_packed(jnp.asarray(words),
                                          jnp.asarray(sp))))
    assert np.array_equal(packed.run_heads(torch.from_numpy(sp)).numpy(),
                          np.asarray(jp.run_heads(jnp.asarray(sp))))
    assert np.array_equal(
        u32.to_numpy_u32(packed.delta_from_sorted_positions(
            torch.from_numpy(sp), w)),
        np.asarray(jp.delta_from_sorted_positions(jnp.asarray(sp), w)))
    assert np.array_equal(packed.popcount_words(_w(words)).numpy(),
                          np.asarray(jp.popcount_words(jnp.asarray(words))))
    assert np.array_equal(packed.popcount(_w(words)).numpy(),
                          np.asarray(jp.popcount(jnp.asarray(words))))


@pytest.mark.parametrize("n_valid", (256, 200, 1, 0))
def test_intra_batch_seen_matches_reference(n_valid):
    r = np.random.default_rng(n_valid)
    keys = r.integers(0, 50, 256).astype(np.uint32)
    keys[::7] = 0xFFFFFFFF                     # collides with the sentinel
    valid = np.arange(256) < n_valid
    want = np.asarray(jb.intra_batch_seen(jnp.asarray(keys),
                                          jnp.asarray(valid)))
    got = tb.intra_batch_seen(_w(keys), torch.from_numpy(valid)).numpy()
    assert np.array_equal(got, want)


def _rnd_pair(b, k, s, seed):
    r = np.random.default_rng(seed)
    del_pos = r.integers(0, s, (b, k)).astype(np.int32)
    u_bern = r.random(b).astype(np.float32)
    u_aux = r.random((b, k)).astype(np.float32)
    which = r.integers(0, k, b).astype(np.int32)
    j = jb.BatchRandomness(*(jnp.asarray(x) for x in
                             (del_pos, u_bern, u_aux, which)))
    t = tb.BatchRandomness(*(torch.from_numpy(x) for x in
                             (del_pos, u_bern, u_aux, which)))
    return j, t


@pytest.mark.parametrize("variant", BITSET)
@pytest.mark.parametrize("position", (1, 1300, 1400, 45000, 10 ** 6,
                                      2 ** 31 - 600))
def test_decisions_match_reference(variant, position):
    """Every rsbf phase (s = 1365 here: phase 2 from i = 1366, phase 3 from
    i = 45500) and the other variants' rules, on the same inputs."""
    kw = dict(memory_bits=1 << 12, packed=True)
    jc, tc = JConfig.for_variant(variant, **kw), DedupConfig.for_variant(
        variant, **kw)
    b, k, s = 256, jc.k, jc.s
    r = np.random.default_rng(position % 1000)
    vals = r.integers(0, 2, (b, k)).astype(np.uint8)
    valid = r.random(b) < 0.9
    seen = r.random(b) < 0.2
    i_t = (position + np.arange(b)).astype(np.int32)
    load = r.integers(0, s, k).astype(np.int32)
    jr, tr = _rnd_pair(b, k, s, position % 97)
    want = jb.make_decision_fn(jc)(
        jnp.asarray(vals), jnp.asarray(valid), jnp.asarray(seen),
        jnp.asarray(i_t), jnp.asarray(load), jr)
    got = tb.make_decision_fn(tc)(
        torch.from_numpy(vals), torch.from_numpy(valid),
        torch.from_numpy(seen), torch.from_numpy(i_t),
        torch.from_numpy(load), tr)
    for a, g in zip(want, got):
        assert np.array_equal(np.asarray(a), g.numpy())


@pytest.mark.parametrize("op", ("scatter_or", "scatter_andnot"))
def test_scatter_masks_match_reference(op):
    """The reference's per-element enable-mask scatters: every mask word
    OR-ed (or cleared) into its row's word; an index past the row drops."""
    r = np.random.default_rng(5)
    k, w, b = 3, 40, 500
    words = r.integers(0, 2 ** 32, (k, w), dtype=np.uint64).astype(np.uint32)
    idx = r.integers(0, w + 25, (b, k)).astype(np.int32)
    idx[:, 1] %= w                           # one row: in range only
    mask = r.integers(0, 2 ** 32, (b, k), dtype=np.uint64).astype(np.uint32)
    mask[::7] = 0
    want = getattr(jp, op)(jnp.asarray(words), jnp.asarray(idx),
                           jnp.asarray(mask))
    got = getattr(packed, op)(_w(words), torch.from_numpy(idx), _w(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(u32.to_numpy_u32(got), np.asarray(want))
    # the (batch, ..., k) form the reference takes
    want = getattr(jp, op)(jnp.asarray(words),
                           jnp.asarray(idx[:480].reshape(4, 120, k)),
                           jnp.asarray(mask[:480].reshape(4, 120, k)))
    got = getattr(packed, op)(_w(words), torch.from_numpy(
        idx[:480].reshape(4, 120, k)), _w(mask[:480].reshape(4, 120, k)))
    assert np.array_equal(u32.to_numpy_u32(got), np.asarray(want))
    # a negative index counts from the end (here no two lanes share a word)
    idx = np.array([[-1, 3, -41], [2, -2, 0]], np.int32)
    mask = np.array([[1, 2, 4], [8, 16, 32]], np.uint32)
    want = getattr(jp, op)(jnp.asarray(words), jnp.asarray(idx),
                           jnp.asarray(mask))
    got = getattr(packed, op)(_w(words), torch.from_numpy(idx), _w(mask))
    assert np.array_equal(u32.to_numpy_u32(got), np.asarray(want))
