"""The port's ``kernels/ops.py`` against ``repro.kernels.ops`` (its Pallas
kernels in interpret mode here): ``hash_positions``, ``probe``,
``fused_probe``, ``scatter_or`` and ``scatter_andnot`` give the same words,
with disabled scatter lanes given as -1 and as indices >= W, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import derive_seeds as jseeds
from repro.kernels import ops as jops
from repro_torch.core import u32
from repro_torch.kernels import ops
from repro_torch.kernels.bloom_probe import bloom_probe
from repro_torch.kernels.scatter_delta import scatter_delta

SWEEP = [
    # (batch, k, s bits)
    (64, 1, 1 << 10),
    (100, 2, 1 << 14),
    (2048, 3, 1 << 16),
    (1000, 5, 3 * 1024),       # s not a power of two: the mod path
    (1, 2, 64),
]


def _w(a):
    return u32.from_numpy_u32(a, "cpu")


def _inputs(b, k, s, seed=0):
    r = np.random.default_rng(seed)
    keys = r.integers(0, 2 ** 32, size=b, dtype=np.uint64).astype(np.uint32)
    seeds = jseeds(42, k)
    w = ((s + 31) // 32 + 511) // 512 * 512    # the reference's tile width
    words = r.integers(0, 2 ** 32, (k, w), dtype=np.uint64).astype(np.uint32)
    return keys, seeds, words, w


@pytest.mark.parametrize("b,k,s", SWEEP)
def test_hash_probe_and_fused_probe_match_reference(b, k, s):
    keys, seeds, words, _ = _inputs(b, k, s)
    want_pos = np.asarray(jops.hash_positions(jnp.asarray(keys),
                                              jnp.asarray(seeds), s))
    pos = ops.hash_positions(_w(keys), _w(seeds), s)
    assert pos.dtype == torch.int32
    assert np.array_equal(pos.numpy(), want_pos)
    widx = (want_pos // 32).astype(np.int32)
    mask = (np.uint32(1) << (want_pos % 32).astype(np.uint32))
    want_hits = np.asarray(jops.probe(jnp.asarray(words), jnp.asarray(widx),
                                      jnp.asarray(mask)))
    hits = ops.probe(_w(words), torch.from_numpy(widx), _w(mask))
    assert hits.dtype == torch.uint8
    assert np.array_equal(hits.numpy(), want_hits)
    jdup, jhits, jpos = jops.fused_probe(jnp.asarray(keys), jnp.asarray(words),
                                         jnp.asarray(seeds), s)
    dup, hits, pos = ops.fused_probe(_w(keys), _w(words), _w(seeds), s)
    assert np.array_equal(dup.numpy(), np.asarray(jdup))
    assert np.array_equal(hits.numpy(), np.asarray(jhits))
    assert np.array_equal(pos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("disabled", ("minus_one", "past_w"))
@pytest.mark.parametrize("b,k,s", SWEEP)
def test_scatter_or_and_andnot_match_reference(b, k, s, disabled):
    keys, seeds, words, w = _inputs(b, k, s, seed=2)
    pos = np.asarray(jops.hash_positions(jnp.asarray(keys),
                                         jnp.asarray(seeds), s))
    r = np.random.default_rng(b + k)
    off = r.random((b, k)) < 0.3
    widx = np.where(off, -1 if disabled == "minus_one" else w + (pos % 7),
                    pos // 32).astype(np.int32)
    mask = (np.uint32(1) << (pos % 32).astype(np.uint32))
    for fn, jfn in ((ops.scatter_or, jops.scatter_or),
                    (ops.scatter_andnot, jops.scatter_andnot)):
        want = np.asarray(jfn(jnp.asarray(words), jnp.asarray(widx),
                              jnp.asarray(mask)))
        got = fn(_w(words), torch.from_numpy(widx), _w(mask))
        assert np.array_equal(u32.to_numpy_u32(got), want), fn.__name__


def test_scatter_delta_with_multibit_masks_and_collisions():
    """Masks of many bits, every lane on a few words: the delta is the
    OR of all of them, as the reference's tree-OR computes it."""
    from repro.kernels.scatter_delta import scatter_delta as jscatter
    r = np.random.default_rng(9)
    b, k, w = 300, 2, 512
    widx = r.integers(-2, 6, (b, k)).astype(np.int32)
    mask = r.integers(0, 2 ** 32, (b, k), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jscatter(jnp.asarray(widx), jnp.asarray(mask), w=w))
    got = scatter_delta(torch.from_numpy(widx), _w(mask), w=w)
    assert np.array_equal(u32.to_numpy_u32(got), want)


def test_wrappers_on_cpu_launch_nothing_and_check_inputs():
    keys, seeds, words, w = _inputs(64, 2, 1 << 12)
    idx = torch.zeros((64, 2), dtype=torch.int32)
    mask = torch.ones((64, 2), dtype=torch.int32)
    launches = (bloom_probe.launches, scatter_delta.launches)
    ops.probe(_w(words), idx, mask)
    ops.scatter_or(_w(words), idx, mask)
    assert (bloom_probe.launches, scatter_delta.launches) == launches
    with pytest.raises(TypeError, match="int32"):
        ops.probe(_w(words), idx.long(), mask)
    with pytest.raises(ValueError, match=r"\(B, k\)"):
        ops.scatter_or(_w(words), idx, mask[:, :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.probe(_w(words), idx.T.contiguous().T, mask)
    with pytest.raises(ValueError, match="words must be"):
        ops.probe(_w(words)[:1], idx, mask)
    # an index past the row reads a clamped word, as a JAX gather does
    far = torch.full((64, 2), 10 * w, dtype=torch.int32)
    assert torch.equal(ops.probe(_w(words), far, mask),
                       ops.probe(_w(words), torch.full_like(far, w - 1),
                                 mask))
