"""Hashing and the threefry stream of the port, exactly against the JAX
package and ``jax.random`` on the CPU (JAX's hashmix Pallas kernel runs in
interpret mode, as the JAX package's own tests run it here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.kernels import ref
from repro.kernels.hashmix import hashmix as jax_hashmix
from repro_torch.core import hashing as th
from repro_torch.core import prng, u32
from repro_torch.kernels.hashmix import hashmix, hashmix_plain

S_GRID = (1 << 30, 715827882, 1 << 12, 1365, 8)


def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n,
                                                dtype=np.uint64) \
        .astype(np.uint32)


def _w(a):
    return u32.from_numpy_u32(a, "cpu")


def test_u32_round_trips_and_arithmetic():
    a = _keys(4096)
    assert np.array_equal(u32.to_numpy_u32(_w(a)), a)
    v = u32.to_u64(_w(a))
    assert np.array_equal(v.numpy(), a.astype(np.int64))
    assert np.array_equal(u32.to_numpy_u32(u32.to_i32(v)), a)
    with np.errstate(over="ignore"):
        want = a * np.uint32(0x85EBCA6B)
    assert np.array_equal(u32.mul32(v, 0x85EBCA6B).numpy(),
                          want.astype(np.int64))
    pc = np.array([bin(int(x)).count("1") for x in a])
    assert np.array_equal(u32.popcount_u64(v).numpy(), pc)
    t = torch.from_numpy(a.astype(np.int64))
    assert torch.equal(u32.as_words(t, "cpu"), _w(a))
    assert torch.equal(u32.as_words(list(a[:5]), "cpu"), _w(a[:5]))


def test_fmix32_and_derive_seeds():
    a = _keys(2048, 1)
    got = th.fmix32(u32.to_u64(_w(a))).numpy()
    want = np.asarray(jh.fmix32(jnp.asarray(a))).astype(np.int64)
    assert np.array_equal(got, want)
    for seed, k, ch in ((0x5EED, 2, 0), (0x5EED, 3, 1), (123, 5, 7),
                        (2 ** 40 + 3, 4, 2)):
        assert np.array_equal(th.derive_seeds(seed, k, ch),
                              np.asarray(jh.derive_seeds(seed, k, ch)))


@pytest.mark.parametrize("s", S_GRID)
@pytest.mark.parametrize("k", (1, 2, 3))
def test_hash_positions_and_hashmix_plain(s, k):
    keys = _keys(3000, k)
    seeds = jh.derive_seeds(0x5EED, k)
    tseeds = _w(th.derive_seeds(0x5EED, k))
    want = np.asarray(jh.hash_positions(jnp.asarray(keys), seeds, s))
    got = th.hash_positions(_w(keys), tseeds, s).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(hashmix_plain(_w(keys), tseeds, s).numpy(), want)
    assert np.array_equal(
        np.asarray(ref.ref_hashmix(jnp.asarray(keys), seeds, s=s)), want)
    assert np.array_equal(np.asarray(jax_hashmix(jnp.asarray(keys), seeds,
                                                 s=s, interpret=True)), want)


def test_hashmix_wrapper_on_cpu_counts_no_launch():
    before = hashmix.launches
    keys, seeds = _w(_keys(64)), _w(th.derive_seeds(1, 2))
    assert torch.equal(hashmix(keys, seeds, s=1 << 20),
                       hashmix_plain(keys, seeds, 1 << 20))
    assert hashmix.launches == before
    with pytest.raises(TypeError):
        hashmix(keys.long(), seeds, s=1 << 20)
    with pytest.raises(ValueError):
        hashmix(keys[None], seeds, s=1 << 20)
    with pytest.raises(ValueError):
        hashmix(keys[::2], seeds, s=1 << 20)
    with pytest.raises(ValueError):
        hashmix(keys, seeds, s=0)


@pytest.mark.parametrize("block_bits", (5, 9))
def test_hash_positions_blocked(block_bits):
    keys = _keys(2000, 5)
    s = 1 << 14
    seeds, bseeds = jh.derive_seeds(9, 3, 0), jh.derive_seeds(9, 3, 1)
    want = np.asarray(jh.hash_positions(jnp.asarray(keys), seeds, s,
                                        block_bits, bseeds))
    got = th.hash_positions(_w(keys), _w(th.derive_seeds(9, 3, 0)), s,
                            block_bits, _w(th.derive_seeds(9, 3, 1)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 6, 7, 8, 16, 1000))
def test_route_hash_and_range_bucket(n):
    keys = _keys(1500, n)
    assert np.array_equal(
        th.route_hash(_w(keys), n, 0x5EED).numpy(),
        np.asarray(jh.route_hash(jnp.asarray(keys), n, 0x5EED)))
    assert np.array_equal(
        th.range_bucket(_w(keys), n).numpy(),
        np.asarray(jh.range_bucket(jnp.asarray(keys), n)))


# ------------------------------------------------------------- threefry //
@pytest.fixture(params=(True, False), ids=("partitionable", "original"))
def threefry_layout(request):
    """Run a test under each of JAX's threefry counter layouts, restoring
    the installed setting afterwards."""
    before = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", request.param)
    try:
        yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _kd(key):
    return np.asarray(key)


@pytest.mark.parametrize("seed", (0, 7, 0x5EED, -3, 2 ** 32 + 5))
def test_prng_key_split_fold_in(seed, threefry_layout):
    part = threefry_layout
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    assert np.array_equal(u32.to_numpy_u32(tk), _kd(jk))
    for n in (2, 3, 4):
        assert np.array_equal(u32.to_numpy_u32(prng.split(tk, n, part)),
                              _kd(jax.random.split(jk, n)))
    for data in (0, 3, 12345, 2 ** 31 + 1):
        assert np.array_equal(u32.to_numpy_u32(prng.fold_in(tk, data)),
                              _kd(jax.random.fold_in(jk, data)))


# every draw the bitset step makes (core/batched.py::draw_randomness) at
# the batch widths the tests and the chip run use, for s = 2^30 (256 MB at
# k = 2), rsbf's non-power-of-two s at 256 MB and k = 3, and small filters
DRAW_S = (1 << 30, 715827882, 1 << 15, 1365)


@pytest.mark.parametrize("b", (1, 61, 256, 8192))
def test_draw_shapes_exact(b, threefry_layout):
    part = threefry_layout
    root = jax.random.PRNGKey(0x5EED)
    rng, r_ins, r_del, r_aux = jax.random.split(root, 4)
    trng, t_ins, t_del, t_aux = prng.split(prng.PRNGKey(0x5EED, "cpu"), 4,
                                           part)
    assert np.array_equal(u32.to_numpy_u32(trng), _kd(rng))
    for k in (2, 3):
        for s in DRAW_S:
            want = np.asarray(jax.random.randint(r_del, (b, k), 0, s,
                                                 dtype=jnp.int32))
            got = prng.randint(t_del, (b, k), 0, s, part).numpy()
            assert np.array_equal(got, want), (k, s)
        assert np.array_equal(
            prng.uniform(t_aux, (b, k), part).numpy(),
            np.asarray(jax.random.uniform(r_aux, (b, k))))
        assert np.array_equal(
            prng.randint(t_aux, (b,), 0, k, part).numpy(),
            np.asarray(jax.random.randint(r_aux, (b,), 0, k,
                                          dtype=jnp.int32)))
    assert np.array_equal(prng.uniform(t_ins, (b,), part).numpy(),
                          np.asarray(jax.random.uniform(r_ins, (b,))))


def test_draw_randomness_matches_reference(threefry_layout):
    from repro.core import batched as jb
    from repro.core.config import DedupConfig as JC
    from repro_torch.core import batched as tb
    from repro_torch.core.config import DedupConfig as TC
    for variant in ("rsbf", "bsbf", "bsbfsd", "rlbsbf"):
        kw = dict(memory_bits=1 << 13, packed=True)
        jrng, jr = jb.draw_randomness(JC.for_variant(variant, **kw),
                                      jax.random.PRNGKey(11), 300)
        trng, tr = tb.draw_randomness(TC.for_variant(variant, **kw),
                                      prng.PRNGKey(11, "cpu"), 300,
                                      threefry_layout)
        assert np.array_equal(u32.to_numpy_u32(trng), _kd(jrng))
        for a, b in zip(jr, tr):
            assert np.array_equal(np.asarray(a), b.numpy()), variant


@pytest.mark.parametrize("s", (1 << 30, 715827882, 1365, 8))
def test_uniform_positions_matches_reference(s, threefry_layout):
    jk, tk = jax.random.PRNGKey(0x1D), prng.PRNGKey(0x1D, "cpu")
    for shape in ((5,), (300, 3), (2, 64, 2)):
        got = th.uniform_positions(tk, shape, s, threefry_layout)
        want = np.asarray(jh.uniform_positions(jk, shape, s))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), shape
